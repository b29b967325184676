"""Console output helpers (the tags match the JAX package's console).

Every warning and error also counts into the active run's manifest
(``telemetry.console_event``: the ``warnings`` / ``errors`` counters and
the ``warning_tail``), as the JAX package's ``printing.py`` does.
"""

from __future__ import annotations

import sys


class SofaUserError(FileNotFoundError):
    """A usage error with a curated message (a bad fault spec, a missing
    logdir): the CLI prints it as one [ERROR] line, without a traceback."""


def _note_telemetry(level: str, msg: str) -> None:
    try:
        from sofa_tpu_torch import telemetry    # it imports us

        telemetry.console_event(level, msg)
    except Exception:  # noqa: BLE001 - logging never raises
        pass


def print_info(msg: str) -> None:
    print(f"[INFO] {msg}", flush=True)


def print_warning(msg: str) -> None:
    _note_telemetry("warning", msg)
    print(f"[WARNING] {msg}", file=sys.stderr, flush=True)


def print_error(msg: str) -> None:
    _note_telemetry("error", msg)
    print(f"[ERROR] {msg}", file=sys.stderr, flush=True)


def print_progress(msg: str) -> None:
    print(f"[PROGRESS] {msg}", flush=True)


def print_title(msg: str) -> None:
    print(f"\n==== {msg} ====", flush=True)


def print_hint(msg: str) -> None:
    print(f"[HINT] {msg}", flush=True)
