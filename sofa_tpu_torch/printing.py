"""Console output helpers (the tags match the JAX package's console)."""

from __future__ import annotations

import sys


def print_info(msg: str) -> None:
    print(f"[INFO] {msg}", flush=True)


def print_warning(msg: str) -> None:
    print(f"[WARNING] {msg}", file=sys.stderr, flush=True)


def print_progress(msg: str) -> None:
    print(f"[PROGRESS] {msg}", flush=True)


def print_title(msg: str) -> None:
    print(f"\n==== {msg} ====", flush=True)


def print_hint(msg: str) -> None:
    print(f"[HINT] {msg}", flush=True)
