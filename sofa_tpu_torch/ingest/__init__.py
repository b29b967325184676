"""Parsers turning raw collector output into unified-schema frames.

Corruption contract (the JAX package's ``sofa_tpu/ingest/__init__.py:24-57``):
a parser that can positively identify a truncated or corrupt raw file
raises :class:`CorruptRawError` (never for a merely empty or absent file);
preprocess then moves the file to ``<logdir>/_quarantine/`` and records the
source ``quarantined`` in the run manifest.  A parser whose external
converter fails over existing raw bytes raises :class:`IngestToolError`;
the source is recorded ``failed`` and the file stays where it is.
"""

from __future__ import annotations


class CorruptRawError(ValueError):
    """A raw collector file is positively corrupt (not merely absent or
    empty).  Carries the file's ``path`` for the quarantine; the args stay
    ``(path, reason)`` so that it survives a process-pool pickle."""

    def __init__(self, path: str, reason: str):
        super().__init__(path, reason)
        self.path = path
        self.reason = reason

    def __str__(self) -> str:
        return f"{self.path}: {self.reason}"


class IngestToolError(RuntimeError):
    """An external conversion tool failed or hung over existing raw bytes:
    the file may be fine, so it is not quarantined, and a run with a
    working tool can still ingest it."""

    def __init__(self, path: str, reason: str):
        super().__init__(path, reason)
        self.path = path
        self.reason = reason

    def __str__(self) -> str:
        return f"{self.path}: {self.reason}"
