"""Named locks and the retry backoff (the JAX package's
``sofa_tpu/concurrency.py:46-135``).

``Guard`` is a re-entrant lock that names the state it protects.
``jittered_backoff`` is the retry policy of the collector supervisor's
restarts.
"""

from __future__ import annotations

import random
import threading

__all__ = ["Guard", "jittered_backoff"]


def jittered_backoff(attempt: int, base_s: float = 0.5,
                     cap_s: float = 30.0, rng=random) -> float:
    """``base_s * 2^attempt`` capped at ``cap_s``, scaled by a random
    factor in [0.5, 1.0], so that collectors that failed together do not
    retry together.  Always in ``[min(base_s, cap_s) * 0.5, cap_s]``; pass
    a seeded ``rng`` for a deterministic sequence."""
    raw = min(base_s * (2 ** max(int(attempt), 0)), cap_s)
    return raw * (0.5 + 0.5 * rng.random())


class Guard:
    """A named lock that declares the attributes it protects; re-entrant
    unless ``reentrant=False``."""

    __slots__ = ("name", "protects", "_lock")

    def __init__(self, name: str, protects=(), reentrant: bool = True):
        if not name or not isinstance(name, str):
            raise ValueError(f"Guard needs a non-empty name, got {name!r}")
        self.name = name
        self.protects = tuple(protects)
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def __enter__(self) -> "Guard":
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False

    def __repr__(self) -> str:
        return f"Guard({self.name!r}, protects={list(self.protects)})"
