"""The worker-pool policy of the report path (the JAX package's
``sofa_tpu/pool.py``).

Every pool on the report path takes its width from ``--jobs``
(``SofaConfig.jobs``; 0 = auto: ``SOFA_JOBS`` if set, else the usable CPUs,
at most 32).  Thread pools are the default: pandas' readers and writers
release the GIL, and the pure-Python parsers still overlap their file IO.
Process pools, for the CPU-heavy parsers, come from
:func:`process_context`: forkserver where available, else spawn, never
fork, since the caller may hold sampler threads and an initialized CUDA
context, which a forked child inherits broken.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, TypeVar

T = TypeVar("T")
R = TypeVar("R")

# Past ~32 workers the report path is IO- or join-bound.
MAX_AUTO_JOBS = 32


def resolve_jobs(jobs: int = 0) -> int:
    """A positive ``jobs`` wins; 0 or less means auto: ``SOFA_JOBS`` if
    set, else the CPUs this process may run on (capped)."""
    if jobs and jobs > 0:
        return int(jobs)
    env = os.environ.get("SOFA_JOBS", "").strip()
    if env.isdigit() and int(env) > 0:
        return min(int(env), MAX_AUTO_JOBS)
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n = os.cpu_count() or 1
    return max(1, min(n, MAX_AUTO_JOBS))


def cfg_jobs(cfg) -> int:
    """The resolved worker count of a SofaConfig (0 or absent = auto)."""
    return resolve_jobs(getattr(cfg, "jobs", 0))


def pool_size(jobs: int, n_items: int) -> int:
    """Workers to start: never more than items, never fewer than 1."""
    return max(1, min(jobs, n_items))


def thread_map(fn: Callable[[T], R], items: Iterable[T],
               jobs: int) -> List[R]:
    """Ordered ``map`` over a thread pool; serial with one job or one item
    (so ``--jobs 1`` runs no pool at all)."""
    items = list(items)
    if jobs <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=pool_size(jobs, len(items))) as pool:
        return list(pool.map(fn, items))


def process_context():
    """The multiprocessing context of a parser process pool: forkserver
    when available, else spawn, never fork."""
    import multiprocessing as mp

    methods = mp.get_all_start_methods()
    return mp.get_context("forkserver" if "forkserver" in methods else "spawn")
