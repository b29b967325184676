"""Shared plumbing for the PyTorch workloads.

Device choice, timing loops and the ``sofa_step_N`` step annotation.  The
annotation is a ``torch.profiler.record_function`` range, which the Kineto
trace carries on the host (``user_annotation``); the port's ingest turns it
into one ``gpusteps`` row per step, spanning the device work launched while
it was open (from any thread, the autograd engine's included).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device a workload runs on: CUDA unless the caller names another.

    ``None`` means the card; with no card that raises instead of falling
    back to the CPU, so a run can never report CPU numbers as the GPU's.
    An explicit ``"cpu"`` (what the tests pass) is honoured as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU on purpose")
    return dev


def fence(tree) -> Optional[float]:
    """Wait for the device to finish ``tree``: synchronize, then pull one
    element of the first tensor to the host (returned), which cannot
    complete before the work that produced it."""
    leaves = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    if any(x.is_cuda for x in leaves):
        torch.cuda.synchronize()
    if not leaves or leaves[0].numel() == 0:
        return None
    return leaves[0].reshape(-1)[0].item()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def step_annotation(step: int):
    """Profiler range wrapping one training/inference step."""
    return torch.profiler.record_function(f"sofa_step_{step}")


def steps_per_sec(step_fn, state, n_steps: int, warmup: int = 2,
                  annotate: bool = True) -> Tuple[float, object]:
    """Run ``state = step_fn(state)`` n_steps times and report steady-state
    steps/second (after ``warmup`` steps)."""
    for _ in range(warmup):
        state = step_fn(state)
    fence(state)
    t0 = time.perf_counter()
    for i in range(n_steps):
        with (step_annotation(i) if annotate else nullcontext()):
            state = step_fn(state)
    fence(state)
    dt = time.perf_counter() - t0
    return n_steps / dt, state


def parse_workload_args(argv, defaults: Dict[str, object]):
    """Tiny ``--key value`` parser so workloads stay dependency-free.
    A default of None is read as a string (``--device``)."""
    import argparse

    p = argparse.ArgumentParser()
    for k, v in defaults.items():
        if isinstance(v, bool):
            p.add_argument(f"--{k}", action=argparse.BooleanOptionalAction,
                           default=v)
        elif v is None:
            p.add_argument(f"--{k}", type=str, default=None)
        else:
            p.add_argument(f"--{k}", type=type(v), default=v)
    return p.parse_args(argv)
