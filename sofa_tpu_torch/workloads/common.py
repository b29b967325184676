"""Shared plumbing for the PyTorch workloads.

Device choice, timing loops, the ``sofa_step_N`` step annotation, and the
ranks: ``init_distributed`` (torchrun's environment, or a FileStore for
``spawn_ranks``), ``make_mesh`` (a DeviceMesh with the JAX package's
sizing rules), ``Ring``, the rank's neighbours along one mesh axis,
which rotates tensors around it by P2P, and ``AxisGroup`` with the
differentiable collectives over one axis that the tensor-, fully-sharded-
and expert-parallel workloads call (``copy_to``, ``sum_from``, ``gather``,
``all_to_all``).  The
annotation is a ``torch.profiler.record_function`` range, which the Kineto
trace carries on the host (``user_annotation``); the port's ingest turns it
into one ``gpusteps`` row per step, spanning the device work launched while
it was open (from any thread, the autograd engine's included).
"""

from __future__ import annotations

import dataclasses
import math
import time
from contextlib import nullcontext
from typing import Any, Dict, Optional, Sequence, Tuple, Union

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


# --- the mesh and the ranks --------------------------------------------------

def balanced_factorization(n: int, num_axes: int) -> Tuple[int, ...]:
    """Factor ``n`` into ``num_axes`` factors, largest first, as balanced as
    a greedy prime split allows (8, 3 axes -> (2, 2, 2); 12, 2 -> (4, 3))."""
    factors = [1] * num_axes
    primes = []
    m, p = n, 2
    while p * p <= m:
        while m % p == 0:
            primes.append(p)
            m //= p
        p += 1
    if m > 1:
        primes.append(m)
    for prime in sorted(primes, reverse=True):
        i = factors.index(min(factors))
        factors[i] *= prime
    return tuple(sorted(factors, reverse=True))


def mesh_sizes(n: int, axis_names: Sequence[str],
               axis_sizes: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The JAX package's sizing rules for ``n`` ranks: balanced over the
    axes when ``axis_sizes`` is None; an explicit -1 means "whatever is
    left"; the sizes must multiply to ``n``."""
    if axis_sizes is None:
        return balanced_factorization(n, len(axis_names))
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} ranks not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} != {n} ranks")
    return tuple(sizes)


def make_mesh(axis_names: Sequence[str],
              axis_sizes: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A ``torch.distributed`` DeviceMesh over every rank of the process
    group (``init_distributed`` first), sized by ``mesh_sizes``.  Rank
    ``i`` sits at the row-major position ``i`` of the mesh, so an axis's
    process group lists its ranks in mesh order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sizes = mesh_sizes(dist.get_world_size(), axis_names, axis_sizes)
    return init_device_mesh(device_type, sizes,
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh or that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's position along ``axis`` (0 without a mesh or axis)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """What ``init_distributed`` set up for this process."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str
    shared: bool        # the card is shared with other ranks (asked for)


def init_distributed(backend: Optional[str] = None, device=None,
                     share_device: bool = False,
                     store_path: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> RankInfo:
    """Join the process group and pick this rank's device.

    The rank comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and ``MASTER_ADDR`` /
    ``MASTER_PORT`` for the rendezvous), or, for ranks started by
    ``spawn_ranks``, from ``rank`` and ``world_size`` with a ``FileStore``
    at ``store_path``.  ``device`` as ``resolve_device``: the card unless
    the caller names the CPU.  Rank r runs on ``cuda:LOCAL_RANK``; ranks
    share a card only with ``share_device`` (each says so on its first
    line), and never under NCCL, which refuses two ranks on one card.  The
    backend defaults to ``nccl`` on the card and ``gloo`` on the CPU;
    ``gloo`` over CUDA tensors runs only when the caller names it.
    Nothing switches backend or device on a failure."""
    import os

    import torch.distributed as dist

    if store_path is None:
        try:
            rank = int(os.environ["RANK"])
            world_size = int(os.environ["WORLD_SIZE"])
        except KeyError:
            raise RuntimeError(
                "no RANK / WORLD_SIZE in the environment: start the ranks "
                "with torchrun (python -m torch.distributed.run)") from None
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        if rank is None or world_size is None:
            raise ValueError("a FileStore rendezvous needs rank and "
                             "world_size")
        local_rank, local_world = rank, world_size
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    shared = False
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        shared = local_world > count
        if shared and not share_device:
            raise RuntimeError(
                f"{local_world} ranks on this host but {count} CUDA devices: "
                f"ranks share a card only when asked (--share_device)")
        if shared and backend == "nccl":
            raise RuntimeError("NCCL refuses two ranks on one card; share "
                               "a card over gloo (--backend gloo)")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
        torch.cuda.init()       # so that the mesh keeps this device
        if shared:
            print(f"rank {rank}: shares {dev} with the other ranks of this "
                  f"host ({local_world} ranks, {count} cards), as asked",
                  flush=True)
    if store_path is None:
        dist.init_process_group(backend, rank=rank, world_size=world_size)
    else:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size)
    return RankInfo(rank, world_size, local_rank, dev, backend, shared)


def spawn_ranks(n: int, fn, *args, timeout: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes and join them
    within ``timeout`` seconds; past it, kill them all and raise
    TimeoutError (a deadlocked exchange fails in seconds, not at the
    suite's limit).  A rank that raises fails the call, as
    ``torch.multiprocessing.spawn`` does.  ``fn`` must be importable (a
    module-level function)."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, args=args, nprocs=n, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} ranks of {fn.__name__} did not "
                                   f"finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()  # sofa-lint: disable=SL008 — a spawned rank still alive past the join deadline: no collector tree, nothing to escalate; joined below
            p.join(5)


class Ring:
    """One rank's place on a ring of ranks: position ``index`` of ``size``
    over the process group ``group`` whose global ranks, in ring order,
    are ``ranks``.  ``rotate`` sends to the next position and receives
    from the previous one; with one rank it is the identity (torch refuses
    a send to self; JAX's ppermute of one is the identity)."""

    def __init__(self, index: int, size: int, group=None, ranks=()):
        self.index, self.size, self.group = index, size, group
        self.ranks = tuple(ranks)

    def _exchange(self, tensors, to: int, frm: int):
        import torch.distributed as dist

        recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in tensors]
        ops = ([dist.P2POp(dist.isend, t.contiguous(), self.ranks[to],
                           self.group) for t in tensors]
               + [dist.P2POp(dist.irecv, r, self.ranks[frm], self.group)
                  for r in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def rotate(self, tensors):
        """Each tensor to position (index + 1) mod size, in one batch of
        P2P operations; returns what came from (index - 1) mod size.
        Differentiable: the gradient rotates the other way, as the
        transpose of JAX's ppermute does."""
        if self.size == 1:
            return list(tensors)
        return list(_Rotate.apply(self, *tensors))


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        n = ring.size
        return tuple(ring._exchange(tensors, (ring.index + 1) % n,
                                    (ring.index - 1) % n))

    @staticmethod
    def backward(ctx, *grads):
        ring = ctx.ring     # None grads arrive as zeros (materialized)
        n = ring.size
        back = ring._exchange(grads, (ring.index - 1) % n,
                              (ring.index + 1) % n)
        return (None, *back)


def mesh_ring(mesh, axis: str) -> Ring:
    """This rank's ring along ``axis`` of ``mesh``."""
    import torch.distributed as dist

    ax = mesh_axis(mesh, axis)
    if ax.size == 1:
        return Ring(0, 1)
    return Ring(ax.index, ax.size, ax.group,
                dist.get_process_group_ranks(ax.group))


# --- collectives over one mesh axis ------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's place along one mesh axis: position ``index`` of
    ``size`` over the process group ``group`` (None for an axis of 1,
    where every collective below is the identity)."""

    name: str
    index: int = 0
    size: int = 1
    group: Any = None


def mesh_axis(mesh, axis: str) -> AxisGroup:
    """This rank's ``AxisGroup`` along ``axis`` of ``mesh``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return AxisGroup(axis)
    return AxisGroup(axis, mesh.get_local_rank(axis), n, mesh.get_group(axis))


def all_reduce_axes(x: torch.Tensor, mesh, axes: Sequence[str],
                    op: str = "sum") -> torch.Tensor:
    """All-reduce ``x`` in place over every axis of ``axes`` (one
    collective per axis of size above 1: over all of them together, the
    reduction over their product).  Not differentiable: for gradients and
    printed losses."""
    import torch.distributed as dist

    for name in axes:
        ax = mesh_axis(mesh, name)
        if ax.size > 1:
            dist.all_reduce(x, op=getattr(dist.ReduceOp, op.upper()),
                            group=ax.group)
    return x


def _all_reduce(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous().clone()
    dist.all_reduce(x, group=ax.group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _SumFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """The input of a column-parallel product: the identity forward, the
    gradient summed over ``ax`` backward (Megatron's f)."""
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def sum_from(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """The output of a row-parallel product: summed over ``ax`` forward,
    the identity backward (Megatron's g).  Every rank of ``ax`` then
    holds the same sum, and the gradient that reaches it is the whole
    one on every rank."""
    return x if ax.size == 1 else _SumFrom.apply(x, ax)


def _gather_dim(x: torch.Tensor, dim: int, ax: AxisGroup) -> torch.Tensor:
    import torch.distributed as dist

    lead = x.movedim(dim, 0).contiguous()
    out = torch.empty((ax.size * lead.shape[0], *lead.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, lead, group=ax.group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(g: torch.Tensor, dim: int,
                        ax: AxisGroup) -> torch.Tensor:
    import torch.distributed as dist

    lead = g.movedim(dim, 0).contiguous()
    out = torch.empty((lead.shape[0] // ax.size, *lead.shape[1:]),
                      dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, lead, group=ax.group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _gather_dim(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.dim, ctx.ax), None, None


def gather(x: torch.Tensor, dim: int, ax: AxisGroup) -> torch.Tensor:
    """The shards of ``ax`` concatenated along ``dim``, in axis order
    (``all_gather_into_tensor``); backward, the gradient's shard of this
    rank summed over ``ax`` (``reduce_scatter_tensor``): the fully
    sharded leaf's gather and its gradient's reduction."""
    return x if ax.size == 1 else _Gather.apply(x, dim, ax)


def _exchange(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    import torch.distributed as dist

    # a gradient may come strided, and so would empty_like's result of a
    # strided tensor, which gloo fills as if it were flat
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ax.group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _exchange(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.ax), None


def all_to_all(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """Block i of ``x``'s leading dimension (its size a multiple of
    ``ax.size``) goes to rank i of ``ax``; block i of the result came from
    rank i (``all_to_all_single``, JAX's ``all_to_all`` with
    ``split_axis=concat_axis=0``, untiled).  Its own transpose, so the
    gradient takes the same exchange."""
    return x if ax.size == 1 else _AllToAll.apply(x, ax)
