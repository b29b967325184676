"""Collective microbench: nccl-tests' table over the mesh's axes.

The counterpart of ``sofa_tpu/workloads/collectives.py`` (the reference
profiler's xring sweep of ring all-reduce configurations): for each mesh axis
and each payload size it times ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and a neighbour exchange (``ppermute``, by
``batch_isend_irecv`` to the next rank of the axis) over the axis's process
group, and reports algorithm and bus bandwidth per rank the way nccl-tests
does.  It is the profiler's canonical generator of collective traffic
(``analysis/comm.py``).  A collective the backend lacks is reported as
unsupported, never emulated by another one.  Run the ranks with torchrun
(``python -m torch.distributed.run``); one rank prints the single-device
line and stops.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")


def _bus_factor(kind: str, n: int) -> float:
    """Bytes actually crossing links per byte of input, per nccl-tests."""
    if n <= 1:
        return 0.0
    return {
        "all_reduce": 2.0 * (n - 1) / n,
        "all_gather": (n - 1) / n,
        "reduce_scatter": (n - 1) / n,
        "ppermute": 1.0,
    }[kind]


def _make_op(kind: str, ring):
    """``op(x)`` running collective ``kind`` over ``ring``'s group on this
    rank's buffer x [count] (count a multiple of the group size)."""
    import torch.distributed as dist

    group, n = ring.group, ring.size

    def op(x):
        if kind == "all_reduce":
            dist.all_reduce(x, group=group)
            return x
        if kind == "all_gather":
            out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=group)
            return out
        if kind == "reduce_scatter":
            out = torch.empty(x.numel() // n, dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, x, group=group)
            return out
        if kind == "ppermute":
            return ring.rotate([x])[0]
        raise ValueError(kind)

    return op


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_axis(mesh, axis: str, sizes_mb: List[float], reps: int = 10,
               dtype=torch.bfloat16, device=None) -> List[Dict]:
    """Rows of the table for ``axis``: each kind at each size, timed over
    ``reps`` calls after one warm-up, on ``device`` (the mesh's)."""
    from sofa_tpu_torch.workloads.common import mesh_ring

    ring = mesh_ring(mesh, axis)
    n = ring.size
    device = torch.device(device or mesh.device_type)
    item = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=device)
    gen.manual_seed(ring.index)        # each rank holds distinct data
    rows = []
    for mb in sizes_mb:
        count = max(int(mb * 2 ** 20) // item, n)
        count = (count // n) * n
        for kind in KINDS:
            x = torch.randn(count, generator=gen, device=device).to(dtype)
            op = _make_op(kind, ring)
            # nccl-tests' size convention: the per-rank buffer for
            # all_reduce, reduce_scatter and ppermute, the gathered output
            # for all_gather (each rank receives (n-1)/n of it)
            size_b = count * item * (n if kind == "all_gather" else 1)
            row = {"collective": kind, "axis": axis, "axis_size": n,
                   "size_mb": round(size_b / 2 ** 20, 3)}
            try:
                op(x)                   # warm-up: the backend's support
            except (RuntimeError, NotImplementedError) as e:
                rows.append({**row, "time_us": None, "algbw_gbps": None,
                             "busbw_gbps": None,
                             "status": f"unsupported: {str(e)[:120]}"})
                continue
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                y = op(x)
            _sync(device)
            dt = (time.perf_counter() - t0) / reps
            del y
            alg = size_b / dt / 1e9
            rows.append({**row, "time_us": round(dt * 1e6, 1),
                         "algbw_gbps": round(alg, 3),
                         "busbw_gbps": round(alg * _bus_factor(kind, n), 3),
                         "status": "ok"})
    return rows


def run(mesh, sizes_mb=None, reps: int = 10, device=None) -> List[Dict]:
    """The table over every axis of ``mesh`` larger than 1."""
    from sofa_tpu_torch.workloads.common import axis_size

    sizes_mb = sizes_mb or [1, 4, 16, 64]
    rows = []
    for axis in mesh.mesh_dim_names:
        if axis_size(mesh, axis) > 1:
            rows.extend(bench_axis(mesh, axis, sizes_mb, reps,
                                   device=device))
    return rows


def print_table(rows: List[Dict]) -> None:
    hdr = ["collective", "axis", "axis_size", "size_mb", "time_us",
           "algbw_gbps", "busbw_gbps"]
    print("  ".join(f"{h:>14}" for h in hdr))
    for r in rows:
        cells = [r[h] if r["status"] == "ok" or h not in hdr[4:]
                 else "unsupported" for h in hdr]
        print("  ".join(f"{c!s:>14}" for c in cells))
    done = [r for r in rows if r["status"] == "ok"]
    if done:
        best = max(done, key=lambda r: r["busbw_gbps"])
        print(f"best bus bandwidth: {best['busbw_gbps']} GB/s "
              f"({best['collective']} over axis {best['axis']!r}, "
              f"{best['size_mb']} MB)")


def main(argv=None):
    import os

    from sofa_tpu_torch.workloads.common import (init_distributed, make_mesh,
                                                 parse_workload_args)

    args = parse_workload_args(argv, {
        "sizes_mb": "1,4,16,64", "reps": 10, "axes": "data,model",
        "device": None,
    })
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        print("collectives: single device, nothing to do")
        return
    info = init_distributed(device=args.device)
    mesh = make_mesh(tuple(args.axes.split(",")),
                     device_type=info.device.type)
    rows = run(mesh, [float(s) for s in args.sizes_mb.split(",")],
               args.reps, device=info.device)
    if info.rank == 0:
        print_table(rows)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
