"""Mesh advice and rule-based hints on the feature vector (the JAX
package's ``sofa_tpu/analysis/advice.py``), with the same thresholds over
the port's features.

``mesh_advice`` orders the ranks into a ring along the peer access
between their cards (the merged topology, ``gpu_topo.json``), where the
reference's xring searched the NVLink topology for a
``CUDA_VISIBLE_DEVICES`` order and the JAX package snakes over the torus
coordinates, and suggests (data, seq) meshes; it writes
``sofa_hints/mesh_advice.txt``.

Per-device rules scan ``gpu<N>_`` features, and the worst device drives
each hint.  ``tpu_ops`` is ``gpu_kernels`` (the compute-bound verdict
needs a kernel: ``gpu_profile`` writes 0 for an empty trace, where the
JAX pass writes nothing) and ``tpu0_op_time`` ``gpu0_kernel_time``.  The
custom-call rule reads ``gpu_unattributed_kernel_time`` (hand-written
kernels launched outside any aten op and cost range, measured at trace
detail level 2 only) and names the port's fix, a cost range; the ``[whatif]`` lines rank the
``whatif_model`` pass's payoffs, the largest first.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from sofa_tpu_torch.analysis.comm import load_topology
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass
from sofa_tpu_torch.printing import print_hint
from sofa_tpu_torch.trace import atomic_write


def _factorizations(n: int) -> List[Tuple[int, int]]:
    """All 2D factor pairs of n, most-square first (good default meshes)."""
    out = []
    for a in range(1, int(n ** 0.5) + 1):
        if n % a == 0:
            out.append((a, n // a))
    return sorted(out, key=lambda p: abs(p[0] - p[1]))


def _linked(a: dict, b: dict, peer_access: dict) -> bool:
    """Whether two ranks' cards reach each other directly: the same card,
    or two cards of one host with peer access."""
    if a.get("host") != b.get("host") or a.get("cuda_ordinal") is None:
        return False
    pair = [a.get("cuda_ordinal"), b.get("cuda_ordinal")]
    return pair[0] == pair[1] or pair in peer_access.get(a.get("host"), [])


def link_ring(topo: dict) -> Tuple[List[int], bool]:
    """(ring order of the ranks, whether any step of it follows a link):
    from the lowest rank, each step goes to the lowest unvisited rank
    whose card the current one reaches directly, else to the lowest
    unvisited rank."""
    devices = sorted(topo.get("devices", []), key=lambda d: d["id"])
    peer_access = topo.get("peer_access") or {}
    if not isinstance(peer_access, dict):
        peer_access = {}
    if not devices:
        return [], False
    order, linked = [devices[0]], False
    left = devices[1:]
    while left:
        nxt = next((d for d in left
                    if _linked(order[-1], d, peer_access)), None)
        linked |= nxt is not None
        nxt = nxt or left[0]
        order.append(nxt)
        left.remove(nxt)
    return [d["id"] for d in order], linked


@analysis_pass(
    name="mesh_advice", order=240,
    provides_features=("mesh_advice",),
    provides_artifacts=("mesh_advice.txt",),
)
def mesh_advice(frames, cfg, features: Features) -> None:
    """``sofa_hints/mesh_advice.txt``: the device count, a ring order of
    the ranks, and (data, seq) mesh shapes for ``make_mesh``, most
    square first; ``mesh_advice`` names the file."""
    topo = load_topology(cfg)
    if topo is None:
        return
    n = len(topo.get("devices", []))
    if n == 0:
        return
    ring, linked = link_ring(topo)
    lines = ["# sofa_tpu_torch mesh advice", f"device_count = {n}"]
    if linked:
        lines.append(f"link_ring_order = {ring}  # along the peer access "
                     "between the ranks' cards")
    else:
        lines.append(f"ring_order = {ring}  # by rank (no peer access "
                     "between the cards)")
    if n > 1:
        lines.append("suggested 2D meshes (data, seq):")
        for dp, sp in _factorizations(n)[:3]:
            lines.append(f'  make_mesh(("data", "seq", "model"), '
                         f"({dp}, {sp}, 1))")
        lines.append(
            "put the seq axis on ranks next to each other in the ring order"
            " so that the ring attention's K/V hops take the shortest links")
    hints_dir = cfg.path("sofa_hints")
    os.makedirs(hints_dir, exist_ok=True)
    with atomic_write(os.path.join(hints_dir, "mesh_advice.txt")) as f:
        f.write("\n".join(lines) + "\n")
    features.add_info("mesh_advice", f"{hints_dir}/mesh_advice.txt")


def _pct(v: Optional[float]) -> float:
    return float(v) if v is not None else 0.0


def generate_hints(features: Features, cfg) -> List[str]:
    hints: List[str] = []
    get = features.get

    comm_ratio = _pct(get("comm_ratio"))
    if comm_ratio >= 0.15:
        # the reference's compute- vs communication-bound threshold
        hints.append(
            f"communication-bound: collectives take {comm_ratio:.0%} of"
            " device time — try a larger per-GPU batch, gradient"
            " accumulation, or a mesh shape that shortens the all-reduce"
            " ring (see mesh_advice)")
    elif get("gpu_kernels"):
        hints.append(f"compute-bound: collectives take {comm_ratio:.0%} of "
                     "device time")

    effs = features.by_regex(r"gpu\d+_roofline_efficiency")
    if effs:
        name, eff = min(effs, key=lambda nv: nv[1])
        dev = name.split("_", 1)[0]
        if eff < 0.4:
            mem_t = get(f"{dev}_memory_bound_time")
            cmp_t = get(f"{dev}_compute_bound_time")
            dominant = ("memory" if (mem_t or 0) >= (cmp_t or 0)
                        else "compute")
            fix = ("fuse elementwise chains into the matmuls and raise"
                   " arithmetic intensity (larger batch/tiles)"
                   if dominant == "memory" else
                   "check that matmul and convolution shapes fill the"
                   " tensor cores' tiles (dimensions in multiples of 64)"
                   " and prefer bf16 inputs")
            hints.append(
                f"kernels on {dev} run at {eff:.0%} of their roofline bound"
                f" and {dominant}-bound time dominates — {fix}"
                " (see roofline.csv)")

    exposed = []
    for name, hidden in features.by_regex(r"gpu\d+_async_hidden_pct"):
        dev = name.split("_", 1)[0]
        atime = get(f"{dev}_async_time")
        ktime = get(f"{dev}_kernel_time")
        if hidden < 50.0 and atime and ktime and atime > 0.05 * ktime:
            exposed.append((hidden, dev))
    if exposed:
        hidden, dev = min(exposed)
        hints.append(
            f"exposed copy latency on {dev}: only {hidden:.0f}% of the"
            " memcpy/memset time overlaps a running kernel — copy from"
            " pinned memory with non_blocking=True on a side stream, prefetch"
            " the next batch, or fuse small transfers")

    gaps = features.by_regex(r"gpu\d+_step_gap_pct")
    if gaps:
        name, gap = max(gaps, key=lambda nv: nv[1])
        dev = name.split("_", 1)[0]
        if gap > 15.0:
            h2d = get(f"{dev}_step_h2d_pct") or 0.0
            cause = (
                f"host->device copies cover {h2d:.0f}% of step time — the"
                " input pipeline is the likely gate; prefetch batches to"
                " the device (pinned memory, a side stream) or move"
                " preprocessing off the host"
                if h2d > 0.2 * gap else
                "little H2D activity fills the gaps — look at host dispatch"
                " (many small kernels: CUDA graphs or torch.compile),"
                " synchronizations (.item(), .cpu()), or eval between steps")
            hints.append(
                f"device idle inside steps on {dev}: kernels cover only"
                f" {100.0 - gap:.0f}% of step time — {cause}"
                " (see gpu_input_pipeline.csv)")

    unattr = get("gpu_unattributed_kernel_time")
    if unattr:
        total = sum(v for _, v in features.by_regex(r"gpu\d+_kernel_time"))
        if total and unattr > 0.05 * total:
            hints.append(
                f"unattributed kernel time: kernels launched outside any aten"
                f" op and cost range take {unattr / total:.0%} of device time"
                " and carry no flops or bytes, so the roofline and the top"
                " kernels' flops undercount exactly them; open a"
                " torch.profiler.record_function range named by"
                " sofa_tpu_torch.costs.cost_range_name(...) around each"
                " launch (workloads/flash_cuda.py does so for the flash"
                " kernels)")

    skew = get("step_skew_mean")
    step_mean = get("step_time_mean") or get("aisi_step_time_mean")
    if skew is not None and step_mean and skew > 0.05 * step_mean:
        hints.append(
            f"straggler skew: devices start the same step {skew * 1e3:.2f} ms"
            " apart on average — check uneven sharding, host input"
            " pipelines, or host-network interference (see"
            " gpu_step_skew.csv)")

    tensor = get("tensor_util_mean")
    if tensor is not None and tensor < 30.0:
        hints.append(
            f"tensor-core utilization is low ({tensor:.1f}% mean) — check"
            " for small matmul shapes, fp32 where bf16 would do, or"
            " elementwise kernels that cannot use the tensor cores")
    h2d = get("comm_h2d_time")
    busy = get("gpu0_kernel_time")
    if h2d and busy and h2d > 0.2 * busy:
        hints.append(
            "input-bound: host->device transfer is a large fraction of"
            " device time — prefetch batches (pinned memory, a side"
            " stream) or move preprocessing off the host")
    iow = _pct(get("elapsed_iow_ratio"))
    if iow > 0.2:
        hints.append(
            f"I/O-wait dominates {iow:.0%} of wall time — data loading is"
            " likely the bottleneck (consider caching or faster storage)")
    idl = _pct(get("elapsed_idl_ratio"))
    if idl > 0.5:
        hints.append(
            f"{idl:.0%} of wall time is idle — the GPU is starved or the"
            " workload is tiny relative to the recording window")
    cpu_util = get("cpu_util")
    ncores = get("num_cores")
    if cpu_util is not None and ncores and cpu_util > 0.85:
        hints.append(
            "host CPU is saturated — data pipeline or Python overhead may be"
            " gating the GPU")

    # the what-if payoffs the whatif_model pass priced over this run's own
    # step timeline, the largest first
    payoffs = []
    for name, scenario, story in (
        ("whatif_overlap_payoff_pct", "overlap:*",
         "hiding exposed collectives behind step compute"),
        ("whatif_sol_payoff_pct", "scale:*=sol",
         "running every kernel class at its speed-of-light time"),
    ):
        pct = get(name)
        if pct is not None and pct >= 2.0:
            payoffs.append((pct, scenario, story))
    for pct, scenario, story in sorted(payoffs, reverse=True):
        hints.append(
            f"[whatif] {story} is predicted to cut mean step time by "
            f"{pct:.1f}% — preview with `python -m sofa_tpu_torch whatif "
            f"<logdir> --apply {scenario}` (error bars in "
            "whatif_report.json)")
    return hints


def self_hints(logdir: str) -> List[str]:
    """The run manifest's health warnings as ``[self]`` hints (the JAX
    package's ``advice.py:257-264``): a hint computed from a half-captured
    trace is advice about the gap, so these ride the same channel."""
    from sofa_tpu_torch import telemetry

    return [f"[self] {w}" for w in
            telemetry.manifest_warnings(telemetry.load_manifest(logdir))]


def hint_report(features: Features, cfg) -> List[str]:
    """Print the hints, the ``[self]`` ones last, and write them to
    ``hints.txt`` (atomically); a run with none leaves no hints.txt, not
    an older run's."""
    hints = generate_hints(features, cfg) + self_hints(cfg.logdir)
    for h in hints:
        print_hint(h)
    path = cfg.path("hints.txt")
    if hints:
        with atomic_write(path) as f:
            f.write("\n".join(hints) + "\n")
    elif os.path.isfile(path):
        os.unlink(path)
    return hints
