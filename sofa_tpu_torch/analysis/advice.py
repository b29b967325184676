"""Rule-based hints on the feature vector (the JAX package's local rules,
``sofa_tpu/analysis/advice.py``), with the same thresholds over the port's
features.

Per-device rules scan ``gpu<N>_`` features, and the worst device drives
each hint.  The rules that need multi-GPU or what-if features (the
communication ratio, step skew, the what-if payoffs, the custom-call rule)
and the mesh advice wait for those subsystems.
"""

from __future__ import annotations

import os
from typing import List, Optional

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.printing import print_hint
from sofa_tpu_torch.trace import atomic_write


def _pct(v: Optional[float]) -> float:
    return float(v) if v is not None else 0.0


def generate_hints(features: Features, cfg) -> List[str]:
    hints: List[str] = []
    get = features.get

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

    tensor = get("tensor_util_mean")
    if tensor is not None and tensor < 30.0:
        hints.append(
            f"tensor-core utilization is low ({tensor:.1f}% mean) — check"
            " for small matmul shapes, fp32 where bf16 would do, or"
            " elementwise kernels that cannot use the tensor cores")
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
    return hints


def hint_report(features: Features, cfg) -> List[str]:
    """Print the hints and write them to ``hints.txt`` (atomically); a
    run with none leaves no hints.txt, not an older run's."""
    hints = generate_hints(features, cfg)
    for h in hints:
        print_hint(h)
    path = cfg.path("hints.txt")
    if hints:
        with atomic_write(path) as f:
            f.write("\n".join(hints) + "\n")
    elif os.path.isfile(path):
        os.unlink(path)
    return hints
