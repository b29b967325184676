"""Single-device passes over the CUDA trace: ROI, op tree, copy overlap,
input pipeline, roofline and utilization.

The counterparts of ``sofa_tpu/analysis/tpu.py``'s ``spotlight_roi``,
``op_tree_profile``, ``overlap_profile``, ``input_pipeline_profile``,
``roofline_profile`` and ``tpuutil_profile``, over ``gputrace``,
``gpusteps`` and ``gpuutil``, with the region of interest applied as
there.  Where a TPU pass reads the op category (0 the TensorCore's
synchronous ops, 2 the asynchronous copies), these read the CUDA work:
kernels are the compute, memcpys and memsets the copies.  Feature and file
names swap the ``tpu`` prefix for ``gpu``; ``tc_util`` is ``kernel_util``
and ``mxu_util`` ``tensor_util`` (``ingest.kineto.gpu_utilization``).
``step_skew_profile``, the counterpart of ``tpu.py``'s, reads the steps
of several devices: under torch.distributed each rank is a device (its
global index, ``ingest/kineto.py``), so two ranks on one card are two.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass
from sofa_tpu_torch.analysis.sol import device_peaks, no_costs
from sofa_tpu_torch.printing import print_hint, print_title, print_warning
from sofa_tpu_torch.trace import (CopyKind, merged_intervals, narrow,
                                  roi_bounds, roi_clip)

KERNEL = int(CopyKind.KERNEL)
COPY_KINDS = tuple(int(k) for k in (CopyKind.H2D, CopyKind.D2H,
                                    CopyKind.D2D, CopyKind.P2P))


def _union_coverage(arr, t0s, t1s):
    """Covered length of each query window [t0, t1) under a disjoint
    sorted interval union ``arr``, by prefix sums."""
    if not len(arr):
        return np.zeros(len(t0s))
    starts, ends = arr[:, 0], arr[:, 1]
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])

    def measure_below(ts):
        j = np.searchsorted(starts, ts, side="right")
        below = cum[j]
        prev = np.maximum(j - 1, 0)
        over = np.maximum(ends[prev] - np.maximum(ts, starts[prev]), 0.0)
        return below - np.where(j > 0, over, 0.0)

    return measure_below(np.asarray(t1s)) - measure_below(np.asarray(t0s))


def _intersect_intervals(a, b):
    """Intersection of two disjoint sorted interval unions (M x 2)."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i, 0], b[j, 0])
        hi = min(a[i, 1], b[j, 1])
        if hi > lo:
            out.append((lo, hi))
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return np.asarray(out, dtype=float).reshape(-1, 2)


def _spans(df) -> np.ndarray:
    if df.empty:
        return np.empty((0, 2))
    return merged_intervals(df["timestamp"].to_numpy(float),
                            (df["timestamp"] + df["duration"]).to_numpy(float))


def _hysteresis_roi(ev, ts, dur, high: float, low: float, up_count: int,
                    t_first: float):
    """(begin, end) of the utilization ROI: a "high" sample increments a
    counter that each "low" resets; the ROI begins at the first high whose
    run since the last low reaches ``up_count``, and ends at the first low
    after it."""
    hi = ev >= high
    lo = ev < low
    cs = np.cumsum(hi)
    count = cs - np.maximum.accumulate(np.where(lo, cs, 0))
    armed = np.flatnonzero(hi & (count >= up_count))
    if armed.size == 0:
        return None, None
    i = int(armed[0])
    begin = max(float(ts[i] - dur[i] * up_count), t_first)
    after = np.flatnonzero(lo[i:])
    if after.size == 0:
        return begin, None
    j = i + int(after[0])
    return begin, float(ts[j] - dur[j])


@analysis_pass(
    name="spotlight", order=10,
    reads_frames=("gpuutil",),
    reads_columns=("timestamp", "duration", "name", "event"),
    provides_features=("roi_begin", "roi_end"),
)
def spotlight_roi(frames, cfg, features: Features) -> None:
    """Set cfg.roi_begin/roi_end from the kernel utilization: >= 50 % for
    3 windows begins the region, < 10 % ends it.  A manual
    ``--profile_region`` wins; without ``--spotlight`` nothing is set."""
    if cfg.profile_region:
        try:
            begin_s, _, end_s = cfg.profile_region.partition(":")
            cfg.roi_begin = float(begin_s or 0)
            cfg.roi_end = float(end_s or 0)
            features.add("roi_begin", cfg.roi_begin)
            features.add("roi_end", cfg.roi_end)
            return
        except ValueError:
            print_warning(f"bad --profile_region {cfg.profile_region!r}; "
                          "ignoring")
    if not cfg.spotlight:
        return
    df = frames.get("gpuutil")
    if df is None or df.empty:
        return
    util = df[df["name"] == "kernel_util"].sort_values("timestamp")
    if util.empty:
        return
    high, low, up_count = 50.0, 10.0, 3
    t_first = float(util["timestamp"].min() - util["duration"].iloc[0])
    begin, end = _hysteresis_roi(
        util["event"].to_numpy(float), util["timestamp"].to_numpy(float),
        util["duration"].to_numpy(float), high, low, up_count, t_first)
    if begin is not None:
        if end is None or end <= begin:
            end = float(util["timestamp"].max())
        cfg.roi_begin, cfg.roi_end = begin, end
        features.add("roi_begin", begin)
        features.add("roi_end", end)
        print_hint(f"spotlight ROI: {begin:.3f}s .. {end:.3f}s")


@analysis_pass(
    name="op_tree_profile", order=120,
    reads_frames=("gputrace",),
    reads_columns=("timestamp", "duration", "copyKind", "op_path", "flops",
                   "bytes_accessed"),
    provides_features=("op_tree_paths",),
    provides_artifacts=("gpu_op_tree.csv",),
    after=("spotlight",),
)
def op_tree_profile(frames, cfg, features: Features) -> None:
    """Kernel time credited to every prefix of its ``op_path`` (the host
    ranges open at its launch): ``gpu_op_tree.csv`` (path, depth, time,
    count, flops, bytes_accessed, time_pct; flops and bytes absent for a
    prefix over a kernel whose are) and ``op_tree_paths``."""
    df = frames.get("gputrace")
    if df is None or df.empty or "op_path" not in df.columns:
        return
    df = roi_clip(df, cfg)
    kern = df[(df["copyKind"] == KERNEL) & (df["op_path"] != "")]
    if kern.empty:
        return
    per_path = kern.groupby("op_path", sort=False).agg(
        time=("duration", "sum"), count=("duration", "count"),
        flops=("flops", "sum"), nbytes=("bytes_accessed", "sum"))
    for col, key in (("flops", "flops"), ("bytes_accessed", "nbytes")):
        if kern[col].isna().any():      # absent under every prefix of it
            absent = kern[col].isna().groupby(kern["op_path"],
                                              sort=False).any()
            per_path.loc[absent[absent].index, key] = float("nan")
    agg: dict = {}
    for path, dur, cnt, flops, nbytes in per_path.itertuples(name=None):
        parts = path.split("/")
        for depth in range(1, len(parts) + 1):
            prefix = "/".join(parts[:depth])
            a = agg.get(prefix)
            if a is None:
                agg[prefix] = a = [depth, 0.0, 0, 0.0, 0.0]
            a[1] += dur
            a[2] += cnt
            a[3] += flops
            a[4] += nbytes
    total = float(kern["duration"].sum())
    table = pd.DataFrame(
        [(p, d, t, c, f, b) for p, (d, t, c, f, b) in agg.items()],
        columns=["path", "depth", "time", "count", "flops", "bytes_accessed"],
    ).sort_values(["depth", "time"], ascending=[True, False])
    table["time_pct"] = 100.0 * table["time"] / total if total > 0 else 0.0
    table.to_csv(cfg.path("gpu_op_tree.csv"), index=False)
    features.add("op_tree_paths", len(table))
    if cfg.verbose and not table.empty:
        print_title("Op tree (time by program path, depth <= 2)")
        shallow = table[table["depth"] <= 2].head(12)
        print(shallow[["path", "time", "time_pct", "count"]]
              .to_string(index=False))


@analysis_pass(
    name="overlap_profile", order=130,
    reads_frames=("gputrace",),
    reads_columns=("timestamp", "duration", "deviceId", "copyKind"),
    provides_features=("gpu*_async_time", "gpu*_async_hidden_pct"),
    after=("spotlight",),
)
def overlap_profile(frames, cfg, features: Features) -> None:
    """How much copy time hides under kernels, per device:
    ``gpu<N>_async_time`` (the copies' total time) and
    ``gpu<N>_async_hidden_pct`` (its share covered by a running kernel)."""
    df = frames.get("gputrace")
    if df is None or df.empty:
        return
    df = narrow(df, ["timestamp", "duration", "deviceId", "copyKind"])
    df = roi_clip(df, cfg)
    for device_id, rows in df.groupby("deviceId"):
        kern = rows[rows["copyKind"] == KERNEL]
        copies = rows[rows["copyKind"].isin(COPY_KINDS)]
        if kern.empty or copies.empty:
            continue
        marr = _spans(kern)
        a0 = copies["timestamp"].to_numpy(float)
        a1 = (copies["timestamp"] + copies["duration"]).to_numpy(float)
        total = float((a1 - a0).sum())
        if total <= 0:
            continue
        hidden = float(np.maximum(_union_coverage(marr, a0, a1), 0.0).sum())
        features.add(f"gpu{device_id}_async_time", total)
        features.add(f"gpu{device_id}_async_hidden_pct",
                     100.0 * min(hidden / total, 1.0))


@analysis_pass(
    name="input_pipeline_profile", order=150,
    reads_frames=("gpusteps", "gputrace"),
    reads_columns=("timestamp", "duration", "deviceId", "category",
                   "copyKind", "event"),
    provides_features=("gpu*_step_gap_pct", "gpu*_step_h2d_pct"),
    provides_artifacts=("gpu_input_pipeline.csv",),
    after=("spotlight",),
)
def input_pipeline_profile(frames, cfg, features: Features) -> None:
    """Device idle time inside the steps (``gpusteps``): per device and
    step, ``busy_pct`` (share covered by kernels), ``gap_ms`` (no kernel
    running: the card waits for the host, its dispatch or its input) and
    ``h2d_ms`` (host-to-device copy time not hidden under a kernel), in
    ``gpu_input_pipeline.csv``; ``gpu<N>_step_gap_pct`` and
    ``gpu<N>_step_h2d_pct`` over all steps."""
    steps = frames.get("gpusteps")
    ops = frames.get("gputrace")
    if steps is None or steps.empty or ops is None or ops.empty:
        return
    ops = narrow(ops, ["timestamp", "duration", "deviceId", "copyKind"])
    ops = roi_clip(ops, cfg)
    steps = roi_clip(steps, cfg)
    if ops.empty or steps.empty:
        return
    rows = []
    for device_id, dev_steps in steps.groupby("deviceId"):
        dev_ops = ops[ops["deviceId"] == device_id]
        if dev_ops.empty:
            continue
        marr = _spans(dev_ops[dev_ops["copyKind"] == KERNEL])
        harr = _spans(dev_ops[dev_ops["copyKind"] == int(CopyKind.H2D)])
        hidden_h2d = _intersect_intervals(harr, marr)
        t0s = dev_steps["timestamp"].to_numpy(float)
        t1s = t0s + dev_steps["duration"].to_numpy(float)
        bounds = roi_bounds(cfg)
        if bounds is not None:
            t0s = np.maximum(t0s, bounds[0])
            t1s = np.minimum(t1s, bounds[1])
        busy = _union_coverage(marr, t0s, t1s)
        h2d_s = (_union_coverage(harr, t0s, t1s)
                 - _union_coverage(hidden_h2d, t0s, t1s))
        for i, srow in enumerate(dev_steps.itertuples(index=False)):
            if t1s[i] <= t0s[i]:
                continue
            dur = t1s[i] - t0s[i]
            rows.append({
                "deviceId": int(device_id), "step": float(srow.event),
                "t0": t0s[i], "dur": dur,
                "busy_pct": 100.0 * busy[i] / dur,
                "gap_ms": max(0.0, dur - busy[i]) * 1e3,
                "h2d_ms": h2d_s[i] * 1e3,
            })
    if not rows:
        return
    table = pd.DataFrame(rows)
    table.to_csv(cfg.path("gpu_input_pipeline.csv"), index=False)
    for device_id, sel in table.groupby("deviceId"):
        dur_s = sel["dur"].sum()
        if dur_s <= 0:
            continue
        gap_pct = 100.0 * (sel["gap_ms"].sum() / 1e3) / dur_s
        h2d_pct = 100.0 * (sel["h2d_ms"].sum() / 1e3) / dur_s
        features.add(f"gpu{device_id}_step_gap_pct", float(gap_pct))
        features.add(f"gpu{device_id}_step_h2d_pct", float(h2d_pct))


@analysis_pass(
    name="roofline_profile", order=160,
    reads_frames=("gputrace",),
    reads_columns=("timestamp", "duration", "deviceId", "category",
                   "copyKind", "name", "flops", "bytes_accessed"),
    provides_features=("gpu*_roofline_efficiency", "gpu*_compute_bound_time",
                       "gpu*_memory_bound_time",
                       "gpu*_arithmetic_intensity"),
    provides_artifacts=("roofline.csv",),
    after=("spotlight",),
)
def roofline_profile(frames, cfg, features: Features) -> None:
    """Per kernel name, the speed-of-light time max(flops / peak FLOP/s,
    bytes / peak bandwidth) against the time taken: ``roofline.csv``
    (time, count, flops, bytes_accessed, sol_time, efficiency clipped at 1,
    bound compute or memory) and per device the duration-weighted
    ``gpu<N>_roofline_efficiency``, ``gpu<N>_compute_bound_time``,
    ``gpu<N>_memory_bound_time`` and ``gpu<N>_arithmetic_intensity``.  The
    peaks are the card's data sheet's (``analysis/sol.py``): an unknown
    card gets no roofline."""
    df = frames.get("gputrace")
    if df is None or df.empty:
        return
    meta = device_peaks(cfg)
    if not meta:
        return
    df = roi_clip(df, cfg)
    kern = df[(df["copyKind"] == KERNEL) & (df["duration"] > 0)]
    if no_costs(kern, "roofline_profile"):
        return
    rows = kern[(kern["flops"] > 0) | (kern["bytes_accessed"] > 0)]
    if rows.empty:
        return
    out = []
    for device_id, dev in rows.groupby("deviceId"):
        peaks = meta.get(str(device_id), {})
        peak_flops = float(peaks.get("peak_teraflops_per_second", 0)) * 1e12
        peak_bw = float(
            peaks.get("peak_hbm_bw_gigabytes_per_second", 0)) * 1e9
        if peak_flops <= 0 or peak_bw <= 0:
            continue
        agg = dev.groupby("name").agg(
            time=("duration", "sum"), count=("duration", "count"),
            flops=("flops", "sum"), bytes_accessed=("bytes_accessed", "sum"))
        t_compute = agg["flops"] / peak_flops
        t_memory = agg["bytes_accessed"] / peak_bw
        agg["sol_time"] = pd.concat([t_compute, t_memory], axis=1).max(axis=1)
        agg["efficiency"] = (agg["sol_time"] / agg["time"]).clip(upper=1.0)
        agg["bound"] = "memory"
        agg.loc[t_compute >= t_memory, "bound"] = "compute"
        agg["deviceId"] = device_id
        out.append(agg)
        total = float(agg["time"].sum())
        sol = float((agg["time"] * agg["efficiency"]).sum())
        features.add(f"gpu{device_id}_roofline_efficiency",
                     sol / total if total else 0.0)
        for bound in ("compute", "memory"):
            features.add(
                f"gpu{device_id}_{bound}_bound_time",
                float(agg.loc[agg["bound"] == bound, "time"].sum()))
        tf, tb = float(agg["flops"].sum()), float(agg["bytes_accessed"].sum())
        if tb > 0:
            features.add(f"gpu{device_id}_arithmetic_intensity", tf / tb)
    if not out:
        return
    table = (pd.concat(out)
             .sort_values("time", ascending=False)
             .reset_index())
    table.to_csv(cfg.path("roofline.csv"), index=False)
    if cfg.verbose:
        heavy = table.head(20).sort_values("efficiency").head(5)
        print_title("Furthest-from-roofline heavy kernels")
        print(heavy[["name", "time", "efficiency", "bound"]].to_string(
            index=False))


@analysis_pass(
    name="gpuutil_profile", order=180,
    reads_frames=("gpuutil",),
    reads_columns=("name", "event"),
    provides_features=("*_mean", "*_max", "*_median"),
)
def gpuutil_profile(frames, cfg, features: Features) -> None:
    """Mean, max and median of each ``gpuutil`` series."""
    df = frames.get("gpuutil")
    if df is None or df.empty:
        return
    for metric in ("kernel_util", "tensor_util", "hbm_gbps"):
        rows = df[df["name"] == metric]
        if rows.empty:
            continue
        features.add(f"{metric}_mean", float(rows["event"].mean()))
        features.add(f"{metric}_max", float(rows["event"].max()))
        q = rows["event"].quantile([0.25, 0.5, 0.75])
        features.add(f"{metric}_median", float(q.loc[0.5]))


@analysis_pass(
    name="step_skew_profile", order=140,
    reads_frames=("gpusteps",),
    reads_columns=("timestamp", "duration", "deviceId", "event"),
    provides_features=("step_time_mean", "step_skew_mean", "step_skew_max"),
    provides_artifacts=("gpu_step_skew.csv",),
)
def step_skew_profile(frames, cfg, features: Features) -> None:
    """Straggler skew across devices from the per-device step spans: step
    k should begin on every device at once, and the spread of its begins
    (max - min over the devices that ran it) is collective wait or a
    straggler.  ``step_time_mean`` (the mean device step), and with two
    devices or more ``step_skew_mean`` / ``step_skew_max`` and
    ``gpu_step_skew.csv`` (step, skew, count: one row per step at least
    two devices ran)."""
    steps = frames.get("gpusteps")
    if steps is None or steps.empty:
        return
    features.add("step_time_mean", float(steps["duration"].mean()))
    if steps["deviceId"].nunique() < 2:
        return
    per = steps.groupby("event")["timestamp"].agg(["min", "max", "count"])
    per = per[per["count"] >= 2]
    if per.empty:
        return
    skew = per["max"] - per["min"]
    out = per.reset_index().rename(columns={"event": "step"})
    out["skew"] = skew.values
    out[["step", "skew", "count"]].to_csv(cfg.path("gpu_step_skew.csv"),
                                          index=False)
    features.add("step_skew_mean", float(skew.mean()))
    features.add("step_skew_max", float(skew.max()))
