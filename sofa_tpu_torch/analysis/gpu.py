"""GPU-side analysis passes.

Over the Kineto-derived frames: ``gpu_profile`` is the counterpart of
``analysis/tpu.py:tpu_profile`` (kernel and copy time per device, busy
share, flops and bytes, forward and backward time, op categories, ranges,
top kernels); ``serving_profile`` of its ``serving_profile`` (the
prefill/decode split, read from the ``module`` column: the ``run_prefill``
/ ``run_decode`` profiler ranges the serving loop wraps its phases in).
The other single-device passes are in ``analysis/device.py``; ``PASSES``
lists them all in the JAX package's order.

Over the memory sampler: ``gpumon_profile`` (occupancy and peak per
device, from the gpumon frame) and ``memprof_profile`` (which allocation
sites held the peak, from the memprof snapshot), the counterparts of
``tpumon_profile`` and ``memprof_profile``.
"""

from __future__ import annotations

from sofa_tpu_torch.analysis import device
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass
from sofa_tpu_torch.printing import print_title, print_warning
from sofa_tpu_torch.trace import CopyKind, merged_intervals, roi_clip


def _traced_window(frames) -> float:
    """Seconds from the first traced event (host or device) to the last
    one's end."""
    spans = [(df["timestamp"], df["timestamp"] + df["duration"])
             for df in (frames.get("gputrace"), frames.get("hosttrace"))
             if df is not None and not df.empty]
    if not spans:
        return 0.0
    first = min(float(s.min()) for s, _ in spans)
    last = max(float(e.max()) for _, e in spans)
    return last - first


def _overlap_s(a, b) -> float:
    """Total length of the intersection of two sorted, disjoint interval
    sets (merged_intervals output)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i, 1], b[j, 1]) - max(a[i, 0], b[j, 0]))
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return total


#: The ``hlo_category`` of a kernel no op or cost range owns: its Kineto
#: category (``ingest/kineto.py``).
UNOWNED = "kernel"


def _slug(name: str) -> str:
    return name.strip().lower().replace(" ", "_").replace("-", "_")


@analysis_pass(
    name="gpu_profile", order=110,
    reads_frames=("gputrace", "gpusteps", "hosttrace"),
    reads_columns=("timestamp", "duration", "deviceId", "copyKind", "name",
                   "hlo_category", "module", "phase", "flops",
                   "bytes_accessed", "op_path"),
    provides_features=("gpu_devices", "gpu_kernels", "gpu*_kernel_time",
                       "gpu*_memcpy_time", "gpu*_busy_pct", "gpu_busy_pct",
                       "gpu_step_busy_pct", "gpu_total_flops",
                       "gpu_total_bytes_accessed", "gpu_fw_time",
                       "gpu_bw_time", "gpu_bw_fw_ratio", "gpu_op_time_*",
                       "gpu_unattributed_kernel_time"),
    provides_artifacts=("gpu_top_kernels.csv", "gpu_categories.csv",
                        "gpu_modules_summary.csv"),
    after=("spotlight",),
)
def gpu_profile(frames, cfg, features: Features) -> None:
    """Kernel and copy time per device, the busy share of the traced window
    and of the annotated steps, and what ``tpu_profile`` gives: the flops
    and bytes of the kernels (absent when a kernel's are), the forward and
    backward time, the time per
    op category (``gpu_op_time_<op>``, ``gpu_categories.csv``), per
    annotated range (``gpu_modules_summary.csv``) and the top kernels with
    their flops and bytes (``gpu_top_kernels.csv``)."""
    df = frames.get("gputrace")
    if df is None or df.empty:
        print_warning("gpu_profile: gputrace is empty: the trace holds no "
                      "CUDA kernels or copies (no card, or the program "
                      "never used it)")
        features.add("gpu_devices", 0)
        features.add("gpu_kernels", 0)
        return
    df = roi_clip(df, cfg)
    kern = df[df["copyKind"] == int(CopyKind.KERNEL)]
    features.add("gpu_devices", df["deviceId"].nunique())
    features.add("gpu_kernels", len(kern))
    window = _traced_window(frames)
    busy = []
    for device_id, rows in df.groupby("deviceId"):
        k = rows[rows["copyKind"] == int(CopyKind.KERNEL)]
        c = rows[rows["copyKind"].isin(device.COPY_KINDS)]
        features.add(f"gpu{device_id}_kernel_time", float(k["duration"].sum()))
        features.add(f"gpu{device_id}_memcpy_time", float(c["duration"].sum()))
        spans = merged_intervals(rows["timestamp"],
                                 rows["timestamp"] + rows["duration"])
        pct = 100.0 * float((spans[:, 1] - spans[:, 0]).sum()) / window \
            if window > 0 else 0.0
        features.add(f"gpu{device_id}_busy_pct", pct)
        busy.append(pct)
    features.add("gpu_busy_pct", sum(busy) / len(busy))
    # The same share inside the annotated steps only (the whole window also
    # holds start-up, weight init and teardown).
    steps = frames.get("gpusteps")
    if steps is not None and not steps.empty:
        step_spans = merged_intervals(steps["timestamp"],
                                      steps["timestamp"] + steps["duration"])
        dev_spans = merged_intervals(df["timestamp"],
                                     df["timestamp"] + df["duration"])
        in_steps = float((step_spans[:, 1] - step_spans[:, 0]).sum())
        if in_steps > 0:
            features.add("gpu_step_busy_pct",
                         100.0 * _overlap_s(dev_spans, step_spans) / in_steps)
    # absent (NaN) costs leave the totals absent too: a trace without
    # operand shapes (--kineto_host_tracer_level below 2)
    if not kern["flops"].isna().any():
        features.add("gpu_total_flops", float(kern["flops"].sum()))
    if not kern["bytes_accessed"].isna().any():
        features.add("gpu_total_bytes_accessed",
                     float(kern["bytes_accessed"].sum()))
    # Hand-written kernels launched outside any aten op and outside a cost
    # range (a ctypes or Triton launch) carry neither flops nor bytes, and
    # drop out of the roofline and the top kernels' flops: the JAX
    # package's tpu_customcall_unattributed_time, its Pallas kernels
    # without a CostEstimate.  A kernel inside an aten op that costs.py
    # does not model is not one of them (its fix is a cost formula, not a
    # range).  Only where the trace recorded the operand shapes
    # (--kineto_host_tracer_level 2 or more): below it every unowned
    # kernel's cost is absent (NaN), not 0, and proves nothing.
    if not kern["flops"].isna().any() \
            and not kern["bytes_accessed"].isna().any():
        outside = ~kern["op_path"].astype(str).str.contains(
            r"(?:^|/)aten::", regex=True)
        unowned = kern[(kern["hlo_category"] == UNOWNED) & outside
                       & (kern["flops"] <= 0)
                       & (kern["bytes_accessed"] <= 0)]
        if len(unowned):
            features.add("gpu_unattributed_kernel_time",
                         float(unowned["duration"].sum()))
    fw = float(kern.loc[kern["phase"] == "fw", "duration"].sum())
    bw = float(kern.loc[kern["phase"] == "bw", "duration"].sum())
    if fw > 0 or bw > 0:
        features.add("gpu_fw_time", fw)
        features.add("gpu_bw_time", bw)
        if fw > 0:
            features.add("gpu_bw_fw_ratio", bw / fw)
    top = (kern.groupby("name")
           .agg(total_time=("duration", "sum"), count=("duration", "count"),
                mean_time=("duration", "mean"), flops=("flops", "sum"),
                bytes_accessed=("bytes_accessed", "sum"))
           .sort_values("total_time", ascending=False))
    for col in ("flops", "bytes_accessed"):
        if kern[col].isna().any():      # a kernel without its cost: absent
            absent = kern[col].isna().groupby(kern["name"]).any()
            top.loc[absent[absent].index, col] = float("nan")
    top.to_csv(cfg.path("gpu_top_kernels.csv"))
    if cfg.verbose and not top.empty:
        print_title("Top-10 CUDA kernels by total time")
        print(top.head(10).to_string())
    cat_key = df["hlo_category"].where(df["hlo_category"] != "",
                                       "uncategorized").rename("cat")
    cat = df.groupby(cat_key)["duration"].sum().sort_values(ascending=False)
    for name, value in cat.items():
        features.add(f"gpu_op_time_{_slug(name)}", float(value))
    cat.to_csv(cfg.path("gpu_categories.csv"))
    ranged = kern[kern["module"] != ""]
    if not ranged.empty:
        ranged.groupby("module")["duration"].agg(["sum", "count"]).to_csv(
            cfg.path("gpu_modules_summary.csv"))


@analysis_pass(
    name="serving_profile", order=170,
    reads_frames=("gputrace", "hosttrace"),
    reads_columns=("timestamp", "duration", "module", "name",
                   "hlo_category"),
    provides_features=("serving_prefill_time", "serving_decode_time",
                       "serving_decode_calls", "serving_ttft"),
    after=("spotlight",),
)
def serving_profile(frames, cfg, features: Features) -> None:
    """Device time of the prefill and decode phases, decode dispatches,
    and time to first token: from the first prefill dispatch on the host
    to the end of the last prefill kernel before the first decode kernel."""
    df = frames.get("gputrace")
    if df is None or df.empty:
        return
    mods = df["module"].astype(str)
    pre = df[mods.str.contains("prefill", case=False)]
    dec = df[mods.str.contains("decode|generate", case=False)]
    if pre.empty or dec.empty:
        return
    features.add("serving_prefill_time", float(pre["duration"].sum()))
    features.add("serving_decode_time", float(dec["duration"].sum()))
    host = frames.get("hosttrace")
    start = float(pre["timestamp"].min())
    if host is not None and not host.empty:
        ann = host[host["hlo_category"] == "user_annotation"]
        names = ann["name"].astype(str)
        features.add("serving_decode_calls", int(names.str.contains(
            "decode|generate", case=False).sum()))
        pre_ann = ann[names.str.contains("prefill", case=False)]
        if not pre_ann.empty:
            start = float(pre_ann["timestamp"].min())
    head = pre[pre["timestamp"] < float(dec["timestamp"].min())]
    if not head.empty:
        end = float((head["timestamp"] + head["duration"]).max())
        features.add("serving_ttft", end - start)


@analysis_pass(
    name="gpumon_profile", order=190,
    reads_frames=("gpumon",),
    reads_columns=("timestamp", "name", "deviceId", "event", "payload"),
    provides_features=("gpumon_samples", "gpumon_span",
                       "gpu*_hbm_used_mean_gb", "gpu*_hbm_used_max_gb",
                       "gpu*_hbm_occupancy_mean", "gpu*_hbm_occupancy_max",
                       "gpu*_hbm_peak_gb"),
)
def gpumon_profile(frames, cfg, features: Features) -> None:
    """Live memory occupancy and liveness features from the in-process
    sampler: present even when the Kineto trace was off."""
    df = frames.get("gpumon")
    if df is None or df.empty:
        print_warning("gpumon_profile: gpumon is empty: no memory samples "
                      "(the program never initialized CUDA, or "
                      "--disable_gpu_mon)")
        return
    alive = df[df["name"] == "alive"]
    if not alive.empty:
        features.add("gpumon_samples", len(alive))
        span = float(alive["timestamp"].max() - alive["timestamp"].min())
        features.add("gpumon_span", span)
    used = df[df["name"] == "hbm_used_gb"]
    for device_id, rows in used.groupby("deviceId"):
        features.add(f"gpu{device_id}_hbm_used_mean_gb",
                     float(rows["event"].mean()))
        features.add(f"gpu{device_id}_hbm_used_max_gb",
                     float(rows["event"].max()))
    # the allocator's peak bytes ride the occupancy rows' payload
    occ = df[df["name"] == "hbm_occupancy"]
    for device_id, rows in occ.groupby("deviceId"):
        features.add(f"gpu{device_id}_hbm_occupancy_mean",
                     float(rows["event"].mean()))
        features.add(f"gpu{device_id}_hbm_occupancy_max",
                     float(rows["event"].max()))
        peak = float(rows["payload"].max())
        if peak > 0:
            features.add(f"gpu{device_id}_hbm_peak_gb", peak / 1e9)


@analysis_pass(
    name="memprof_profile", order=200,
    provides_features=("memprof_held_gb", "memprof_buffers",
                       "memprof_sites", "memprof_devices",
                       "memprof_trigger", "memprof_top_site"),
    provides_artifacts=("gpu_memprof.csv",),
)
def memprof_profile(frames, cfg, features: Features) -> None:
    """Which allocation sites held the occupancy peak: the snapshot
    collectors/gpumon.py took (ingest/memprof.py), as the top-site table
    gpu_memprof.csv and the totals as features."""
    from sofa_tpu_torch.ingest.memprof import aggregate_sites, load_memprof

    df, meta = load_memprof(cfg.logdir)
    if df is None or df.empty:
        return
    buffers = df[df["kind"] == "buffer"]
    features.add("memprof_held_gb", float(buffers["bytes"].sum()) / 1e9)
    features.add("memprof_buffers", float(buffers["count"].sum()))
    features.add("memprof_sites", float(buffers["site"].nunique()))
    n_dev = buffers.loc[buffers["device"] != "", "device"].nunique()
    if n_dev:
        features.add("memprof_devices", float(n_dev))
    sites = aggregate_sites(df)
    sites.to_csv(cfg.path("gpu_memprof.csv"), index=False)
    if meta.get("trigger"):
        features.add_info("memprof_trigger", meta["trigger"])
    if not sites.empty:
        top = sites.iloc[0]
        features.add_info(
            "memprof_top_site",
            f"{top['site']} ({top['bytes'] / 1e9:.2f} GB, "
            f"{top['share']:.0%})")
    if cfg.verbose:
        print_title("Top GPU memory allocation sites")
        print(sites.head(10).to_string(index=False))
