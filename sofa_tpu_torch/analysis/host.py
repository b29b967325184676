"""Host-side analysis passes: CPU samples, mpstat, vmstat, disk, block IO,
strace and Python stacks (the JAX package's analysis/host.py;
``mpstat_profile`` reports a frozen /proc/stat as not measured).
``cpu_profile`` clips the CPU samples to the region of interest, so it
runs ``after=("spotlight",)``, as the JAX registry declares it."""

from __future__ import annotations

import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass
from sofa_tpu_torch.printing import print_title, print_warning
from sofa_tpu_torch.trace import roi_clip


@analysis_pass(
    name="cpu_profile", order=20,
    reads_frames=("cputrace",),
    reads_columns=("duration", "deviceId", "name"),
    provides_features=("cpu_samples", "cpu_core*_exec_time"),
    provides_artifacts=("cpu_top.csv",),
    after=("spotlight",),
)
def cpu_profile(frames, cfg, features: Features) -> None:
    df = frames.get("cputrace")
    if df is None or df.empty:
        return
    roi = roi_clip(df, cfg)
    features.add("cpu_samples", len(roi))
    per_core = roi.groupby("deviceId")["duration"].sum()
    for core, total in per_core.items():
        features.add(f"cpu_core{core}_exec_time", total)
    top = (
        roi.groupby("name")["duration"]
        .agg(["sum", "count"])
        .sort_values("sum", ascending=False)
        .head(20)
    )
    if cfg.verbose and not top.empty:
        print_title("Top-20 hottest CPU symbols")
        print(top.to_string())
    top.to_csv(cfg.path("cpu_top.csv"))


@analysis_pass(
    name="mpstat_profile", order=30,
    reads_frames=("mpstat",),
    reads_columns=("duration", "deviceId", "name", "event", "payload"),
    provides_features=("num_cores", "mpstat_*_pct", "mpstat_*_time",
                       "cpu_util"),
)
def mpstat_profile(frames, cfg, features: Features) -> None:
    """Cores, and the mean share of each jiffy counter over the run with
    ``cpu_util`` (user + system).

    A deliberate difference from the JAX package: where the aggregate
    counters never advance over the whole run (a sandboxed /proc/stat
    that reads frozen; the parser then reports every interval 100 % idle),
    the host CPU was not measured, so the per-counter features and
    ``cpu_util`` are left out with a warning instead of reporting 0.0."""
    df = frames.get("mpstat")
    if df is None or df.empty:
        return
    cores = df[df["deviceId"] >= 0]
    num_cores = cores["deviceId"].nunique() if not cores.empty else 0
    features.add("num_cores", num_cores)
    agg = df[df["deviceId"] == -1]
    if agg.empty:
        return
    if not agg["payload"].any():
        print_warning("mpstat: /proc/stat did not advance during the run: "
                      "the host CPU was not measured (no cpu_util)")
        return
    # Mean percentage and absolute busy time per metric over the run.
    for metric in ("usr", "sys", "iow", "irq", "idl"):
        rows = agg[agg["name"] == metric]
        if rows.empty:
            continue
        pct = float(rows["event"].mean())
        seconds = float((rows["event"] / 100.0 * rows["duration"]).sum())
        features.add(f"mpstat_{metric}_pct", pct)
        features.add(f"mpstat_{metric}_time", seconds)
    usr = features.get("mpstat_usr_pct") or 0.0
    sys_ = features.get("mpstat_sys_pct") or 0.0
    features.add("cpu_util", (usr + sys_) / 100.0)


@analysis_pass(
    name="vmstat_profile", order=40,
    reads_frames=("vmstat",),
    reads_columns=("name", "event"),
    provides_features=("vmstat_mean_*",),
)
def vmstat_profile(frames, cfg, features: Features) -> None:
    df = frames.get("vmstat")
    if df is None or df.empty:
        return
    for metric in ("bi", "bo", "cs", "in"):
        rows = df[df["name"] == f"vmstat.{metric}"]
        if not rows.empty:
            features.add(f"vmstat_mean_{metric}", float(rows["event"].mean()))


@analysis_pass(
    name="diskstat_profile", order=50,
    reads_frames=("diskstat",),
    reads_columns=("timestamp", "deviceId", "name", "event", "payload"),
    provides_features=("disk_*_r_bw_mean", "disk_*_w_bw_mean",
                       "disk_total_bytes"),
    provides_artifacts=("disk_summary.csv",),
)
def diskstat_profile(frames, cfg, features: Features) -> None:
    df = frames.get("diskstat")
    if df is None or df.empty:
        return
    table = []
    for (name,), rows in df.groupby(["name"]):
        q = rows["event"].quantile([0.25, 0.5, 0.75])
        table.append({"metric": name, "mean": rows["event"].mean(),
                      "q25": q.loc[0.25], "median": q.loc[0.5],
                      "q75": q.loc[0.75], "max": rows["event"].max()})
        dev, _, metric = name.partition(".")
        if metric in ("r_bw", "w_bw"):
            features.add(f"disk_{dev}_{metric}_mean",
                         float(rows["event"].mean()))
    pd.DataFrame(table).to_csv(cfg.path("disk_summary.csv"), index=False)
    total_bytes = df.drop_duplicates(
        subset=["timestamp", "deviceId"])["payload"].sum()
    features.add("disk_total_bytes", float(total_bytes))


@analysis_pass(
    name="blktrace_latency_profile", order=60,
    reads_frames=("blktrace",),
    reads_columns=("timestamp", "duration", "name", "payload"),
    provides_features=("blktrace_*",),
)
def blktrace_latency_profile(frames, cfg, features: Features) -> None:
    """Per-IO dispatch-to-complete latency quartiles and totals."""
    df = frames.get("blktrace")
    if df is None or df.empty:
        return
    lat = df["duration"]
    q = lat.quantile([0.25, 0.5, 0.75])
    features.add("blktrace_ios", len(df))
    features.add("blktrace_latency_q1", float(q.loc[0.25]))
    features.add("blktrace_latency_median", float(q.loc[0.5]))
    features.add("blktrace_latency_q3", float(q.loc[0.75]))
    features.add("blktrace_latency_max", float(lat.max()))
    features.add("blktrace_total_bytes", float(df["payload"].sum()))
    reads = df[df["name"].str.startswith("blk_r")]
    writes = df[df["name"].str.startswith("blk_w")]
    features.add("blktrace_read_ios", len(reads))
    features.add("blktrace_write_ios", len(writes))
    span = float((df["timestamp"] + df["duration"]).max()
                 - df["timestamp"].min())
    if span > 0:
        features.add("blktrace_iops", len(df) / span)
        features.add("blktrace_bandwidth", float(df["payload"].sum()) / span)


@analysis_pass(
    name="strace_profile", order=70,
    reads_frames=("strace",),
    reads_columns=("duration", "name"),
    provides_features=("syscall_total_time", "syscall_count"),
    provides_artifacts=("strace_top.csv",),
)
def strace_profile(frames, cfg, features: Features) -> None:
    df = frames.get("strace")
    if df is None or df.empty:
        return
    df = df.assign(call=df["name"].str.partition("(")[0])
    top = (
        df.groupby("call")["duration"]
        .agg(["sum", "count"])
        .sort_values("sum", ascending=False)
    )
    features.add("syscall_total_time", float(df["duration"].sum()))
    features.add("syscall_count", len(df))
    top.head(20).to_csv(cfg.path("strace_top.csv"))


@analysis_pass(
    name="pystacks_profile", order=80,
    reads_frames=("pystacks",),
    reads_columns=("timestamp", "name"),
    provides_features=("py_samples",),
    provides_artifacts=("pystacks_top.csv",),
)
def pystacks_profile(frames, cfg, features: Features) -> None:
    df = frames.get("pystacks")
    if df is None or df.empty:
        return
    features.add("py_samples", len(df))
    top = df.groupby("name")["timestamp"].count().sort_values(ascending=False)
    top.head(20).to_csv(cfg.path("pystacks_top.csv"))
