"""preprocess: fold a recording's raw traces into the unified schema.

A table of ingest tasks in the JAX package's order: the host samplers
(mpstat, diskstat, netbandwidth, cpuinfo, vmstat), perf's CPU samples
(cputrace), syscalls (strace), Python stacks (pystacks), packets
(nettrace), the GPU memory sampler (gpumon), block IO (blktrace), then the
Kineto capture (gputrace, gpusteps, hosttrace, and the gpuutil series
derived from it).  Each source is optional:
a missing raw file yields an empty frame, and a parse failure costs that
source only, with a warning.  Every frame is written as ``<name>.csv``;
then the frames become the board's timeline series (``build_series``),
their deep-zoom tile pyramid (``tiles.py``) and ``report.js``, all under
the derived-write guard.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, NamedTuple, Tuple

import pandas as pd

from sofa_tpu_torch.analysis.sol import device_peaks
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import procfs, strace_parse
from sofa_tpu_torch.ingest.blktrace_parse import ingest_blktrace
from sofa_tpu_torch.ingest.gpumon_parse import ingest_gpumon
from sofa_tpu_torch.ingest.kineto import gpu_utilization, ingest_kineto_dir
from sofa_tpu_torch.ingest.pcap import ingest_pcap
from sofa_tpu_torch.ingest.perf_script import ingest_perf
from sofa_tpu_torch.ingest.timebase_align import converter
from sofa_tpu_torch.printing import print_info, print_progress, print_warning
from sofa_tpu_torch.trace import (SofaSeries, derived_write_guard,
                                  empty_frame, read_csv, reap_stale_sentinel,
                                  series_to_report_js, write_csv)

KINETO_FRAMES = ("gputrace", "gpusteps", "hosttrace", "gpuutil")
UTIL_WINDOW_S = 0.1         # gpuutil's window, as the JAX tpuutil's

# The timeline's series, in legend order: frame -> (title, colour).  The
# colours are the JAX package's, the device frames taking their TPU
# counterparts' (tputrace, tpuutil, tpumon, tpusteps).
_SERIES_STYLE = {
    "cputrace": ("CPU samples", "dodgerblue"),
    "hosttrace": ("Host runtime", "slategray"),
    "pystacks": ("Python stacks", "goldenrod"),
    "strace": ("Syscalls", "brown"),
    "mpstat": ("CPU util %", "steelblue"),
    "vmstat": ("vmstat", "darkkhaki"),
    "diskstat": ("Disk", "sienna"),
    "netbandwidth": ("NIC B/s", "seagreen"),
    "nettrace": ("Packets", "olive"),
    "gputrace": ("GPU kernels", "darkorchid"),
    "gpuutil": ("GPU util", "crimson"),
    "gpumon": ("GPU memory", "firebrick"),
    "gpusteps": ("GPU steps", "black"),
    "blktrace": ("Block IO latency (ms)", "peru"),
}
LINE_SERIES = ("mpstat", "vmstat", "diskstat", "netbandwidth", "gpuutil",
               "gpumon")


def read_time_base(cfg: SofaConfig) -> float:
    """The run's time zero (unix seconds) from ``sofa_time.txt``."""
    try:
        with open(cfg.path("sofa_time.txt")) as f:
            return float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        print_warning("sofa_time.txt missing; timestamps stay absolute")
        return 0.0


def read_misc(cfg: SofaConfig) -> Dict[str, str]:
    out: Dict[str, str] = {}
    try:
        with open(cfg.path("misc.txt")) as f:
            for line in f:
                p = line.split()
                if len(p) == 2:
                    out[p[0]] = p[1]
    except OSError:
        pass
    return out


def _ingest_cputrace(logdir: str, time_base: float) -> pd.DataFrame:
    """perf samples, with perf's monotonic clock bridged to unix time
    (timebase.txt) and cycles turned into seconds at the sampled MHz."""
    mono_to_unix = converter(os.path.join(logdir, "timebase.txt"),
                             "monotonic")
    cpuinfo = procfs.load(os.path.join(logdir, "cpuinfo.txt"),
                          procfs.parse_cpuinfo, time_base)
    return ingest_perf(logdir, time_base, mono_to_unix,
                       procfs.cpu_mhz_interpolator(cpuinfo))


def _ingest_kineto(cfg: SofaConfig, time_base: float):
    """The Kineto frames, and gpuutil derived from gputrace against the
    card's peaks (gpu_topo.json)."""
    frames = ingest_kineto_dir(cfg.kineto_dir, time_base)
    frames["gpuutil"] = gpu_utilization(frames["gputrace"], UTIL_WINDOW_S,
                                        device_peaks(cfg))
    return frames


class _Task(NamedTuple):
    frames: Tuple[str, ...]   # frames produced, in output order
    fn: Callable              # () -> frame, or {frame name: frame}


def _tasks(cfg: SofaConfig, time_base: float) -> List[_Task]:
    """THE task table; its order is the frames' order."""
    P = cfg.path

    def text_task(name, raw, parser, **kw):
        return _Task((name,), lambda: procfs.load(P(raw), parser, time_base,
                                                  **kw))

    return [
        text_task("mpstat", "mpstat.txt", procfs.parse_mpstat),
        text_task("diskstat", "diskstat.txt", procfs.parse_diskstat),
        text_task("netbandwidth", "netstat.txt", procfs.parse_netstat),
        text_task("cpuinfo", "cpuinfo.txt", procfs.parse_cpuinfo),
        text_task("vmstat", "vmstat.txt", procfs.parse_vmstat,
                  record_start=time_base),
        _Task(("cputrace",), lambda: _ingest_cputrace(cfg.logdir, time_base)),
        text_task("strace", "strace.txt", strace_parse.parse_strace,
                  min_time=cfg.strace_min_time),
        text_task("pystacks", "pystacks.txt", strace_parse.parse_pystacks),
        _Task(("nettrace",), lambda: ingest_pcap(P("sofa.pcap"), time_base)),
        _Task(("gpumon",), lambda: ingest_gpumon(cfg.logdir, time_base)),
        # blkparse times are already trace-relative
        _Task(("blktrace",), lambda: ingest_blktrace(cfg.logdir, 0.0)),
        _Task(KINETO_FRAMES, lambda: _ingest_kineto(cfg, time_base)),
    ]


def frame_names() -> List[str]:
    """Every frame preprocess writes, in order."""
    return [name for t in _tasks(SofaConfig(), 0.0) for name in t.frames]


def sofa_preprocess(cfg: SofaConfig) -> Dict[str, pd.DataFrame]:
    reap_stale_sentinel(cfg.logdir)
    time_base = read_time_base(cfg)
    frames: Dict[str, pd.DataFrame] = {}
    for task in _tasks(cfg, time_base):
        try:
            out = task.fn()
        except Exception as e:  # noqa: BLE001 - one source, not the run
            print_warning(f"preprocess: {'/'.join(task.frames)} failed "
                          f"({e!r}); its frames stay empty")
            out = {}
        if not isinstance(out, dict):
            out = {task.frames[0]: out}
        for name in task.frames:
            frames[name] = out.get(name, empty_frame())
    with derived_write_guard(cfg.logdir):
        for name, df in frames.items():
            write_csv(df, cfg.path(f"{name}.csv"))
            if not df.empty:
                print_info(f"{name}.csv: {len(df)} rows")
        write_board_data(cfg, frames, time_base)
    return frames


def _contains(col: pd.Series, keyword: str) -> pd.Series:
    """Case-insensitive substring match, over the column's unique values
    (kernel names repeat heavily)."""
    kw = keyword.lower()
    return col.isin([u for u in col.unique() if kw in str(u).lower()])


def build_series(cfg: SofaConfig,
                 frames: Dict[str, pd.DataFrame]) -> List[SofaSeries]:
    """The timeline: one series per non-empty frame of ``_SERIES_STYLE``,
    then the CPU filters over cputrace, the fw/bw phases of gputrace and
    the GPU filters over gputrace."""
    series: List[SofaSeries] = []
    for key, (title, color) in _SERIES_STYLE.items():
        df = frames.get(key)
        if df is None or df.empty:
            continue
        if key == "mpstat":
            # the aggregate non-idle share; per-core rows feed cpu-report
            df = df[(df["deviceId"] == -1) & df["name"].isin(["usr", "sys"])]
        series.append(SofaSeries(
            key, title, color, df,
            kind="line" if key in LINE_SERIES else "scatter"))
    cputrace = frames.get("cputrace", empty_frame())
    for filt in cfg.cpu_filters:
        if cputrace.empty:
            break
        sel = cputrace[_contains(cputrace["name"], filt.keyword)]
        if not sel.empty:
            series.append(SofaSeries(f"cpu_{filt.keyword}",
                                     f"CPU: {filt.keyword}", filt.color, sel))
    gputrace = frames.get("gputrace", empty_frame())
    if not gputrace.empty:
        for phase, title, color in (("fw", "GPU forward", "mediumseagreen"),
                                    ("bw", "GPU backward", "crimson")):
            sel = gputrace[gputrace["phase"] == phase]
            if not sel.empty:
                series.append(SofaSeries(f"gpu_phase_{phase}", title, color,
                                         sel))
    for filt in cfg.gpu_filters:
        if gputrace.empty:
            break
        sel = gputrace[_contains(gputrace["name"], filt.keyword)
                       | _contains(gputrace["hlo_category"], filt.keyword)]
        if not sel.empty:
            series.append(SofaSeries(f"gpu_{filt.keyword}",
                                     f"GPU: {filt.keyword}", filt.color, sel))
    return series


def _gpu_meta(cfg: SofaConfig):
    """The card's meta (gpu_topo.json), or None without one."""
    try:
        with open(cfg.path("gpu_topo.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_board_data(cfg: SofaConfig, frames: Dict[str, pd.DataFrame],
                     time_base: float) -> None:
    """The series, their tile pyramid (a failure costs the deep zoom only)
    and report.js; prints each stage's time."""
    t0 = time.perf_counter()
    series = build_series(cfg, frames)
    t1 = time.perf_counter()
    manifest = None
    if cfg.enable_tiles:
        from sofa_tpu_torch import tiles

        try:
            manifest = tiles.build_tiles(cfg, series)
        except Exception as e:  # noqa: BLE001 - the overview still works
            print_warning(f"preprocess: tile pyramid failed ({e!r}); the "
                          "board serves the overview only")
    t2 = time.perf_counter()
    meta = {"elapsed_time": float(read_misc(cfg).get("elapsed_time", 0) or 0),
            "time_base": time_base, "gpu_meta": _gpu_meta(cfg),
            "logdir": cfg.logdir}
    if manifest is not None:
        meta["tiles"] = manifest
    path = cfg.path("report.js")
    series_to_report_js(series, path, cfg.viz_downsample_to, meta)
    t3 = time.perf_counter()
    print_progress(
        f"board data: {len(series)} series in {t1 - t0:.3f} s, tiles in "
        f"{t2 - t1:.3f} s, report.js ({os.path.getsize(path)} bytes) in "
        f"{t3 - t2:.3f} s")


def load_frames(cfg: SofaConfig) -> Dict[str, pd.DataFrame]:
    """The frames a previous preprocess wrote (missing ones are skipped)."""
    return {name: read_csv(cfg.path(f"{name}.csv")) for name in frame_names()
            if os.path.isfile(cfg.path(f"{name}.csv"))}
