"""preprocess: fold a recording's raw traces into the unified schema.

A table of ingest tasks in the JAX package's order: the host samplers
(mpstat, diskstat, netbandwidth, cpuinfo, vmstat), perf's CPU samples
(cputrace), syscalls (strace), Python stacks (pystacks), packets
(nettrace), the GPU memory sampler (gpumon), block IO (blktrace), then the
Kineto capture (gputrace, gpusteps, hosttrace, and the gpuutil series
derived from it).  Each source is optional:
a missing raw file yields an empty frame, and a parse failure costs that
source only, with a warning.  Every frame is written as ``<name>.csv``.
"""

from __future__ import annotations

import os
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
from sofa_tpu_torch.printing import print_info, print_warning
from sofa_tpu_torch.trace import empty_frame, read_csv, write_csv

KINETO_FRAMES = ("gputrace", "gpusteps", "hosttrace", "gpuutil")
UTIL_WINDOW_S = 0.1         # gpuutil's window, as the JAX tpuutil's


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
    for name, df in frames.items():
        write_csv(df, cfg.path(f"{name}.csv"))
        if not df.empty:
            print_info(f"{name}.csv: {len(df)} rows")
    return frames


def load_frames(cfg: SofaConfig) -> Dict[str, pd.DataFrame]:
    """The frames a previous preprocess wrote (missing ones are skipped)."""
    return {name: read_csv(cfg.path(f"{name}.csv")) for name in frame_names()
            if os.path.isfile(cfg.path(f"{name}.csv"))}
