"""Run configuration for the PyTorch profiler path (a trimmed SofaConfig).

The collector fields and their defaults are the JAX package's
(``SofaConfig``'s "record: host" block), except that its TPU sampler
(``tpu_mon_rate`` / ``enable_tpu_mon``) is the GPU memory sampler here
(``gpu_mon_rate`` / ``enable_gpu_mon``), and its TPU timeline filters
are the GPU ones below.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class Filter:
    """A keyword that pulls the matching rows of a frame (a substring of
    ``name`` or of ``hlo_category``, case-insensitive) into a coloured
    series of their own on the timeline."""

    keyword: str
    color: str


# The JAX package highlights idle CPU and, on the device, infeed/outfeed,
# copies, fusions and the collectives.  On the GPU: the three copy kinds
# (Kineto's "Memcpy HtoD/DtoH/DtoD" rows), the hand-written flash kernels in
# the place of XLA's fusions, and NCCL's collective kernels
# ("ncclDevKernel_AllReduce_...", ..., "SendRecv" for point-to-point).
DEFAULT_CPU_FILTERS = [Filter("idle", "black")]
DEFAULT_GPU_FILTERS = [
    Filter("HtoD", "red"),
    Filter("DtoH", "greenyellow"),
    Filter("DtoD", "royalblue"),
    Filter("sofa_flash", "darkviolet"),
    Filter("AllReduce", "indigo"),
    Filter("AllGather", "tomato"),
    Filter("ReduceScatter", "orange"),
    Filter("SendRecv", "deeppink"),
]


@dataclasses.dataclass
class SofaConfig:
    logdir: str = "sofalog/"
    verbose: bool = False
    # Worker count of the report path's pools (ingest, frame writes); 0 =
    # auto (SOFA_JOBS, else the usable CPUs, at most 32: pool.py).
    jobs: int = 0
    # The content-keyed ingest cache (ingest/cache.py); --no_ingest_cache
    # bypasses it.
    ingest_cache: bool = True

    # --- record: host collectors ------------------------------------------
    perf_events: str = ""            # extra `perf record -e` events
    no_perf_events: bool = False     # skip perf entirely (fallback to time -v)
    cpu_sample_rate: int = 99        # perf -F
    # "off" (default: DWARF unwinding at 99 Hz copies ~16 KB of stack per
    # sample), "fp" (frame pointers) or "dwarf".
    perf_call_graph: str = "off"
    sys_mon_rate: int = 10           # /proc sampler Hz
    enable_strace: bool = False
    strace_min_time: float = 1e-6    # drop syscalls shorter than this (s)
    enable_py_stacks: bool = False   # in-process Python stack sampler
    py_stack_rate: int = 67          # Hz for the Python stack sampler
    enable_tcpdump: bool = False
    netstat_interface: Optional[str] = None
    blkdev: Optional[str] = None     # block device for blktrace (opt-in)
    enable_vmstat: bool = True
    pid: Optional[int] = None        # attach to a running process (--pid)
    # --cluster_hosts: record and report over several hosts at once, each
    # into <logdir>-<host>/ (record.cluster_record, analyze.cluster_analyze)
    cluster_hosts: List[str] = dataclasses.field(default_factory=list)

    # --- record: GPU collectors (injected into the profiled program) ------
    # Trace the profiled program with torch.profiler (Kineto: CPU ops and,
    # when the program sees a card, CUDA kernels/copies via CUPTI).
    enable_kineto: bool = True
    enable_gpu_mon: bool = True      # allocator memory sampler (in-process)
    gpu_mon_rate: int = 1            # its rate, Hz
    enable_mem_prof: bool = True     # allocation-site snapshot (pprof) at
                                     # the observed occupancy peak
    # Seconds past the child's at-exit breadcrumb (_inject/atexit_stop.json)
    # before record presumes it wedged and kills its process group; None
    # derives the allowance from the breadcrumb's own timeouts.
    epilogue_deadline_s: Optional[float] = None

    # --- record: fault tolerance (the JAX package's config.py:76-137) ------
    inject_faults: str = ""          # fault spec (faults.py; SOFA_FAULTS)
    collector_restarts: int = 1      # restarts of a collector that dies
                                     # mid-run (0 = never restart)
    collector_stop_timeout_s: float = 15.0      # 0 = unbounded
    collector_harvest_timeout_s: float = 120.0  # 0 = unbounded
    disk_budget_mb: float = 0.0      # --disk_budget: MB over all watched
                                     # collectors (0 = off)
    collector_disk_budget_mb: float = 0.0       # per collector (0 = off)

    # --- analyze: region of interest ---------------------------------------
    profile_region: str = ""         # "begin:end" manual ROI (seconds)
    spotlight: bool = False          # auto-ROI from the kernel utilization
    # set by the spotlight pass (or --profile_region); 0/0 = the whole run
    roi_begin: float = 0.0
    roi_end: float = 0.0

    # --- the board ----------------------------------------------------------
    viz_downsample_to: int = 10000   # points per series in report.js
    enable_tiles: bool = True        # the deep-zoom tile pyramid (--no_tiles)
    viz_port: int = 8000             # first port viz tries (up to +19)
    # loopback unless the user opts open: the board serves command lines
    # and host names; --viz_bind 0.0.0.0 opens it
    viz_bind: str = "127.0.0.1"
    cpu_filters: List[Filter] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_CPU_FILTERS))
    gpu_filters: List[Filter] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_GPU_FILTERS))

    def __post_init__(self) -> None:
        if not self.logdir.endswith("/"):
            self.logdir += "/"

    def path(self, *parts: str) -> str:
        return os.path.join(self.logdir, *parts)

    @property
    def kineto_dir(self) -> str:
        return self.path("kineto")

    @property
    def inject_dir(self) -> str:
        return self.path("_inject")
