"""Run configuration for the PyTorch profiler path (a trimmed SofaConfig).

The collector fields and their defaults are the JAX package's
(``SofaConfig``'s "record: host" block), except that its TPU sampler
(``tpu_mon_rate`` / ``enable_tpu_mon``) is the GPU memory sampler here
(``gpu_mon_rate`` / ``enable_gpu_mon``), its trace knobs ``xprof_*`` are
``kineto_*``, its device clock fix ``tpu_time_offset_ms`` is
``gpu_time_offset_ms``, and its TPU timeline filters are the GPU ones
below.  ``SofaConfig.from_toml`` / ``from_dict`` load a config file as the
JAX package's do (``sofa_tpu/config.py:292-336``), keyed by these names.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import List, Optional


@dataclasses.dataclass
class Filter:
    """A keyword that pulls the matching rows of a frame (a substring of
    ``name`` or of ``hlo_category``, case-insensitive) into a coloured
    series of their own on the timeline."""

    keyword: str
    color: str

    @classmethod
    def parse(cls, spec: str) -> "Filter":
        """``keyword:color``; a bare keyword is orange (the JAX package's
        ``Filter.parse``)."""
        if ":" in spec:
            kw, _, color = spec.partition(":")
        else:
            kw, color = spec, "orange"
        return cls(keyword=kw, color=color)


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


#: What ``--iterations_from`` may name.  The JAX package's ``module``
#: (XLA module launches) has no counterpart in a CUDA trace.
ITERATION_SOURCES = ("auto", "steps", "marker", "op")
MODULE_REFUSAL = (
    "--iterations_from module mines XLA module launches, which a CUDA "
    "trace does not have; use steps (the sofa_step_N ranges on the "
    "device), marker (the same ranges on the host) or op (kernel names)")


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
    # How much the trace records (collectors/kineto.py, ``start_trace``):
    # 0 the device activity, its launches and the record_function ranges;
    # 1 the aten ops too, without shapes; 2 with shapes and flops; 3 with
    # Python stacks as well.  kineto_python_tracer adds the stacks at any
    # level.  The window: start kineto_delay_s after torch is imported,
    # stop kineto_duration_s after the start (0 = until exit).
    kineto_host_tracer_level: int = 2
    kineto_python_tracer: bool = False
    kineto_delay_s: float = 0.0
    kineto_duration_s: float = 0.0
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

    # --- preprocess: manual clock fixes, applied after the ingest cache ----
    cpu_time_offset_ms: int = 0      # shifts the host frames
    gpu_time_offset_ms: float = 0.0  # shifts the Kineto frames
    # csv | parquet | columnar; "" = SOFA_TRACE_FORMAT, else columnar (the
    # chunk store, frames.py): trace.resolve_trace_format decides
    trace_format: str = ""

    # --- analyze -------------------------------------------------------------
    profile_region: str = ""         # "begin:end" manual ROI (seconds)
    spotlight: bool = False          # auto-ROI from the kernel utilization
    # concurrency_breakdown: a window whose dominant activity is below this
    # share (of 1) is idle
    is_idle_threshold: float = 0.01
    hint_server: Optional[str] = None  # gRPC advice service host:port
    # set by the spotlight pass (or --profile_region); 0/0 = the whole run
    roi_begin: float = 0.0
    roi_end: float = 0.0
    # The mining passes (ml/, analysis/mlpass.py): AISI's expected
    # iteration count and boundary source (ITERATION_SOURCES: auto = the
    # device step spans, else the sofa_step markers, else kernel-name
    # mining), HSG's swarm count.
    num_iterations: int = 20
    num_swarms: int = 10
    enable_aisi: bool = False
    enable_hsg: bool = False
    enable_swarms: bool = False
    iterations_from: str = "auto"

    # --- diff and whatif ------------------------------------------------------
    base_logdir: Optional[str] = None
    match_logdir: Optional[str] = None
    whatif_apply: str = ""           # --apply: comma-joined scenario specs

    # --- live (live.py) -------------------------------------------------------
    live_interval_s: float = 2.0     # seconds between epochs
    live_epochs: int = 0             # run exactly N epochs (0 = until
                                     # interrupted)
    live_stall_s: float = 30.0       # a source quiet this long while
                                     # another streams is `stalled` (0 =
                                     # never)

    # --- archive and regress (archive/) --------------------------------------
    archive_root: str = ""           # --archive_root; "" = SOFA_ARCHIVE_ROOT,
                                     # else ./sofa_archive
    archive_label: str = ""          # --label: the tag of an ingest, and
                                     # the `archive ls --label` filter
    archive_keep: int = 0            # `archive gc --keep N` newest runs
    archive_keep_days: float = 0.0   # `archive gc --keep_days D`
    archive_limit: int = 0           # `archive ls --limit N` newest runs
                                     # (0 = all)
    archive_since: str = ""          # `archive ls --since <unix|7d|12h|30m>`
    archive_host: str = ""           # `archive ls --host <hostname>`
    regress_rolling: int = 0         # `regress --rolling N`: the baseline
                                     # is the newest N archived runs
    regress_pct: float = 50.0        # the rolling baseline's percentile
    regress_threshold: float = 10.0  # the relative % move a verdict needs

    # --- the fleet: serve and agent (archive/service.py, agent.py) -----------
    serve_bind: str = "127.0.0.1"    # loopback unless opted open
    serve_port: int = 8044           # 0 = OS-assigned
    serve_token: str = ""            # --token; SOFA_SERVE_TOKEN alike
    serve_quota_mb: float = 0.0      # per-tenant object-store quota (0 = off)
    serve_max_inflight: int = 8      # concurrent writes before a 503 +
                                     # Retry-After
    serve_workers: int = 1           # --workers: pool processes on one
                                     # port, tenants sharded on the ring
    serve_replica_of: str = ""       # --replica-of: a read-only query
                                     # replica of this primary URL
    serve_slo: str = ""              # --slo: SLO targets judged per scrape
                                     # window (metrics.parse_slo)
    serve_rolling_restart: bool = False  # --rolling-restart: SIGHUP the
                                     # root's pool supervisor, then exit
    status_fleet: str = ""           # status --fleet: the tier topology of
                                     # this service URL (comma: failover)
    fleet_tenant: str = "default"    # the tenant an agent pushes into
    agent_service: str = ""          # service URL(s) (SOFA_AGENT_SERVICE);
                                     # empty = spool-only mode
    agent_spool: str = ""            # the spool root (SOFA_AGENT_SPOOL, else
                                     # ./sofa_spool)
    agent_poll_s: float = 5.0        # the daemon's scan period
    agent_settle_s: float = 0.5      # a logdir quiet this long is finished
    agent_timeout_s: float = 10.0    # per-request transport deadline
    agent_retries: int = 4           # per-operation retry budget
    agent_backoff_s: float = 0.5     # retry backoff base (jittered)
    agent_backoff_cap_s: float = 30.0  # retry backoff cap

    # --- the board ----------------------------------------------------------
    viz_downsample_to: int = 10000   # points per series in report.js
    enable_tiles: bool = True        # the deep-zoom tile pyramid (--no_tiles)
    tile_levels: int = 0             # cap on the pyramid's depth (0 = auto:
                                     # until every leaf tile is exact)
    viz_port: int = 8000             # first port viz tries (up to +19)
    # loopback unless the user opts open: the board serves command lines
    # and host names; --viz_bind 0.0.0.0 opens it
    viz_bind: str = "127.0.0.1"
    cpu_filters: List[Filter] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_CPU_FILTERS))
    gpu_filters: List[Filter] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_GPU_FILTERS))

    # --- plugins: module[:func] called with the config at CLI start ---------
    plugins: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.logdir.endswith("/"):
            self.logdir += "/"
        if self.iterations_from not in ITERATION_SOURCES:
            raise ValueError(MODULE_REFUSAL if self.iterations_from
                             == "module" else
                             f"iterations_from {self.iterations_from!r} is "
                             f"not one of {ITERATION_SOURCES}")

    def path(self, *parts: str) -> str:
        return os.path.join(self.logdir, *parts)

    @property
    def kineto_dir(self) -> str:
        return self.path("kineto")

    @property
    def inject_dir(self) -> str:
        return self.path("_inject")

    @classmethod
    def from_toml(cls, path: str) -> "SofaConfig":
        """Load a config file; unknown keys are rejected loudly."""
        with open(path, "rb") as f:
            data = tomllib.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "SofaConfig":
        """A config from a mapping of field names, with the JAX package's
        checks and messages: unknown keys and values of another type than
        the field's default are a ValueError (an int is fine for a float;
        Optional and list fields take what TOML produced), and the filters
        are ``keyword:color`` strings or ``{keyword, color}`` tables."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        kwargs = dict(data)
        for key in ("cpu_filters", "gpu_filters"):
            if key in kwargs:
                kwargs[key] = [
                    Filter.parse(v) if isinstance(v, str) else Filter(**v)
                    for v in kwargs[key]
                ]
        defaults = cls()
        for key, value in kwargs.items():
            if key in ("cpu_filters", "gpu_filters"):
                continue
            default = getattr(defaults, key)
            if default is None or isinstance(default, (list, dict)):
                continue
            want = type(default)
            if want is float and isinstance(value, int) \
                    and not isinstance(value, bool):
                continue
            if not isinstance(value, want) or (
                    want is not bool and isinstance(value, bool)):
                raise ValueError(
                    f"config key {key!r}: expected {want.__name__}, "
                    f"got {type(value).__name__} ({value!r})")
        return cls(**kwargs)
