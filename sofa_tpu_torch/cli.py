"""Command line: ``python -m sofa_tpu_torch <verb>``.

  record      run "cmd" under the collectors, raw traces into --logdir
  preprocess  fold the raw traces into the unified frames (<source>.csv),
              the timeline's report.js and its tile pyramid (_tiles/)
  analyze     run the passes, write features.csv and hints.txt, stage the
              board's pages, print Complete!!
  stat        record + preprocess + analyze; exits with the command's rc
  report      [preprocess] + analyze [+ viz with --with-gui]
  viz         serve the board over --logdir (http://localhost:8000/)
  status      render --logdir's run_manifest.json (the pipeline's own
              health: collectors, sources, stages, analysis passes);
              exits 1 when a collector failed, died, timed out or hit the
              disk budget, or a pass failed, 2 without a manifest
  passes      print the analysis passes' schedule (waves), contracts and
              the last run's statuses and times; exits 2 when the
              declared graph cannot be scheduled
  clean       remove the derived files, keep the raw ones

report, analyze, viz, status, passes and clean run on the host only: they
never touch a GPU.

--config FILE loads a TOML file of SofaConfig fields; flags given on the
command line override it.  --plugin mod[:func] (repeatable) imports mod
and calls func(cfg) before the verb runs; a plugin may register analysis
passes.

With --cluster_hosts h1,h2,... record runs on every host at once, each
into <logdir>-<host>/ (localhost and 127.0.0.1 here, any other host over
ssh), and report preprocesses each host's logdir, analyzes each, and
writes one clock-aligned report.js and cluster_summary.csv into
--logdir.  stat and analyze stay single-host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from sofa_tpu_torch import __version__
from sofa_tpu_torch.config import Filter, SofaConfig

VERBS = ("record", "preprocess", "analyze", "stat", "report", "viz",
         "status", "passes", "clean")

# Flags that map 1:1 onto SofaConfig fields.
_FIELDS = (
    "logdir", "verbose", "perf_events", "no_perf_events", "cpu_sample_rate",
    "perf_call_graph", "sys_mon_rate", "enable_strace", "strace_min_time",
    "enable_py_stacks", "enable_tcpdump", "netstat_interface", "blkdev",
    "gpu_mon_rate", "profile_region", "spotlight", "viz_port", "viz_bind",
    "jobs", "pid", "epilogue_deadline_s", "inject_faults",
    "collector_restarts", "collector_stop_timeout_s",
    "collector_harvest_timeout_s", "disk_budget_mb",
    "collector_disk_budget_mb", "kineto_host_tracer_level",
    "kineto_python_tracer", "kineto_delay_s", "kineto_duration_s",
    "cpu_time_offset_ms", "gpu_time_offset_ms", "viz_downsample_to",
    "tile_levels", "is_idle_threshold", "hint_server", "plugins",
)
# --disable_<flag> clears SofaConfig.<field>.
_DISABLES = {"disable_kineto": "enable_kineto",
             "disable_gpu_mon": "enable_gpu_mon",
             "disable_memprof": "enable_mem_prof",
             "no_tiles": "enable_tiles",
             "no_ingest_cache": "ingest_cache"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sofa_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter,
                                argument_default=argparse.SUPPRESS)
    p.add_argument("--version", action="version",
                   version=f"sofa_tpu_torch {__version__}")
    p.add_argument("verb", choices=VERBS)
    p.add_argument("command", nargs="?", default=None,
                   help="shell command to profile (record, stat); the "
                   "logdir for status and passes")
    p.add_argument("--logdir")
    p.add_argument("--config",
                   help="TOML file of config fields; flags override it")
    p.add_argument("--plugin", action="append", dest="plugins",
                   help="module[:func] called with the config at start "
                   "(repeatable)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--jobs", type=int,
                   help="worker count of the preprocess pools; 0 = auto "
                   "(SOFA_JOBS, else the CPU count)")
    p.add_argument("--no_ingest_cache", action="store_true",
                   help="bypass the content-keyed ingest cache (always "
                   "reparse the raw files)")

    g = p.add_argument_group("record: host")
    g.add_argument("--perf_events")
    g.add_argument("--no-perf-events", dest="no_perf_events",
                   action="store_true")
    g.add_argument("--cpu_sample_rate", type=int)
    g.add_argument("--perf_call_graph", choices=["off", "fp", "dwarf"])
    g.add_argument("--sys_mon_rate", type=int)
    g.add_argument("--enable_strace", action="store_true")
    g.add_argument("--strace_min_time", type=float)
    g.add_argument("--enable_py_stacks", action="store_true")
    g.add_argument("--enable_tcpdump", action="store_true")
    g.add_argument("--netstat_interface")
    g.add_argument("--blkdev")
    g.add_argument("--pid", type=int,
                   help="attach to a running pid instead of launching; "
                   "record returns when it exits")

    g = p.add_argument_group("record: gpu")
    g.add_argument("--disable_kineto", action="store_true",
                   help="run the command without the torch.profiler trace")
    g.add_argument("--gpu_mon_rate", type=int,
                   help="allocator memory sampler rate, Hz (default 1)")
    g.add_argument("--disable_gpu_mon", action="store_true")
    g.add_argument("--disable_memprof", action="store_true",
                   help="skip the peak-memory allocation-site snapshot")
    g.add_argument("--kineto_host_tracer_level", type=int,
                   choices=(0, 1, 2, 3),
                   help="trace detail: 0 device activity, its launches and "
                   "record_function ranges; 1 + aten ops; 2 + shapes and "
                   "flops (default); 3 + Python stacks")
    g.add_argument("--kineto_python_tracer", action="store_true",
                   help="record Python stacks with the ops (with_stack)")
    g.add_argument("--kineto_delay_s", type=float,
                   help="start the trace this long after torch is imported")
    g.add_argument("--kineto_duration_s", type=float,
                   help="stop the trace this long after it starts (0 = at "
                   "exit)")
    g.add_argument("--epilogue_deadline_s", type=float,
                   help="seconds past the child's at-exit breadcrumb before "
                   "record presumes it wedged and kills its process group "
                   "(default: from the breadcrumb's own timeouts)")

    g = p.add_argument_group("record: fault tolerance")
    g.add_argument("--inject_faults",
                   help="fault spec, e.g. 'procmon:die@2s,kineto:wedge@"
                   "harvest,kineto:corrupt' (SOFA_FAULTS alike; kinds die, "
                   "wedge, fail, truncate, corrupt)")
    g.add_argument("--collector_restarts", type=int,
                   help="restarts of a collector that dies mid-run (default "
                   "1; 0 disables)")
    g.add_argument("--collector_stop_timeout_s", type=float,
                   help="per-collector stop deadline, s (default 15; 0 = "
                   "unbounded)")
    g.add_argument("--collector_harvest_timeout_s", type=float,
                   help="per-collector harvest deadline, s (default 120; "
                   "0 = unbounded)")
    g.add_argument("--disk_budget", type=float, dest="disk_budget_mb",
                   help="raw-output budget in MB over all collectors: the "
                   "oldest files rotate, the worst offender stops (0 = off)")
    g.add_argument("--collector_disk_budget", type=float,
                   dest="collector_disk_budget_mb",
                   help="raw-output budget in MB per collector (0 = off)")

    g = p.add_argument_group("cluster")
    g.add_argument("--cluster_hosts",
                   help="comma-joined host list: record and report over "
                   "every host, each into <logdir>-<host>/")

    g = p.add_argument_group("preprocess")
    g.add_argument("--cpu_time_offset_ms", type=int,
                   help="shift the host frames by this many ms")
    g.add_argument("--gpu_time_offset_ms", type=float,
                   help="shift the Kineto frames by this many ms when the "
                   "marker alignment is wrong")
    g.add_argument("--cpu_filters",
                   help="comma-joined keyword:color timeline filters")
    g.add_argument("--gpu_filters",
                   help="comma-joined keyword:color timeline filters")

    g = p.add_argument_group("analyze")
    g.add_argument("--profile_region", help='manual ROI "begin:end" seconds')
    g.add_argument("--spotlight", action="store_true",
                   help="auto-ROI from the kernel utilization")
    g.add_argument("--is_idle_threshold", type=float,
                   help="concurrency breakdown: a window below this share "
                   "(of 1) is idle (default 0.01)")
    g.add_argument("--hint_server",
                   help="gRPC advice service host[:port] (also "
                   "SOFA_HINT_SERVER)")

    g = p.add_argument_group("board")
    g.add_argument("--no_tiles", action="store_true",
                   help="skip the deep-zoom tile pyramid")
    g.add_argument("--viz_downsample_to", type=int,
                   help="points per series in report.js (default 10000)")
    g.add_argument("--tile_levels", type=int,
                   help="cap the tile pyramid's depth (0 = auto)")
    g.add_argument("--skip_preprocess", action="store_true",
                   help="report: analyze the CSVs an earlier preprocess "
                   "wrote")
    g.add_argument("--with-gui", dest="with_gui", action="store_true",
                   help="report: serve the board afterwards")
    g.add_argument("--viz_port", type=int,
                   help="first port viz tries (default 8000; up to +19)")
    g.add_argument("--viz_bind",
                   help="bind address (default 127.0.0.1; 0.0.0.0 opens "
                   "the board to the network)")
    return p


def config_from_args(args: argparse.Namespace) -> SofaConfig:
    """The config of a command line: the --config file's, or the
    defaults, with every flag given set over it."""
    passed = vars(args)
    cfg = (SofaConfig.from_toml(passed["config"]) if passed.get("config")
           else SofaConfig())
    for name in _FIELDS:
        if name in passed:
            setattr(cfg, name, passed[name])
    for flag, field in _DISABLES.items():
        if passed.get(flag):
            setattr(cfg, field, False)
    for name in ("cluster_hosts", "cpu_filters", "gpu_filters"):
        if name in passed:
            specs = [s for s in passed[name].split(",") if s]
            setattr(cfg, name, specs if name == "cluster_hosts"
                    else [Filter.parse(s) for s in specs])
    cfg.__post_init__()
    return cfg


def main(argv: Optional[list] = None) -> int:
    from sofa_tpu_torch.printing import SofaUserError, print_error

    p = build_parser()
    args = p.parse_intermixed_args(argv)
    if args.verb in ("record", "stat") and not args.command \
            and "pid" not in vars(args):
        p.error(f"{args.verb} needs a command (or --pid)")
    if args.verb in ("status", "passes") and args.command \
            and "logdir" not in vars(args):
        args.logdir = args.command      # `status <logdir>` reads naturally
    try:
        cfg = config_from_args(args)
    except (ValueError, OSError) as e:
        print_error(f"bad configuration: {e}")
        return 2
    from sofa_tpu_torch.plugins import load_plugins

    load_plugins(cfg)
    try:
        return _run(args, cfg)
    except SofaUserError as e:
        print_error(str(e))
        return 1


def _run(args: argparse.Namespace, cfg: SofaConfig) -> int:
    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.record import cluster_record, sofa_clean, sofa_record
    from sofa_tpu_torch.telemetry import sofa_status
    from sofa_tpu_torch.viz import sofa_viz

    verb = args.verb
    if verb == "status":
        return sofa_status(cfg)
    if verb == "passes":
        from sofa_tpu_torch.analysis.registry import sofa_passes

        return sofa_passes(cfg)
    if verb == "clean":
        sofa_clean(cfg)
        return 0
    if verb == "viz":
        return 0 if sofa_viz(cfg) is not None else 1
    if cfg.cluster_hosts and verb == "record":
        return cluster_record(args.command, cfg)
    if cfg.cluster_hosts and verb == "report":
        _cluster_report(args, cfg)
        return 0
    rc = 0
    if verb in ("record", "stat"):
        rc = sofa_record(args.command, cfg)
    # preprocess hands its frames to analyze in memory
    frames = None
    if verb in ("preprocess", "stat") or (
            verb == "report" and not getattr(args, "skip_preprocess", False)):
        frames = sofa_preprocess(cfg)
    if verb in ("analyze", "stat", "report"):
        sofa_analyze(cfg, frames)
    frames = None
    if verb == "report" and getattr(args, "with_gui", False):
        sofa_viz(cfg)
    return rc


def _cluster_report(args: argparse.Namespace, cfg: SofaConfig) -> None:
    """Preprocess each host's logdir (unless --skip_preprocess) and hand
    its frames to ``cluster_analyze`` (the JAX package's
    ``cli.py:534-544``); then serve the merged board with --with-gui."""
    from sofa_tpu_torch.analyze import cluster_analyze, cluster_host_cfgs
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.viz import sofa_viz

    preloaded = {}
    if not getattr(args, "skip_preprocess", False):
        for _i, host, host_cfg in cluster_host_cfgs(cfg):
            if os.path.isdir(host_cfg.logdir):
                preloaded[host] = sofa_preprocess(host_cfg)
    cluster_analyze(cfg, preloaded=preloaded or None)
    preloaded = None
    if getattr(args, "with_gui", False):
        sofa_viz(cfg)


if __name__ == "__main__":
    sys.exit(main())
