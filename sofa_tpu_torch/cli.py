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
  resume      replay what the run journal (_journal.jsonl) says did not
              commit: a preprocess or analyze killed mid-run, or a
              preprocess whose raw files changed since
  fsck        check --logdir against its digests (_digests.json): prints
              each missing, corrupt, stale or orphaned file; exits 0
              healthy, 1 on damage, 2 without digests; --repair
              invalidates the damaged cache, tile and chunk entries,
              removes the orphans and re-derives
  diff        --base_logdir A --match_logdir B: preprocess and cluster
              both runs, write gpu_diff.csv (device time per kernel),
              mem_diff.csv (bytes per allocation site) and swarm_diff.csv
              into --logdir with the board's diff-report.html; exits 1
              when none of the three could be written
  whatif      replay --logdir's step timeline under --apply scenarios
              (overlap:<class>, scale:<class>=<factor>|sol, link:<f>,
              batch:<f>) and predict the step time with error bars from
              the run's own spread: whatif_report.json, meta.whatif and
              the board's whatif.html; exits 0 calibrated, 1
              uncalibrated (the zero-scenario identity gate failed, or
              fewer than 6 steps), 2 without a logdir
  export      sofa_report.pdf and overview.png; with --perfetto
              trace.json.gz (ui.perfetto.dev), with --folded the
              *.folded collapsed stacks (speedscope, flamegraph.pl); with
              --cluster_hosts every host's frames on one clock
  top         a live dashboard over a recording's samplers (each
              process's cards and memory, the host's CPU, network and
              disk), redrawn every --interval s; --once draws one frame
  archive     <logdir>: store the run in the archive (--archive_root, else
              SOFA_ARCHIVE_ROOT, else ./sofa_archive): each artifact once
              under objects/<sha256>, a run doc, a catalog line, the
              columnar index (--label tags it); a second ingest of the
              same run adds no object.  ls [--limit N --since S --host H
              --label L] | show <run-id-prefix> | gc --keep N
              --keep_days D | fsck [--repair] | backup <root> <dest> |
              restore <backup> <target>
  regress     <run> [<baseline>]: typed verdicts (regressed, improved,
              noise) a feature and a swarm cluster, of a logdir or an
              archived run id against another, or with --rolling N
              against the newest N archived runs (--pct P, default the
              median; --regress_threshold %, default 10):
              regress_verdict.json; exits 0 noise or improved, 1
              regressed, 2 on a usage error
  live        streaming ingest over a logdir the collectors still write:
              every --live_interval_s seconds (default 2) an epoch tails
              the raw files from the byte offsets of _live_offsets.json,
              backs a torn last record off to the next epoch, parses each
              new chunk once, and refreshes the frames, the tiles that
              changed, the passes whose inputs changed and report.js, all
              by tmp+rename; --live_epochs N stops after N epochs (0 =
              until interrupted), --live_stall_s S flags a source quiet
              for S seconds while another streams; --drain ends with the
              batch preprocess + analyze, byte-identical to a batch run;
              exits 0, 1 when a source is stalled, 2 without the logdir
  clean       remove the derived files, keep the raw ones

analyze --enable_aisi finds the iterations (--iterations_from
auto|steps|marker|op, --num_iterations) and writes iterations.csv;
--enable_hsg (or --enable_swarms) clusters the host samples into
--num_swarms swarms (auto_caption.csv, swarms_report.csv).

report, analyze, viz, status, passes, resume, fsck, diff, whatif, export,
top, live, archive, regress and clean run on the host only: they never
touch a GPU.  fsck over an archive root checks the store (objects against
their names, run docs against the objects, the index's chunks).

--trace_format csv|parquet|columnar (or SOFA_TRACE_FORMAT) picks how
preprocess writes the frames; the default, columnar, is the chunked Arrow
store _frames/ (CSV where pyarrow is missing), beside which each frame's
<name>.csv is the board's downsampled copy.

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
         "status", "passes", "resume", "fsck", "diff", "whatif", "export",
         "top", "live", "archive", "regress", "clean")
# Verbs whose positional argument is the logdir.
LOGDIR_VERBS = ("status", "passes", "resume", "fsck", "whatif", "live")

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
    "trace_format", "num_iterations", "num_swarms", "enable_aisi",
    "enable_hsg", "enable_swarms", "iterations_from", "base_logdir",
    "match_logdir", "whatif_apply", "live_interval_s", "live_epochs",
    "live_stall_s", "archive_root", "archive_label", "archive_keep",
    "archive_keep_days", "archive_limit", "archive_since", "archive_host",
    "regress_rolling", "regress_pct", "regress_threshold",
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
                   "logdir for status, passes, resume, fsck, whatif and "
                   "live; archive's logdir or action; regress's run")
    p.add_argument("extra", nargs="?", default="",
                   help="archive show's run, backup's root, restore's "
                   "backup; regress's baseline")
    p.add_argument("extra2", nargs="?", default="",
                   help="archive backup's destination, restore's target")
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
    g.add_argument("--trace_format", choices=["csv", "parquet", "columnar"],
                   help="how the frames are written (default columnar: the "
                   "chunked _frames/ store; SOFA_TRACE_FORMAT alike)")

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

    g.add_argument("--enable_aisi", action="store_true",
                   help="find the iterations and profile each "
                   "(iterations.csv)")
    g.add_argument("--iterations_from",
                   choices=["auto", "steps", "marker", "module", "op"],
                   help="AISI's boundaries: the device step spans, the "
                   "sofa_step markers, or kernel-name mining (op); module "
                   "is the JAX package's and a usage error here")
    g.add_argument("--num_iterations", type=int,
                   help="the iteration count kernel-name mining looks for "
                   "(default 20)")
    g.add_argument("--enable_hsg", action="store_true",
                   help="cluster the host samples into swarms "
                   "(auto_caption.csv)")
    g.add_argument("--enable_swarms", action="store_true",
                   help="the same as --enable_hsg")
    g.add_argument("--num_swarms", type=int,
                   help="the most swarms (default 10)")

    g = p.add_argument_group("diff, whatif, export, top")
    g.add_argument("--base_logdir", help="diff: the base run")
    g.add_argument("--match_logdir", help="diff: the run compared to it")
    g.add_argument("--apply", dest="whatif_apply", metavar="SCENARIOS",
                   help="whatif: comma-joined scenarios, e.g. "
                   "'overlap:*,scale:aten::mm=0.5,scale:*=sol,link:2'")
    g.add_argument("--perfetto", action="store_true",
                   help="export: also trace.json.gz (Trace Event Format)")
    g.add_argument("--folded", action="store_true",
                   help="export: also the *.folded collapsed stacks")
    g.add_argument("--interval", type=float,
                   help="top: seconds between frames (default 2)")
    g.add_argument("--once", action="store_true",
                   help="top: draw one frame and exit")

    g = p.add_argument_group("live")
    g.add_argument("--live_interval_s", type=float,
                   help="live: seconds between epochs (default 2)")
    g.add_argument("--live_epochs", type=int,
                   help="live: run exactly N epochs, then exit (default 0: "
                   "until interrupted)")
    g.add_argument("--live_stall_s", type=float,
                   help="live: a source that stops growing this long while "
                   "another streams is `stalled` (default 30; 0 = never)")
    g.add_argument("--drain", action="store_true",
                   help="live: after the epochs (at once with no epoch "
                   "budget), the batch preprocess + analyze, so that every "
                   "output equals a batch run's")

    g = p.add_argument_group("fsck")
    g.add_argument("--repair", action="store_true",
                   help="fsck: invalidate the damaged cache, tile and chunk "
                   "entries, remove the orphans and re-derive (over an "
                   "archive root: re-adopt uncataloged runs, restore or "
                   "quarantine rotted objects, rebuild the index)")

    g = p.add_argument_group("archive, regress")
    g.add_argument("--archive_root",
                   help="the archive root (SOFA_ARCHIVE_ROOT alike; default "
                   "./sofa_archive)")
    g.add_argument("--label", dest="archive_label",
                   help="archive: a tag stored with the ingested run; ls: "
                   "only runs with it")
    g.add_argument("--keep", type=int, dest="archive_keep",
                   help="archive gc: keep the newest N runs")
    g.add_argument("--keep_days", type=float, dest="archive_keep_days",
                   help="archive gc: keep the runs ingested within D days")
    g.add_argument("--limit", type=int, dest="archive_limit",
                   help="archive ls: the newest N runs only")
    g.add_argument("--since", dest="archive_since",
                   help="archive ls: runs ingested since a unix time, or "
                   "e.g. 7d / 12h / 30m ago")
    g.add_argument("--host", dest="archive_host",
                   help="archive ls: runs ingested on this host only")
    g.add_argument("--rolling", type=int, dest="regress_rolling",
                   help="regress: the baseline is the newest N archived "
                   "runs instead of a second run")
    g.add_argument("--pct", type=float, dest="regress_pct",
                   help="regress --rolling: the baseline's percentile "
                   "(default 50, the median)")
    g.add_argument("--regress_threshold", type=float,
                   help="regress: the relative %% move a regressed or "
                   "improved verdict needs (default 10)")

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
    if args.verb in LOGDIR_VERBS and args.command \
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
    except BrokenPipeError:
        # `top --once | head` closing the pipe: the streaming verbs have
        # done their work; the others' files may be unwritten
        sys.stdout = open(os.devnull, "w")
        return 0 if args.verb in ("top", "viz") else 1


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
    if verb == "resume":
        from sofa_tpu_torch.durability import sofa_resume

        return sofa_resume(cfg)
    if verb == "fsck":
        from sofa_tpu_torch.durability import sofa_fsck

        return sofa_fsck(cfg, repair=getattr(args, "repair", False))
    if verb == "clean":
        sofa_clean(cfg)
        return 0
    if verb == "archive":
        from sofa_tpu_torch.archive.store import sofa_archive

        return sofa_archive(cfg, args.command or "", args.extra, args.extra2,
                            repair=getattr(args, "repair", False))
    if verb == "regress":
        from sofa_tpu_torch.archive.verdict import sofa_regress

        return sofa_regress(cfg, args.command or "", args.extra)
    if verb == "live":
        from sofa_tpu_torch.live import sofa_live

        return sofa_live(cfg, drain=getattr(args, "drain", False))
    if verb == "diff":
        if not (cfg.base_logdir and cfg.match_logdir):
            from sofa_tpu_torch.printing import print_error

            print_error("diff needs --base_logdir and --match_logdir")
            return 2
        from sofa_tpu_torch.ml.diff import sofa_diff

        return sofa_diff(cfg)
    if verb == "whatif":
        from sofa_tpu_torch.whatif import sofa_whatif

        return sofa_whatif(cfg)
    if verb == "export":
        return _export(args, cfg)
    if verb == "top":
        from sofa_tpu_torch.top import sofa_top

        return sofa_top(cfg, interval=getattr(args, "interval", 2.0),
                        once=getattr(args, "once", False))
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


def _export(args: argparse.Namespace, cfg: SofaConfig) -> int:
    """The charts, and with --perfetto / --folded the trace and the
    stacks, from frames read once (every host's on one clock with
    --cluster_hosts); then the logdir's digests are refreshed.  Exits 1
    when nothing was written or a flagged export failed (folded stacks
    count as written or absent: no sampler may have run)."""
    from sofa_tpu_torch import durability
    from sofa_tpu_torch.export_static import STATIC_FRAMES, export_static
    from sofa_tpu_torch.preprocess import load_frames

    perfetto = getattr(args, "perfetto", False)
    folded = getattr(args, "folded", False)
    wanted = set(STATIC_FRAMES)
    if perfetto:
        from sofa_tpu_torch.export_perfetto import (PERFETTO_FRAMES,
                                                    export_perfetto)

        wanted |= set(PERFETTO_FRAMES)
    if folded:
        from sofa_tpu_torch.export_folded import FOLDED_FRAMES, export_folded

        wanted |= set(FOLDED_FRAMES)
    if cfg.cluster_hosts:
        from sofa_tpu_torch.analyze import load_cluster_frames

        frames = load_cluster_frames(cfg, only=sorted(wanted))
    else:
        frames = load_frames(cfg, only=sorted(wanted))
    wrote_any = bool(export_static(cfg, frames))
    failed = False
    if perfetto:
        ok = export_perfetto(cfg, frames) is not None
        wrote_any |= ok
        failed |= not ok
    if folded:
        wrote_any |= bool(export_folded(cfg, frames))
    if os.path.isdir(cfg.logdir):
        durability.write_digests(cfg.logdir)
    return 0 if wrote_any and not failed else 1


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
