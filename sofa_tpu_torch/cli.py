"""Command line: ``python -m sofa_tpu_torch <verb>``.

  record      run "cmd" under the collectors, raw traces into --logdir
  preprocess  fold the raw traces into the unified frames (<source>.csv),
              the timeline's report.js and its tile pyramid (_tiles/)
  analyze     run the passes, write features.csv and hints.txt, stage the
              board's pages, print Complete!!
  stat        record + preprocess + analyze; exits with the command's rc
  report      [preprocess] + analyze [+ viz with --with-gui]
  viz         serve the board over --logdir (http://localhost:8000/)
  clean       remove the derived files, keep the raw ones

report, analyze, viz and clean run on the host only: they never touch a
GPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from sofa_tpu_torch.config import SofaConfig

VERBS = ("record", "preprocess", "analyze", "stat", "report", "viz", "clean")

# Flags that map 1:1 onto SofaConfig fields.
_FIELDS = (
    "logdir", "verbose", "perf_events", "no_perf_events", "cpu_sample_rate",
    "perf_call_graph", "sys_mon_rate", "enable_strace", "strace_min_time",
    "enable_py_stacks", "enable_tcpdump", "netstat_interface", "blkdev",
    "gpu_mon_rate", "profile_region", "spotlight", "viz_port", "viz_bind",
)
# --disable_<flag> clears SofaConfig.<field>.
_DISABLES = {"disable_kineto": "enable_kineto",
             "disable_gpu_mon": "enable_gpu_mon",
             "disable_memprof": "enable_mem_prof",
             "no_tiles": "enable_tiles"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sofa_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter,
                                argument_default=argparse.SUPPRESS)
    p.add_argument("verb", choices=VERBS)
    p.add_argument("command", nargs="?", default=None,
                   help="shell command to profile (record, stat)")
    p.add_argument("--logdir")
    p.add_argument("--verbose", action="store_true")

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

    g = p.add_argument_group("record: gpu")
    g.add_argument("--disable_kineto", action="store_true",
                   help="run the command without the torch.profiler trace")
    g.add_argument("--gpu_mon_rate", type=int,
                   help="allocator memory sampler rate, Hz (default 1)")
    g.add_argument("--disable_gpu_mon", action="store_true")
    g.add_argument("--disable_memprof", action="store_true",
                   help="skip the peak-memory allocation-site snapshot")

    g = p.add_argument_group("analyze")
    g.add_argument("--profile_region", help='manual ROI "begin:end" seconds')
    g.add_argument("--spotlight", action="store_true",
                   help="auto-ROI from the kernel utilization")

    g = p.add_argument_group("board")
    g.add_argument("--no_tiles", action="store_true",
                   help="skip the deep-zoom tile pyramid")
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
    passed = vars(args)
    cfg = SofaConfig(**{k: passed[k] for k in _FIELDS if k in passed})
    for flag, field in _DISABLES.items():
        if passed.get(flag):
            setattr(cfg, field, False)
    return cfg


def main(argv: Optional[list] = None) -> int:
    p = build_parser()
    args = p.parse_intermixed_args(argv)
    if args.verb in ("record", "stat") and not args.command:
        p.error(f"{args.verb} needs a command")
    cfg = config_from_args(args)

    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.record import sofa_clean, sofa_record
    from sofa_tpu_torch.viz import sofa_viz

    verb = args.verb
    if verb == "clean":
        sofa_clean(cfg)
        return 0
    if verb == "viz":
        return 0 if sofa_viz(cfg) is not None else 1
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


if __name__ == "__main__":
    sys.exit(main())
