"""Command line: ``python -m sofa_tpu_torch {record,preprocess,analyze,stat}``.

  record      run "cmd" under the collectors, raw traces into --logdir
  preprocess  fold the raw traces into the unified frames (<source>.csv)
  analyze     run the passes, write features.csv, print Complete!!
  stat        record + preprocess + analyze; exits with the command's rc
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from sofa_tpu_torch.config import SofaConfig

VERBS = ("record", "preprocess", "analyze", "stat")

# Flags that map 1:1 onto SofaConfig fields.
_FIELDS = (
    "logdir", "verbose", "perf_events", "no_perf_events", "cpu_sample_rate",
    "perf_call_graph", "sys_mon_rate", "enable_strace", "strace_min_time",
    "enable_py_stacks", "enable_tcpdump", "netstat_interface", "blkdev",
    "gpu_mon_rate", "profile_region", "spotlight",
)
# --disable_<flag> clears SofaConfig.<field>.
_DISABLES = {"disable_kineto": "enable_kineto",
             "disable_gpu_mon": "enable_gpu_mon",
             "disable_memprof": "enable_mem_prof"}


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
    from sofa_tpu_torch.record import sofa_record

    rc = 0
    if args.verb in ("record", "stat"):
        rc = sofa_record(args.command, cfg)
    frames = None
    if args.verb in ("preprocess", "stat"):
        frames = sofa_preprocess(cfg)
    if args.verb in ("analyze", "stat"):
        sofa_analyze(cfg, frames)
    return rc


if __name__ == "__main__":
    sys.exit(main())
