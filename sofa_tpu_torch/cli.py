"""Command line: ``python -m sofa_tpu_torch {record,preprocess,analyze,stat}``.

  record      run "cmd" under the collectors, raw traces into --logdir
  preprocess  fold the raw traces into gputrace/gpusteps/hosttrace.csv
  analyze     run the passes, write features.csv, print Complete!!
  stat        record + preprocess + analyze; exits with the command's rc
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from sofa_tpu_torch.config import SofaConfig

VERBS = ("record", "preprocess", "analyze", "stat")


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m sofa_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("verb", choices=VERBS)
    p.add_argument("command", nargs="?", default=None,
                   help="shell command to profile (record, stat)")
    p.add_argument("--logdir", default="sofalog/")
    p.add_argument("--disable_kineto", action="store_true",
                   help="run the command without the torch.profiler trace")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_intermixed_args(argv)
    if args.verb in ("record", "stat") and not args.command:
        p.error(f"{args.verb} needs a command")
    cfg = SofaConfig(logdir=args.logdir,
                     enable_kineto=not args.disable_kineto,
                     verbose=args.verbose)

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
