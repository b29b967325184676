"""preprocess: fold a recording's raw traces into the unified schema.

The JAX package runs a table of ingest tasks (xplane, tpumon and the host
collectors).  The port's table has one source so far, the Kineto capture,
which yields ``gputrace.csv``, ``gpusteps.csv`` and ``hosttrace.csv``.
"""

from __future__ import annotations

import os
from typing import Dict

import pandas as pd

from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest.kineto import ingest_kineto_dir
from sofa_tpu_torch.printing import print_info, print_warning
from sofa_tpu_torch.trace import read_csv, write_csv

FRAMES = ("gputrace", "gpusteps", "hosttrace")


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


def sofa_preprocess(cfg: SofaConfig) -> Dict[str, pd.DataFrame]:
    frames = ingest_kineto_dir(cfg.kineto_dir, read_time_base(cfg))
    for name in FRAMES:
        write_csv(frames[name], cfg.path(f"{name}.csv"))
        print_info(f"{name}.csv: {len(frames[name])} rows")
    return frames


def load_frames(cfg: SofaConfig) -> Dict[str, pd.DataFrame]:
    """The frames a previous preprocess wrote (missing ones are skipped)."""
    return {name: read_csv(cfg.path(f"{name}.csv")) for name in FRAMES
            if os.path.isfile(cfg.path(f"{name}.csv"))}
