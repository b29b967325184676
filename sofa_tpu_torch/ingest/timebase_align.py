"""Clock-domain conversion built from timebase.txt.

timebase.txt rows are simultaneous (realtime, monotonic, boottime,
monotonic_raw) nanosecond samples taken at record start AND record end
(collectors/timebase.py).  When the samples span enough wall time, a
least-squares linear fit captures clock drift/NTP slew (long runs);
clustered samples fall back to a mean offset.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

CLOCKS = {"realtime": 0, "monotonic": 1, "boottime": 2, "monotonic_raw": 3}


def load_timebase(path: str) -> Optional[np.ndarray]:
    if not os.path.isfile(path):
        return None
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) == 4:
                try:
                    rows.append([int(v) for v in p])
                except ValueError:
                    continue
    if not rows:
        return None
    return np.array(rows, dtype=np.int64)


# Minimum sample spread for a slope fit: below this, noise in the bracketing
# reads dominates and an offset is strictly better.
_MIN_FIT_SPREAD_NS = 1e9
# Real clock drift is ppm-scale; a fit outside this band means bad samples.
_MAX_DRIFT = 1e-3


def converter(path: str, source_clock: str = "monotonic") -> Optional[Callable[[float], float]]:
    """Return f(seconds in source clock) -> unix seconds, or None."""
    table = load_timebase(path)
    if table is None:
        return None
    col = CLOCKS[source_clock]
    x = table[:, col].astype(np.float64)
    y = table[:, 0].astype(np.float64)
    offset_ns = float(np.mean(y - x))
    slope = 1.0
    spread = float(x.max() - x.min())
    if len(x) >= 2 and spread >= _MIN_FIT_SPREAD_NS:
        xc = x - x.mean()
        fit = float((xc * (y - y.mean())).sum() / (xc * xc).sum())
        if abs(fit - 1.0) <= _MAX_DRIFT:
            slope = fit
    x0, y0 = float(x.mean()), float(y.mean())

    def f(t_s: float) -> float:
        if slope == 1.0:
            return t_s + offset_ns / 1e9
        return (y0 + slope * (t_s * 1e9 - x0)) / 1e9

    return f
