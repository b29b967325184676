"""gpumon.txt -> unified-schema frame.

Input: one line per device per tick (collectors/gpumon.py),

    <unix_ns> <device_id> <bytes_in_use> <bytes_limit> <peak_bytes_in_use>

deviceId -1 is the liveness heartbeat.  Output rows (name = metric,
event = value), as the JAX package's tpumon frame has them (the H100's
memory is HBM3, so the names stay):

    hbm_used_gb    — allocator bytes in use, GB (payload carries raw bytes)
    hbm_occupancy  — % of bytes_limit in use (payload carries the peak)
    alive          — heartbeat, event=1.0
"""

from __future__ import annotations

import os

import pandas as pd

from sofa_tpu_torch.trace import empty_frame, make_frame


def parse_gpumon_line(line: str):
    """One sampler line -> (ts_ns, dev, used, limit, peak) or None."""
    parts = line.split()
    if len(parts) != 5:
        return None
    try:
        return tuple(int(p) for p in parts)
    except ValueError:
        return None


def parse_gpumon(text: str, time_base: float = 0.0) -> pd.DataFrame:
    rows = []
    for line in text.splitlines():
        parsed = parse_gpumon_line(line)
        if parsed is None:
            continue
        ts_ns, dev, used, limit, peak = parsed
        t = ts_ns / 1e9 - time_base
        if dev == -1:
            rows.append({"timestamp": t, "event": 1.0, "deviceId": -1,
                         "name": "alive", "device_kind": "gpu"})
            continue
        rows.append({"timestamp": t, "event": used / 1e9, "deviceId": dev,
                     "payload": used, "name": "hbm_used_gb",
                     "device_kind": "gpu"})
        if limit > 0:
            rows.append({"timestamp": t, "event": 100.0 * used / limit,
                         "deviceId": dev, "payload": peak,
                         "name": "hbm_occupancy", "device_kind": "gpu"})
    return make_frame(rows)


def ingest_gpumon(logdir: str, time_base: float = 0.0) -> pd.DataFrame:
    path = os.path.join(logdir, "gpumon.txt")
    if not os.path.isfile(path):
        return empty_frame()
    with open(path) as f:
        return parse_gpumon(f.read(), time_base)
