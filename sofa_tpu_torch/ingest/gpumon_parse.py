"""gpumon.txt -> unified-schema frame.

Input: one line per device per tick (collectors/gpumon.py),

    <unix_ns> <device_id> <bytes_in_use> <bytes_limit> <peak_bytes_in_use>

deviceId -1 is the liveness heartbeat.  Rank r of a process group of two
or more writes ``gpumon.rank<r>.txt`` (collectors/gpumon.py): when its
device rows name one card, they take deviceId r, the rank's global index,
as its Kineto rows do; a rank that sampled several cards keeps their
ordinals, with a warning.  ``gpumon.pid<pid>.txt`` is a process that might
have joined a group and never did (or died first): its rows keep their
ordinals.  Output rows (name = metric,
event = value), as the JAX package's tpumon frame has them (the H100's
memory is HBM3, so the names stay):

    hbm_used_gb    — allocator bytes in use, GB (payload carries raw bytes)
    hbm_occupancy  — % of bytes_limit in use (payload carries the peak)
    alive          — heartbeat, event=1.0
"""

from __future__ import annotations

import glob
import os
import re

import pandas as pd

from sofa_tpu_torch.printing import print_warning
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


RANK_FILE_RE = re.compile(r"gpumon\.rank(\d+)\.txt$")


def gpumon_files(logdir: str):
    """gpumon.txt, the ranks' gpumon.rank<r>.txt and the unranked
    processes' gpumon.pid<pid>.txt, in name order."""
    return [os.path.join(logdir, "gpumon.txt")] + sorted(
        glob.glob(os.path.join(logdir, "gpumon.rank*.txt"))
        + glob.glob(os.path.join(logdir, "gpumon.pid*.txt")))


def ingest_gpumon(logdir: str, time_base: float = 0.0) -> pd.DataFrame:
    frames = []
    for path in gpumon_files(logdir):
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            df = parse_gpumon(f.read(), time_base)
        m = RANK_FILE_RE.search(path)
        if m and not df.empty:
            cards = df.loc[df["deviceId"] >= 0, "deviceId"].unique()
            if len(cards) <= 1:
                df.loc[df["deviceId"] >= 0, "deviceId"] = int(m.group(1))
            else:
                print_warning(
                    "gpumon: rank %s sampled cards %s: its rows keep the "
                    "ordinals (one device per rank holds for a rank that "
                    "drives one card)" % (m.group(1), sorted(cards.tolist())))
        if not df.empty:
            frames.append(df)
    if len(frames) < 2:
        return frames[0] if frames else empty_frame()
    return pd.concat(frames, ignore_index=True).sort_values(
        "timestamp", kind="stable").reset_index(drop=True)
