"""blktrace.txt (blkparse text) -> per-IO latency frame.

D (dispatch) and C (complete) events on the same start block pair into
per-IO latency, on blkparse's default output:

    <maj>,<min> <cpu> <seq> <time> <pid> <action> <rwbs> <sector> + <nsect> [proc]

Rows: timestamp = dispatch time (relative to trace start ~= record start),
duration = D->C latency, payload = bytes (nsectors * 512), event = latency in
ms (scatter y), bandwidth = payload/latency.  Unmatched dispatches (trace cut
mid-IO) are dropped.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import pandas as pd

from sofa_tpu_torch.trace import empty_frame, make_frame

_LINE_RE = re.compile(
    r"^\s*(?P<maj>\d+),(?P<min>\d+)\s+(?P<cpu>\d+)\s+(?P<seq>\d+)\s+"
    r"(?P<time>[\d.]+)\s+(?P<pid>\d+)\s+(?P<action>[A-Z])\s+"
    r"(?P<rwbs>[A-Z]+)\s+(?P<sector>\d+)\s+\+\s+(?P<nsect>\d+)"
)

_SECTOR_BYTES = 512


def parse_blktrace(text: str, time_base: float = 0.0) -> pd.DataFrame:
    # (dev, sector) -> list of pending dispatches (time, pid, nsect, rwbs)
    pending: Dict[Tuple[str, int], List[Tuple[float, int, int, str]]] = {}
    rows = []
    for line in text.splitlines():
        m = _LINE_RE.match(line)
        if m is None:
            continue
        action = m.group("action")
        if action not in ("D", "C"):
            continue
        dev = f"{m.group('maj')},{m.group('min')}"
        sector = int(m.group("sector"))
        t = float(m.group("time"))
        key = (dev, sector)
        if action == "D":
            pending.setdefault(key, []).append(
                (t, int(m.group("pid")), int(m.group("nsect")), m.group("rwbs"))
            )
            continue
        # C: complete — match the earliest unmatched dispatch on this block
        queue = pending.get(key)
        if not queue:
            continue
        t_d, pid, nsect, rwbs = queue.pop(0)
        if not queue:
            del pending[key]
        latency = max(t - t_d, 0.0)
        nbytes = nsect * _SECTOR_BYTES
        rows.append(
            {
                "timestamp": t_d - time_base,
                "event": latency * 1e3,       # ms, the scatter y-value
                "duration": latency,
                "deviceId": int(m.group("min")),
                "payload": nbytes,
                "bandwidth": nbytes / latency if latency > 0 else 0.0,
                "pid": pid,
                "name": f"blk_{rwbs.lower()} {dev} sector {sector}",
                "device_kind": "disk",
            }
        )
    return make_frame(rows)


def ingest_blktrace(logdir: str, time_base: float = 0.0) -> pd.DataFrame:
    path = os.path.join(logdir, "blktrace.txt")
    if not os.path.isfile(path):
        return empty_frame()
    with open(path) as f:
        return parse_blktrace(f.read(), time_base)
