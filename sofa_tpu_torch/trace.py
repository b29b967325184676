"""The unified trace schema (the port's own copy of sofa_tpu/trace.py's core).

Every collector's output is coerced into one flat schema before analysis:
the reference's 13 base columns plus the extension columns.  On the GPU path
``deviceId`` is the CUDA device ordinal (host rows: -1), ``copyKind`` the
data-movement kind below, ``module`` the innermost profiler range
(``record_function``) open on the host when a device event was launched, and ``timestamp`` seconds
since the run's time base (``sofa_time.txt``).
"""

from __future__ import annotations

import os
from enum import IntEnum
from typing import Optional

import numpy as np
import pandas as pd

BASE_COLUMNS = [
    "timestamp",
    "event",
    "duration",
    "deviceId",
    "copyKind",
    "payload",
    "bandwidth",
    "pkt_src",
    "pkt_dst",
    "pid",
    "tid",
    "name",
    "category",
]

EXTRA_COLUMNS = ["device_kind", "hlo_category", "module", "flops",
                 "bytes_accessed", "groups", "phase", "source", "op_path"]

COLUMNS = BASE_COLUMNS + EXTRA_COLUMNS

_DEFAULTS = {
    "timestamp": 0.0,
    "event": 0.0,
    "duration": 0.0,
    "deviceId": -1,
    "copyKind": -1,
    "payload": 0,
    "bandwidth": 0.0,
    "pkt_src": -1,
    "pkt_dst": -1,
    "pid": -1,
    "tid": -1,
    "name": "",
    "category": 0,
    "device_kind": "",
    "hlo_category": "",
    "module": "",
    "flops": 0.0,
    "bytes_accessed": 0.0,
    "groups": "",
    "phase": "",
    "source": "",
    "op_path": "",
}


class CopyKind(IntEnum):
    """Data-movement taxonomy; 0/1/2/8/10 keep the reference's CUPTI
    numbering, >= 20 are collectives."""

    NA = -1
    KERNEL = 0
    H2D = 1
    D2H = 2
    D2D = 8
    P2P = 10
    ALL_REDUCE = 20
    ALL_GATHER = 21
    REDUCE_SCATTER = 22
    ALL_TO_ALL = 23
    COLLECTIVE_PERMUTE = 24
    COLLECTIVE_BROADCAST = 25


def empty_frame() -> pd.DataFrame:
    return pd.DataFrame(
        {c: pd.Series(dtype=object if isinstance(d, str) else type(d))
         for c, d in _DEFAULTS.items()})


def make_frame(rows) -> pd.DataFrame:
    """Schema frame from a list of dicts (or a dict of columns); missing
    columns get the schema defaults, unknown keys are rejected."""
    df = pd.DataFrame(rows if isinstance(rows, dict) else list(rows))
    if df.empty:
        return empty_frame()
    unknown = set(df.columns) - set(COLUMNS)
    if unknown:
        raise ValueError(f"columns outside the unified schema: "
                         f"{sorted(unknown)}")
    for col in COLUMNS:
        if col not in df.columns:
            df[col] = _DEFAULTS[col]
        elif df[col].isna().any():
            df[col] = df[col].fillna(_DEFAULTS[col])
    return df[COLUMNS]


def write_csv(df: pd.DataFrame, path: str) -> None:
    df.to_csv(path, index=False)


def read_csv(path: str) -> pd.DataFrame:
    """Read a schema CSV back with the schema's dtypes (text columns stay
    text, so a numeric-looking name is never mangled)."""
    text = [c for c, d in _DEFAULTS.items() if isinstance(d, str)]
    df = pd.read_csv(path, dtype={c: str for c in text},
                     keep_default_na=False,
                     na_values={c: [] for c in text})
    for col in COLUMNS:
        if col not in df.columns:
            df[col] = _DEFAULTS[col]
    return df[COLUMNS]


def roi_bounds(cfg) -> "Optional[tuple]":
    """(begin, end) when a region of interest is active, else None."""
    begin, end = cfg.roi_begin, cfg.roi_end
    if end > begin > 0 or (begin == 0 and end > 0):
        return begin, end
    return None


def narrow(df: pd.DataFrame, cols) -> pd.DataFrame:
    """Project a frame to the columns a pass reads before any row mask
    copies the rest.  A frame lacking one of them passes through unchanged;
    the result may be the input itself, so treat it as read-only."""
    if list(df.columns) == list(cols):
        return df
    if all(c in df.columns for c in cols):
        return df[list(cols)]
    return df


def roi_clip(df: pd.DataFrame, cfg) -> pd.DataFrame:
    """The rows that overlap the region of interest when one is set (a
    row straddling a bound stays whole), else the frame itself."""
    bounds = roi_bounds(cfg)
    if bounds is not None:
        begin, end = bounds
        starts = df["timestamp"]
        ends = starts + df["duration"]
        return df[(starts <= end) & (ends >= begin)]
    return df


def merged_intervals(starts, ends) -> np.ndarray:
    """Union of possibly-overlapping [start, end) intervals, as an (n, 2)
    array sorted by start."""
    starts = np.asarray(starts, dtype=float)
    ends = np.asarray(ends, dtype=float)
    if starts.size == 0:
        return np.empty((0, 2))
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    emax = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > emax[:-1]])
    idx = np.flatnonzero(new)
    ms = s[idx]
    me = np.concatenate([emax[idx[1:] - 1], emax[-1:]])
    return np.stack([ms, me], axis=1)


def packed_ip(ip: str) -> int:
    """Pack dotted IPv4 into the integer encoding of pkt_src/pkt_dst:
    sum(octet * 1000^(3-i)), as the JAX package packs it."""
    try:
        octets = [int(o) for o in ip.split(".")]
    except ValueError:
        return -1
    if len(octets) != 4:
        return -1
    value = 0
    for i, o in enumerate(octets):
        value += o * 1000 ** (3 - i)
    return value


# IPv6 addresses can't ride the 1000-base IPv4 packing (128 bits vs the
# float64-exact 2^53 ceiling); they are interned instead: ids counted up
# from V6_ID_BASE, literal addresses in the capture's net_addrs.csv side
# table.  The base sits above any packed IPv4 (max 255255255255 ≈ 2.6e11)
# and well below 2^53, so ids stay exact through the float frame columns.
V6_ID_BASE = 10 ** 12


def write_net_addrs(ids, logdir: str):
    """Write the interned {literal: id} table as net_addrs.csv beside the
    trace CSVs (atomically: a half-written table must never look
    complete); no IPv6 packets, no file.  Returns the path or None."""
    if not ids:
        return None
    out = os.path.join(logdir, "net_addrs.csv")
    with open(out + ".tmp", "w") as f:
        f.write("id,address\n")
        for literal, aid in sorted(ids.items(), key=lambda kv: kv[1]):
            f.write(f"{aid},{literal}\n")
    os.replace(out + ".tmp", out)
    return out
