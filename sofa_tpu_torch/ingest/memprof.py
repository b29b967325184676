"""Allocation-site snapshot (pprof) -> allocation-site table.

Decodes the gzipped pprof ``Profile`` that collectors/gpumon.py writes at
the observed occupancy peak (or at exit as a fallback) into a flat
DataFrame:

    device | kind | count | bytes | site | stack

One row per pprof sample.  ``site`` is the innermost frame whose file lies
outside the ``torch`` package (the leaf frames of an allocation are torch's
own, e.g. AdamW's state init; the user wants the line that called it), past
the sampler's ``(autograd engine)`` frame (a block the engine allocated on
its device thread, under the stack of the backward call it served), and
``stack`` is the full leaf-first ``;``-joined frame path.

The decoder is written by hand against the pprof wire format (string
table, function, location, line, sample, label), the mirror image of the
sampler's encoder, so ingest needs no protobuf package.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

import pandas as pd

_COLUMNS = ["device", "kind", "count", "bytes", "site", "stack"]
_ENGINE = "(autograd engine)"


class DecodeError(ValueError):
    """The bytes are not a well-formed pprof Profile."""


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if i >= len(buf) or shift > 63:
            raise DecodeError("truncated varint")
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message:
    value is an int for varints and fixed widths, bytes when
    length-delimited."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = int.from_bytes(buf[i:i + 8], "little"), i + 8
        elif wire == 5:
            value, i = int.from_bytes(buf[i:i + 4], "little"), i + 4
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise DecodeError(f"unsupported wire type {wire}")
        if i > len(buf):
            raise DecodeError("field runs past the message")
        yield field, wire, value


def _ints(wire: int, value) -> List[int]:
    """A repeated integer field, packed (wire 2) or not."""
    if wire != 2:
        return [value]
    out, i = [], 0
    while i < len(value):
        v, i = _varint(value, i)
        out.append(v)
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _message(value) -> bytes:
    if not isinstance(value, bytes):
        raise DecodeError("expected a length-delimited message")
    return value


def decode_profile(blob: bytes) -> dict:
    """The fields of a pprof Profile that the site table needs."""
    prof = {"sample_type": [], "sample": [], "location": {}, "function": {},
            "string_table": []}
    for field, wire, value in _fields(blob):
        if field == 1:                               # ValueType
            vt = {1: 0, 2: 0}
            for f, w, v in _fields(_message(value)):
                if f in vt:
                    vt[f] = v
            prof["sample_type"].append((vt[1], vt[2]))
        elif field == 2:                             # Sample
            sample = {"location_id": [], "value": [], "label": []}
            for f, w, v in _fields(_message(value)):
                if f == 1:
                    sample["location_id"] += _ints(w, v)
                elif f == 2:
                    sample["value"] += [_signed(x) for x in _ints(w, v)]
                elif f == 3:
                    lb = {1: 0, 2: 0, 3: 0}
                    for lf, lw, lv in _fields(_message(v)):
                        if lf in lb:
                            lb[lf] = lv
                    sample["label"].append((lb[1], lb[2], _signed(lb[3])))
            prof["sample"].append(sample)
        elif field == 4:                             # Location
            loc = {"id": 0, "address": 0, "lines": []}
            for f, w, v in _fields(_message(value)):
                if f == 1:
                    loc["id"] = v
                elif f == 3:
                    loc["address"] = v
                elif f == 4:
                    ln = {1: 0, 2: 0}
                    for lf, lw, lv in _fields(_message(v)):
                        if lf in ln:
                            ln[lf] = lv
                    loc["lines"].append((ln[1], _signed(ln[2])))
            prof["location"][loc["id"]] = loc
        elif field == 5:                             # Function
            fn = {1: 0, 2: 0, 4: 0}
            for f, w, v in _fields(_message(value)):
                if f in fn:
                    fn[f] = v
            prof["function"][fn[1]] = (fn[2], fn[4])
        elif field == 6:                             # string_table
            prof["string_table"].append(
                _message(value).decode("utf-8", "replace"))
    return prof


def _in_torch(path: str) -> bool:
    """Whether a frame's file lies inside the torch package."""
    return "torch" in os.path.normpath(path).split(os.sep)[:-1]


def _site_of(frames: List[str], files: List[str]) -> str:
    for name, path in zip(frames, files):
        if not _in_torch(path) and name != _ENGINE:
            return name
    return frames[0] if frames else "(unknown)"


def parse_memprof(path: str) -> pd.DataFrame:
    """Decode one ``memprof.pb.gz`` into the allocation-site DataFrame."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        blob = gzip.decompress(blob)
    except (OSError, EOFError):
        pass  # already raw proto (synthetic fixtures)
    prof = decode_profile(blob)
    st = prof["string_table"]

    def s(i: int) -> str:
        return st[i] if 0 <= i < len(st) else ""

    # Column order of the sample values: find (allocations,count) and
    # (space,bytes); fall back positionally for foreign producers.
    count_i, bytes_i = 0, min(1, max(0, len(prof["sample_type"]) - 1))
    for i, (_, unit) in enumerate(prof["sample_type"]):
        if s(unit) == "count":
            count_i = i
        elif s(unit) == "bytes":
            bytes_i = i

    fns: Dict[int, Tuple[str, str]] = {
        fid: (s(name), s(fname))
        for fid, (name, fname) in prof["function"].items()}
    loc_frames: Dict[int, List[Tuple[str, str]]] = {}
    for lid, loc in prof["location"].items():
        loc_frames[lid] = [fns.get(fid, ("", "")) for fid, _ in loc["lines"]] \
            or [(f"0x{loc['address']:x}", "")]

    rows = []
    for sample in prof["sample"]:
        frames: List[Tuple[str, str]] = []
        for lid in sample["location_id"]:  # leaf first, per pprof convention
            frames.extend(loc_frames.get(lid, []))
        labels = {}
        for key, str_i, num in sample["label"]:
            labels[s(key)] = s(str_i) if str_i else num
        values = sample["value"]

        def v(i: int) -> int:
            return int(values[i]) if i < len(values) else 0

        names = [name for name, _ in frames]
        rows.append({
            "device": str(labels.get("device", "")),
            "kind": str(labels.get("kind", "buffer")),
            "count": v(count_i),
            "bytes": v(bytes_i),
            "site": _site_of(names, [fname for _, fname in frames]),
            "stack": ";".join(names),
        })
    return pd.DataFrame(rows, columns=_COLUMNS)


def load_memprof(logdir: str) -> Tuple[Optional[pd.DataFrame], dict]:
    """(samples, meta) for a logdir, or (None, {}) when never captured.

    meta is the sidecar collectors/gpumon.py writes: unix_ns, trigger
    ("peak" | "final"), total_bytes at trigger time, snapshot_s.
    """
    path = os.path.join(logdir, "memprof.pb.gz")
    if not os.path.isfile(path):
        return None, {}
    df = parse_memprof(path)
    meta = {}
    try:
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        pass
    return df, meta


def aggregate_sites(df: pd.DataFrame, top_k: int = 30) -> pd.DataFrame:
    """Top allocation sites by held bytes, with per-site share of total."""
    if df is None or df.empty:
        return pd.DataFrame(
            columns=["site", "kind", "bytes", "count", "share"])
    g = (df.groupby(["site", "kind"], as_index=False)
           .agg(bytes=("bytes", "sum"), count=("count", "sum"))
           .sort_values("bytes", ascending=False))
    total = float(g["bytes"].sum()) or 1.0
    g["share"] = g["bytes"] / total
    return g.head(top_k).reset_index(drop=True)
