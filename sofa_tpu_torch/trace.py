"""The unified trace schema (the port's own copy of sofa_tpu/trace.py's core).

Every collector's output is coerced into one flat schema before analysis:
the reference's 13 base columns plus the extension columns.  On the GPU path
``deviceId`` is the CUDA device ordinal (host rows: -1), ``copyKind`` the
data-movement kind below, ``module`` the innermost profiler range
(``record_function``) open on the host when a device event was launched, and ``timestamp`` seconds
since the run's time base (``sofa_time.txt``).

A frame travels between the verbs in one of ``TRACE_FORMATS``
(``write_frame`` / ``read_frame``; the JAX package's ``trace.py:354-470``):
the chunked Arrow store of ``frames.py`` by default, else parquet or CSV.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional, Tuple

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


#: copyKind -> its name (comm.csv's ``kind``, the ``comm_<kind>_*`` features)
CK_NAMES = {int(k): k.name for k in CopyKind}


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
    text, so a numeric-looking name is never mangled; an empty numeric
    cell is NaN: a cost the trace could not see).  Floats parse correctly
    rounded, so a frame reads back exactly as the chunk store gives it."""
    text = [c for c, d in _DEFAULTS.items() if isinstance(d, str)]
    df = pd.read_csv(path, dtype={c: str for c in text},
                     keep_default_na=False, float_precision="round_trip",
                     na_values={c: [] if c in text else [""]
                                for c in _DEFAULTS})
    for col in COLUMNS:
        if col not in df.columns:
            df[col] = _DEFAULTS[col]
    return df[COLUMNS]


def _conform(df: pd.DataFrame) -> pd.DataFrame:
    """Coerce a frame to the schema in place: missing columns get their
    defaults, text columns are str, float columns float64 (the JAX
    package's ``_conform``, so that both packages hash a frame alike)."""
    for col in COLUMNS:
        if col not in df.columns:
            df[col] = _DEFAULTS[col]
    for col, default in _DEFAULTS.items():
        if isinstance(default, str):
            df[col] = df[col].fillna("").astype(str)
        elif isinstance(default, float) and df[col].dtype.kind != "f":
            df[col] = df[col].astype("float64")
    return df[COLUMNS]


# --- the frame formats --------------------------------------------------------

#: What ``--trace_format`` selects: one CSV a frame, one parquet file a
#: frame, or the chunked Arrow store under ``_frames/`` (``frames.py``).
TRACE_FORMATS = ("csv", "parquet", "columnar")


def resolve_trace_format(cfg) -> str:
    """The format this run writes: ``cfg.trace_format``, else
    ``SOFA_TRACE_FORMAT``, else ``columnar``; columnar and parquet fall
    back to csv, with a warning, where pyarrow is missing."""
    from sofa_tpu_torch.frames import columnar_available
    from sofa_tpu_torch.printing import print_warning

    fmt = getattr(cfg, "trace_format", "") \
        or os.environ.get("SOFA_TRACE_FORMAT", "") or "columnar"
    if fmt not in TRACE_FORMATS:
        print_warning(f"trace_format {fmt!r} is not one of "
                      f"{'/'.join(TRACE_FORMATS)}; using columnar")
        fmt = "columnar"
    if fmt in ("columnar", "parquet") and not columnar_available():
        print_warning(f"trace_format={fmt} needs pyarrow; falling back to "
                      "csv")
        fmt = "csv"
    return fmt


def open_frame(base_path: str):
    """A lazy ``frames.FrameHandle`` over ``base_path``'s chunk store, or
    None when it has none."""
    from sofa_tpu_torch import frames as framestore

    logdir, name = os.path.split(base_path)
    return framestore.open_frame(logdir or ".", name)


def _unlink(path: str) -> None:
    with contextlib.suppress(OSError):
        os.unlink(path)


def write_frame(df: pd.DataFrame, base_path: str, fmt: str = "csv"
                ) -> Tuple[str, Optional[dict]]:
    """Write a schema frame in ``fmt``; returns the path written and, for
    a chunk store, its write stats (chunks written and reused, bytes).
    Each mode deletes the others' artifacts, since a reader takes the
    chunk store before ``<name>.parquet`` before ``<name>.csv``.  A frame
    the chunk store refuses is written as CSV instead, with a warning
    (and no stats)."""
    from sofa_tpu_torch import frames as framestore

    logdir, name = os.path.split(base_path)
    logdir = logdir or "."
    if fmt == "columnar":
        try:
            doc = framestore.write_frame_chunks(df, logdir, name)
        except Exception as e:  # noqa: BLE001 - one frame falls back to csv
            from sofa_tpu_torch.printing import print_warning

            print_warning(f"frames: columnar store of {name} failed ({e}); "
                          f"writing {name}.csv instead")
            framestore.delete_frame_store(logdir, name)
            return write_frame(df, base_path, "csv")
        _unlink(base_path + ".parquet")
        return os.path.join(framestore.frame_dir(logdir, name),
                            framestore.FRAME_INDEX_NAME), doc["_stats"]
    if fmt == "parquet":
        path = base_path + ".parquet"
        with atomic_replace(path) as tmp:
            df.to_parquet(tmp, index=False)
    else:
        path = base_path + ".csv"
        write_csv(df, path)
        _unlink(base_path + ".parquet")
    framestore.delete_frame_store(logdir, name)
    return path, None


def read_frame(base_path: str,
               columns: Optional[List[str]] = None
               ) -> Optional[pd.DataFrame]:
    """A frame from its chunk store, else ``<base_path>.parquet``, else
    ``<base_path>.csv``, else None.  ``columns`` is pushed down into the
    chunk reader; the other two read every column and project after."""
    handle = open_frame(base_path)
    if handle is not None:
        return handle.read(columns=columns)
    if os.path.isfile(base_path + ".parquet"):
        df = _conform(pd.read_parquet(base_path + ".parquet"))
    elif os.path.isfile(base_path + ".csv"):
        df = read_csv(base_path + ".csv")
    else:
        return None
    if columns is not None:
        return narrow(df, [c for c in columns if c in df.columns])
    return df


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
    with atomic_write(out) as f:
        f.write("id,address\n")
        for literal, aid in sorted(ids.items(), key=lambda kv: kv[1]):
            f.write(f"{aid},{literal}\n")
    return out


def unpack_ip(value: int, addrs: Optional[dict] = None) -> str:
    """An address id of pkt_src/pkt_dst -> its literal.  ``addrs`` is the
    interned id -> literal table (net_addrs.csv) for IPv6 ids; without it
    a v6 id reads as a stable placeholder, never a wrong dotted quad."""
    if value < 0:                   # -1: the schema's "not a packet"
        return "n/a"
    v = int(value)
    if v >= V6_ID_BASE:
        if addrs:
            hit = addrs.get(v)
            if hit:
                return hit
        return f"ipv6#{v - V6_ID_BASE}"
    octets = []
    for i in range(4):
        octets.append(v // 1000 ** (3 - i))
        v %= 1000 ** (3 - i)
    return ".".join(str(o) for o in octets)


def read_net_addrs(path: str) -> dict:
    """A capture's interned id -> literal address table (net_addrs.csv,
    written by the pcap ingest when non-IPv4 packets appear).  A missing
    file gives {}; an unreadable one (a preprocess mid-write, the guard's
    sentinel present) gives the rows read so far, with a warning."""
    import csv

    table: dict = {}
    if not os.path.isfile(path):
        return table
    try:
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                try:
                    table[int(row["id"])] = row["address"]
                except (KeyError, ValueError, TypeError):
                    continue
    except OSError as e:
        from sofa_tpu_torch.printing import print_warning

        why = ("a preprocess is mid-write on this logdir"
               if derived_writing(os.path.dirname(path) or ".") else e)
        print_warning(f"net_addrs: cannot read {path} ({why}); addresses "
                      "degrade to placeholders")
    return table


# --- atomic writes and the derived-write guard -------------------------------

@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w", fsync: bool = False):
    """Open ``<path>.tmp`` and rename it over ``path`` on a clean exit; on
    any exception the tmp file is removed and ``path`` is untouched, so a
    reader racing the writer sees the old complete file.  ``fsync=True``
    syncs before the rename (a commit point, such as a tile index)."""
    tmp = path + ".tmp"
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        if fsync:
            os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        try:
            f.close()
        finally:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
        raise


@contextlib.contextmanager
def atomic_replace(path: str):
    """Yield ``<path>.tmp`` for a writer that opens the file itself
    (pyarrow, pandas ``to_*``); rename it over ``path`` on a clean exit,
    remove it on failure."""
    tmp = path + ".tmp"
    try:
        yield tmp
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def fsync_append(path: str, text: str) -> None:
    """Append ``text`` in one write, flushed and fsync'd before returning:
    a crash mid-append leaves at worst one torn last line, which the
    JSONL readers skip (the run journal's write)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:  # sofa-lint: disable=SL009 — THE durable-append helper (atomic_write's sibling): appends cannot rename
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


# Frame CSVs stream and the tile pyramid lands file by file, so a board
# request racing preprocess or analyze could read a torn file.  Writers hold
# this sentinel (its content: the writer's pid) while derived data is in
# flight; viz answers data requests 503 + Retry-After while it exists.
WRITING_SENTINEL = "_derived.writing"
SENTINEL_STALE_S = 1800.0


def derived_writing(logdir: str) -> bool:
    """True while a pipeline verb is mid-write on this logdir.  The
    sentinel is ignored when its writer is dead, and when it is older than
    SENTINEL_STALE_S (a torn sentinel or a recycled pid must not 503 the
    board forever)."""
    path = os.path.join(logdir, WRITING_SENTINEL)
    try:
        st = os.stat(path)
    except OSError:
        return False
    if time.time() - st.st_mtime > SENTINEL_STALE_S:  # sofa-lint: disable=SL003 — compared against a file mtime, which IS wall clock; monotonic has no common epoch with it
        return False
    try:
        with open(path) as f:
            pid = int(f.read().strip() or "0")
    except OSError:
        return False
    except ValueError:
        return True              # torn but fresh: plausibly mid-write
    if pid <= 0:
        return True
    try:
        os.kill(pid, 0)  # sofa-lint: disable=SL008 — signal 0 is a liveness probe, not a kill
        return True
    except ProcessLookupError:
        return False             # the writer died without cleaning up
    except OSError:
        return True


def reap_stale_sentinel(logdir: str) -> bool:
    """Remove a sentinel whose writer is dead or timed out (run before
    serving and before writing: a crashed writer must not wedge the next
    run's readers).  Returns whether one was removed."""
    path = os.path.join(logdir, WRITING_SENTINEL)
    if not os.path.exists(path) or derived_writing(logdir):
        return False
    try:
        os.unlink(path)
    except OSError:
        return False
    from sofa_tpu_torch.printing import print_info

    print_info(f"reaped a stale {WRITING_SENTINEL} (its writer is gone)")
    return True


class derived_write_guard:
    """Held across non-atomic derived writes.  Reentrant per process: an
    inner guard on a logdir this pid already holds leaves the sentinel to
    the outer one."""

    def __init__(self, logdir: str):
        self._path = os.path.join(logdir, WRITING_SENTINEL)
        self._owned = False

    def __enter__(self):
        try:
            with open(self._path) as f:
                if f.read().strip() == str(os.getpid()):
                    return self
        except OSError:
            pass
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            with open(self._path, "w") as f:  # sofa-lint: disable=SL009 — the sentinel IS the mid-write signal; an atomic rename would defeat its purpose
                f.write(str(os.getpid()))
            self._owned = True
        except OSError:
            pass             # an unwritable logdir fails later, loudly
        return self

    def __exit__(self, *exc):
        if self._owned:
            with contextlib.suppress(OSError):
                os.unlink(self._path)
        return False


# --- timeline series and report.js -------------------------------------------

def downsample(df: pd.DataFrame, max_points: int,
               rank_col: str = "duration") -> pd.DataFrame:
    """About ``max_points`` rows of ``df``: a stride sample united with the
    top max_points/10 rows by ``rank_col``, in their order, so a rare long
    kernel between strides is never dropped."""
    if max_points <= 0 or len(df) <= max_points:
        return df
    rv = None
    if rank_col in df.columns:
        rv = pd.to_numeric(df[rank_col], errors="coerce").fillna(0.0) \
            .to_numpy()
    return df.iloc[downsample_indices(len(df), max_points, rv)]


def downsample_indices(n: int, max_points: int,
                       rank_values: "np.ndarray | None" = None) -> np.ndarray:
    """The row positions :func:`downsample` keeps."""
    if max_points <= 0 or n <= max_points:
        return np.arange(n)
    k = max(1, max_points // 10) if rank_values is not None else 0
    stride = int(np.ceil(n / max(1, max_points - k)))
    keep = np.zeros(n, dtype=bool)
    keep[::stride] = True
    if k:
        keep[np.argsort(rank_values)[-k:]] = True
    return np.flatnonzero(keep)


def _scrub(values, digits: int) -> list:
    """NaN/Inf to 0 (bare NaN is invalid JSON for the board), rounded."""
    a = np.asarray(values, dtype=float)
    a = np.where(np.isfinite(a), a, 0.0)
    return np.round(a, digits).tolist()


@dataclass
class SofaSeries:
    """One named, coloured series on the board's timeline."""

    name: str            # unique key
    title: str           # legend text
    color: str
    data: pd.DataFrame = field(default_factory=empty_frame)
    y_axis: str = "event"      # the column that gives y
    kind: str = "scatter"      # scatter | line

    def to_columnar(self, max_points: int = 10000) -> dict:
        """The downsampled series as ``{"x", "y", "d", "names", "ni"}``:
        parallel arrays with the names interned into a table."""
        df = downsample(self.data, max_points)
        if df.empty:
            return {"x": [], "y": [], "d": [], "names": [], "ni": []}
        ys = df[self.y_axis] if self.y_axis in df.columns else df["event"]
        codes, uniques = pd.factorize(df["name"], use_na_sentinel=False)
        return {
            "x": _scrub(df["timestamp"].to_numpy(), 6),
            "y": _scrub(ys.to_numpy(), 6),
            "d": _scrub(df["duration"].to_numpy(), 9),
            "names": [str(u) for u in uniques],
            "ni": codes.tolist(),
        }


def series_to_report_js(series: List[SofaSeries], path: str,
                        max_points: int = 10000,
                        extra: Optional[dict] = None) -> None:
    """Write every series to ``report.js``, the board's data contract:
    each series' data is its columnar overview; ``meta.tiles`` names the
    deep-zoom pyramids (``tiles.py``)."""
    payload = [{"name": s.name, "title": s.title, "color": s.color,
                "kind": s.kind, "data": s.to_columnar(max_points)}
               for s in series]
    write_report_js_doc({"series": payload, "meta": extra or {}}, path)


def write_report_js_doc(doc: dict, path: str) -> None:
    """THE report.js writer (``sofa_traces = <json>;``), atomic."""
    with atomic_write(path) as f:
        f.write("sofa_traces = ")
        f.write(json.dumps(doc))
        f.write(";\n")


def read_report_js_doc(path: str) -> dict:
    """Parse a report.js back into its document."""
    with open(path) as f:
        text = f.read()
    return json.loads(text[len("sofa_traces = "):].rstrip(";\n"))
