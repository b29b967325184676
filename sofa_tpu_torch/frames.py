"""The chunked columnar frame store, ``<logdir>/_frames/`` (the JAX
package's ``sofa_tpu/frames.py``).

    <logdir>/_frames/<name>/NNNNNN.arrow      one chunk of CHUNK_ROWS rows
                                              (Arrow IPC file, uncompressed:
                                              memory-mappable)
    <logdir>/_frames/<name>/frame_index.json  the frame's index (schema
                                              ``sofa_tpu/frame_index`` v1):
                                              columns, rows, and per chunk
                                              its rows, t_min/t_max and a
                                              content hash

* **The schema is trace.COLUMNS**, in order, with ``trace._conform``'s
  dtypes: a store never invents a column.
* **Projection pushdown**: ``FrameHandle.read(columns=...)`` maps only the
  requested column buffers; the analysis registry hands each pass exactly
  its declared ``reads_columns`` (``ProjectionPool``).
* **Time-range pushdown**: the index signs each chunk's ``[t_min, t_max]``,
  so a ``time_range`` read skips whole chunks; the row filter is on
  ``timestamp``, closed.
* **Content-keyed writes**: chunk boundaries are fixed multiples of
  CHUNK_ROWS and each chunk is keyed by the hash of its rows, so writing
  the same frame again rewrites nothing and an append rewrites only the
  last partial chunk and the new tail.
* **Crash safety**: chunk files land by tmp+rename and the index is written
  last, fsync'd: a SIGKILL mid-write leaves the previous generation whole.
* **Fallbacks**: without pyarrow the verbs write CSV
  (``trace.resolve_trace_format``); a frame whose Arrow conversion fails
  is written as CSV alone (``trace.write_frame``); a logdir without
  ``_frames/`` reads its parquet or CSV files.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_warning

FRAMES_DIR_NAME = "_frames"
FRAME_INDEX_NAME = "frame_index.json"
FRAME_INDEX_SCHEMA = "sofa_tpu/frame_index"
FRAME_INDEX_VERSION = 1

#: Rows per chunk: a few MiB of the widest frames' buffers, so that the
#: tail chunk is cheap to rewrite.
CHUNK_ROWS = 1 << 16


def columnar_available() -> bool:
    """Whether pyarrow can serve the store here; the verbs fall back to
    CSV where it cannot."""
    try:
        import pyarrow.ipc  # noqa: F401

        return True
    except ImportError:
        return False


def frame_dir(logdir: str, name: str) -> str:
    return os.path.join(logdir, FRAMES_DIR_NAME, name)


def _chunk_file(i: int) -> str:
    return f"{i:06d}.arrow"


def _row_hashes(df: pd.DataFrame) -> np.ndarray:
    """Per-row content hashes (pandas' fixed key: the same in every
    process), computed once a frame; each chunk hashes its slice."""
    return pd.util.hash_pandas_object(df, index=False).to_numpy()


def _chunk_sha(row_hashes: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(row_hashes).tobytes())
    return h.hexdigest()


def _conformed(df: pd.DataFrame) -> pd.DataFrame:
    from sofa_tpu_torch.trace import COLUMNS, _conform

    if list(df.columns) == COLUMNS:
        return df
    if all(c in df.columns for c in COLUMNS):
        return df[COLUMNS]
    return _conform(df.copy())


def write_frame_chunks(df: pd.DataFrame, logdir: str, name: str,
                       chunk_rows: Optional[int] = None) -> dict:
    """Write or refresh one frame's chunk store under trace.COLUMNS;
    returns the committed index (with ``_stats``: chunks written, reused,
    bytes)."""
    from sofa_tpu_torch.trace import COLUMNS

    return write_chunk_store(_conformed(df), frame_dir(logdir, name), name,
                             columns=list(COLUMNS), chunk_rows=chunk_rows)


def write_chunk_store(df: pd.DataFrame, sdir: str, name: str,
                      columns: Optional[List[str]] = None,
                      chunk_rows: Optional[int] = None,
                      time_column: str = "timestamp") -> dict:
    """The store's writer over any column set (``columns``, else the
    frame's own): content-keyed chunks at fixed boundaries, each by
    tmp+rename, then the index, fsync'd, as the commit point.  Chunk files
    past a shrunk frame's count go only after the commit, so a kill before
    it leaves the previous generation readable."""
    import pyarrow as pa

    from sofa_tpu_torch.trace import atomic_replace, atomic_write

    if columns is not None and list(df.columns) != list(columns):
        df = df[list(columns)]
    rows = int(len(df))
    step = int(chunk_rows or CHUNK_ROWS)
    os.makedirs(sdir, exist_ok=True)
    index_path = os.path.join(sdir, FRAME_INDEX_NAME)
    prev = _load_index(index_path)
    prev_chunks = (prev or {}).get("chunks") or []
    reusable = prev is not None and prev.get("chunk_rows") == step

    chunks: List[dict] = []
    wrote = reused = n_bytes = 0
    row_hashes = _row_hashes(df) if rows else np.empty(0, dtype=np.uint64)
    ts_all = (df[time_column].to_numpy(dtype=float)
              if rows and time_column in df.columns else np.empty(0))
    # one conversion for the frame; each chunk is a zero-copy slice
    table_all = pa.Table.from_pandas(df, preserve_index=False) if rows \
        else None
    for i, a in enumerate(range(0, rows, step)):
        b = min(a + step, rows)
        sha = _chunk_sha(row_hashes[a:b])
        fname = _chunk_file(i)
        path = os.path.join(sdir, fname)
        old = prev_chunks[i] if reusable and i < len(prev_chunks) else None
        if old is not None and old.get("sha") == sha \
                and old.get("rows") == b - a and os.path.isfile(path):
            entry = dict(old)
            reused += 1
        else:
            with atomic_replace(path) as tmp:
                _write_chunk(table_all.slice(a, b - a), tmp)
            # NaN timestamps sign no range; an all-NaN chunk signs null
            # bounds (NaN is not JSON, and would drop the chunk from every
            # time_range read)
            ts = ts_all[a:b]
            finite = ts[~np.isnan(ts)] if len(ts) else ts
            entry = {
                "file": fname, "rows": int(b - a), "sha": sha,
                "t_min": float(finite.min()) if len(finite) else None,
                "t_max": float(finite.max()) if len(finite) else None,
            }
            wrote += 1
        try:
            n_bytes += os.path.getsize(path)
        except OSError:
            pass
        chunks.append(entry)

    doc = {
        "schema": FRAME_INDEX_SCHEMA, "version": FRAME_INDEX_VERSION,
        "name": name,
        "columns": list(columns) if columns is not None
        else [str(c) for c in df.columns],
        "rows": rows, "chunk_rows": step, "format": "arrow",
        "chunks": chunks,
    }
    # no wall-clock stamp: the index is a function of the frame, so a
    # rewrite (a `resume` replay) is byte-identical
    with atomic_write(index_path, fsync=True) as f:
        json.dump(doc, f, sort_keys=True)
    for i in range(len(chunks), len(prev_chunks)):
        try:
            os.unlink(os.path.join(sdir, _chunk_file(i)))
        except OSError:
            pass
    doc["_stats"] = {"wrote": wrote, "reused": reused, "bytes": n_bytes}
    return doc


def _write_chunk(table, path: str) -> None:
    """One chunk as an uncompressed Arrow IPC file (Feather V2)."""
    import pyarrow as pa

    with pa.OSFile(path, "wb") as sink, \
            pa.ipc.new_file(sink, table.schema) as writer:
        writer.write_table(table)


def _read_chunk(path: str, columns=None):
    """A chunk file as a pyarrow Table, memory-mapped: a projection never
    touches the other columns' buffers."""
    import pyarrow as pa

    with pa.memory_map(path) as source:
        table = pa.ipc.open_file(source).read_all()
    return table.select(columns) if columns is not None else table


def _load_index(index_path: str) -> Optional[dict]:
    try:
        with open(index_path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != FRAME_INDEX_SCHEMA \
            or doc.get("version") != FRAME_INDEX_VERSION:
        return None
    return doc


def delete_frame_store(logdir: str, name: str) -> None:
    """Remove one frame's chunk store (a csv or parquet write must not
    leave a store that readers would take first)."""
    sdir = frame_dir(logdir, name)
    if os.path.isdir(sdir):
        shutil.rmtree(sdir, ignore_errors=True)


def frame_store_names(logdir: str) -> List[str]:
    """The frames with a committed chunk store in the logdir."""
    root = os.path.join(logdir, FRAMES_DIR_NAME)
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    return [n for n in entries
            if os.path.isfile(os.path.join(root, n, FRAME_INDEX_NAME))]


def verify_frame_store(logdir: str, name: str) -> List[str]:
    """Re-hash one frame's committed chunks against their index; returns
    the logdir-relative paths of missing, short or altered chunks.  The
    digest ledger skips ``_frames/``, so this is ``fsck``'s check of it.
    A tail chunk with more rows than its entry (an append before its
    commit) is healthy: only the committed rows are hashed."""
    return verify_chunk_store(frame_dir(logdir, name),
                              "/".join([FRAMES_DIR_NAME, name]))


def verify_chunk_store(sdir: str, rel_prefix: str) -> List[str]:
    """``verify_frame_store`` over any committed store: the damaged
    chunks as ``<rel_prefix>/<file>``."""
    if not columnar_available():
        return []                   # nothing can read the chunks here
    index = _load_index(os.path.join(sdir, FRAME_INDEX_NAME))
    if index is None:
        return []
    bad: List[str] = []
    for c in index.get("chunks") or []:
        rel = "/".join([rel_prefix, c["file"]])
        rows = int(c.get("rows") or 0)
        try:
            tbl = _read_chunk(os.path.join(sdir, c["file"]))
            if tbl.num_rows < rows:
                bad.append(rel)
                continue
            # inside the try, the hash too: rot in a string buffer surfaces
            # as a decode error here (in to_pandas, or in the row hash of
            # invalid UTF-8), not in read_table.  The JAX package hashes
            # outside its try and raises instead of naming the chunk.
            sha = _chunk_sha(_row_hashes(tbl.slice(0, rows).to_pandas()))
        except Exception as e:  # noqa: BLE001 - unreadable is damaged
            print_warning(f"frames: chunk {rel} is unreadable ({e})")
            bad.append(rel)
            continue
        if sha != c.get("sha"):
            bad.append(rel)
    return bad


class FrameHandle:
    """A frame on disk: ``read`` materializes only the requested columns
    of the chunks a time range overlaps."""

    def __init__(self, sdir: str, index: dict):
        self._sdir = sdir
        self.index = index
        self.name = index.get("name") or os.path.basename(sdir)
        self.columns: List[str] = list(index.get("columns") or [])
        self.rows = int(index.get("rows") or 0)
        # one handle may serve several passes on the --jobs pool
        self._guard = Guard("frames.handle_stats", protects=("chunks_read",))
        #: chunks materialized by this handle's reads (skipped ones never
        #: count): the pushdown's evidence
        self.chunks_read = 0

    def __len__(self) -> int:
        return self.rows

    def _select_chunks(self, time_range) -> List[dict]:
        chunks = self.index.get("chunks") or []
        if time_range is None:
            return list(chunks)
        a, b = float(time_range[0]), float(time_range[1])

        def overlaps(c: dict) -> bool:
            lo, hi = c.get("t_min"), c.get("t_max")
            if lo is None or hi is None:
                return True     # unsigned (all-NaN): the row filter decides
            return hi >= a and lo <= b

        return [c for c in chunks if overlaps(c)]

    def read_chunk(self, i: int, columns=None) -> pd.DataFrame:
        """One committed chunk, projected and cut to its signed rows."""
        return self.read_chunk_table(i, columns).to_pandas()

    def read_chunk_table(self, i: int, columns=None):
        """One committed chunk as a pyarrow Table, projected and cut to
        its signed rows."""
        c = (self.index.get("chunks") or [])[i]
        cols = None
        if columns is not None:
            cols = [x for x in columns if x in self.columns]
        tbl = _read_chunk(os.path.join(self._sdir, c["file"]), cols)
        if tbl.num_rows != int(c.get("rows") or 0):
            tbl = tbl.slice(0, int(c.get("rows") or 0))
        with self._guard:
            self.chunks_read += 1
        if cols is not None:
            tbl = tbl.select(cols)
        return tbl

    def read_table(self, columns=None):
        """The committed frame as one pyarrow Table, projected."""
        import pyarrow as pa

        chunks = self.index.get("chunks") or []
        if not chunks:
            cols = ([c for c in columns if c in self.columns]
                    if columns is not None else self.columns)
            return pa.table({c: pa.array([], type=pa.null())
                             for c in cols}) if cols else pa.table({})
        return pa.concat_tables([self.read_chunk_table(i, columns)
                                 for i in range(len(chunks))])

    def read(self, columns=None, time_range=None) -> pd.DataFrame:
        """The frame, or a column and time slice of it.  ``columns`` keeps
        the requested order and drops names the store lacks;
        ``time_range=(a, b)`` keeps rows with ``a <= timestamp <= b``,
        reading only the chunks whose signed range overlaps."""
        import pyarrow as pa

        from sofa_tpu_torch.trace import COLUMNS, empty_frame

        cols = None
        if columns is not None:
            cols = [c for c in columns if c in self.columns]
        want = cols if cols is not None else self.columns
        need_ts = time_range is not None and "timestamp" not in want
        read_cols = (want + ["timestamp"]) if need_ts else want
        chunks = self._select_chunks(time_range)
        if not chunks or not self.rows:
            if self.columns == list(COLUMNS):
                base = empty_frame()    # the schema's exact dtypes
                return base[want] if want else base
            return pd.DataFrame(columns=want or self.columns)
        tables = []
        for c in chunks:
            tbl = _read_chunk(os.path.join(self._sdir, c["file"]),
                              read_cols)
            # the index is the commit point: a tail file may hold more rows
            # than its committed entry
            if tbl.num_rows != int(c.get("rows") or 0):
                tbl = tbl.slice(0, int(c.get("rows") or 0))
            tables.append(tbl)
        with self._guard:
            self.chunks_read += len(tables)
        df = pa.concat_tables(tables).to_pandas()
        if time_range is not None:
            a, b = float(time_range[0]), float(time_range[1])
            ts = df["timestamp"].to_numpy()
            df = df[(ts >= a) & (ts <= b)]
            if need_ts:
                df = df.drop(columns=["timestamp"])
            df = df.reset_index(drop=True)
        return df


def open_frame(logdir: str, name: str) -> Optional[FrameHandle]:
    """A lazy handle on a frame's committed chunk store, or None without
    one.  A store pyarrow cannot serve here is None with a warning: the
    CSV beside it may be the board's downsampled copy."""
    sdir = frame_dir(logdir, name)
    index = _load_index(os.path.join(sdir, FRAME_INDEX_NAME))
    if index is None:
        return None
    if not columnar_available():
        print_warning(
            f"frames: {name} has a columnar store but pyarrow is missing — "
            "falling back to the CSV copy (which may be downsampled)")
        return None
    return FrameHandle(sdir, index)


def open_chunk_store(sdir: str) -> Optional[FrameHandle]:
    """A handle on any committed store by directory, or None."""
    index = _load_index(os.path.join(sdir, FRAME_INDEX_NAME))
    if index is None or not columnar_available():
        return None
    return FrameHandle(sdir, index)


def materialize(value, columns=None) -> pd.DataFrame:
    """A DataFrame from a FrameHandle (a projected read), or an eager
    frame as it is."""
    if isinstance(value, FrameHandle):
        return value.read(columns=columns)
    return value


class ProjectionPool:
    """The analysis registry's materializer: each pass reads its declared
    slice on entry and drops it on exit, with no cache, so analyze's peak
    is the largest slice among the passes running at once, not the sum
    (the page cache shares the mapped chunks)."""

    def __init__(self, frames: Dict[str, object]):
        self.frames = frames
        self.lazy = any(isinstance(v, FrameHandle) for v in frames.values())

    def for_pass(self, reads_frames, reads_columns) -> Dict[str, object]:
        """The frames one pass receives: its declared frames as their
        declared columns; an undeclared frame stays a handle, so that a
        pass reading it fails inside its own fault isolation."""
        if not self.lazy:
            return self.frames
        out: Dict[str, object] = {}
        for name, v in self.frames.items():
            if isinstance(v, FrameHandle) and name in reads_frames:
                out[name] = v.read(
                    columns=list(reads_columns) if reads_columns else None)
            else:
                out[name] = v
        return out
