"""Content-keyed ingest cache: parsed frames beside the logdir (the JAX
package's ``sofa_tpu/ingest/cache.py``).

A source's frames are a pure function of its raw files' bytes, its parser
and the parameters that shape the output, so each source's frames are
cached under ``<logdir>/_ingest_cache/``, keyed on:

  * every raw file's (path, size, mtime_ns); an absent file signs as
    absent, so a source that appears later invalidates cleanly;
  * the source's entry in :data:`PARSER_VERSIONS`: bump it whenever a
    parser's output for the same input changes;
  * the parameters that shape the output (time_base, the strace minimum,
    the GPU utilization window, ...).

On a key match the cached frames load instead of a reparse: parquet, or
pickle where pyarrow is missing (``stats()["formats"]`` says which).  Any
mismatch reparses and overwrites.  ``--no_ingest_cache`` bypasses reads
and writes; ``clean`` removes the directory.

``ChunkStore`` keys the same cache by byte range for ``live`` (``live.py``):
a growing raw file would flip its whole-source key on every append, so each
committed ``[start, end)`` range of a tailed source is parsed once, stored
under ``_live_chunks/<source>/<start>-<end>`` and loaded by every later
epoch and every replay.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Optional

import pandas as pd

from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_info, print_warning

CACHE_DIR_NAME = "_ingest_cache"

# The container format; a bump invalidates every cached source at once.
CACHE_FORMAT = 1

# Per-source parser versions: bump a source's entry whenever its parser's
# output for unchanged input changes.  ``kineto`` is one multi-frame source
# (gputrace, gpusteps, hosttrace and the gpuutil series derived from them).
PARSER_VERSIONS: Dict[str, int] = {
    "mpstat": 1,
    "diskstat": 1,
    "netbandwidth": 1,
    "cpuinfo": 1,
    "vmstat": 1,
    "cputrace": 1,
    "strace": 1,
    "pystacks": 1,
    "nettrace": 1,
    "gpumon": 1,
    "blktrace": 1,
    "kineto": 1,
}


def _file_sig(path: str) -> List:
    """[path, size, mtime_ns]; an absent file signs as (-1, -1)."""
    try:
        st = os.stat(path)
        return [path, int(st.st_size), int(st.st_mtime_ns)]
    except OSError:
        return [path, -1, -1]


def make_key(source: str, raw_paths, params: Optional[dict] = None) -> dict:
    return {
        "format": CACHE_FORMAT,
        "source": source,
        "parser_version": PARSER_VERSIONS.get(source, 0),
        "files": [_file_sig(p) for p in sorted(raw_paths)],
        "params": params or {},
    }


def raw_files_present(key: dict) -> bool:
    """Whether any raw input exists: a source with nothing on disk parses
    to an empty frame at once and is not worth an entry."""
    return any(size >= 0 for _p, size, _m in key["files"])


class IngestCache:
    """One logdir's ingest cache; ``enabled=False`` makes every operation
    a no-op, so ``--no_ingest_cache`` needs no branch in the callers."""

    def __init__(self, root: str, enabled: bool = True):
        self.root = root
        self.enabled = enabled
        # one cache serves every ingest worker
        self._ledger_guard = Guard("ingest_cache.ledgers", protects=(
            "hits", "misses", "stored_bytes", "formats"))
        self.hits: List[str] = []
        self.misses: List[str] = []
        self.stored_bytes: Dict[str, int] = {}
        self.formats: Dict[str, str] = {}

    def _key_path(self, source: str) -> str:
        return os.path.join(self.root, f"{source}.key.json")

    def _frame_path(self, source: str, frame: str, ext: str) -> str:
        return os.path.join(self.root, f"{source}__{frame}{ext}")

    def _miss(self, source: str) -> None:
        with self._ledger_guard:
            self.misses.append(source)

    def load(self, source: str, key: dict) -> Optional[dict]:
        """``{"frames": {name: df}, "meta": {...}}`` on a key match, else
        None; a read problem is a miss."""
        if not self.enabled:
            return None
        try:
            with open(self._key_path(source)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            self._miss(source)
            return None
        if doc.get("key") != key:
            self._miss(source)
            return None
        frames: Dict[str, pd.DataFrame] = {}
        fmt = None
        try:
            for name in doc.get("frames", []):
                pq = self._frame_path(source, name, ".parquet")
                pk = self._frame_path(source, name, ".pkl")
                if os.path.isfile(pq):
                    frames[name], fmt = pd.read_parquet(pq), "parquet"
                elif os.path.isfile(pk):
                    frames[name], fmt = pd.read_pickle(pk), "pickle"
                else:
                    self._miss(source)
                    return None
        except Exception as e:  # noqa: BLE001 - a bad entry is a miss
            print_warning(f"ingest cache: unreadable entry for {source} "
                          f"({e}); reparsing from raw")
            self._miss(source)
            return None
        with self._ledger_guard:
            self.hits.append(source)
            if fmt is not None:
                self.formats[source] = fmt
        return {"frames": frames, "meta": doc.get("meta") or {}}

    def invalidate(self, source: str) -> None:
        """Drop every stored entry of a source: a source whose raw input
        was quarantined must never be served warm (called even when the
        cache is bypassed, since a later cached run would read it)."""
        try:
            os.unlink(self._key_path(source))
        except OSError:
            pass
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if name.startswith(source + "__"):
                try:
                    os.unlink(os.path.join(self.root, name))
                except OSError:
                    pass

    def stats(self) -> dict:
        """The manifest's ``meta.ingest_cache``: which sources hit and
        missed, the bytes stored this run, and each entry's format."""
        return {
            "enabled": self.enabled,
            "hits": sorted(self.hits),
            "misses": sorted(set(self.misses)),
            "stored_bytes": dict(self.stored_bytes),
            "formats": dict(self.formats),
        }

    def chunks(self) -> "ChunkStore":
        """The chunk store ``live`` tails into, enabled as this cache is."""
        return ChunkStore(self.root, enabled=self.enabled)

    def store(self, source: str, key: dict,
              frames: Dict[str, pd.DataFrame],
              meta: Optional[dict] = None) -> None:
        """Persist a parse result; best effort (a read-only logdir must
        not fail preprocess)."""
        if not self.enabled:
            return
        from sofa_tpu_torch.trace import atomic_write

        try:
            os.makedirs(self.root, exist_ok=True)
            stored, fmt = 0, "parquet"
            for name, df in frames.items():
                pq = self._frame_path(source, name, ".parquet")
                pk = self._frame_path(source, name, ".pkl")
                try:
                    df.to_parquet(pq + ".tmp", index=False)
                    os.replace(pq + ".tmp", pq)
                    if os.path.isfile(pk):
                        os.unlink(pk)       # never shadow a fresh parquet
                    stored += os.path.getsize(pq)
                except Exception as e:  # noqa: BLE001 - no pyarrow: pickle
                    if fmt == "parquet":
                        print_info(f"ingest cache: parquet store of "
                                   f"{source}/{name} failed ({e!r}); "
                                   "using pickle")
                    fmt = "pickle"
                    with contextlib.suppress(OSError):
                        os.unlink(pq + ".tmp")
                    df.to_pickle(pk + ".tmp")
                    os.replace(pk + ".tmp", pk)
                    if os.path.isfile(pq):
                        os.unlink(pq)
                    stored += os.path.getsize(pk)
            with self._ledger_guard:
                self.stored_bytes[source] = stored
                self.formats[source] = fmt
            doc = {"key": key, "frames": sorted(frames), "meta": meta or {}}
            # the key last: a crash mid-store leaves a stale key that
            # mismatches, never a key pointing at missing frames
            with atomic_write(self._key_path(source), fsync=True) as f:
                json.dump(doc, f)
        except OSError:
            pass


CHUNK_DIR_NAME = "_live_chunks"


class ChunkStore:
    """The parsed frames of committed byte ranges, under
    ``_ingest_cache/_live_chunks/<source>/``.  Each chunk is written by
    tmp+rename and named by its range, so a replayed epoch overwrites its
    own half-written chunk; the offset ledger (``live.OffsetLedger``) is
    the commit point, and a chunk it does not name is simply parsed
    again.  A chunk that cannot be read is a miss."""

    def __init__(self, root: str, enabled: bool = True):
        self.root = os.path.join(root, CHUNK_DIR_NAME)
        self.enabled = enabled

    def _path(self, source: str, start: int, end: int, ext: str) -> str:
        return os.path.join(self.root, source,
                            f"{int(start):012d}-{int(end):012d}{ext}")

    def store(self, source: str, start: int, end: int,
              df: pd.DataFrame) -> bool:
        """Persist one chunk's frame; best effort (an unwritable logdir
        costs a reparse of the chunk next epoch, never a failed epoch)."""
        if not self.enabled:
            return False
        from sofa_tpu_torch.trace import atomic_replace

        pq = self._path(source, start, end, ".parquet")
        pk = self._path(source, start, end, ".pkl")
        try:
            os.makedirs(os.path.dirname(pq), exist_ok=True)
            try:
                with atomic_replace(pq) as tmp:
                    df.to_parquet(tmp, index=False)
                with contextlib.suppress(OSError):
                    os.unlink(pk)
            except Exception as e:  # noqa: BLE001 - no pyarrow: pickle
                print_info(f"live chunk cache: parquet store of "
                           f"{source}[{start}:{end}] failed ({e!r}); "
                           "using pickle")
                with atomic_replace(pk) as tmp:
                    df.to_pickle(tmp)
            return True
        except OSError:
            return False

    def load(self, source: str, start: int,
             end: int) -> Optional[pd.DataFrame]:
        """A committed chunk's frame, or None (the caller parses the range
        again)."""
        if not self.enabled:
            return None
        from sofa_tpu_torch.trace import _conform

        pq = self._path(source, start, end, ".parquet")
        pk = self._path(source, start, end, ".pkl")
        try:
            if os.path.isfile(pq):
                return _conform(pd.read_parquet(pq))
            if os.path.isfile(pk):
                return _conform(pd.read_pickle(pk))
        except Exception as e:  # noqa: BLE001 - a corrupt chunk is a miss
            print_warning(f"live chunk cache: unreadable chunk "
                          f"{source}[{start}:{end}] ({e!r}); reparsing")
        return None

    def discard(self, source: str, start: int, end: int) -> None:
        """Remove one chunk (a compaction superseded it)."""
        for ext in (".parquet", ".pkl"):
            with contextlib.suppress(OSError):
                os.unlink(self._path(source, start, end, ext))

    def drop(self, source: str) -> None:
        """Forget every chunk of a source (a rotation, a vanished file)."""
        import shutil

        shutil.rmtree(os.path.join(self.root, source), ignore_errors=True)

    def rename(self, old: str, new: str) -> bool:
        """Move a source's chunks to a new name (a raw file renamed while
        it was written); False when there was nothing to move or the move
        failed."""
        src = os.path.join(self.root, old)
        if not os.path.isdir(src):
            return False
        self.drop(new)
        try:
            os.replace(src, os.path.join(self.root, new))
            return True
        except OSError:
            return False
