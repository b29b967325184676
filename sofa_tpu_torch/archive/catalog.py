"""The archive's append-only run catalog, ``catalog.jsonl`` (the JAX
package's ``sofa_tpu/archive/catalog.py``).

One JSON line an event, each appended and fsync'd by ``fsync_append``
(the run journal's discipline): a crash mid-append leaves at worst one torn
last line, which :func:`read_catalog` skips.  The events::

    {"ev": "ingest", "run": <run_id>, "t": ..., "logdir": ..., "files": N,
     "new_objects": M, "bytes_added": B, "label": ...}
    {"ev": "bench",  "metric": ..., "value": ..., "t": ..., "round": ...}
    {"ev": "gc",     "t": ..., "dropped_runs": N, "swept_objects": M,
     "freed_bytes": B}

The catalog holds the ORDER of the runs (rolling baselines read it newest
last); a run's content is its ``runs/<run_id>.json``.  Re-ingesting a run
appends another ingest line for the same id and readers keep the newest,
so the file only grows: ``archive gc`` is the one compaction.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

from sofa_tpu_torch.archive import CATALOG_NAME

#: The rewrite generation (``catalog.gen``), bumped by every
#: :func:`rewrite`, so that the columnar index (index.py) detects a gc
#: compaction for certain: one that keeps the head bytes and grows the
#: file back past the index's committed offset would pass the size and
#: head checks alone.
GEN_NAME = "catalog.gen"

#: Bytes of the catalog's head that the index commit signs: another head
#: under the same path is a rewritten ledger, not an append.
HEAD_SIG_BYTES = 256


def catalog_path(root: str) -> str:
    return os.path.join(root, CATALOG_NAME)


def generation(root: str) -> int:
    """The catalog's rewrite generation (0 until the first rewrite)."""
    try:
        with open(os.path.join(root, GEN_NAME)) as f:
            doc = json.load(f)
        return int(doc.get("gen", 0))
    except (OSError, ValueError, TypeError, AttributeError):
        return 0


def head_sig(root: str, length: Optional[int] = None) -> str:
    """sha1 of the catalog's first ``min(HEAD_SIG_BYTES, length)`` bytes
    (HEAD_SIG_BYTES when ``length`` is None).  The index signs its own
    committed prefix's head, so an append past a short catalog never
    looks like a rewrite, nor a rewrite of the same size like an
    append."""
    n = HEAD_SIG_BYTES if length is None else min(HEAD_SIG_BYTES,
                                                  max(int(length), 0))
    try:
        with open(catalog_path(root), "rb") as f:
            return hashlib.sha1(f.read(n)).hexdigest()
    except OSError:
        return hashlib.sha1(b"").hexdigest()


def append_event(root: str, ev: str, **fields) -> dict:
    """Append one event line, fsync'd; returns the entry written."""
    from sofa_tpu_torch.trace import fsync_append

    entry = {"ev": ev, "t": round(time.time(), 3), **fields}
    fsync_append(catalog_path(root),
                 json.dumps(entry, separators=(",", ":")) + "\n")
    return entry


def read_catalog(root: str) -> List[dict]:
    """Every parseable event in file order (oldest first).  A torn last
    line, or any line that does not parse, is skipped, as the run
    journal's reader does."""
    entries: List[dict] = []
    try:
        with open(catalog_path(root)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue            # the torn tail of a killed append
                if isinstance(e, dict):
                    entries.append(e)
    except OSError:
        return []
    return entries


def ingest_entries(entries: List[dict]) -> List[dict]:
    """The ingest events, one per run id (the newest), oldest first: the
    run sequence rolling baselines walk."""
    latest: Dict[str, dict] = {}
    for e in entries:
        run = e.get("run")
        if e.get("ev") == "ingest" and isinstance(run, str):
            latest[run] = e
    return sorted(latest.values(), key=lambda e: e.get("t", 0))


def bench_entries(entries: List[dict],
                  metric: Optional[str] = None) -> List[dict]:
    """The bench events, oldest first, of one metric or all.  ``archive
    ls`` counts them; no writer of the port appends them yet."""
    out = [e for e in entries if e.get("ev") == "bench"
           and (metric is None or e.get("metric") == metric)]
    return sorted(out, key=lambda e: e.get("t", 0))


def rewrite(root: str, entries: List[dict]) -> None:
    """Replace the catalog atomically: gc's compaction, the one writer
    that does not append.

    Holds the root's ``derived_write_guard`` across the replace (it is
    reentrant: ``archive gc`` holds it around the whole sweep), so that a
    reader sees the mid-write signal instead of racing the swap, and
    bumps the rewrite generation, so that the index invalidates."""
    from sofa_tpu_torch import trace

    with trace.derived_write_guard(root):
        with trace.atomic_write(catalog_path(root), fsync=True) as f:
            for e in entries:
                f.write(json.dumps(e, separators=(",", ":")) + "\n")
        with trace.atomic_write(os.path.join(root, GEN_NAME),
                                fsync=True) as f:
            json.dump({"gen": generation(root) + 1}, f)
