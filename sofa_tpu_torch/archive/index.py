"""The incremental columnar index over the archive, ``<root>/_index/``
(the JAX package's ``sofa_tpu/archive/index.py``).

Without it every read over the archive is a linear scan: ``archive ls``
parses the whole ``catalog.jsonl``, a rolling ``regress`` baseline does it
again, and a question across runs opens one ``runs/<id>.json`` a run.
Here the catalog and the runs' feature vectors are chunk stores (the
``_frames/`` machinery of frames.py pointed at the archive), kept
tail-aware like live's offset ledger, so that a query is a column scan.

    _index/index_commit.json   THE commit point (schema
                               ``sofa_tpu/archive_index`` v1, fsync'd,
                               written last): the catalog byte offset it
                               covers, the head signature and rewrite
                               generation, event and run totals, and a
                               commit sha over every chunk's hash
    _index/catalog/            every catalog event as columns (run, verb,
                               label, host, logdir, timestamp, bytes,
                               files), in file order
    _index/runs/               the deduped ingest sequence (the newest
                               event a run id, ``ingest_entries`` order)
                               with each run's feature count: ``ls`` and
                               the rolling window read its tail chunks
    _index/features/           runs x features, long form (run, name,
                               value, timestamp), from the run docs at
                               index time, the per-card
                               ``gpu*_sol_distance`` values among them

Each family is a chunk store with its own fsync'd-last
``frame_index.json``, so an append rewrites only the tail chunk and the
archive's fsck re-hashes the committed chunks.

* **Suffix-only refresh**: the commit records the catalog byte offset it
  covers, backed off to the last whole record (live's torn-tail rule); a
  refresh parses the appended suffix only, and one over an unchanged
  catalog parses 0 bytes and touches 0 files.
* **Invalidation**: a gc compaction shows three ways (the size shrank,
  the head signature over the committed prefix changed, ``catalog.gen``
  moved) and triggers a full rebuild, never a stale answer.
* **Derived state**: everything here is re-derived from ``catalog.jsonl``
  and the run docs, so :func:`drop` then :func:`refresh` is always safe,
  and the archive's ``fsck --repair`` does that when a chunk rots.
* **Crash safety**: the families commit one by one and
  ``index_commit.json`` lands last: a SIGKILL mid-refresh leaves the
  previous commit readable, a reader that finds commit and catalog out of
  step scans, and the next refresh (or ``resume``'s replay of the
  journaled ingest) converges to the uninterrupted bytes: the commit
  holds no wall clock.
* **Readers never write**: :func:`query` and the rest serve a current
  index or fall back to the scan; refresh runs at the ingest and gc commit
  points.  ``SOFA_ARCHIVE_INDEX=0`` sends every reader to the scan.

The JAX package's read-replica pins (its tier serves pulled commits with
no local catalog) are not here: the tier is not ported.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import shutil
from typing import Callable, Dict, List, Optional

from sofa_tpu_torch.archive import catalog
from sofa_tpu_torch.printing import print_warning

INDEX_DIR_NAME = "_index"
INDEX_COMMIT_NAME = "index_commit.json"
INDEX_SCHEMA = "sofa_tpu/archive_index"
# Bumps on a breaking change of layout or meaning; added keys do not.
INDEX_VERSION = 1

CATALOG_FAMILY = "catalog"
RUNS_FAMILY = "runs"
FEATURES_FAMILY = "features"
FAMILIES = (CATALOG_FAMILY, RUNS_FAMILY, FEATURES_FAMILY)

#: Column families, schema-pinned like trace.COLUMNS pins the frame
#: store (string columns and float64 columns; absent strings are "",
#: absent numerics NaN).
CATALOG_COLUMNS = ["run", "verb", "label", "host", "logdir",
                   "timestamp", "bytes", "files"]
RUNS_COLUMNS = ["run", "label", "host", "logdir",
                "timestamp", "bytes", "files", "n_features"]
FEATURE_COLUMNS = ["run", "name", "value", "timestamp"]
_STR_COLS = {"run", "verb", "label", "host", "logdir", "name"}

#: Rows per index chunk — sized so a 50k-run catalog stays in a handful
#: of chunks while a newest-N tail read touches exactly one.
INDEX_CHUNK_ROWS = 1 << 14

#: What :func:`offenders` ranks by default: the per-card speed-of-light
#: distances that analysis/sol.py writes (the JAX package's is
#: ``tpu*_sol_distance``).
DEFAULT_OFFENDER_PATTERN = "gpu*_sol_distance"


def _chaos_tick() -> None:
    """``SOFA_INDEX_EXIT_AFTER=<n>`` hard-exits (rc 87) at the start of
    the n-th chunk-store write of this process: a deterministic stand-in
    for a SIGKILL mid-refresh, to prove that a refresh or ``resume``
    converges after one."""
    try:
        n = int(os.environ.get("SOFA_INDEX_EXIT_AFTER", "0"))
    except ValueError:
        n = 0
    if not n:
        return
    count = int(os.environ.get("_SOFA_INDEX_WRITES", "0")) + 1
    os.environ["_SOFA_INDEX_WRITES"] = str(count)
    if count >= n:
        os._exit(87)


def index_dir(root: str) -> str:
    return os.path.join(root, INDEX_DIR_NAME)


def family_dir(root: str, family: str) -> str:
    return os.path.join(root, INDEX_DIR_NAME, family)


def commit_path(root: str) -> str:
    return os.path.join(root, INDEX_DIR_NAME, INDEX_COMMIT_NAME)


def available() -> bool:
    """Whether the index can operate here (pyarrow present) — without it
    every consumer stays on the linear-scan path, stated once."""
    from sofa_tpu_torch import frames

    return frames.columnar_available()


def enabled() -> bool:
    """The consumer-side gate: pyarrow present and not opted out via
    ``SOFA_ARCHIVE_INDEX=0`` (the scan-mode escape hatch tests and
    operators use)."""
    return os.environ.get("SOFA_ARCHIVE_INDEX", "1") != "0" \
        and available()


def load_commit(root: str) -> Optional[dict]:
    """The committed index manifest, or None when there is no readable
    v1 commit (readers then fall back to the linear scan)."""
    try:
        with open(commit_path(root)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != INDEX_SCHEMA \
            or doc.get("version") != INDEX_VERSION:
        return None
    return doc


def is_current(root: str, commit: "dict | None" = None) -> bool:
    """Whether the committed index covers the catalog AS IT IS NOW — the
    read-path gate: queries serve a current index and scan otherwise
    (readers never refresh; ingest/serve commit points do).

    Current means: same rewrite generation, same head signature over the
    committed prefix, and no un-indexed *whole* record appended (a torn
    final line — the mid-append crash — is not yet data)."""
    commit = commit if commit is not None else load_commit(root)
    if commit is None:
        return False
    offset = int(commit.get("catalog_offset") or 0)
    try:
        size = os.path.getsize(catalog.catalog_path(root))
    except OSError:
        size = 0
    if size < offset:
        return False  # the catalog shrank: not the same ledger
    if catalog.generation(root) != commit.get("catalog_gen"):
        return False  # gc compaction bumped the rewrite generation
    if catalog.head_sig(root, offset) != commit.get("catalog_head_sha"):
        return False  # same name, different bytes at the head
    if size == offset:
        return True
    tail = _read_range(catalog.catalog_path(root), offset, size)
    from sofa_tpu_torch.live import whole_records

    return not whole_records(tail or b"")


def _read_range(path: str, start: int, end: int) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            f.seek(start)
            return f.read(max(end - start, 0))
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Building the column families.
# ---------------------------------------------------------------------------

def _parse_events(buf: bytes) -> List[dict]:
    """The suffix parser: JSON events from a whole-records byte range
    (unparsable lines skipped, the catalog reader's rule).  A seam on
    purpose — the suffix-only-refresh test monkeypatches it to raise on
    any byte the commit already covers."""
    out: List[dict] = []
    for line in buf.decode("utf-8", errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
        except ValueError:
            continue
        if isinstance(e, dict):
            out.append(e)
    return out


def _conform_family(df, columns: List[str]):
    """Pin a family frame to its canonical schema and dtypes (strings as
    object/str with "" for absent, numerics as float64 with NaN) — the
    per-chunk content hashes must be a pure function of the DATA, not of
    whichever pandas inference path built the frame."""
    import numpy as np
    import pandas as pd

    out = pd.DataFrame(index=df.index if len(df) else None)
    for c in columns:
        col = df[c] if c in df.columns else None
        if c in _STR_COLS:
            if col is None:
                vals = [""] * len(df)
            else:
                vals = ["" if v is None or (isinstance(v, float)
                                            and v != v) else str(v)
                        for v in col.tolist()]
            out[c] = pd.Series(vals, index=out.index, dtype=object)
        else:
            if col is None:
                out[c] = pd.Series(np.full(len(df), np.nan),
                                   index=out.index, dtype="float64")
            else:
                out[c] = pd.to_numeric(col, errors="coerce").astype(
                    "float64")
    return out


def _event_rows(events: List[dict],
                host_of: Callable[[str], str]) -> "object":
    """Catalog events -> family rows (one per event, file order kept —
    the order ``ingest_entries`` dedup semantics depend on)."""
    import pandas as pd

    rows = []
    for e in events:
        verb = str(e.get("ev") or "?")
        run = e.get("run") if isinstance(e.get("run"), str) else ""
        rows.append({
            "run": run,
            "verb": verb,
            "label": str(e.get("label") or e.get("metric") or ""),
            "host": host_of(run) if verb == "ingest" and run else "",
            "logdir": str(e.get("logdir") or ""),
            "timestamp": e.get("t"),
            "bytes": (e.get("bytes_added") if verb == "ingest"
                      else e.get("freed_bytes") if verb == "gc"
                      else e.get("value")),
            "files": e.get("files"),
        })
    return _conform_family(pd.DataFrame(rows, columns=CATALOG_COLUMNS),
                           CATALOG_COLUMNS)


def _feature_rows(events: List[dict],
                  docs: Dict[str, "dict | None"]) -> "object":
    """New ingest events -> feature-family rows: the run doc's inlined
    feature vector flattened to (run, name, value, t) long form.  Runs
    whose doc is unreadable contribute nothing — exactly the rolling-
    baseline scan's skip rule."""
    import pandas as pd

    rows = []
    for e in events:
        if e.get("ev") != "ingest" or not isinstance(e.get("run"), str):
            continue
        doc = docs.get(e["run"])
        feats = (doc or {}).get("features") or {}
        for name, value in feats.items():
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                rows.append({"run": e["run"], "name": str(name),
                             "value": float(value),
                             "timestamp": e.get("t")})
    return _conform_family(pd.DataFrame(rows, columns=FEATURE_COLUMNS),
                           FEATURE_COLUMNS)


def _runs_rows(ev_all, ft_all) -> "object":
    """The deduped run family from the full event family: newest ingest
    event per run id, ``catalog.ingest_entries`` order EXACTLY (each
    run's first-appearance position breaks timestamp ties — the dict-
    insertion rule of the old per-row loop), plus each run's feature
    count so the rolling-baseline window selection never touches the
    features family.

    Whole-column pandas/NumPy ops throughout: the per-row
    ``to_dict("records")`` round trip this replaces dominated full
    index rebuilds at catalog scale.  An absent timestamp sorts as 0
    (the loop's ``or 0`` rule, now total: NaN keys previously fell
    through ``or`` into undefined float comparisons)."""
    import numpy as np
    import pandas as pd

    ing = ev_all[(ev_all["verb"] == "ingest") & (ev_all["run"] != "")]
    ing = ing.reset_index(drop=True)
    if len(ing):
        # keep-last dedup carries the newest event's values; the sort
        # key pairs (timestamp NaN->0, per-run first-appearance
        # position) — first-position is unique, so the order is total
        first_pos = pd.Series(ing.index, index=ing["run"]) \
            .groupby(level=0, sort=False).first()
        dedup = ing[~ing.duplicated("run", keep="last")]
        order = np.lexsort((
            dedup["run"].map(first_pos).to_numpy(dtype=np.int64),
            np.nan_to_num(dedup["timestamp"].to_numpy(dtype=float),
                          nan=0.0)))
        dedup = dedup.iloc[order]
    else:
        dedup = ing
    out = dedup[["run", "label", "host", "logdir",
                 "timestamp", "bytes", "files"]].copy()
    if len(ft_all):
        dd = ft_all[~ft_all.duplicated(["run", "name"], keep="last")]
        out["n_features"] = out["run"].map(
            dd["run"].value_counts()).fillna(0.0).astype(float)
    else:
        out["n_features"] = 0.0
    return _conform_family(out.reset_index(drop=True), RUNS_COLUMNS)


def _family_frame(root: str, family: str, columns: List[str]):
    """The committed family as a DataFrame (empty, schema-true, when the
    store is missing) — the incremental refresh's load half: committed
    rows LOAD from Arrow chunks, they are never re-parsed from JSON."""
    import pandas as pd

    from sofa_tpu_torch import frames

    handle = frames.open_chunk_store(family_dir(root, family))
    if handle is None:
        return _conform_family(pd.DataFrame(columns=columns), columns)
    return _conform_family(handle.read(), columns)


def _commit_sha(family_docs: Dict[str, dict]) -> str:
    h = hashlib.sha1()
    for family in sorted(family_docs):
        doc = family_docs[family]
        h.update(f"{family}:{doc.get('rows', 0)}\n".encode())
        for c in doc.get("chunks") or []:
            h.update(f"{c.get('sha')}\n".encode())
    return h.hexdigest()


def refresh(root: str, jobs: int = 0) -> Optional[dict]:
    """Refresh (or build) the index; returns the commit doc with a
    transient ``_stats`` key, or None when pyarrow is unavailable (the
    scan path rules, stated by the caller).

    Incremental by construction: a committed, still-valid prefix is
    never re-parsed — only the appended whole-record suffix is — and the
    chunk stores' content keying means an append rewrites only each
    family's tail chunk.  An unchanged catalog returns WITHOUT touching
    any file (0 bytes parsed, untouched mtimes).  Run docs for newly
    ingested runs load on the shared ``--jobs`` pool."""
    from sofa_tpu_torch import frames, pool

    if not available():
        return None
    state_gen = catalog.generation(root)
    commit = load_commit(root)
    cpath = catalog.catalog_path(root)
    try:
        size = os.path.getsize(cpath)
    except OSError:
        size = 0
    full = commit is None
    offset = 0 if full else int(commit.get("catalog_offset") or 0)
    if not full:
        if size < offset \
                or commit.get("catalog_gen") != state_gen \
                or catalog.head_sig(root, offset) \
                != commit.get("catalog_head_sha"):
            # rotation discipline: a compacted/rewritten catalog triggers
            # a full rebuild — never a silently stale suffix parse
            full = True
            offset = 0
    if not full:
        # the commit is the ONLY truth about what the families hold: a
        # refresh killed between a family write and the commit leaves
        # that family AHEAD of the commit, and treating its rows as the
        # committed baseline would double-append the suffix — any
        # disagreement rebuilds from byte 0 (self-healing without fsck)
        for family in FAMILIES:
            fdoc = frames._load_index(os.path.join(
                family_dir(root, family), frames.FRAME_INDEX_NAME))
            want = ((commit.get("families") or {}).get(family)
                    or {}).get("rows")
            if fdoc is None or fdoc.get("rows") != want:
                full = True
                offset = 0
                break

    from sofa_tpu_torch.live import whole_records

    buf = _read_range(cpath, offset, size) if size > offset else b""
    consumed = whole_records(buf or b"")
    if not full and not consumed and commit is not None:
        # warm no-op: nothing new committed to the catalog (at most a
        # torn tail) — parse 0 bytes, rewrite 0 chunks, touch 0 mtimes
        return {**commit, "_stats": {"full": False, "parsed_bytes": 0,
                                     "new_events": 0, "chunks_wrote": 0}}
    new_events = _parse_events(consumed)
    new_offset = offset + len(consumed)

    # run docs for the new ingest events, loaded on the shared pool
    from sofa_tpu_torch.archive.store import ArchiveStore

    store = ArchiveStore(root)
    new_runs = sorted({e["run"] for e in new_events
                       if e.get("ev") == "ingest"
                       and isinstance(e.get("run"), str)})
    n_jobs = pool.resolve_jobs(jobs)
    docs: Dict[str, "dict | None"] = dict(zip(new_runs, pool.thread_map(
        store.load_run, new_runs, n_jobs))) if new_runs else {}

    import pandas as pd

    ev_new = _event_rows(new_events,
                         lambda r: str((docs.get(r) or {})
                                       .get("hostname") or ""))
    ft_new = _feature_rows(new_events, docs)
    if full:
        ev_all, ft_all = ev_new, ft_new
    else:
        # committed rows LOAD from Arrow (already schema-conformed by
        # their write); only the suffix rows were built above — the
        # refresh stays O(suffix parse + column load), no re-conform
        def _grown(old, new):
            if not len(new):
                return old
            if not len(old):
                return new
            return pd.concat([old, new], ignore_index=True)

        ev_all = _grown(_family_frame(root, CATALOG_FAMILY,
                                      CATALOG_COLUMNS), ev_new)
        ft_all = _grown(_family_frame(root, FEATURES_FAMILY,
                                      FEATURE_COLUMNS), ft_new)
    runs_all = _runs_rows(ev_all, ft_all)

    family_docs: Dict[str, dict] = {}
    wrote = 0
    for family, df, cols in ((CATALOG_FAMILY, ev_all, CATALOG_COLUMNS),
                             (RUNS_FAMILY, runs_all, RUNS_COLUMNS),
                             (FEATURES_FAMILY, ft_all, FEATURE_COLUMNS)):
        _chaos_tick()
        doc = frames.write_chunk_store(df, family_dir(root, family),
                                       family, columns=cols,
                                       chunk_rows=INDEX_CHUNK_ROWS)
        wrote += int((doc.get("_stats") or {}).get("wrote", 0))
        family_docs[family] = doc

    n_ingest = int(((ev_all["verb"] == "ingest")
                    & (ev_all["run"] != "")).sum())
    out = {
        "schema": INDEX_SCHEMA, "version": INDEX_VERSION,
        "catalog_offset": int(new_offset),
        "catalog_gen": int(state_gen),
        "catalog_head_sha": catalog.head_sig(root, new_offset),
        "events": int(len(ev_all)),
        "ingest_events": n_ingest,
        "bench_events": int((ev_all["verb"] == "bench").sum()),
        "runs": int(len(runs_all)),
        "features_rows": int(len(ft_all)),
        "commit_sha": _commit_sha(family_docs),
        "families": {
            family: {"rows": int(doc.get("rows") or 0),
                     "chunks": len(doc.get("chunks") or [])}
            for family, doc in family_docs.items()},
    }
    # No wall clock on purpose: the commit is a pure function of the
    # catalog + run docs, so a killed-and-resumed refresh converges
    # byte-identical to a never-interrupted one.
    from sofa_tpu_torch.trace import atomic_write

    with atomic_write(commit_path(root), fsync=True) as f:
        json.dump(out, f, indent=1, sort_keys=True)
    out["_stats"] = {"full": bool(full), "parsed_bytes": len(consumed),
                     "new_events": len(new_events), "chunks_wrote": wrote}
    return out


def refresh_after_ingest(root: str, jobs: int = 0) -> Optional[dict]:
    """The ingest/serve commit-point hook: refresh, degrading to a
    warning on ANY failure — the index is derived state and must never
    be able to fail the write path that feeds it."""
    try:
        return refresh(root, jobs=jobs)
    except Exception as e:  # noqa: BLE001 - derived: degrade, never fail
        print_warning(f"archive index: refresh failed ({e}) — queries "
                      "fall back to the linear scan until the next "
                      "refresh; `archive fsck --repair` rebuilds")
        return None


def drop(root: str) -> None:
    """Remove the index wholesale (fsck --repair's first half; the
    rebuild is a plain :func:`refresh`)."""
    shutil.rmtree(index_dir(root), ignore_errors=True)


def verify(root: str) -> List[str]:
    """Integrity check: re-hash every committed chunk of every family
    against their index-signed shas (frames.verify_chunk_store), and
    flag a commit manifest whose families disagree with the chunk
    stores.  Returns root-relative damage paths; [] when healthy or when
    there is simply no index."""
    from sofa_tpu_torch import frames

    commit = load_commit(root)
    if commit is None:
        if os.path.isdir(index_dir(root)):
            return [f"{INDEX_DIR_NAME}/{INDEX_COMMIT_NAME}"]
        return []
    bad: List[str] = []
    for family in FAMILIES:
        bad.extend(frames.verify_chunk_store(
            family_dir(root, family), f"{INDEX_DIR_NAME}/{family}"))
        want = (commit.get("families") or {}).get(family) or {}
        index_doc = frames._load_index(os.path.join(
            family_dir(root, family), frames.FRAME_INDEX_NAME))
        have_rows = (index_doc or {}).get("rows")
        if index_doc is None or (want and want.get("rows") != have_rows):
            bad.append(f"{INDEX_DIR_NAME}/{family}/"
                       f"{frames.FRAME_INDEX_NAME}")
    return sorted(set(bad))


# ---------------------------------------------------------------------------
# Queries.
# ---------------------------------------------------------------------------

def _open_family(root: str, family: str, commit: "dict | None" = None):
    """(handle, commit) when the index is CURRENT, else (None, None)."""
    commit = commit if commit is not None else load_commit(root)
    if not enabled() or not is_current(root, commit):
        return None, None
    from sofa_tpu_torch import frames

    handle = frames.open_chunk_store(family_dir(root, family))
    return (handle, commit) if handle is not None else (None, None)


def _run_record(rec: dict) -> dict:
    """One runs-family row -> the ``ingest_entries`` event shape (plus
    ``host``), NaN numerics mapped back to absent keys so the shared
    renderer prints byte-identically to the scan path."""
    e = {"ev": "ingest", "run": rec["run"],
         "t": float(rec["timestamp"]),
         "logdir": rec["logdir"], "host": rec["host"]}
    if rec["files"] == rec["files"]:          # not NaN
        e["files"] = int(rec["files"])
    if rec["bytes"] == rec["bytes"]:
        e["bytes_added"] = int(rec["bytes"])
    if rec["label"]:
        e["label"] = rec["label"]
    return e


def run_entries(root: str) -> Optional[List[dict]]:
    """The catalog's full deduped ingest sequence — ``ingest_entries``
    shape and ordering, fed from the pre-deduped runs family (None when
    the index is absent or stale; callers fall back to the scan).  Each
    entry additionally carries ``host`` (from the run doc at index
    time), so a host filter needs no doc opens."""
    handle, _commit = _open_family(root, RUNS_FAMILY)
    if handle is None:
        return None
    return [_run_record(rec) for rec in handle.read().to_dict("records")]


def run_entries_tail(root: str, limit: int,
                     host: "str | None" = None,
                     label: "str | None" = None,
                     since: "float | None" = None
                     ) -> "Optional[tuple]":
    """The newest ``limit`` filtered runs, oldest-first, touching only
    the tail chunks of the runs family that actually contain them —
    O(result), THE `ls --limit` fast path.  Returns (entries,
    total_runs, bench_events) or None when no current index."""
    handle, commit = _open_family(root, RUNS_FAMILY)
    if handle is None:
        return None
    import pandas as pd

    chunks = handle.index.get("chunks") or []
    parts: List[object] = []
    count = 0
    for i in range(len(chunks) - 1, -1, -1):
        df = handle.read_chunk(i)
        mask = pd.Series(True, index=df.index)
        if since is not None:
            mask &= df["timestamp"] >= since
        if label:
            mask &= df["label"] == label
        if host:
            mask &= df["host"] == host
        sub = df[mask]
        parts.insert(0, sub)
        count += len(sub)
        if limit and count >= limit:
            break
    rows = (pd.concat(parts, ignore_index=True) if parts
            else pd.DataFrame(columns=RUNS_COLUMNS))
    if limit:
        rows = rows.iloc[max(len(rows) - limit, 0):]
    entries = [_run_record(rec) for rec in rows.to_dict("records")]
    return entries, int(commit.get("runs") or 0), \
        int(commit.get("bench_events") or 0)


def filter_runs(runs: List[dict], host: "str | None" = None,
                label: "str | None" = None,
                since: "float | None" = None,
                limit: "int | None" = None,
                host_of: "Callable[[str], str] | None" = None
                ) -> List[dict]:
    """The one filter pipeline the scan path (and the full-index path)
    runs — identical inputs MUST yield identical `ls` output, and
    ``run_entries_tail`` applies these exact predicates vectorized.
    ``runs`` is ingest_entries-shaped, oldest first; ``limit`` keeps the
    NEWEST N (order preserved); ``host_of`` lazily resolves a run's host
    when the entries do not carry one (the scan path — this is the
    N-doc-opens cost the index exists to delete)."""
    out = []
    for e in runs:
        if since is not None and float(e.get("t", 0) or 0) < since:
            continue
        if label and (e.get("label") or "") != label:
            continue
        if host:
            h = e["host"] if "host" in e else (
                host_of(e["run"]) if host_of else "")
            if h != host:
                continue
        out.append(e)
    if limit is not None and limit > 0:
        out = out[-limit:]
    return out


def rolling_samples(root: str, rolling: int,
                    exclude_run: "str | None" = None
                    ) -> "Optional[Dict[str, List[float]]]":
    """Index-fed twin of ``baseline.rolling_samples``: per-feature sample
    lists from the newest ``rolling`` indexed runs (oldest first, the run
    under test excluded) — same selection rules, zero run-doc opens and
    O(window) chunk reads.  None when the index is absent/stale (the
    caller scans).

    Window selection walks the runs family backward (``n_features > 0``
    is the has-features rule); the feature rows then come from the
    features family's TAIL chunks — the newest feature-bearing runs'
    rows are by construction the closest to the tail, so the backward
    read stops as soon as every selected run is covered."""
    handle, commit = _open_family(root, RUNS_FAMILY)
    if handle is None:
        return None
    chunks = handle.index.get("chunks") or []
    selected: List[str] = []                 # newest first
    for i in range(len(chunks) - 1, -1, -1):
        # two projected columns per tail chunk: the window selection
        # never touches the rest of the family, let alone a run doc
        df = handle.read_chunk(i, columns=["run", "n_features"])
        sub = df[(df["n_features"] > 0) & (df["run"] != exclude_run)] \
            if exclude_run else df[df["n_features"] > 0]
        take = rolling - len(selected)
        selected.extend(reversed(sub["run"].tolist()[-take:]
                                 if take < len(sub)
                                 else sub["run"].tolist()))
        if len(selected) >= rolling:
            break
    if not selected:
        return {}
    from sofa_tpu_torch import frames

    fhandle = frames.open_chunk_store(family_dir(root, FEATURES_FAMILY))
    if fhandle is None:
        return None
    import pandas as pd

    # phase 1: find the minimal tail-chunk range covering the window by
    # reading only the run column; phase 2: materialize exactly those
    # chunks and slice the window's rows out
    needed = set(selected)
    fchunks = fhandle.index.get("chunks") or []
    seen: set = set()
    lo = len(fchunks)
    for i in range(len(fchunks) - 1, -1, -1):
        lo = i
        seen.update(fhandle.read_chunk(i, columns=["run"])
                    ["run"].unique())
        if needed <= seen:
            break
    parts = [fhandle.read_chunk(i) for i in range(lo, len(fchunks))]
    buf = (pd.concat(parts, ignore_index=True) if parts
           else pd.DataFrame(columns=FEATURE_COLUMNS))
    if len(buf):
        buf = buf[buf["run"].isin(needed)]
        # a re-ingested run's newest rows are nearest the tail: within
        # the buffer keep-last is exactly the newest-event-wins rule
        buf = buf[~buf.duplicated(["run", "name"], keep="last")]
    # whole-column regroup (the per-row records loop this replaces was
    # the O(window * features) hot spot): a stable sort by each row's
    # window rank orders the buffer newest run first while keeping the
    # family's row order within a run, so per-name value lists reversed
    # read oldest first — exactly the nested selected/by_run loops
    rank = {run_id: i for i, run_id in enumerate(selected)}
    out: Dict[str, List[float]] = {}
    if len(buf):
        buf = buf.iloc[buf["run"].map(rank).argsort(kind="stable")]
        for name, grp in buf.groupby("name", sort=False)["value"]:
            out[name] = grp.tolist()[::-1]   # oldest first, for readers
    return out


def _runs_meta(root: str, commit: dict,
               run_ids: set) -> Dict[str, dict]:
    """Provenance rows (t, host, label, logdir) for a SET of runs —
    O(result): one projected run-column read locates the rows, then only
    the chunks that hold them materialize."""
    handle, _c = _open_family(root, RUNS_FAMILY, commit)
    if handle is None or not run_ids:
        return {}
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    # hash-join membership (pc.is_in), NOT np.isin: the run column is
    # strings, and numpy's object-dtype isin degrades to an O(rows*ids)
    # scan over a catalog of many runs
    vset = pa.array(sorted(run_ids))
    mask = pc.is_in(handle.read_table(columns=["run"])["run"],
                    value_set=vset)
    step = int(handle.index.get("chunk_rows") or INDEX_CHUNK_ROWS)
    hits = np.nonzero(mask.to_numpy(zero_copy_only=False))[0]
    meta: Dict[str, dict] = {}
    for ci in sorted({int(p) // step for p in hits}):
        # filter in Arrow, THEN materialize — to_pandas on the matched
        # rows only, not the whole chunk (to_pandas keeps the family's
        # null->NaN convention, so the row dicts are unchanged)
        tbl = handle.read_chunk_table(ci)
        sub = tbl.filter(pc.is_in(tbl["run"], value_set=vset))
        for rec in sub.to_pandas().to_dict("records"):
            meta[rec["run"]] = rec
    return meta


def _offender_page(root: str, pattern: str, offset: int,
                   limit: int) -> "Optional[tuple]":
    """(total, page rows) of the worst-offender ranking, index-fed —
    ordered by (-value, run, name) like the scan twin.  The whole scan
    runs as Arrow compute kernels; python objects materialize only for
    the boundary tie group and the final page."""
    import numpy as np

    handle, commit = _open_family(root, FEATURES_FAMILY)
    if handle is None:
        return None
    tbl = handle.read_table(columns=["run", "name", "value"])
    if tbl.num_rows:
        import pyarrow as pa
        import pyarrow.compute as pc

        # fnmatch the UNIQUE names (dozens), then one is_in kernel over
        # the rows — no per-row python
        names = pc.unique(tbl["name"]).to_pylist()
        keep = [n for n in names if fnmatch.fnmatchcase(n, pattern)]
        tbl = tbl.filter(pc.is_in(tbl["name"],
                                  value_set=pa.array(keep or [""])))
    if tbl.num_rows and commit.get("ingest_events") != commit.get("runs"):
        # only a catalog with re-ingested runs can carry duplicate
        # (run, name) rows — the rare path pays the pandas dedup
        df = tbl.to_pandas()
        tbl = None
        df = df[~df.duplicated(["run", "name"], keep="last")]
        vals = df["value"].to_numpy()
    else:
        df = None
        vals = (tbl["value"].to_numpy() if tbl.num_rows
                else np.empty(0))
    total = int(len(vals))
    if not total:
        return 0, []
    want = min(offset + limit, total) if limit else total
    if want and want < total:
        kth = np.partition(vals, total - want)[total - want]
        mask = vals >= kth
        cand = (df[mask] if df is not None
                else tbl.filter(mask).to_pandas())
    else:
        cand = df if df is not None else tbl.to_pandas()
    ranked = sorted(cand.to_dict("records"),
                    key=lambda r: (-r["value"], r["run"], r["name"]))
    page = ranked[offset:offset + limit] if limit else ranked[offset:]
    # join the run's provenance for the PAGE rows only — O(result)
    meta = _runs_meta(root, commit, {r["run"] for r in page})
    rows = [{"run": r["run"], "name": r["name"],
             "value": float(r["value"]),
             "t": float((meta.get(r["run"]) or {}).get("timestamp")
                        or 0.0),
             "host": (meta.get(r["run"]) or {}).get("host", ""),
             "label": (meta.get(r["run"]) or {}).get("label", ""),
             "logdir": (meta.get(r["run"]) or {}).get("logdir", "")}
            for r in page]
    return total, rows


def offenders(root: str, pattern: str = DEFAULT_OFFENDER_PATTERN,
              limit: int = 20) -> Optional[List[dict]]:
    """The worst-offender ranking, index-fed: (run,
    feature) rows ranked by value descending — sol distance is "how far
    from the speed of light", higher is worse.  None when no current
    index (callers fall back to :func:`offenders_scan`)."""
    page = _offender_page(root, pattern, 0, limit)
    return None if page is None else page[1]


def offenders_scan(store, pattern: str = DEFAULT_OFFENDER_PATTERN,
                   limit: int = 20) -> List[dict]:
    """The linear-scan twin of :func:`offenders` — one run-doc open per
    run, O(runs).  The fallback when no index exists."""
    runs = catalog.ingest_entries(catalog.read_catalog(store.root))
    rows = []
    for e in runs:
        doc = store.load_run(e.get("run"))
        if doc is None:
            continue
        for name, value in (doc.get("features") or {}).items():
            if not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                continue
            if not fnmatch.fnmatchcase(str(name), pattern):
                continue
            rows.append({"run": e["run"], "name": str(name),
                         "value": float(value),
                         "t": float(e.get("t", 0) or 0),
                         "host": str(doc.get("hostname") or ""),
                         "label": str(e.get("label") or ""),
                         "logdir": str(e.get("logdir") or "")})
    rows.sort(key=lambda r: (-r["value"], r["run"], r["name"]))
    return rows[:max(int(limit), 0)] if limit else rows


# ---------------------------------------------------------------------------
# The query surface (the JAX package's fleet service serves it as
# ``/v1/<tenant>/query``).
# ---------------------------------------------------------------------------

#: Pagination bounds for the served query endpoint.
QUERY_DEFAULT_LIMIT = 50
QUERY_MAX_LIMIT = 500


def query(root: str, kind: str = "runs", host: "str | None" = None,
          label: "str | None" = None, since: "float | None" = None,
          feature: "str | None" = None, limit: int = QUERY_DEFAULT_LIMIT,
          offset: int = 0) -> dict:
    """The query API: filter/sort/limit/since over runs and
    features, index-fed with a linear-scan fallback (``source`` states
    which answered).  Returns::

        {"kind", "total", "offset", "limit", "rows", "source",
         "commit_sha"}       # commit_sha None on the scan path

    ``kind="runs"``: newest-first deduped ingest runs, filtered by
    host/label/since.  ``kind="features"``: per-(run, feature) rows
    matched by the fnmatch ``feature`` pattern, worst value first (the
    board's offender ranking).  Pagination slices AFTER filtering, so
    ``total`` is the filtered population."""
    limit = max(1, min(int(limit or QUERY_DEFAULT_LIMIT),
                       QUERY_MAX_LIMIT))
    offset = max(int(offset or 0), 0)
    commit = load_commit(root)
    fresh = enabled() and is_current(root, commit)
    commit_sha = (commit or {}).get("commit_sha") if fresh else None

    if kind == "features":
        pattern = feature or "*"
        paged = None
        if fresh and not (host or label or since is not None):
            paged = _offender_page(root, pattern, offset, limit)
        if paged is not None:
            total, rows = paged
            return {"kind": kind, "total": total, "offset": offset,
                    "limit": limit, "rows": rows, "source": "index",
                    "commit_sha": commit_sha}
        # filtered (or index-less) ranking: the full row set is needed
        # for an honest total anyway
        rows = offenders(root, pattern=pattern, limit=0) if fresh \
            else None
        source = "index"
        if rows is None:
            from sofa_tpu_torch.archive.store import ArchiveStore

            rows = offenders_scan(ArchiveStore(root), pattern=pattern,
                                  limit=0)
            source = "scan"
            commit_sha = None
        if host:
            rows = [r for r in rows if r.get("host") == host]
        if label:
            rows = [r for r in rows if r.get("label") == label]
        if since is not None:
            rows = [r for r in rows if r.get("t", 0) >= since]
        return {"kind": kind, "total": len(rows), "offset": offset,
                "limit": limit, "rows": rows[offset:offset + limit],
                "source": source, "commit_sha": commit_sha}

    runs = run_entries(root) if fresh else None
    source = "index"
    host_of = None
    if runs is None:
        from sofa_tpu_torch.archive.store import ArchiveStore

        store = ArchiveStore(root)
        runs = catalog.ingest_entries(catalog.read_catalog(root))
        source = "scan"
        commit_sha = None

        def host_of(run_id):  # noqa: E306 — the scan path's doc lookup
            return str((store.load_run(run_id) or {})
                       .get("hostname") or "")

    rows = filter_runs(runs, host=host, label=label, since=since,
                       host_of=host_of)
    rows = list(reversed(rows))              # newest first for the API
    return {"kind": "runs", "total": len(rows), "offset": offset,
            "limit": limit, "rows": rows[offset:offset + limit],
            "source": source, "commit_sha": commit_sha}
