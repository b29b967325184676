"""The content-addressed object store, the run docs and the ``archive``
verb (the JAX package's ``sofa_tpu/archive/store.py``).

An ingest walks the logdir's sha256 digests (durability.py; computed on
the spot where a logdir has none), stores each artifact once under
``objects/<aa>/<sha256>``, and lands the run's doc in
``runs/<run_id>.json`` and one fsync'd catalog line.  The dedup comes from
the pipeline's determinism: tiles are gzip'd with ``mtime=0`` and frames
are written by a deterministic columnar writer, so two runs over
unchanged inputs share every object and the second ingest costs one
catalog line.

Unlike the JAX package, an ingest also stores each committed chunk store
under ``_frames/`` (its ``frame_index.json`` and its chunks): the digests
skip ``_frames/``, and in a columnar logdir ``<name>.csv`` is the board's
downsampled copy, so without them the archive would not hold the run's
frames.  A logdir without a chunk store gets the JAX package's run id.

Crash safety is the logdir pipeline's: objects and run docs land by
tmp+rename (deterministic ``.tmp`` names, so a replay overwrites a
crash's leftovers), the catalog line is the commit point, and the ingest
is journaled in the LOGDIR's journal (``resume`` replays an uncommitted
``archive`` stage).  ``archive_fsck`` checks the store: every object
re-hashes to its name, every run doc's references exist, and a run doc
the catalog never committed is re-adopted by ``--repair``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
import time
from typing import Dict, List, Optional, Tuple

from sofa_tpu_torch.archive import (
    ARCHIVE_MARKER_NAME,
    ARCHIVE_SCHEMA,
    ARCHIVE_VERSION,
    OBJECTS_DIR_NAME,
    QUARANTINE_DIR_NAME,
    RUNS_DIR_NAME,
    catalog,
)
from sofa_tpu_torch.printing import (
    print_error,
    print_progress,
    print_title,
    print_warning,
)

RUN_SCHEMA = "sofa_tpu/archive_run"
RUN_VERSION = 1

_HASH_CHUNK = 1 << 20

# fsck's verdicts over the store, in the order they are printed.  ``corrupt``
# (object bytes no longer hash to its name), ``missing`` (a run doc
# references an absent object), ``orphaned`` (``*.tmp`` leftovers of an
# interrupted write), ``uncataloged`` (a run doc the catalog never
# committed — recoverable: --repair re-appends its ingest line),
# ``index`` (a columnar-index chunk whose bytes stopped matching its
# index-signed sha — pure derived state: --repair drops + rebuilds it).
# ``unreferenced`` objects (no surviving run points at them) are reported
# but are NOT damage: they are what `archive gc` exists to sweep.
# ``fleet`` is the JAX package's check of the fleet-pass tier (_fleet/),
# which is not ported: it stays a key, so that both packages' reports have
# the same keys, and stays empty (a present _fleet/ is reported unchecked).
ARCHIVE_FSCK_VERDICTS = ("corrupt", "missing", "orphaned", "uncataloged",
                         "index", "fleet")


class ArchiveStore:
    """One archive root.  ``create=True`` initializes the marker/dirs."""

    def __init__(self, root: str, create: bool = False):
        self.root = root
        self.marker_path = os.path.join(root, ARCHIVE_MARKER_NAME)
        if create and not os.path.isfile(self.marker_path):
            self._init_root()

    def _init_root(self) -> None:
        os.makedirs(os.path.join(self.root, OBJECTS_DIR_NAME), exist_ok=True)
        os.makedirs(os.path.join(self.root, RUNS_DIR_NAME), exist_ok=True)
        import threading

        # writer-unique stage + first-writer-wins rename: pool workers
        # (and their handler threads) creating the same tenant root
        # concurrently must not tear each other's marker — every loser's
        # marker said the same thing anyway
        stage = (f"{self.marker_path}.{os.getpid()}"
                 f".{threading.get_ident()}.tmp")
        # not atomic_write: its fixed .tmp name is the race avoided here
        with open(stage, "w") as f:
            json.dump({"schema": ARCHIVE_SCHEMA, "version": ARCHIVE_VERSION,
                       "created_unix": round(time.time(), 3)}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            if os.path.isfile(self.marker_path):
                os.unlink(stage)
            else:
                os.replace(stage, self.marker_path)
        except OSError:
            pass

    @property
    def exists(self) -> bool:
        return os.path.isfile(self.marker_path)

    # -- objects -----------------------------------------------------------
    def object_path(self, sha: str) -> str:
        return os.path.join(self.root, OBJECTS_DIR_NAME, sha[:2], sha)

    def has_object(self, sha: str) -> bool:
        return os.path.isfile(self.object_path(sha))

    def put_file(self, src: str,
                 expected_sha: Optional[str] = None) -> Tuple[str, int]:
        """Store ``src``'s bytes; returns (sha256, bytes_added).

        Dedup fast path: when the caller's digest-ledger sha is trusted
        and the object already exists, nothing is read at all.  Otherwise
        the bytes are hashed while staging into a deterministic ``.tmp``
        beside the object (a crashed ingest's leftover is simply
        overwritten by the replay), then renamed in."""
        if expected_sha and self.has_object(expected_sha):
            return expected_sha, 0
        h = hashlib.sha256()
        stage = self.object_path(expected_sha or "xx/staging") + ".tmp"
        os.makedirs(os.path.dirname(stage), exist_ok=True)
        size = 0
        # not atomic_write: the path is unknown until the bytes are hashed
        with open(src, "rb") as fin, open(stage, "wb") as fout:
            while True:
                chunk = fin.read(_HASH_CHUNK)
                if not chunk:
                    break
                h.update(chunk)
                fout.write(chunk)
                size += len(chunk)
            fout.flush()
            os.fsync(fout.fileno())
        sha = h.hexdigest()
        dest = self.object_path(sha)
        if os.path.isfile(dest):
            os.unlink(stage)
            return sha, 0
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        os.replace(stage, dest)
        return sha, size

    def put_bytes(self, blob: bytes) -> Tuple[str, int]:
        """Store an in-memory blob; returns (sha256, bytes_added).

        Staged under a pid-unique ``.tmp`` (fsck still classifies it as
        an orphan, never damage): two writers storing the SAME object at
        once each stage privately and the renames converge on identical
        bytes — no fixed-name collision."""
        sha = hashlib.sha256(blob).hexdigest()
        dest = self.object_path(sha)
        if os.path.isfile(dest):
            return sha, 0
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        stage = f"{dest}.{os.getpid()}.tmp"
        # not atomic_write: its fixed .tmp name would collide across
        # writers storing the same object
        with open(stage, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(stage, dest)
        return sha, len(blob)

    def read_object(self, sha: str) -> Optional[bytes]:
        try:
            with open(self.object_path(sha), "rb") as f:
                return f.read()
        except OSError:
            return None

    # -- run docs ----------------------------------------------------------
    def run_doc_path(self, run_id: str) -> str:
        return os.path.join(self.root, RUNS_DIR_NAME, f"{run_id}.json")

    def load_run(self, run_id: str) -> Optional[dict]:
        try:
            with open(self.run_doc_path(run_id)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def run_ids(self) -> List[str]:
        try:
            names = os.listdir(os.path.join(self.root, RUNS_DIR_NAME))
        except OSError:
            return []
        return sorted(n[:-5] for n in names
                      if n.endswith(".json") and len(n) == 69)

    def resolve_run_id(self, prefix: str) -> Optional[str]:
        """Full run id from a unique prefix (>= 6 chars), else None."""
        if len(prefix) < 6:
            return None
        hits = [r for r in self.run_ids() if r.startswith(prefix)]
        return hits[0] if len(hits) == 1 else None

    def extract(self, run_id: str, dest: str) -> int:
        """Materialize an archived run's files under ``dest`` (tooling /
        tests); returns the file count."""
        doc = self.load_run(run_id)
        if doc is None:
            raise FileNotFoundError(f"no archived run {run_id}")
        n = 0
        for rel, ent in sorted((doc.get("files") or {}).items()):
            blob = self.read_object(ent.get("sha256", ""))
            if blob is None:
                print_warning(f"archive: object for {rel} is missing — "
                              "skipped in extract (run `fsck` on the "
                              "archive root)")
                continue
            path = os.path.join(dest, rel)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            from sofa_tpu_torch.trace import atomic_write

            with atomic_write(path, "wb") as f:
                f.write(blob)
            n += 1
        return n


def run_content_id(files: Dict[str, dict]) -> str:
    """The run id: sha256 over the sorted (rel, sha256) content map — a
    content address, so an unchanged logdir re-ingests to the same id."""
    h = hashlib.sha256()
    for rel in sorted(files):
        h.update(f"{rel}\0{files[rel]['sha256']}\n".encode())
    return h.hexdigest()


#: The kind of a chunk-store file in a run doc (the digests' kinds are
#: ``raw`` and ``derived``).
FRAME_KIND = "frame"


def _frame_store_files(logdir: str) -> List[str]:
    """The logdir-relative files of its committed chunk stores: each
    store's ``frame_index.json`` and the chunks it names."""
    from sofa_tpu_torch import frames

    out: List[str] = []
    for name in frames.frame_store_names(logdir):
        rel = "/".join([frames.FRAMES_DIR_NAME, name])
        index = frames._load_index(os.path.join(
            frames.frame_dir(logdir, name), frames.FRAME_INDEX_NAME))
        if index is None:
            continue
        out.append(f"{rel}/{frames.FRAME_INDEX_NAME}")
        out += [f"{rel}/{c['file']}" for c in index.get("chunks") or []]
    return out


def _read_features_csv(path: str) -> Dict[str, float]:
    """features.csv (name,value) -> dict; latest value wins, like
    Features.get.  Missing/unparsable file -> {}."""
    import csv

    out: Dict[str, float] = {}
    try:
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                try:
                    out[str(row["name"])] = float(row["value"])
                except (KeyError, ValueError, TypeError):
                    continue
    except OSError:
        return {}
    return out


def ingest_run(cfg, root: str, label: str = "",
               tel=None) -> dict:
    """Ingest ``cfg.logdir`` into the archive at ``root``.

    Returns the catalog summary ``{"run", "files", "new_objects",
    "bytes_added", "wall_s"}``.  Journaled in the logdir's run journal
    (stage ``archive``) so `resume` replays a killed ingest."""
    from sofa_tpu_torch import durability
    from sofa_tpu_torch.trace import atomic_write

    logdir = cfg.logdir
    t0 = time.perf_counter()
    store = ArchiveStore(root, create=True)
    journal = durability.Journal(logdir)
    journal.begin("archive", key=durability.logdir_raw_key(logdir),
                  archive_root=os.path.abspath(root))

    from sofa_tpu_torch.telemetry import maybe_span

    with maybe_span("archive_scan", cat="stage"):
        ledger = durability.load_digests(logdir)
        if ledger is None:
            ledger = durability.compute_digests(logdir)
        targets: Dict[str, dict] = dict(ledger.get("files") or {})

    files: Dict[str, dict] = {}
    new_objects = 0
    bytes_added = 0

    def store_file(rel: str, expected: Optional[str], kind: str) -> None:
        nonlocal new_objects, bytes_added
        path = os.path.join(logdir, rel)
        try:
            size = os.path.getsize(path)
            sha, added = store.put_file(path, expected)
        except OSError as e:
            print_warning(f"archive: cannot store {rel}: {e} — "
                          "skipped (the run doc will not reference it)")
            return
        files[rel] = {"sha256": sha, "bytes": int(size), "kind": kind}
        if added:
            new_objects += 1
            bytes_added += added

    with maybe_span("archive_objects", cat="stage"):
        for rel, ent in sorted(targets.items()):
            try:
                st = os.stat(os.path.join(logdir, rel))
            except OSError:
                continue  # vanished since the ledger: nothing to archive
            # the digest's sha is trusted while size and mtime still match
            expected = ent.get("sha256") if (
                st.st_size == ent.get("bytes")
                and st.st_mtime_ns == ent.get("mtime_ns")) else None
            store_file(rel, expected,
                       ent.get("kind") or ("raw" if durability._is_raw(rel)
                                           else "derived"))
        # the chunk stores, which the digests skip: hashed first, so that
        # a chunk the store already holds is read once and never copied
        for rel in _frame_store_files(logdir):
            store_file(rel, _sha256_file(os.path.join(logdir, rel)),
                       FRAME_KIND)
        # The run manifest is the health record of the run — archive it
        # too (the digest ledger skips it by design), but NORMALIZED: the
        # archive/regress verbs' own sections and the per-write timestamp
        # are stripped, so the act of archiving can never change the next
        # ingest's content (re-ingest must stay a pure catalog append).
        blob = _normalized_manifest(logdir)
        if blob is not None:
            from sofa_tpu_torch.telemetry import MANIFEST_NAME

            sha, added = store.put_bytes(blob)
            files[MANIFEST_NAME] = {"sha256": sha, "bytes": len(blob),
                                    "kind": "derived"}
            if added:
                new_objects += 1
                bytes_added += added

    run_id = run_content_id(files)
    features = _read_features_csv(os.path.join(logdir, "features.csv"))
    doc = {
        "schema": RUN_SCHEMA, "version": RUN_VERSION,
        "run": run_id, "t": round(time.time(), 3),
        "logdir": os.path.abspath(logdir),
        "hostname": _hostname(),
        "label": label or "",
        "files": files,
        "features": features,
    }
    with maybe_span("archive_commit", cat="stage"):
        prev = store.load_run(run_id)
        if prev is None or prev.get("files") != files:
            with atomic_write(store.run_doc_path(run_id), fsync=True) as f:
                json.dump(doc, f, indent=1, sort_keys=True)
        # The catalog line is the ingest's commit point: fsck adopts a
        # run doc whose append never landed.
        catalog.append_event(root, "ingest", run=run_id,
                             logdir=os.path.abspath(logdir),
                             files=len(files), new_objects=new_objects,
                             bytes_added=bytes_added,
                             **({"label": label} if label else {}))
    # Ingest commit point = index refresh point (archive/index.py): the
    # suffix-only parse folds exactly this ingest's catalog line in.  It
    # runs INSIDE the journaled archive stage, so a kill mid-refresh
    # leaves the stage uncommitted and `resume` replays ingest +
    # refresh to the identical bytes (the commit doc carries no clock).
    from sofa_tpu_torch import pool
    from sofa_tpu_torch.archive import index as aindex

    with maybe_span("archive_index", cat="stage"):
        idx = aindex.refresh_after_ingest(root, jobs=pool.cfg_jobs(cfg))
    journal.commit("archive", key=durability.logdir_raw_key(logdir),
                   run=run_id)
    summary = {"run": run_id, "files": len(files),
               "new_objects": new_objects, "bytes_added": bytes_added,
               "wall_s": round(time.perf_counter() - t0, 3)}
    if idx is not None:
        summary["index"] = {"runs": idx.get("runs"),
                            "events": idx.get("events"),
                            **(idx.get("_stats") or {})}
    if tel is not None:
        tel.set_meta(archive={**summary, "root": os.path.abspath(root)})
    print_progress(
        f"archive: run {run_id[:12]} — {len(files)} file(s), "
        f"{new_objects} new object(s), {bytes_added / 2**20:.2f} MiB added "
        f"-> {root}")
    return summary


# Verbs whose manifest sections describe ARCHIVING/SHIPPING the run
# rather than the run itself: stripped by normalization so that
# archiving, re-archiving, or the agent stamping meta.agent/meta.serve
# can never change the next ingest's content address ("serve",
# "metrics", "slo", "health", and "backup" appear only as meta keys —
# the ack's observability fold, the client's failover picture, and the
# backup receipt — but the strip loops cover both namespaces).
_SELF_VERBS = ("archive", "regress", "agent", "serve", "tier",
               "metrics", "slo", "health", "backup")


def _normalized_manifest(logdir: str) -> Optional[bytes]:
    """run_manifest.json reduced to canonical bytes that are a pure
    function of the RUN: the archive/regress self-sections, the per-write
    timestamp, and the last-writer-wins ``env``/``config`` snapshots
    (pid, the writing verb's own flags) are stripped — so archiving a
    run, or re-archiving it, can never change what the next ingest sees.
    The health ledger itself (collectors, sources, pipeline runs, stages)
    is what the archive preserves."""
    from sofa_tpu_torch.telemetry import load_manifest

    doc = load_manifest(logdir)
    if doc is None:
        return None
    for volatile in ("generated_unix", "env", "config"):
        doc.pop(volatile, None)
    runs = doc.get("runs")
    if isinstance(runs, dict):
        for verb in _SELF_VERBS:
            runs.pop(verb, None)
    meta = doc.get("meta")
    if isinstance(meta, dict):
        for key in _SELF_VERBS:
            meta.pop(key, None)
    if isinstance(doc.get("stages"), list):
        doc["stages"] = [s for s in doc["stages"]
                         if s.get("verb") not in _SELF_VERBS]
    # A container the strip emptied must normalize like one that never
    # existed — "agent stamped meta.agent, then nothing" and "no agent
    # ever ran" are the same run content.
    for key in ("meta", "runs", "collectors", "sources", "stages"):
        if key in doc and not doc[key]:
            doc.pop(key)
    return json.dumps(doc, indent=1, sort_keys=True).encode()


def _hostname() -> str:
    try:
        return socket.gethostname()
    except OSError:
        return ""


# ---------------------------------------------------------------------------
# gc.
# ---------------------------------------------------------------------------

def gc(root: str, keep: int = 0, keep_days: float = 0.0) -> dict:
    """Drop ingest runs beyond the retention policy and sweep objects no
    surviving run references.  The ONLY deletion path for archived data.

    ``keep``: newest N ingest runs survive (0 = no count limit);
    ``keep_days``: runs ingested within the last D days survive (0 = no
    age limit).  A run survives if EITHER rule keeps it.

    The whole sweep holds the root's ``derived_write_guard`` sentinel:
    the JAX package's fleet service answers uploads 503 + Retry-After
    while it is up, so a push can never race gc deleting the objects it
    just deduped against."""
    from sofa_tpu_torch.trace import derived_write_guard

    with derived_write_guard(root):
        return _gc_locked(root, keep=keep, keep_days=keep_days)


def _gc_locked(root: str, keep: int, keep_days: float) -> dict:
    store = ArchiveStore(root)
    entries = catalog.read_catalog(root)
    runs = catalog.ingest_entries(entries)
    cutoff = (time.time() - keep_days * 86400.0) if keep_days > 0 else None
    dropped: List[str] = []
    kept: List[dict] = []
    for i, e in enumerate(runs):
        newest_n = keep > 0 and i >= len(runs) - keep
        fresh = cutoff is not None and e.get("t", 0) >= cutoff
        if newest_n or fresh or (keep <= 0 and cutoff is None):
            kept.append(e)
        else:
            dropped.append(e["run"])
    for run_id in dropped:
        try:
            os.unlink(store.run_doc_path(run_id))
        except OSError as e:
            print_warning(f"archive gc: cannot drop run doc "
                          f"{run_id[:12]}: {e}")
    # Sweep objects referenced by no surviving run doc (including docs
    # that were never cataloged — fsck's adoption path owns those, gc
    # must not pull bytes out from under them).
    referenced = set()
    for run_id in store.run_ids():
        doc = store.load_run(run_id) or {}
        for ent in (doc.get("files") or {}).values():
            referenced.add(ent.get("sha256"))
    swept = 0
    freed = 0
    obj_root = os.path.join(root, OBJECTS_DIR_NAME)
    for dirpath, _dirs, names in os.walk(obj_root):
        for name in names:
            if name.endswith(".tmp") or name in referenced:
                continue
            path = os.path.join(dirpath, name)
            try:
                freed += os.path.getsize(path)
                os.unlink(path)
                swept += 1
            except OSError as e:
                print_warning(f"archive gc: cannot sweep object "
                              f"{name[:12]}: {e}")
    # Compact the catalog: ingest lines of surviving runs + every
    # non-ingest event (the bench trajectory is history, not retention).
    keep_ids = {e["run"] for e in kept}
    compacted = [e for e in entries
                 if e.get("ev") != "ingest" or e.get("run") in keep_ids]
    catalog.rewrite(root, compacted)
    summary = {"dropped_runs": len(dropped), "swept_objects": swept,
               "freed_bytes": freed}
    catalog.append_event(root, "gc", **summary)
    # The rewrite bumped the catalog generation, deterministically
    # invalidating the columnar index — rebuild it at this commit point
    # so the next query is index-fed instead of paying a full scan.
    from sofa_tpu_torch.archive import index as aindex

    aindex.refresh_after_ingest(root)
    print_progress(
        f"archive gc: dropped {len(dropped)} run(s), swept {swept} "
        f"object(s), freed {freed / 2**20:.2f} MiB")
    return summary


# ---------------------------------------------------------------------------
# fsck.
# ---------------------------------------------------------------------------

def archive_fsck(root: str, repair: bool = False) -> Optional[dict]:
    """Verify store integrity; returns the report dict or None when
    ``root`` is not an archive.  Verdicts: ARCHIVE_FSCK_VERDICTS (damage)
    plus informational ``unreferenced`` (gc's job, not damage)."""
    store = ArchiveStore(root)
    if not store.exists:
        return None
    report: Dict[str, list] = {v: [] for v in ARCHIVE_FSCK_VERDICTS}
    report["unreferenced"] = []
    entries = catalog.read_catalog(root)
    cataloged = {e.get("run") for e in entries if e.get("ev") == "ingest"}
    referenced: Dict[str, str] = {}
    for run_id in store.run_ids():
        doc = store.load_run(run_id)
        if doc is None:
            report["corrupt"].append(f"runs/{run_id}.json")
            continue
        if run_id not in cataloged:
            report["uncataloged"].append(run_id)
        for rel, ent in sorted((doc.get("files") or {}).items()):
            sha = ent.get("sha256", "")
            referenced.setdefault(sha, f"{run_id[:12]}:{rel}")
            if not store.has_object(sha):
                report["missing"].append(f"{run_id[:12]}:{rel}")
    checked = 0
    obj_root = os.path.join(root, OBJECTS_DIR_NAME)
    for dirpath, _dirs, names in os.walk(obj_root):
        for name in sorted(names):
            path = os.path.join(dirpath, name)
            if name.endswith(".tmp"):
                report["orphaned"].append(
                    os.path.relpath(path, root).replace(os.sep, "/"))
                continue
            checked += 1
            if _sha256_file(path) != name:
                report["corrupt"].append(
                    os.path.relpath(path, root).replace(os.sep, "/"))
            elif name not in referenced:
                report["unreferenced"].append(name)
    for dirpath, dirs, names in os.walk(root):
        if os.path.basename(dirpath) == OBJECTS_DIR_NAME:
            dirs[:] = []  # object tmps already classified above
            continue
        for name in names:
            if name.endswith(".tmp"):
                report["orphaned"].append(os.path.relpath(
                    os.path.join(dirpath, name), root).replace(os.sep, "/"))
    # The columnar catalog index (archive/index.py) is digest-less pure
    # derived state — integrity is its per-chunk index-signed shas, and
    # THIS is where that claim is enforced (the frames.verify_frame_store
    # discipline applied to the archive).
    from sofa_tpu_torch.archive import index as aindex

    report["index"] = aindex.verify(root)
    # The JAX package checks its fleet-pass tier (_fleet/) here; the port
    # has no such tier yet (durability.UNPORTED_FLEET_TIER), so a present
    # one is reported unchecked, never as damage.
    from sofa_tpu_torch.durability import UNPORTED_FLEET_TIER

    report["fleet"] = []
    for name in UNPORTED_FLEET_TIER:
        if os.path.isdir(os.path.join(root, name)):
            print_warning(f"archive fsck: {name}/ (the JAX package's "
                          "fleet-pass tier) is not checked: sofa_tpu_torch "
                          "has no fleet passes yet")
    report["checked"] = checked
    if repair:
        _archive_repair(store, report)
    return report


def _sha256_file(path: str) -> Optional[str]:
    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            while True:
                chunk = f.read(_HASH_CHUNK)
                if not chunk:
                    break
                h.update(chunk)
    except OSError:
        return None
    return h.hexdigest()


def _archive_repair(store: ArchiveStore, report: Dict[str, list]) -> None:
    """Adopt uncataloged runs, restore corrupt objects from their source
    logdir when it still holds matching bytes (quarantine otherwise),
    and sweep tmp orphans.  Mutates ``report`` toward post-repair truth."""
    root = store.root
    for run_id in list(report.get("uncataloged") or []):
        doc = store.load_run(run_id) or {}
        catalog.append_event(root, "ingest", run=run_id,
                             logdir=doc.get("logdir", ""),
                             files=len(doc.get("files") or {}),
                             new_objects=0, bytes_added=0, recovered=True)
        report["uncataloged"].remove(run_id)
        print_progress(f"archive fsck: re-adopted uncataloged run "
                       f"{run_id[:12]} into the catalog")
    # sha -> (source logdir, rel) from the run docs, for re-copy repair.
    sources: Dict[str, Tuple[str, str]] = {}
    for run_id in store.run_ids():
        doc = store.load_run(run_id) or {}
        for rel, ent in (doc.get("files") or {}).items():
            sources.setdefault(ent.get("sha256", ""),
                               (doc.get("logdir", ""), rel))
    for relpath in list(report.get("corrupt") or []):
        sha = os.path.basename(relpath)
        src = sources.get(sha)
        restored = False
        if src and src[0]:
            cand = os.path.join(src[0], src[1])
            if os.path.isfile(cand) and _sha256_file(cand) == sha:
                try:
                    os.unlink(store.object_path(sha))
                except OSError:
                    pass
                try:
                    store.put_file(cand, None)
                    restored = True
                except OSError as e:
                    print_warning(f"archive fsck: re-copy of {sha[:12]} "
                                  f"from {cand} failed: {e}")
        if restored:
            report["corrupt"].remove(relpath)
            print_progress(f"archive fsck: restored object {sha[:12]} "
                           f"from {src[0]}")
            continue
        qdir = os.path.join(root, QUARANTINE_DIR_NAME)
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(os.path.join(root, relpath),
                       os.path.join(qdir, sha))
            report["corrupt"].remove(relpath)
            report.setdefault("missing", []).append(
                f"{(sources.get(sha) or ('?', '?'))[1]} (quarantined "
                f"{sha[:12]})")
            print_warning(f"archive fsck: object {sha[:12]} is rotted and "
                          "its source is gone — quarantined (runs "
                          "referencing it now report missing)")
        except OSError as e:
            print_warning(f"archive fsck: cannot quarantine {sha[:12]}: "
                          f"{e}")
    for rel in list(report.get("orphaned") or []):
        try:
            os.unlink(os.path.join(root, rel))
            report["orphaned"].remove(rel)
        except OSError as e:
            print_warning(f"archive fsck: cannot sweep {rel}: {e}")
    if report.get("index"):
        # pure derived state: drop the damaged index wholesale and
        # rebuild from the catalog + run docs (reusing a chunk whose
        # signed sha still matched would keep rotted bytes alive — the
        # frame-store repair rule)
        from sofa_tpu_torch.archive import index as aindex

        aindex.drop(root)
        rebuilt = aindex.refresh_after_ingest(root)
        still = aindex.verify(root)
        if rebuilt is not None and not still:
            report["index"] = []
            print_progress("archive fsck: dropped the damaged columnar "
                           "index and rebuilt it from the catalog")
        else:
            report["index"] = still or report["index"]


# ---------------------------------------------------------------------------
# Disaster recovery: incremental content-addressed backup / restore.
# ---------------------------------------------------------------------------

#: Marker at a backup destination root.  Schema registry:
#: the JAX package's; bumps on breaking layout changes only.
BACKUP_MARKER_NAME = "sofa_backup.json"
BACKUP_SCHEMA = "sofa_tpu/archive_backup"
BACKUP_VERSION = 1
BACKUP_SNAPSHOTS_DIR = "snapshots"

_SNAPSHOT_RE_LEN = 6  # snapshots/000001.json


def _backup_snapshot_ids(dest: str) -> List[int]:
    try:
        names = os.listdir(os.path.join(dest, BACKUP_SNAPSHOTS_DIR))
    except OSError:
        return []
    return sorted(int(n[:-5]) for n in names
                  if n.endswith(".json")
                  and n[:-5].isdigit() and len(n[:-5]) == _SNAPSHOT_RE_LEN)


def _load_snapshot(dest: str, snap_id: int) -> Optional[dict]:
    path = os.path.join(dest, BACKUP_SNAPSHOTS_DIR,
                        f"{snap_id:06d}.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != BACKUP_SCHEMA:
        return None
    return doc


def _backup_walk(root: str) -> List[Tuple[str, str]]:
    """(relpath, abspath) of every file a snapshot must carry: the whole
    root except staging leftovers (``*.tmp`` is by definition not yet
    data) and the quarantine (fsck already evicted those bytes).  The
    WAL, catalog, run docs, and index all ride along — restore is
    byte-identical, not a re-derivation."""
    out: List[Tuple[str, str]] = []
    for dirpath, dirs, names in os.walk(root):
        dirs[:] = [d for d in sorted(dirs) if d != QUARANTINE_DIR_NAME]
        for name in sorted(names):
            if name.endswith(".tmp"):
                continue
            path = os.path.join(dirpath, name)
            out.append((os.path.relpath(path, root), path))
    return out


def backup_archive(root: str, dest: str) -> dict:
    """``archive backup <root> <dest>`` — one incremental snapshot.

    The destination is itself content-addressed: every source file's
    bytes land once under ``objects/<aa>/<sha256>`` (an object already
    present from an earlier snapshot costs a stat — the store's sha-keyed
    layout makes increments trivial), and the snapshot manifest
    ``snapshots/<n>.json`` maps relpath -> sha for the WHOLE root at
    this instant.  Every snapshot is a full restore point; only new
    bytes travel.  Returns the snapshot stats."""
    from sofa_tpu_torch.archive import index as aindex
    from sofa_tpu_torch.trace import atomic_write

    if os.path.abspath(dest).startswith(os.path.abspath(root) + os.sep):
        raise OSError(f"backup destination {dest} is inside the source "
                      "root — a snapshot must survive the root dying")
    marker = os.path.join(dest, BACKUP_MARKER_NAME)
    if os.path.isfile(marker):
        try:
            with open(marker) as f:
                mdoc = json.load(f)
        except (OSError, ValueError) as e:
            raise OSError(f"unreadable {BACKUP_MARKER_NAME}: {e}") \
                from None
        if not isinstance(mdoc, dict) \
                or mdoc.get("schema") != BACKUP_SCHEMA:
            raise OSError(f"{dest} is not a backup destination")
        if mdoc.get("version") != BACKUP_VERSION:
            raise OSError(
                f"{dest} holds backup layout v{mdoc.get('version')}; "
                f"this build writes v{BACKUP_VERSION} — refusing to mix")
    else:
        os.makedirs(os.path.join(dest, BACKUP_SNAPSHOTS_DIR),
                    exist_ok=True)
        os.makedirs(os.path.join(dest, OBJECTS_DIR_NAME), exist_ok=True)
        with atomic_write(marker, fsync=True) as f:
            json.dump({"schema": BACKUP_SCHEMA,
                       "version": BACKUP_VERSION,
                       "created_unix": round(time.time(), 3)}, f)
    cas = ArchiveStore(dest)  # reuse the CAS path/put machinery only
    files: Dict[str, dict] = {}
    new_objects = reused = 0
    bytes_added = 0
    for rel, path in _backup_walk(root):
        sha = _sha256_file(path)
        if sha is None:
            print_warning(f"backup: {rel} vanished mid-walk — skipped "
                          "(take another snapshot once the root is "
                          "quiet)")
            continue
        if cas.has_object(sha):
            reused += 1
        else:
            _sha, added = cas.put_file(path, expected_sha=sha)
            new_objects += 1
            bytes_added += added
        files[rel] = {"sha256": sha}
    snaps = _backup_snapshot_ids(dest)
    snap_id = (snaps[-1] + 1) if snaps else 1
    commit = aindex.load_commit(root) or {}
    doc = {"schema": BACKUP_SCHEMA, "version": BACKUP_VERSION,
           "snapshot": snap_id,
           "created_unix": round(time.time(), 3),
           "source_root": os.path.abspath(root),
           "commit_sha": commit.get("commit_sha") or "",
           "files": files}
    with atomic_write(os.path.join(dest, BACKUP_SNAPSHOTS_DIR,
                                   f"{snap_id:06d}.json"),
                      fsync=True) as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return {"snapshot": snap_id, "files": len(files),
            "new_objects": new_objects, "reused_objects": reused,
            "bytes_added": bytes_added,
            "commit_sha": doc["commit_sha"]}


def restore_archive(dest: str, target: str,
                    snapshot: int = 0) -> dict:
    """``archive restore <backup> <target>`` — materialize a
    snapshot (latest by default) into ``target`` and VERIFY it: restore
    without proof is hope.  Verification is (1) ``archive_fsck`` over
    the restored root — every object re-hashes to its name — and (2)
    the restored index commit sha equals the sha recorded at backup
    time.  Returns the stats; ``ok`` is the verdict."""
    marker = os.path.join(dest, BACKUP_MARKER_NAME)
    if not os.path.isfile(marker):
        raise OSError(f"{dest} is not a backup destination "
                      f"(no {BACKUP_MARKER_NAME})")
    snaps = _backup_snapshot_ids(dest)
    if not snaps:
        raise OSError(f"{dest} holds no snapshots")
    snap_id = snapshot or snaps[-1]
    doc = _load_snapshot(dest, snap_id)
    if doc is None:
        raise OSError(f"snapshot {snap_id} in {dest} is unreadable")
    if os.path.isdir(target) and os.listdir(target):
        raise OSError(f"restore target {target} is not empty — a "
                      "restored root must be byte-identical to the "
                      "snapshot, not merged into leftovers")
    from sofa_tpu_torch.archive import index as aindex
    from sofa_tpu_torch.trace import atomic_write

    cas = ArchiveStore(dest)
    restored = 0
    missing: List[str] = []
    for rel, ent in sorted((doc.get("files") or {}).items()):
        blob = cas.read_object(str(ent.get("sha256") or ""))
        if blob is None:
            missing.append(rel)
            continue
        path = os.path.join(target, rel)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with atomic_write(path, "wb") as f:
            f.write(blob)
        restored += 1
    problems = 0
    report = archive_fsck(target, repair=False)
    if report is None:
        problems = -1  # not even a store — the verdict is NO
    else:
        problems = sum(len(report.get(k) or [])
                       for k in ARCHIVE_FSCK_VERDICTS)
    commit = aindex.load_commit(target) or {}
    want_sha = str(doc.get("commit_sha") or "")
    got_sha = commit.get("commit_sha") or ""
    ok = (not missing and problems == 0 and got_sha == want_sha)
    return {"snapshot": snap_id, "files": restored,
            "missing": missing, "fsck_problems": problems,
            "commit_sha": got_sha, "commit_sha_expected": want_sha,
            "ok": ok}


# ---------------------------------------------------------------------------
# Tile diff — the multi-run board view's fast path.
# ---------------------------------------------------------------------------

def tile_diff(doc_a: dict, doc_b: dict) -> dict:
    """Per-series tile comparison of two archived runs BY CONTENT HASH —
    identical tiles compare equal without either payload being read
    (the pyramid is content-keyed and gzip'd deterministically, so
    unchanged data means byte-identical objects).  Returns::

        {"series": {name: {"unchanged": n, "changed": n,
                           "only_a": n, "only_b": n}},
         "totals": {...same counters summed...}}
    """
    def tiles_of(doc: dict) -> Dict[str, str]:
        out = {}
        for rel, ent in (doc.get("files") or {}).items():
            if rel.startswith("_tiles/") and rel.endswith(".json.gz"):
                out[rel] = ent.get("sha256", "")
        return out

    a, b = tiles_of(doc_a), tiles_of(doc_b)
    series: Dict[str, Dict[str, int]] = {}

    def bucket(rel: str) -> Dict[str, int]:
        parts = rel.split("/")
        name = parts[1] if len(parts) > 2 else "?"
        return series.setdefault(name, {"unchanged": 0, "changed": 0,
                                        "only_a": 0, "only_b": 0})

    for rel in sorted(set(a) | set(b)):
        s = bucket(rel)
        if rel not in b:
            s["only_a"] += 1
        elif rel not in a:
            s["only_b"] += 1
        elif a[rel] == b[rel]:
            s["unchanged"] += 1
        else:
            s["changed"] += 1
    totals = {"unchanged": 0, "changed": 0, "only_a": 0, "only_b": 0}
    for s in series.values():
        for k in totals:
            totals[k] += s[k]
    return {"series": series, "totals": totals}


# ---------------------------------------------------------------------------
# The `archive` verb.
# ---------------------------------------------------------------------------

def _fmt_mib(n) -> str:
    return f"{(n or 0) / 2**20:.2f}MiB"


def _parse_since(spec: str) -> Optional[float]:
    """``--since`` → unix-time cutoff: a plain number is an absolute
    timestamp; ``<N>d``/``<N>h``/``<N>m`` are relative to now.  None (and
    a warning) on an unparsable spec — a bad filter must not silently
    show everything as if it matched."""
    spec = (spec or "").strip()
    if not spec:
        return None
    unit = {"d": 86400.0, "h": 3600.0, "m": 60.0}.get(spec[-1].lower())
    try:
        if unit is not None:
            return time.time() - float(spec[:-1]) * unit
        return float(spec)
    except ValueError:
        print_warning(f"archive ls: cannot parse --since {spec!r} "
                      "(want a unix timestamp, or e.g. 7d / 12h / 30m) "
                      "— the filter is ignored")
        return None


def _ls_runs(root: str, cfg=None):
    """(filtered runs, total runs, bench count, source) for `ls` — the
    index-fed fast path when a CURRENT index exists (SOFA_ARCHIVE_INDEX=0
    opts out), else the linear scan; BOTH apply the one filter contract
    (index.filter_runs — the tail read applies the same predicates
    vectorized) and feed the one renderer, so the output is
    byte-identical either way (proven by test_archive_index.py)."""
    from sofa_tpu_torch.archive import index as aindex

    host = getattr(cfg, "archive_host", "") or None
    label = getattr(cfg, "archive_label", "") or None
    since = _parse_since(getattr(cfg, "archive_since", "") or "")
    limit = int(getattr(cfg, "archive_limit", 0) or 0) or None

    if limit:
        # newest-N: O(result) — only the tail chunks that hold the
        # answer are read, the totals come from the commit manifest
        tail = aindex.run_entries_tail(root, limit, host=host,
                                       label=label, since=since)
        if tail is not None:
            runs, total, bench_count = tail
            return runs, total, bench_count, "index"
    runs_all = aindex.run_entries(root)
    bench_count = None
    if runs_all is not None:
        bench_count = int((aindex.load_commit(root) or {})
                          .get("bench_events") or 0)
    host_of = None
    source = "index"
    if runs_all is None:
        entries = catalog.read_catalog(root)
        runs_all = catalog.ingest_entries(entries)
        bench_count = len(catalog.bench_entries(entries))
        source = "scan"
        store = ArchiveStore(root)

        def host_of(run_id):
            # the one-doc-open-a-run cost the index deletes: only paid
            # when --host filters on the scan path
            return str((store.load_run(run_id) or {})
                       .get("hostname") or "")

    runs = aindex.filter_runs(runs_all, host=host, label=label,
                              since=since, limit=limit, host_of=host_of)
    return runs, len(runs_all), bench_count, source


def render_ls(root: str, runs: "List[dict] | None" = None,
              total_runs: "int | None" = None,
              bench_count: "int | None" = None) -> List[str]:
    if runs is None:
        entries = catalog.read_catalog(root)
        runs = catalog.ingest_entries(entries)
        bench_count = len(catalog.bench_entries(entries))
        total_runs = len(runs)
    shown = (f"{len(runs)} run(s)" if len(runs) == total_runs
             else f"{len(runs)} of {total_runs} run(s)")
    lines = [f"archive: {root} — {shown}, "
             f"{bench_count} bench event(s)"]
    rows = [["RUN", "WHEN", "FILES", "ADDED", "LOGDIR"]]
    for e in runs:
        when = time.strftime("%Y-%m-%d %H:%M",
                             time.localtime(e.get("t", 0)))
        rows.append([e["run"][:12], when, str(e.get("files", "?")),
                     _fmt_mib(e.get("bytes_added")),
                     str(e.get("logdir", ""))[-48:]])
    from sofa_tpu_torch.telemetry import _table

    lines += _table(rows)
    return lines


_CARD_FEATURE = re.compile(r"gpu\d+_")


def render_show(store: ArchiveStore, doc: dict) -> List[str]:
    files = doc.get("files") or {}
    by_kind: Dict[str, List[int]] = {}
    for ent in files.values():
        k = by_kind.setdefault(ent.get("kind", "?"), [0, 0])
        k[0] += 1
        k[1] += ent.get("bytes", 0)
    when = time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(doc.get("t", 0)))
    lines = [f"run {doc.get('run', '?')}",
             f"  ingested {when} from {doc.get('logdir', '?')}"
             + (f" [{doc['label']}]" if doc.get("label") else "")]
    for kind, (n, b) in sorted(by_kind.items()):
        lines.append(f"  {kind}: {n} file(s), {_fmt_mib(b)}")
    feats = doc.get("features") or {}
    if feats:
        lines.append(f"  features ({len(feats)}):")
        # the per-card features lead (the JAX package lists the first 20
        # by name, which a capture's cpu_core<N> and disk_ rows fill)
        for name in sorted(feats, key=lambda n: (not _CARD_FEATURE.match(n),
                                                 n))[:20]:
            lines.append(f"    {name:<36} {feats[name]:>12.6g}")
        if len(feats) > 20:
            lines.append(f"    ... {len(feats) - 20} more")
    n_tiles = sum(1 for rel in files if rel.startswith("_tiles/"))
    if n_tiles:
        lines.append(f"  tiles: {n_tiles} pyramid file(s) "
                     "(content-addressed; board diffs them by hash)")
    return lines


def _archive_backup_verb(cfg, src: str, dest: str) -> int:
    """``archive backup <root> <dest>``: one incremental snapshot,
    stamped as ``meta.backup`` into the configured logdir's manifest
    when one exists — an operator can later prove WHEN the last restore
    point was taken (tools/manifest_check.py validates the section)."""
    from sofa_tpu_torch import telemetry
    from sofa_tpu_torch.telemetry import MANIFEST_NAME

    if not dest:
        print_error("archive backup needs a destination: "
                    "`archive backup <root> <dest>`")
        return 2
    if not ArchiveStore(src).exists:
        print_error(f"archive backup: no archive at {src}")
        return 2
    try:
        stats = backup_archive(src, dest)
    except OSError as e:
        print_error(f"archive backup: {e}")
        return 2
    print_progress(
        f"archive backup: snapshot {stats['snapshot']:06d} of {src} -> "
        f"{dest}: {stats['files']} file(s), {stats['new_objects']} new "
        f"object(s) ({stats['bytes_added']} B), "
        f"{stats['reused_objects']} reused"
        + (f"; index commit {stats['commit_sha'][:12]}"
           if stats.get("commit_sha") else ""))
    logdir = getattr(cfg, "logdir", "") or ""
    if logdir and os.path.isfile(os.path.join(logdir, MANIFEST_NAME)):
        tel = telemetry.begin("backup")
        try:
            tel.set_meta(backup={
                "schema": BACKUP_SCHEMA, "version": BACKUP_VERSION,
                "snapshot": stats["snapshot"],
                "dest": os.path.abspath(dest),
                "source_root": os.path.abspath(src),
                "files": stats["files"],
                "new_objects": stats["new_objects"],
                "bytes_added": stats["bytes_added"],
                "commit_sha": stats.get("commit_sha") or "",
                "taken_unix": round(time.time(), 3),
            })
            tel.write(logdir, rc=0, cfg=cfg)
        finally:
            telemetry.end(tel)
    return 0


def _archive_restore_verb(dest: str, target: str) -> int:
    """``archive restore <backup> <target>``: materialize + verify
    (fsck clean AND the restored index commit sha equals the one the
    snapshot recorded).  Exit 0 verified, 1 restored-but-unproven, 2
    usage."""
    if not dest or not target:
        print_error("archive restore needs both ends: "
                    "`archive restore <backup> <target>`")
        return 2
    try:
        stats = restore_archive(dest, target)
    except OSError as e:
        print_error(f"archive restore: {e}")
        return 2
    sha = stats.get("commit_sha") or ""
    print_progress(
        f"archive restore: snapshot {stats['snapshot']:06d} -> {target}: "
        f"{stats['files']} file(s), fsck problems "
        f"{stats['fsck_problems']}, index commit "
        f"{(sha or '-')[:12]}"
        + ("" if stats["ok"] else " — VERIFICATION FAILED"))
    if not stats["ok"]:
        if stats.get("missing"):
            print_error(f"archive restore: {len(stats['missing'])} "
                        "object(s) missing from the backup store — "
                        "the snapshot is damaged, try an earlier one")
        if stats.get("commit_sha") != stats.get("commit_sha_expected"):
            print_error(
                "archive restore: restored index commit "
                f"{(sha or '-')[:12]} != recorded "
                f"{(stats.get('commit_sha_expected') or '-')[:12]}")
        return 1
    return 0


def sofa_archive(cfg, action: str, arg: str = "", arg2: str = "",
                 repair: bool = False) -> int:
    """``archive <logdir> | ls | show <run> | gc [--keep N]
    [--keep_days D] | fsck [--repair] | backup <root> <dest> |
    restore <backup> <target>`` — the trace-database verb."""
    from sofa_tpu_torch import telemetry
    from sofa_tpu_torch.archive import resolve_root

    root = resolve_root(cfg)
    if action == "backup":
        return _archive_backup_verb(cfg, arg or root, arg2)
    if action == "restore":
        return _archive_restore_verb(arg, arg2)
    if action in ("", None):
        print_error("archive needs an action: `archive <logdir>` "
                    "to ingest, or ls / show <run> / gc")
        return 2
    if action == "ls":
        store = ArchiveStore(root)
        if not store.exists:
            print_error(f"no archive at {root} — `archive <logdir>` "
                        "creates one")
            return 2
        runs, total, bench_count, _source = _ls_runs(root, cfg)
        print("\n".join(render_ls(root, runs, total_runs=total,
                                  bench_count=bench_count)))
        return 0
    if action == "show":
        store = ArchiveStore(root)
        run_id = store.resolve_run_id(arg) if arg else None
        if run_id is None:
            print_error(f"archive show: no unique run matches {arg!r} "
                        "(need a >= 6-char unique id prefix; see "
                        "`archive ls`)")
            return 2
        doc = store.load_run(run_id)
        if doc is None:
            print_error(f"archive show: run doc for {run_id[:12]} is "
                        "unreadable — run `fsck` on the archive root")
            return 2
        print_title(f"archived run {run_id[:12]}")
        print("\n".join(render_show(store, doc)))
        return 0
    if action == "fsck":
        # `archive fsck [--repair]` — store-integrity alias of
        # `fsck <archive_root>` (agents and CI scripts read better
        # naming the store explicitly; same exit contract 0/1/2).
        from sofa_tpu_torch.durability import _archive_fsck_verb

        if not ArchiveStore(root).exists:
            print_error(f"no archive at {root}")
            return 2
        return _archive_fsck_verb(root, repair)
    if action == "gc":
        keep = int(getattr(cfg, "archive_keep", 0) or 0)
        keep_days = float(getattr(cfg, "archive_keep_days", 0.0) or 0.0)
        if keep <= 0 and keep_days <= 0:
            print_error("archive gc needs a retention policy: --keep N "
                        "and/or --keep_days D (refusing to guess)")
            return 2
        if not ArchiveStore(root).exists:
            print_error(f"no archive at {root}")
            return 2
        gc(root, keep=keep, keep_days=keep_days)
        return 0
    # default: the action is a logdir to ingest
    if not os.path.isdir(action):
        print_error(f"archive: {action!r} is not a logdir or a known "
                    "action (ls / show / gc)")
        return 2
    import copy

    c = copy.deepcopy(cfg)
    c.logdir = action
    c.__post_init__()
    tel = telemetry.begin("archive")
    try:
        ingest_run(c, root, label=getattr(cfg, "archive_label", "") or "",
                   tel=tel)
        tel.write(c.logdir, rc=0, cfg=c)
        return 0
    finally:
        telemetry.end(tel)
