"""The logdir's durability: the run journal, the digests, ``resume`` and
``fsck`` (the JAX package's ``sofa_tpu/durability.py``, over this
package's stages and raw files).

**Run journal** (``<logdir>/_journal.jsonl``): every pipeline verb appends
a ``begin`` line when it starts and a ``commit`` line once all of its
artifacts, digests included, are on disk.  Each append is one fsync'd
line, so a SIGKILL leaves at worst a torn last line, which the reader
skips.  Past ``JOURNAL_COMPACT_LINES`` lines the journal is rewritten with
the newest begin and commit of each stage.  ``resume`` replays what did
not commit: a stage begun and never committed, or a preprocess whose
committed raw-file key no longer matches; the content-keyed ingest cache,
chunk store and tile index make the replay warm.

**Digests** (``<logdir>/_digests.json`` and run_manifest.json's
``digests``): sha256, size and mtime of every raw and derived artifact,
refreshed at the end of each verb.  ``fsck`` classifies damage:

  ``missing``   a digested file is gone
  ``corrupt``   a derived file changed (the pipeline refreshes the digests
                after every write, so an unexplained change is damage), a
                raw file's bytes changed under the same size and mtime, or
                a ``_frames/`` chunk no longer hashes to its index
  ``stale``     a raw file rewritten after the digests: the derived
                artifacts no longer describe it
  ``orphaned``  ``*.tmp`` leftovers of interrupted writes, and tile files
                the digests do not cover

``fsck --repair`` invalidates exactly the poisoned state (the ingest-cache
entry of a damaged raw file, a damaged tile series, a damaged chunk
store), removes the orphans, re-derives and re-digests.  Exit codes:
``fsck`` 0 healthy, 1 damage found, 2 no digests to check against (or a
root this package cannot check yet); ``resume`` 0 replayed or nothing to
do.

``resume`` replays the ``whatif`` stage too (with the ``--apply`` its
begin entry names), a ``live`` epoch that began and never committed, as
exactly one epoch, and an ``archive`` ingest, into the root its begin
entry names.  ``fsck`` over an archive root checks the store instead
(``archive/store.py``); over a fleet root it is a usage error until the
fleet service is ported.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import time
from typing import Dict, List, Optional

from sofa_tpu_torch.archive import ARCHIVE_MARKER_NAME
from sofa_tpu_torch.trace import atomic_write, fsync_append

JOURNAL_NAME = "_journal.jsonl"
DIGESTS_NAME = "_digests.json"
DIGESTS_SCHEMA = "sofa_tpu/digests"
DIGESTS_VERSION = 1

# Past this many lines the journal keeps the newest begin and commit of
# each stage.
JOURNAL_COMPACT_LINES = 512

_HASH_CHUNK = 1 << 20

# fsck's verdicts, in the order they are printed.
FSCK_VERDICTS = ("missing", "corrupt", "stale", "orphaned")

# Roots marked by a file of their own: an archive (archive/) and the JAX
# package's fleet service root.  The logdir verbs never digest, sweep or
# walk into one: each keeps its own ledger.
FLEET_MARKER_NAME = "sofa_fleet.json"
MARKED_ROOTS = (ARCHIVE_MARKER_NAME, FLEET_MARKER_NAME)
# What of them this package cannot check yet: the fleet service's root,
# and the fleet-pass tier (the directory in an archive root that the JAX
# package's fleet passes write; the archive's fsck reports it unchecked).
UNPORTED_ROOTS = {FLEET_MARKER_NAME: "fleet"}
UNPORTED_FLEET_TIER = ("_fleet",)

# Raw files whose names the collectors number (ranks, pids, blktrace's
# per-cpu files) and the raw directories: everything under them is raw.
RAW_PATTERNS = ("gpumon.rank*.txt", "gpumon.pid*.txt",
                "gpumon.*.txt.meta.json", "memprof.rank*", "memprof.pid*",
                "blktrace.blktrace.*")
RAW_DIRS = ("kineto", "gpu_topo")


# --- the run journal --------------------------------------------------------

class Journal:
    """The begin/commit ledger of one logdir.  Best effort: an unwritable
    logdir is one warning, never a failure of the verb it records."""

    def __init__(self, logdir: str):
        self.path = os.path.join(logdir, JOURNAL_NAME)
        self._warned = False

    def begin(self, stage: str, **fields) -> None:
        self._append({"ev": "begin", "stage": stage, **fields})

    def commit(self, stage: str, **fields) -> None:
        self._append({"ev": "commit", "stage": stage, **fields})

    def _append(self, entry: dict) -> None:
        entry = {**entry, "t": round(time.time(), 3), "pid": os.getpid()}
        try:
            fsync_append(self.path,
                         json.dumps(entry, separators=(",", ":")) + "\n")
            self._maybe_compact()
        except OSError as e:
            if not self._warned:
                self._warned = True
                from sofa_tpu_torch.printing import print_warning

                print_warning(f"journal: cannot write {self.path}: {e} — "
                              "`resume` will not know about this run")

    def _maybe_compact(self) -> None:
        """Rewrite the journal (tmp+rename) with the newest begin and
        commit of each stage, all that ``resume`` reads, once it outgrows
        JOURNAL_COMPACT_LINES."""
        entries = read_journal(os.path.dirname(self.path) or ".")
        if len(entries) <= JOURNAL_COMPACT_LINES:
            return
        keep: Dict[tuple, dict] = {}
        for e in entries:
            keep[(e.get("stage"), e.get("ev"))] = e
        kept = sorted(keep.values(), key=lambda e: e.get("t", 0))
        with atomic_write(self.path, fsync=True) as f:
            for e in kept:
                f.write(json.dumps(e, separators=(",", ":")) + "\n")


def read_journal(logdir: str) -> List[dict]:
    """The journal's entries; a torn or unparsable line is skipped."""
    entries: List[dict] = []
    try:
        with open(os.path.join(logdir, JOURNAL_NAME)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue        # the torn tail of a killed append
                if isinstance(e, dict):
                    entries.append(e)
    except OSError:
        return []
    return entries


def journal_state(entries: List[dict]) -> Dict[str, dict]:
    """{stage: {"committed", "key", "begin_key", "begin_t", "rc"}} from the
    newest begin and commit of each stage; a begin after the last commit
    reopens the stage."""
    state: Dict[str, dict] = {}
    for e in entries:
        stage = e.get("stage")
        if not isinstance(stage, str):
            continue
        st = state.setdefault(stage, {"committed": False, "key": None})
        if e.get("ev") == "begin":
            st["committed"] = False
            st["begin_key"] = e.get("key")
            st["begin_t"] = e.get("t")
        elif e.get("ev") == "commit":
            st["committed"] = True
            st["key"] = e.get("key")
            st["rc"] = e.get("rc")
    return state


def _is_raw(rel: str) -> bool:
    from sofa_tpu_torch.record import RAW_FILES

    if rel in RAW_FILES or rel.split("/", 1)[0] in RAW_DIRS:
        return True
    return "/" not in rel and any(fnmatch.fnmatchcase(rel, p)
                                  for p in RAW_PATTERNS)


def logdir_raw_key(logdir: str) -> str:
    """A key over the raw files' (name, size, mtime_ns): a committed
    preprocess whose key no longer matches has stale outputs."""
    sigs: List[tuple] = []
    for root, dirs, files in os.walk(logdir):
        rel_root = os.path.relpath(root, logdir)
        parts = [] if rel_root == "." else rel_root.split(os.sep)
        if parts and parts[0] not in RAW_DIRS:
            dirs[:] = []
            continue
        for name in files:
            rel = "/".join(parts + [name])
            if not _is_raw(rel):
                continue
            try:
                st = os.stat(os.path.join(root, name))
            except OSError:
                continue
            sigs.append((rel, st.st_size, st.st_mtime_ns))
    h = hashlib.sha1()
    for sig in sorted(sigs):
        h.update(repr(sig).encode())
    return h.hexdigest()


# --- digests ------------------------------------------------------------------

def _sha256(path: str) -> Optional[str]:
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


def marked_root(path: str) -> Optional[str]:
    """The marker file of an archive or fleet root at ``path``, else
    None."""
    return next((m for m in MARKED_ROOTS
                 if os.path.isfile(os.path.join(path, m))), None)


def _digest_targets(logdir: str) -> List[str]:
    """The relative paths of every artifact the digests cover."""
    from sofa_tpu_torch.record import DIGEST_SKIP_DIRS, DIGEST_SKIP_FILES

    out: List[str] = []
    for root, dirs, files in os.walk(logdir):
        rel_root = os.path.relpath(root, logdir)
        parts = [] if rel_root == "." else rel_root.split(os.sep)
        if parts and (parts[0] in DIGEST_SKIP_DIRS or marked_root(root)):
            # an archive nested in the logdir keeps its own ledger
            dirs[:] = []
            continue
        dirs[:] = sorted(d for d in dirs if d not in DIGEST_SKIP_DIRS)
        for name in sorted(files):
            if name in DIGEST_SKIP_FILES or name.endswith(".tmp"):
                continue
            out.append("/".join(parts + [name]))
    return out


def compute_digests(logdir: str) -> dict:
    files: Dict[str, dict] = {}
    for rel in _digest_targets(logdir):
        path = os.path.join(logdir, rel)
        digest = _sha256(path)
        if digest is None:
            continue            # gone mid-scan: the next write catches it
        try:
            st = os.stat(path)
        except OSError:
            continue
        files[rel] = {"sha256": digest, "bytes": int(st.st_size),
                      "mtime_ns": int(st.st_mtime_ns),
                      "kind": "raw" if _is_raw(rel) else "derived"}
    return {"schema": DIGESTS_SCHEMA, "version": DIGESTS_VERSION,
            "algo": "sha256", "generated_unix": round(time.time(), 3),
            "files": files}


def write_digests(logdir: str) -> Optional[dict]:
    """Refresh the digests: ``_digests.json`` (fsync'd: fsck must work
    when the manifest is the damaged file) and the manifest's ``digests``.
    Best effort; ``SOFA_DIGESTS=0`` turns it off."""
    if os.environ.get("SOFA_DIGESTS", "1") == "0":
        return None
    try:
        doc = compute_digests(logdir)
        with atomic_write(os.path.join(logdir, DIGESTS_NAME),
                          fsync=True) as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        attach_digests(logdir, doc)
        return doc
    except OSError as e:
        from sofa_tpu_torch.printing import print_warning

        print_warning(f"digests: cannot write the digests of {logdir}: {e}")
        return None


def attach_digests(logdir: str, doc: dict) -> None:
    """Copy the digests into run_manifest.json's ``digests``."""
    _patch_manifest(logdir, digests={"algo": doc["algo"],
                                     "generated_unix": doc["generated_unix"],
                                     "files": doc["files"]})


def load_digests(logdir: str) -> Optional[dict]:
    """``_digests.json``, else the manifest's copy, else None."""
    try:
        with open(os.path.join(logdir, DIGESTS_NAME)) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and isinstance(doc.get("files"), dict):
            return doc
    except (OSError, ValueError):
        pass
    from sofa_tpu_torch.telemetry import load_manifest

    manifest = load_manifest(logdir)
    if manifest and isinstance(manifest.get("digests"), dict) and \
            isinstance(manifest["digests"].get("files"), dict):
        return manifest["digests"]
    return None


def _patch_manifest(logdir: str, **top_level) -> None:
    """Merge keys into run_manifest.json (``meta=`` into its meta),
    leaving the verbs' sections alone; nothing without a manifest."""
    from sofa_tpu_torch import telemetry

    doc = telemetry.load_manifest(logdir)
    if doc is None:
        return
    meta_patch = top_level.pop("meta", None)
    doc.update(top_level)
    if meta_patch:
        doc.setdefault("meta", {}).update(meta_patch)
    with atomic_write(os.path.join(logdir, telemetry.MANIFEST_NAME)) as f:
        json.dump(doc, f, indent=1, sort_keys=True)


# --- fsck ---------------------------------------------------------------------

# A raw file -> the ingest source whose cache entry it poisons
# (preprocess._ingest_tasks is this table's runtime twin).
_RAW_TO_SOURCE = {
    "mpstat.txt": "mpstat", "diskstat.txt": "diskstat",
    "netstat.txt": "netbandwidth", "cpuinfo.txt": "cpuinfo",
    "vmstat.txt": "vmstat", "perf.data": "cputrace",
    "perf.script": "cputrace", "kallsyms": "cputrace",
    "timebase.txt": "cputrace", "strace.txt": "strace",
    "pystacks.txt": "pystacks", "sofa.pcap": "nettrace",
    "gpumon.txt": "gpumon", "blktrace.txt": "blktrace",
    "gpu_topo.json": "kineto",
}


def _raw_source(rel: str) -> Optional[str]:
    if rel in _RAW_TO_SOURCE:
        return _RAW_TO_SOURCE[rel]
    if rel.startswith("kineto/") or rel.startswith("gpu_topo/"):
        return "kineto"
    if fnmatch.fnmatchcase(rel, "gpumon.*.txt"):
        return "gpumon"
    return None


def fsck_scan(logdir: str, digests: Optional[dict] = None
              ) -> Optional[dict]:
    """Check the logdir against its digests: ``{"checked": n, "ok": [...],
    "missing": [...], "corrupt": [...], "stale": [...], "orphaned":
    [...]}``, or None without digests."""
    from sofa_tpu_torch import frames as framestore

    if digests is None:
        digests = load_digests(logdir)
    if digests is None:
        return None
    files = digests.get("files") or {}
    report: Dict[str, list] = {v: [] for v in FSCK_VERDICTS}
    report["ok"] = []
    for rel, ent in sorted(files.items()):
        path = os.path.join(logdir, rel)
        if not os.path.isfile(path):
            report["missing"].append(rel)
            continue
        if _sha256(path) == ent.get("sha256"):
            report["ok"].append(rel)
            continue
        try:
            st = os.stat(path)
        except OSError:
            report["missing"].append(rel)
            continue
        unchanged_meta = (int(st.st_size) == ent.get("bytes")
                          and int(st.st_mtime_ns) == ent.get("mtime_ns"))
        if ent.get("kind") == "raw" and not unchanged_meta:
            report["stale"].append(rel)     # rewritten after the digests
        else:
            report["corrupt"].append(rel)
    for root, dirs, names in os.walk(logdir):
        rel_root = os.path.relpath(root, logdir)
        parts = [] if rel_root == "." else rel_root.split(os.sep)
        if parts and (parts[0] in ("_inject", "board", "__pycache__")
                      or marked_root(root)):
            dirs[:] = []
            continue
        for name in names:
            rel = "/".join(parts + [name])
            if name.endswith(".tmp"):
                report["orphaned"].append(rel)
            elif parts and parts[0] == "_tiles" and rel not in files:
                report["orphaned"].append(rel)
    # the digests skip _frames/ (chunks are keyed by their index):
    # re-hash each committed chunk against the index instead
    names = framestore.frame_store_names(logdir)
    for fname in names:
        report["corrupt"].extend(framestore.verify_frame_store(logdir,
                                                               fname))
    report["checked"] = len(files) + len(names)
    return report


def fsck_problem_counts(report: dict) -> Dict[str, int]:
    return {v: len(report.get(v) or []) for v in FSCK_VERDICTS}


def _replay_cfg(cfg, fmt: Optional[str]):
    """``cfg`` writing ``fmt`` (the format the damaged or interrupted run
    wrote) unless the caller named one."""
    if fmt and not getattr(cfg, "trace_format", ""):
        cfg.trace_format = fmt
    return cfg


def _fsck_repair(cfg, report: dict) -> None:
    """Invalidate exactly the poisoned state, remove the orphans, then
    re-derive (preprocess, and analyze when it had run)."""
    import shutil

    from sofa_tpu_torch import frames as framestore
    from sofa_tpu_torch.ingest.cache import CACHE_DIR_NAME, IngestCache
    from sofa_tpu_torch.printing import print_progress, print_warning
    from sofa_tpu_torch.telemetry import load_manifest
    from sofa_tpu_torch.tiles import TILES_DIR_NAME

    logdir = cfg.logdir
    damaged = (report.get("missing") or []) + (report.get("corrupt") or []) \
        + (report.get("stale") or [])
    cache = IngestCache(cfg.path(CACHE_DIR_NAME))
    raw_damage: List[str] = []
    tile_series: set = set()
    frame_stores: set = set()
    for rel in damaged:
        if rel.startswith("_tiles/"):
            tile_series.add(rel.split("/")[1])
        elif rel.startswith("_frames/"):
            frame_stores.add(rel.split("/")[1])
        elif _raw_source(rel) is not None:
            raw_damage.append(rel)
            cache.invalidate(_raw_source(rel))
    for series in sorted(tile_series):
        shutil.rmtree(os.path.join(logdir, TILES_DIR_NAME, series),
                      ignore_errors=True)
    # a damaged store goes whole: the rewrite is content-keyed, and a chunk
    # whose index entry still matches the frame would be reused as it is
    for fname in sorted(frame_stores):
        framestore.delete_frame_store(logdir, fname)
    for rel in report.get("orphaned") or []:
        try:
            os.unlink(os.path.join(logdir, rel))
        except OSError:
            pass
    if raw_damage:
        print_warning(
            "fsck: raw artifact damage is not repairable (the bytes are "
            "the evidence): " + ", ".join(sorted(raw_damage)[:8])
            + " — their cache entries are invalidated and derived "
            "artifacts re-derive from what remains")
    from sofa_tpu_torch.preprocess import sofa_preprocess

    manifest = load_manifest(logdir) or {}
    cfg = _replay_cfg(cfg, ((manifest.get("meta") or {}).get("frames")
                            or {}).get("format"))
    frames = sofa_preprocess(cfg)
    if "analyze" in (manifest.get("runs") or {}):
        from sofa_tpu_torch.analyze import sofa_analyze

        sofa_analyze(cfg, frames=frames)
    print_progress("fsck: re-derived artifacts and refreshed the digests")


def sofa_fsck(cfg, repair: bool = False) -> int:
    """The ``fsck`` verb: 0 healthy, 1 damage (each file printed under
    its verdict; with ``repair`` the rc is the re-scan's), 2 without
    digests.  Records ``meta.fsck`` in the manifest.  Over an archive
    root it checks the store (``_archive_fsck_verb``)."""
    from sofa_tpu_torch.printing import (SofaUserError, print_error,
                                         print_progress, print_warning)
    from sofa_tpu_torch.trace import reap_stale_sentinel

    if not os.path.isdir(cfg.logdir):
        print_error(f"logdir {cfg.logdir} does not exist")
        return 2
    marker = marked_root(cfg.logdir)
    if marker == ARCHIVE_MARKER_NAME:
        return _archive_fsck_verb(cfg.logdir, repair)
    if marker is not None:
        raise SofaUserError(
            f"{cfg.logdir} is a {UNPORTED_ROOTS[marker]} root ({marker}); "
            f"checking one needs the {UNPORTED_ROOTS[marker]} module, "
            "which sofa_tpu_torch does not have yet")
    reap_stale_sentinel(cfg.logdir)
    report = fsck_scan(cfg.logdir)
    if report is None:
        print_error(f"no digests in {cfg.logdir} — run `preprocess` (or "
                    "`record`) once to write them")
        return 2
    counts = fsck_problem_counts(report)
    n_bad = sum(counts.values())
    for verdict in FSCK_VERDICTS:
        for rel in sorted(report.get(verdict) or []):
            print(f"  {verdict:<9} {rel}")
    if n_bad and repair:
        _fsck_repair(cfg, report)
        report = fsck_scan(cfg.logdir)
        counts = fsck_problem_counts(report or {})
        n_bad = sum(counts.values()) if report is not None else 1
    _patch_manifest(cfg.logdir, meta={"fsck": {
        "checked_unix": round(time.time(), 3),
        "ok": n_bad == 0,
        "checked": int((report or {}).get("checked", 0)),
        "problems": counts,
        "repaired": bool(repair),
    }})
    if n_bad:
        summary = ", ".join(f"{counts[v]} {v}" for v in FSCK_VERDICTS
                            if counts.get(v))
        print_warning(f"fsck: {(report or {}).get('checked', 0)} "
                      f"artifact(s) checked — {summary}"
                      + ("" if repair else "; `fsck --repair` re-derives"))
        return 1
    print_progress(f"fsck: {report.get('checked', 0)} artifact(s) verified, "
                   "all healthy")
    return 0


def _archive_fsck_verb(root: str, repair: bool) -> int:
    """fsck over an archive root (archive/store.py), with the logdir
    scan's exit codes: 0 healthy, 1 damage, 2 no store."""
    from sofa_tpu_torch.archive.store import (ARCHIVE_FSCK_VERDICTS,
                                              archive_fsck)
    from sofa_tpu_torch.printing import print_progress, print_warning

    report = archive_fsck(root, repair=repair)
    if report is None:
        return 2
    for verdict in ARCHIVE_FSCK_VERDICTS:
        for rel in sorted(report.get(verdict) or []):
            print(f"  {verdict:<11} {rel}")
    n_unref = len(report.get("unreferenced") or [])
    if n_unref:
        print_progress(f"fsck: {n_unref} unreferenced object(s) — not "
                       "damage; `archive gc` sweeps them")
    counts = {v: len(report.get(v) or []) for v in ARCHIVE_FSCK_VERDICTS}
    n_bad = sum(counts.values())
    if n_bad:
        summary = ", ".join(f"{counts[v]} {v}"
                            for v in ARCHIVE_FSCK_VERDICTS if counts[v])
        print_warning(f"fsck: archive {root}: {report.get('checked', 0)} "
                      f"object(s) checked — {summary}"
                      + ("" if repair else "; `fsck --repair` re-adopts, "
                         "restores or quarantines"))
        return 1
    print_progress(f"fsck: archive {root}: {report.get('checked', 0)} "
                   "object(s) verified, all healthy")
    return 0


# --- resume -------------------------------------------------------------------

def sofa_resume(cfg) -> int:
    """The ``resume`` verb: reap a dead writer's sentinel, then replay
    each journaled stage that did not commit (or a preprocess whose raw
    files changed since its commit, and the analyze after it)."""
    from sofa_tpu_torch.printing import (SofaUserError, print_progress,
                                         print_warning)
    from sofa_tpu_torch.trace import reap_stale_sentinel

    if not os.path.isdir(cfg.logdir):
        raise SofaUserError(
            f"logdir {cfg.logdir} does not exist — nothing to resume")
    reap_stale_sentinel(cfg.logdir)
    entries = read_journal(cfg.logdir)
    if not entries:
        raise SofaUserError(
            f"no {JOURNAL_NAME} in {cfg.logdir} — this logdir never ran a "
            "journaled verb; use `report` instead")
    state = journal_state(entries)
    cur_key = logdir_raw_key(cfg.logdir)

    rec = state.get("record")
    if rec is not None and not rec["committed"]:
        print_warning(
            "resume: the recording itself was interrupted — its raw files "
            "are whatever landed before the crash; resuming preprocess/"
            "analyze over them (series may end early)")
    pre = state.get("preprocess")
    need_pre = pre is not None and (not pre["committed"]
                                    or pre.get("key") != cur_key)
    if pre is not None and pre["committed"] and pre.get("key") != cur_key:
        print_warning("resume: raw files changed since the last committed "
                      "preprocess — replaying it")
    an = state.get("analyze")
    need_an = an is not None and (not an["committed"] or need_pre)
    ar = state.get("archive")
    need_ar = ar is not None and (not ar["committed"] or need_pre
                                  or need_an)
    wi = state.get("whatif")
    need_wi = wi is not None and (not wi["committed"] or need_pre
                                  or need_an)
    lv = state.get("live")
    # a committed epoch whose key moved on is the job appending: the next
    # epoch's business; only an epoch that began and never committed
    # replays, as exactly one epoch
    need_lv = lv is not None and not lv["committed"]
    if not (need_pre or need_an or need_ar or need_wi or need_lv):
        print_progress("resume: every journaled stage is committed and "
                       "matches the raw files — nothing to replay")
        return 0
    # the replay writes the format the interrupted preprocess wrote
    fmt = next((e.get("trace_format") for e in reversed(entries)
                if e.get("stage") == "preprocess" and e.get("ev") == "begin"
                and e.get("trace_format")), None)
    cfg = _replay_cfg(cfg, fmt)
    frames = None
    if need_pre:
        from sofa_tpu_torch.preprocess import sofa_preprocess

        print_progress("resume: replaying preprocess (cached ingest, chunk "
                       "and tile work is reused)")
        frames = sofa_preprocess(cfg)
    if need_an:
        from sofa_tpu_torch.analyze import sofa_analyze

        print_progress("resume: replaying analyze")
        sofa_analyze(cfg, frames=frames)
    if need_ar:
        # the root rides the begin entry: the replay lands in the store the
        # killed ingest was writing (the objects it stored dedup; the
        # catalog line is the commit point)
        root = next((e.get("archive_root") for e in reversed(entries)
                     if e.get("stage") == "archive" and e.get("ev") == "begin"
                     and e.get("archive_root")), None)
        if root is None:
            from sofa_tpu_torch.archive import resolve_root

            root = resolve_root(cfg)
        from sofa_tpu_torch.archive.store import ingest_run

        print_progress(f"resume: replaying the archive ingest into {root} "
                       "(objects already stored are deduped)")
        ingest_run(cfg, root)
    if need_wi:
        # the scenarios ride the begin entry: the replay answers the
        # question the killed run was asked
        spec = next((e.get("apply") for e in reversed(entries)
                     if e.get("stage") == "whatif" and e.get("ev") == "begin"
                     and isinstance(e.get("apply"), str)), None)
        if spec is not None:
            cfg.whatif_apply = spec
        from sofa_tpu_torch.whatif import sofa_whatif

        print_progress("resume: replaying whatif "
                       f"(--apply {cfg.whatif_apply or '<identity>'})")
        sofa_whatif(cfg)
    if need_lv:
        # committed chunks load from the chunk store; the uncommitted tail
        # is tailed again from the ledger's last committed offsets
        from sofa_tpu_torch.live import sofa_live

        print_progress("resume: replaying the interrupted live epoch "
                       "(committed chunks load from the chunk store)")
        sofa_live(cfg, epochs=1)
    print_progress("resume: journal replay complete")
    return 0
