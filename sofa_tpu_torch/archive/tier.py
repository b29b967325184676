"""The horizontally scaled fleet tier: sharding, the write-ahead queue,
read replicas and the worker pool (the JAX package's
``sofa_tpu/archive/tier.py``, whole).

**The write-ahead ingest queue.**  A commit lands as one fsync'd line in
the tenant's ``_wal/wal.<worker>.<epoch>.jsonl`` (each worker appends only
to its own file, so appends never interleave); the ack returns once the
owning worker's :class:`Drainer` has applied it (the run doc and the
catalog line exist when the ack does), and the index refresh runs after
the ack, coalesced, on the drainer's refresher thread: a push never pays
the refresh's wall time.  Replay is a pure function of the WAL bytes (each
record carries its own timestamp), so a drain killed anywhere
(``SOFA_WAL_EXIT_AFTER``) and run again converges to the byte-identical
store, and the drain is journaled as the stage ``wal_drain``.

**The worker pool** (``--workers N``).  N worker processes accept on one
port through ``SO_REUSEPORT`` where the platform has it; otherwise a
front-door dispatcher proxies each request with tenant affinity
(``SOFA_TIER_NO_REUSEPORT=1`` forces that path).  The consistent-hash ring
(:func:`ring_owner`) names the one worker that owns a tenant's commit path;
any worker accepts an upload.  A supervisor respawns a dead worker at the
next generation, and :meth:`TierHandle.rolling_restart` hands the workers
off one at a time.  The workers are forked, or spawned when the parent
has imported ``torch`` (a forked child of such a process is undefined).

**Read replicas** (``--replica-of <url>``).  A replica pulls each tenant's
immutable ``_index/`` commit from its upstream (the commit sha is the
ETag, so an unchanged commit is one 304), fetches only the chunks whose
sha changed, and writes ``index_commit.json`` last.  Its tenant roots are
pinned (``archive/index.py``), and a replica behind its upstream says so
in ``X-Sofa-Replica-Stale`` / ``X-Sofa-Replica-Behind``.
"""

from __future__ import annotations

import bisect
import errno
import hashlib
import http.server
import json
import os
import re
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Tuple

from sofa_tpu_torch.archive import catalog
from sofa_tpu_torch.archive.protocol import ERR_NO_WORKER
from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_error, print_progress, print_warning

# The ``meta.tier`` manifest section, the commit ack's ``tier`` fold and
# the ``/v1/tier`` topology document.
TIER_SCHEMA = "sofa_tpu/fleet_tier"
TIER_VERSION = 1

WAL_DIR_NAME = "_wal"
WAL_STATE_NAME = "wal_state.json"
WAL_SCHEMA = "sofa_tpu/fleet_wal"
WAL_VERSION = 1

# An appender starts a fresh epoch file past this size; fully-applied old
# epochs are unlinked by their own appender (the single-writer rule).
WAL_ROTATE_BYTES = 1 << 20

# Admission watermarks on a tenant's unapplied WAL depth (records),
# SOFA_WAL_SOFT_DEPTH / SOFA_WAL_HARD_DEPTH: past SOFT, queries are shed
# (brownout); past HARD, pushes are refused with a Retry-After'd 503.
WAL_SOFT_DEPTH = 64
WAL_HARD_DEPTH = 256

# Written at the served root by the pool's supervisor while it runs:
# ``serve --rolling-restart`` finds the supervisor to SIGHUP there.
SUPERVISOR_PIDFILE_NAME = "sofa_serve.pid"

_WAL_FILE_RE = re.compile(r"^wal\.(\d{3})\.(\d{6})\.jsonl$")

# Virtual nodes per worker on the consistent-hash ring.
RING_VNODES = 64

# How long a commit ack waits for the drainer to apply its record before
# answering 503 (the client retries 5xx).
COMMIT_APPLY_TIMEOUT_S = 30.0

# The replica's pull cadence (SOFA_REPLICA_POLL_S overrides it).
REPLICA_POLL_S = 2.0

# Floor between index refreshes of one tenant under sustained ingest
# (SOFA_REFRESH_MIN_INTERVAL_S): the index is a query cache (a stale one
# falls back to the catalog scan), so its refresh never queues ahead of
# commit acks.
REFRESH_MIN_INTERVAL_S = float(
    os.environ.get("SOFA_REFRESH_MIN_INTERVAL_S", "2.0") or 2.0)


def _chaos_wal_exit_after() -> int:
    """The kill-the-drainer-mid-apply knob (0 = off): hard-exit 88 at the
    n-th applied record, between the run-doc write and the catalog line,
    the widest replay window."""
    try:
        return int(os.environ.get("SOFA_WAL_EXIT_AFTER", "0"))
    except ValueError:
        return 0


_WAL_APPLIED_TICKS = 0


def wal_watermarks() -> Tuple[int, int]:
    """(soft, hard) WAL-depth watermarks, read per call; hard >= soft >= 1
    always (a zero, negative or inverted pair is clamped)."""
    try:
        soft = int(os.environ.get("SOFA_WAL_SOFT_DEPTH", "")
                   or WAL_SOFT_DEPTH)
    except ValueError:
        soft = WAL_SOFT_DEPTH
    try:
        hard = int(os.environ.get("SOFA_WAL_HARD_DEPTH", "")
                   or WAL_HARD_DEPTH)
    except ValueError:
        hard = WAL_HARD_DEPTH
    soft = max(soft, 1)
    return soft, max(hard, soft)


# --- the consistent-hash ring -------------------------------------------------

_RING_CACHE: Dict[tuple, tuple] = {}
_RING_GUARD = Guard("tier.ring_cache", protects=("_RING_CACHE",))


def _ring(ids: tuple) -> tuple:
    """(sorted point list, matching worker-id list) for a worker set."""
    cached = _RING_CACHE.get(ids)
    if cached is not None:
        return cached
    points: List[Tuple[int, int]] = []
    for w in ids:
        for v in range(RING_VNODES):
            digest = hashlib.sha1(f"worker-{w}#{v}".encode()).digest()
            points.append((int.from_bytes(digest[:8], "big"), w))
    points.sort()
    ring = (tuple(p for p, _w in points), tuple(w for _p, w in points))
    if len(_RING_CACHE) < 64:
        with _RING_GUARD:
            _RING_CACHE[ids] = ring
    return ring


def ring_owner(tenant: str, workers) -> int:
    """The worker that owns ``tenant``'s commit path.  ``workers`` is a
    count (ids ``0..n-1``) or an iterable of ids.  Adding a worker steals
    only the arcs of its vnodes; removing one reassigns only its tenants."""
    ids = tuple(range(workers)) if isinstance(workers, int) \
        else tuple(workers)
    if not ids:
        return 0
    points, owners = _ring(ids)
    h = int.from_bytes(
        hashlib.sha1(f"tenant-{tenant}".encode()).digest()[:8], "big")
    return owners[bisect.bisect_right(points, h) % len(points)]


# --- the per-tenant write-ahead log -------------------------------------------

def wal_dir(tenant_root: str) -> str:
    return os.path.join(tenant_root, WAL_DIR_NAME)


def _wal_state_path(tenant_root: str) -> str:
    return os.path.join(wal_dir(tenant_root), WAL_STATE_NAME)


def _wal_files(tenant_root: str) -> List[str]:
    try:
        names = os.listdir(wal_dir(tenant_root))
    except OSError:
        return []
    return sorted(n for n in names if _WAL_FILE_RE.match(n))


def load_wal_state(tenant_root: str) -> dict:
    """The drainer's durable progress: per WAL file the applied and
    refreshed byte offsets.  Carries no clock."""
    try:
        with open(_wal_state_path(tenant_root)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = None
    if not isinstance(doc, dict) or doc.get("schema") != WAL_SCHEMA:
        doc = {"schema": WAL_SCHEMA, "version": WAL_VERSION,
               "applied": {}, "refreshed": {}}
    doc.setdefault("applied", {})
    doc.setdefault("refreshed", {})
    return doc


def _save_wal_state(tenant_root: str, state: dict,
                    fsync: bool = True) -> None:
    live = set(_wal_files(tenant_root))
    for ledger in ("applied", "refreshed"):
        state[ledger] = {k: v for k, v in state[ledger].items()
                         if k in live}
    # a writer-unique stage: the drainer and its refresher thread save at
    # once, and a shared .tmp would let one rename take the other's.
    # fsync=False mid-batch is safe: the state is a replay bound, and a
    # stale offset only re-walks records the idempotent drain applied.
    path = _wal_state_path(tenant_root)
    stage = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(stage, "w") as f:  # sofa-lint: disable=SL009 — the writer-unique stage + os.replace below IS the atomic write; atomic_write's shared .tmp name would let the drainer and refresher threads collide
        json.dump(state, f, sort_keys=True)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(stage, path)


def _pending_records(tenant_root: str,
                     state: dict) -> List[Tuple[str, int, dict]]:
    """Whole WAL records past the applied offsets, as (file name, end
    offset, record) in file order.  A torn final line (a crash mid-append)
    is not data yet and stays unconsumed."""
    out: List[Tuple[str, int, dict]] = []
    for name in _wal_files(tenant_root):
        path = os.path.join(wal_dir(tenant_root), name)
        off = int(state["applied"].get(name, 0))
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        if size <= off:
            continue
        try:
            with open(path, "rb") as f:
                f.seek(off)
                buf = f.read(size - off)
        except OSError:
            continue
        pos = off
        for line in buf.split(b"\n"):
            if not buf.endswith(b"\n") and pos + len(line) >= off + len(buf):
                break  # the torn tail: no newline yet
            end = pos + len(line) + 1
            pos = end
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn line inside: skipped, as readers do
            if isinstance(rec, dict) and rec.get("run"):
                out.append((name, end, rec))
    return out


def wal_depth(tenant_root: str) -> int:
    """The unapplied WAL records: the queue's depth."""
    return len(_pending_records(tenant_root, load_wal_state(tenant_root)))


def wal_pending_runs(tenant_root: str) -> set:
    """Run ids queued but not applied yet: ``have`` and ``commit`` count
    them as committed (the WAL is fsync'd, so they cannot be lost)."""
    return {rec["run"] for _n, _e, rec
            in _pending_records(tenant_root, load_wal_state(tenant_root))}


class WalAppender:
    """One worker's single-writer append handle for one tenant: it
    appends only to ``wal.<worker>.<epoch>.jsonl``, starts a new epoch
    past ``WAL_ROTATE_BYTES``, and unlinks its own old epochs once the
    state shows them applied and refreshed."""

    def __init__(self, tenant_root: str, worker: int):
        self.tenant_root = tenant_root
        self.worker = int(worker)
        self._guard = Guard("tier.wal_append", protects=("_epoch",))
        self._epoch = 0
        for name in _wal_files(tenant_root):
            m = _WAL_FILE_RE.match(name)
            if m and int(m.group(1)) == self.worker:
                self._epoch = max(self._epoch, int(m.group(2)))

    def _name(self, epoch: int) -> str:
        return f"wal.{self.worker:03d}.{epoch:06d}.jsonl"

    def append(self, record: dict) -> Tuple[str, int]:
        """Durably append one record; returns (file name, end offset), the
        coordinates a commit ack waits on.  The record's timestamp is
        stamped here, so a replay reproduces the same bytes; its ``trace``
        (the push's X-Sofa-Trace id) rides along to the drainer."""
        from sofa_tpu_torch import faults, metrics
        from sofa_tpu_torch.trace import fsync_append

        record = dict(record)
        record.setdefault("t", round(time.time(), 3))
        line = json.dumps(record, sort_keys=True) + "\n"
        t0 = time.time()
        with self._guard:
            name = self._name(self._epoch)
            path = os.path.join(wal_dir(self.tenant_root), name)  # sofa-lint: disable=SL020 — os.path.join is pure string math, not IO; the .join blocking-method heuristic misfires
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size >= WAL_ROTATE_BYTES:
                self._gc_applied_epochs()
                self._epoch += 1
                name = self._name(self._epoch)
                path = os.path.join(wal_dir(self.tenant_root), name)  # sofa-lint: disable=SL020 — os.path.join is pure string math, not IO
                size = 0
            if faults.maybe_disk_full():
                raise OSError(errno.ENOSPC,
                              f"disk_full fault: WAL append refused "
                              f"({name})")
            fsync_append(path, line)
        reg = metrics.for_tenant_root(self.tenant_root)
        reg.inc("wal_appends")
        reg.span("wal_append", "wal", t0, time.time() - t0,
                 trace=str(record.get("trace") or ""),
                 tenant=os.path.basename(self.tenant_root),
                 run=str(record.get("run") or ""))
        return name, size + len(line)

    def _gc_applied_epochs(self) -> None:
        """Unlink this worker's old epochs the owner has fully applied and
        refreshed (only the appender deletes its own files)."""
        state = load_wal_state(self.tenant_root)
        for name in _wal_files(self.tenant_root):
            m = _WAL_FILE_RE.match(name)
            if not m or int(m.group(1)) != self.worker \
                    or int(m.group(2)) >= self._epoch:
                continue
            path = os.path.join(wal_dir(self.tenant_root), name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if int(state["applied"].get(name, 0)) >= size and \
                    int(state["refreshed"].get(name, 0)) >= size:
                try:
                    os.unlink(path)
                except OSError:
                    pass


def drain_tenant(tenant_root: str, refresh: bool = True,
                 on_applied=None) -> dict:
    """Apply every pending WAL record: the replay engine, a pure function
    of the WAL bytes, so a drain killed anywhere and run again converges
    to the byte-identical store.  A record whose run is already cataloged
    only advances the applied offset.  Journaled as stage ``wal_drain`` in
    the tenant root.  Returns ``{"applied", "replayed", "refreshed"}``."""
    global _WAL_APPLIED_TICKS
    from sofa_tpu_torch import metrics
    from sofa_tpu_torch.archive.store import (RUN_SCHEMA, RUN_VERSION,
                                              ArchiveStore)
    from sofa_tpu_torch.durability import Journal
    from sofa_tpu_torch.trace import atomic_write

    state = load_wal_state(tenant_root)
    pend = _pending_records(tenant_root, state)
    unrefreshed = any(
        int(state["refreshed"].get(n, 0)) < int(state["applied"].get(n, 0))
        for n in state["applied"])
    if not pend and not unrefreshed:
        return {"applied": 0, "replayed": 0, "refreshed": False}
    store = ArchiveStore(tenant_root, create=True)
    journal = Journal(tenant_root)
    tenant = os.path.basename(tenant_root)
    reg = metrics.for_tenant_root(tenant_root)
    applied = replayed = 0
    if pend:
        journal.begin("wal_drain", key=tenant, records=len(pend))
        cataloged = {e.get("run")
                     for e in catalog.read_catalog(tenant_root)
                     if e.get("ev") == "ingest"}
        chaos_n = _chaos_wal_exit_after()
        for name, end, rec in pend:
            run_id = rec["run"]
            rec_t0 = time.time()
            if run_id in cataloged:
                replayed += 1
            else:
                files = rec.get("files") or {}
                run_doc = {
                    "schema": RUN_SCHEMA, "version": RUN_VERSION,
                    "run": run_id, "t": rec.get("t"),
                    "logdir": str(rec.get("logdir", "")),
                    "hostname": str(rec.get("hostname", "")),
                    "label": str(rec.get("label", "")),
                    "tenant": str(rec.get("tenant", tenant)),
                    "files": files,
                    "features": rec.get("features") or {},
                }
                with atomic_write(store.run_doc_path(run_id),
                                  fsync=True) as f:
                    json.dump(run_doc, f, indent=1, sort_keys=True)
                _WAL_APPLIED_TICKS += 1
                if chaos_n and _WAL_APPLIED_TICKS >= chaos_n:
                    os._exit(88)  # the run doc landed, its catalog line not
                catalog.append_event(
                    tenant_root, "ingest", run=run_id,
                    logdir=str(rec.get("logdir", "")), files=len(files),
                    new_objects=0, bytes_added=0, via="service",
                    t=rec.get("t"),
                    **({"label": str(rec["label"])} if rec.get("label")
                       else {}))
                cataloged.add(run_id)
                applied += 1
            state["applied"][name] = max(
                int(state["applied"].get(name, 0)), end)
            # per record, so that a commit ack waiting on it leaves as soon
            # as it lands, not after the whole batch
            _save_wal_state(tenant_root, state, fsync=False)
            reg.span("wal_apply", "drain", rec_t0, time.time() - rec_t0,
                     trace=str(rec.get("trace") or ""), tenant=tenant,
                     run=run_id)
            if on_applied is not None:
                on_applied(name, end)
        _save_wal_state(tenant_root, state)
        journal.commit("wal_drain", key=tenant,
                       applied=applied, replayed=replayed)
        reg.inc("wal_drained", applied)
        reg.set_gauge("last_drain_unix", round(time.time(), 3))
        # the drained ids surface again under the next index refresh's span
        reg.mark_pending_refresh(
            tenant, [str(rec.get("trace") or "") for _n, _e, rec in pend])
    did_refresh = refresh_tenant(tenant_root) if refresh else False
    return {"applied": applied, "replayed": replayed,
            "refreshed": did_refresh}


def refresh_tenant(tenant_root: str) -> bool:
    """One coalesced index refresh covering everything applied so far,
    then the fleet passes' incremental refresh over the new commit; a
    no-op unless some applied offset is ahead of its refreshed offset."""
    state = load_wal_state(tenant_root)
    covered = dict(state["applied"])  # the snapshot this refresh covers
    if not any(int(state["refreshed"].get(n, 0)) < int(off)
               for n, off in covered.items()):
        return False
    from sofa_tpu_torch import metrics
    from sofa_tpu_torch.archive import index as aindex

    t0 = time.time()
    aindex.refresh_after_ingest(tenant_root)
    wall_s = time.time() - t0
    tenant = os.path.basename(tenant_root)
    reg = metrics.for_tenant_root(tenant_root)
    reg.observe("index_refresh", wall_s * 1e3)
    # the fleet passes ride the fresh commit: O(delta chunks), and a
    # stale fleet report is only a staler /v1/<tenant>/fleet answer
    from sofa_tpu_torch.analysis import fleet

    tf = time.time()
    if fleet.refresh_after_ingest(tenant_root):
        reg.observe("fleet_refresh", (time.time() - tf) * 1e3)
    for tid in reg.take_pending_refresh(tenant) or [""]:
        reg.span("index_commit", "refresh", t0, wall_s, trace=tid,
                 tenant=tenant)
    # reload before saving: the drainer may have advanced the applied
    # ledger meanwhile, and it must never go back
    state = load_wal_state(tenant_root)
    merged = dict(state["refreshed"])
    for n, off in covered.items():
        merged[n] = max(int(merged.get(n, 0)), int(off))
    state["refreshed"] = merged
    _save_wal_state(tenant_root, state)
    return True


def wait_applied(tenant_root: str, name: str, end: int,
                 timeout_s: float = COMMIT_APPLY_TIMEOUT_S,
                 cond: "threading.Condition | None" = None) -> bool:
    """Block until the drainer applied the WAL record ending at ``end``,
    off the state file (cross-process); an in-process waiter passes the
    drainer's condition to wake at once."""
    deadline = time.monotonic() + timeout_s
    while True:
        state = load_wal_state(tenant_root)
        if int(state["applied"].get(name, 0)) >= end:
            return True
        if not os.path.isfile(
                os.path.join(wal_dir(tenant_root), name)):
            return True  # the epoch was gc'd, which follows a full apply
        if time.monotonic() >= deadline:
            return False
        if cond is not None:
            with cond:
                cond.wait(0.05)
        else:
            time.sleep(0.01)


class Drainer(threading.Thread):
    """Applies the WAL of every tenant this worker owns (the ring), on a
    kick from a local commit or a short poll, and refreshes their indexes
    on a thread of its own.  Skips a tenant root mid-gc (the derived-write
    guard owns it then)."""

    def __init__(self, root: str, worker: int = 0, workers: int = 1,
                 poll_s: float = 0.02):
        super().__init__(daemon=True, name="sofa-wal-drainer")
        self.root = root
        self.worker = int(worker)
        self.workers = max(int(workers), 1)
        self.poll_s = poll_s
        self.applied_cond = threading.Condition()
        self._kick = threading.Event()
        self._stop_evt = threading.Event()
        self._last_refresh: Dict[str, float] = {}
        # (tenant, wal file) -> applied end offset: commit-ack waiters read
        # it under applied_cond, with no file I/O on the wait path
        self.applied_mem: Dict[Tuple[str, str], int] = {}
        self._refresher = threading.Thread(
            target=self._refresh_loop, daemon=True,
            name="sofa-index-refresher")

    def kick(self) -> None:
        self._kick.set()

    def note_applied(self, tenant: str, name: str, end: int) -> None:
        with self.applied_cond:
            key = (tenant, name)
            if int(end) > self.applied_mem.get(key, -1):
                self.applied_mem[key] = int(end)
            self.applied_cond.notify_all()

    def wait_local(self, tenant: str, name: str, end: int,
                   timeout_s: float = COMMIT_APPLY_TIMEOUT_S) -> bool:
        """Block until this drainer applied the record ending at ``end``
        (valid for records appended after the drainer started)."""
        key = (tenant, name)
        deadline = time.monotonic() + timeout_s
        with self.applied_cond:
            while self.applied_mem.get(key, -1) < int(end):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.applied_cond.wait(min(left, 0.25))
        return True

    def _wake_waiters(self) -> None:
        with self.applied_cond:
            self.applied_cond.notify_all()

    def stop(self, join_s: float = 5.0) -> None:
        self._stop_evt.set()
        self._kick.set()
        if self.is_alive():
            self.join(timeout=join_s)
        if self._refresher.is_alive():
            self._refresher.join(timeout=join_s)

    def owned_tenants(self) -> List[str]:
        from sofa_tpu_torch.archive.service import TENANTS_DIR_NAME

        try:
            names = os.listdir(os.path.join(self.root, TENANTS_DIR_NAME))
        except OSError:
            return []
        return sorted(t for t in names
                      if ring_owner(t, self.workers) == self.worker)

    def _owned_roots(self):
        """(tenant, root) of each owned tenant with a WAL and no gc."""
        from sofa_tpu_torch.archive.service import TENANTS_DIR_NAME
        from sofa_tpu_torch.trace import derived_writing

        for tenant in self.owned_tenants():
            troot = os.path.join(self.root, TENANTS_DIR_NAME, tenant)
            if os.path.isdir(wal_dir(troot)) and not derived_writing(troot):
                yield tenant, troot

    def drain_cycle(self) -> int:
        """Apply every owned tenant's pending records, waking commit-ack
        waiters per record; never refreshes an index."""
        moved = 0
        for tenant, troot in self._owned_roots():
            try:
                stats = drain_tenant(
                    troot, refresh=False,
                    on_applied=lambda n, e, _t=tenant:
                        self.note_applied(_t, n, e))
            except OSError as e:
                # a wedged drain: acks time out into retryable 503s
                print_warning(f"serve: WAL drain for tenant {tenant} "
                              f"failed: {e}")
                continue
            if stats["applied"] or stats["replayed"]:
                moved += stats["applied"] + stats["replayed"]
                self._wake_waiters()
        return moved

    def refresh_cycle(self) -> int:
        """One pass of the refresher: a coalesced, rate-limited index
        refresh per owned tenant."""
        refreshed = 0
        for tenant, troot in self._owned_roots():
            if self._stop_evt.is_set():
                break
            if (time.monotonic() - self._last_refresh.get(troot, 0.0)
                    < REFRESH_MIN_INTERVAL_S):
                continue
            try:
                if refresh_tenant(troot):
                    self._last_refresh[troot] = time.monotonic()
                    refreshed += 1
            except OSError as e:
                print_warning(f"serve: index refresh for {tenant} "
                              f"failed: {e}")
        return refreshed

    def _refresh_loop(self) -> None:
        while not self._stop_evt.is_set():
            self._stop_evt.wait(REFRESH_MIN_INTERVAL_S / 2)
            if self._stop_evt.is_set():
                return
            self.refresh_cycle()

    def run(self) -> None:
        self._refresher.start()
        while not self._stop_evt.is_set():
            self._kick.wait(self.poll_s)
            self._kick.clear()
            if self._stop_evt.is_set():
                return
            self.drain_cycle()


# ---------------------------------------------------------------------------
# Topology (/v1/tier, `status --fleet`).
# ---------------------------------------------------------------------------

def tier_doc(root: str, worker: int, workers: int, role: str,
             reuseport: bool,
             replica_state: "dict | None" = None) -> dict:
    """The tier topology, computed from disk so any worker can answer:
    tenants with their ring owner, WAL depth, and index commit sha."""
    from sofa_tpu_torch.archive import index as aindex
    from sofa_tpu_torch.archive.service import TENANTS_DIR_NAME

    rows = []
    tdir = os.path.join(root, TENANTS_DIR_NAME)
    try:
        names = sorted(os.listdir(tdir))
    except OSError:
        names = []
    for tenant in names:
        troot = os.path.join(tdir, tenant)
        if not os.path.isdir(troot):
            continue
        commit = aindex.load_commit(troot) or {}
        row = {"tenant": tenant,
               "worker": ring_owner(tenant, workers),
               "wal_depth": wal_depth(troot),
               "commit_sha": commit.get("commit_sha") or ""}
        if replica_state is not None:
            rst = replica_state.get(tenant) or {}
            row["upstream_commit_sha"] = rst.get("upstream") or ""
            row["stale"] = bool(
                rst.get("upstream")
                and rst.get("upstream") != row["commit_sha"])
        rows.append(row)
    doc = {"schema": TIER_SCHEMA, "version": TIER_VERSION, "role": role,
           "worker": int(worker), "workers": int(workers),
           "reuseport": bool(reuseport), "tenants": rows}
    return doc


def render_tier_status(doc: dict, url: str) -> List[str]:
    """``status --fleet <url>`` lines from a /v1/tier document."""
    mode = "SO_REUSEPORT" if doc.get("reuseport") else "dispatcher"
    lines = [f"fleet tier at {url}: role {doc.get('role', '?')}, "
             f"{doc.get('workers', '?')} worker(s) ({mode}), "
             f"{len(doc.get('tenants') or [])} tenant(s)"]
    rows = [["TENANT", "WORKER", "WAL", "COMMIT", ""]]
    for t in doc.get("tenants") or []:
        note = ""
        if t.get("stale"):
            note = f"STALE (upstream {t.get('upstream_commit_sha', '')[:12]})"
        rows.append([t.get("tenant", "?"), str(t.get("worker", "?")),
                     str(t.get("wal_depth", "?")),
                     (t.get("commit_sha") or "-")[:12], note])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        lines.append("  " + "  ".join(
            c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return lines


def sofa_fleet_status(cfg) -> int:
    """``status --fleet <url>``: render the live tier topology,
    replica staleness (the X-Sofa-Replica-Stale/-Behind headers read
    explicitly, not only when a query happens to surface them), and the
    metrics plane's SLO state.  Exit 0 healthy, 1 on unreachable tier OR
    an active SLO breach, scriptable the way ``regress`` is."""
    from sofa_tpu_torch import metrics as fleet_metrics
    from sofa_tpu_torch.archive.service import resolve_token

    urls = [u.strip().rstrip("/")
            for u in (getattr(cfg, "status_fleet", "") or "").split(",")
            if u.strip()]
    token = resolve_token(cfg)
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    doc = None
    url = urls[0] if urls else ""
    errors: List[str] = []
    for candidate in urls:
        req = urllib.request.Request(f"{candidate}/v1/tier",
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                got = json.loads(r.read())
        except (OSError, ValueError, urllib.error.URLError) as e:
            errors.append(f"{candidate}: {e}")
            continue
        if not isinstance(got, dict) or got.get("schema") != TIER_SCHEMA:
            errors.append(f"{candidate}: not a {TIER_SCHEMA} document")
            continue
        doc, url = got, candidate
        break
    if doc is None:
        print_error("status --fleet: no endpoint answered — "
                    + "; ".join(errors or ["no urls given"]))
        return 1
    if url != urls[0]:
        # failover is never silent: say WHICH endpoint answered and why
        # the preferred one did not (the client-failover contract)
        print_warning(f"status --fleet: failed over to {url} ("
                      + "; ".join(errors) + ")")
    print("\n".join(render_tier_status(doc, url)))
    if doc.get("role") == "replica":
        for line in _replica_staleness_lines(url, headers, doc):
            print(line)
    rc = 0
    mdoc = _fetch_metrics_doc(url, headers)
    if mdoc is not None:
        lines, breach = render_fleet_metrics(mdoc)
        for line in lines:
            print(line)
        if breach:
            print_error("status --fleet: SLO breach ACTIVE — "
                        + ", ".join((mdoc.get("slo") or {})
                                    .get("breaching") or []))
            rc = 1
        last = mdoc.get("last_scrape_unix") or 0.0
        age_s = time.time() - last if last else 0.0  # another process's wall-clock stamp
        if age_s > fleet_metrics.STALE_SCRAPE_S:
            print_warning(
                f"status --fleet: last metrics scrape is "
                f"{age_s:.0f}s old (> "
                f"{fleet_metrics.STALE_SCRAPE_S:.0f}s) — the scrape "
                "loop may be stalled")
    return rc


def _fetch_metrics_doc(url: str, headers: dict) -> "dict | None":
    """GET /v1/metrics, best-effort: a tier predating the metrics plane
    (404) — or one with metrics disabled — just renders nothing."""
    from sofa_tpu_torch.metrics import METRICS_SCHEMA

    req = urllib.request.Request(f"{url}/v1/metrics", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10.0) as r:
            doc = json.loads(r.read())
    except (OSError, ValueError, urllib.error.URLError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != METRICS_SCHEMA:
        return None
    return doc


def _replica_staleness_lines(url: str, headers: dict,
                             doc: dict) -> List[str]:
    """One explicit staleness line per tenant, read from the query
    endpoint's X-Sofa-Replica-Stale/-Behind headers (the honest-
    staleness contract) instead of relying on whatever headers the last
    incidental query happened to carry."""
    lines: List[str] = []
    for t in doc.get("tenants") or []:
        tenant = t.get("tenant")
        if not tenant:
            continue
        req = urllib.request.Request(
            f"{url}/v1/{tenant}/query?limit=1", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                hdr = r.headers
        except urllib.error.HTTPError as e:
            hdr = e.headers
        except (OSError, urllib.error.URLError):
            continue
        if hdr.get("X-Sofa-Replica-Stale"):
            behind = hdr.get("X-Sofa-Replica-Behind") or ""
            lines.append(f"  replica: tenant {tenant} STALE — upstream "
                         f"moved to {behind[:12]} "
                         "(X-Sofa-Replica-Stale/-Behind)")
        elif hdr.get("X-Sofa-Replica"):
            lines.append(f"  replica: tenant {tenant} current "
                         f"(commit {(hdr.get('X-Sofa-Replica-Commit') or '-')[:12]})")
    return lines


def render_fleet_metrics(mdoc: dict) -> "Tuple[List[str], bool]":
    """(lines, breach_active) from a /v1/metrics document — the
    ``status --fleet`` metrics block."""
    lines: List[str] = []
    snap = mdoc.get("snapshot") or {}
    last = mdoc.get("last_scrape_unix") or 0.0
    age = f"{max(time.time() - last, 0.0):.1f}s ago" if last \
        else "never (no scrape yet)"
    lines.append(
        f"  metrics: worker {mdoc.get('worker', '?')}, last scrape "
        f"{age}, push p99 {snap.get('push_p99_ms', '-')} ms, "
        f"wal depth {snap.get('wal_depth', '-')}, replica behind "
        f"{snap.get('replica_behind', '-')}")
    slo = mdoc.get("slo")
    breach = False
    if isinstance(slo, dict):
        for t in slo.get("targets") or []:
            mark = {"ok": "ok", "breach": "BREACH",
                    "no_data": "no data"}.get(t.get("status"), "?")
            obs = t.get("observed")
            lines.append(
                f"  slo: {t.get('name')}{t.get('op')}{t.get('value'):g} "
                f"-> {mark}"
                + (f" (observed {obs:g})" if obs is not None else ""))
        breach = not slo.get("ok", True)
    return lines, breach


# ---------------------------------------------------------------------------
# Read replicas.
# ---------------------------------------------------------------------------

class ReplicaPuller:
    """Pulls immutable ``_index/`` commits from the upstream primary.

    Per tenant and pull: one conditional GET of the commit (sha == ETag,
    304 == done), then per family only the chunk files whose positional
    sha changed — content-keyed chunks make the transfer O(new data).
    ``index_commit.json`` is written LAST with fsync, so a SIGKILL
    mid-pull leaves the previous commit fully served.  The
    ``replica_stale`` fault pins the replica at its current commit while
    still learning the upstream sha — the honest-staleness-header path.
    """

    def __init__(self, root: str, upstream: str, token: str,
                 timeout_s: float = 10.0):
        self.root = root
        self.upstream = upstream.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s
        self._guard = Guard("tier.replica", protects=("_state",))
        #: tenant -> {"sha": served, "upstream": last seen upstream sha}
        self._state: Dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- transport ---------------------------------------------------------
    def _get(self, path: str, etag: "str | None" = None
             ) -> Tuple[int, bytes]:
        headers = {"Authorization": f"Bearer {self.token}"}
        if etag:
            headers["If-None-Match"] = etag
        req = urllib.request.Request(self.upstream + path, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            return e.code, body
        except (urllib.error.URLError, OSError) as e:
            # upstream down/unreachable: a pull cycle that finds nothing
            # is a no-op, the previous commit keeps serving
            return 599, str(e).encode()

    # -- state -------------------------------------------------------------
    def state(self) -> Dict[str, dict]:
        with self._guard:
            return {t: dict(s) for t, s in self._state.items()}

    def _note(self, tenant: str, **kw) -> None:
        with self._guard:
            self._state.setdefault(tenant, {}).update(kw)

    def upstream_tenants(self) -> List[str]:
        status, body = self._get("/v1/tier")
        if status != 200:
            return []
        try:
            doc = json.loads(body)
        except ValueError:
            return []
        return [t.get("tenant") for t in (doc.get("tenants") or [])
                if t.get("tenant")]

    # -- the pull ----------------------------------------------------------
    def pull_tenant(self, tenant: str) -> dict:
        """One tenant's incremental pull; returns
        ``{"fetched_chunks", "reused_chunks", "unchanged", "stale"}``."""
        from sofa_tpu_torch import faults
        from sofa_tpu_torch.archive import index as aindex
        from sofa_tpu_torch.archive.service import TENANTS_DIR_NAME
        from sofa_tpu_torch.durability import atomic_write

        troot = os.path.join(self.root, TENANTS_DIR_NAME, tenant)
        local = aindex.load_commit(troot)
        local_sha = (local or {}).get("commit_sha") or ""
        etag = f'"idx-{local_sha}"' if local_sha else None
        status, body = self._get(f"/v1/{tenant}/index/commit", etag=etag)
        if status == 304:
            aindex.pin_root(troot)
            self._note(tenant, sha=local_sha, upstream=local_sha)
            return {"fetched_chunks": 0, "reused_chunks": 0,
                    "unchanged": True, "stale": False}
        if status != 200:
            return {"fetched_chunks": 0, "reused_chunks": 0,
                    "unchanged": False, "stale": False,
                    "error": f"commit GET -> {status}"}
        try:
            commit = json.loads(body)
        except ValueError:
            return {"fetched_chunks": 0, "reused_chunks": 0,
                    "unchanged": False, "stale": False,
                    "error": "commit GET -> unparsable"}
        new_sha = commit.get("commit_sha") or ""
        if new_sha == local_sha:
            aindex.pin_root(troot)
            self._note(tenant, sha=local_sha, upstream=new_sha)
            return {"fetched_chunks": 0, "reused_chunks": 0,
                    "unchanged": True, "stale": False}
        if faults.maybe_replica_stale() and local is not None:
            # the fault pins us: serve the old commit, admit the lag
            self._note(tenant, sha=local_sha, upstream=new_sha)
            return {"fetched_chunks": 0, "reused_chunks": 0,
                    "unchanged": False, "stale": True}
        fetched = reused = 0
        for family in aindex.FAMILIES:
            fdir = aindex.family_dir(troot, family)
            status, fbody = self._get(
                f"/v1/{tenant}/index/{family}/frame_index.json")
            if status != 200:
                return {"fetched_chunks": fetched, "reused_chunks": reused,
                        "unchanged": False, "stale": False,
                        "error": f"{family} frame_index -> {status}"}
            try:
                fidx = json.loads(fbody)
            except ValueError:
                return {"fetched_chunks": fetched, "reused_chunks": reused,
                        "unchanged": False, "stale": False,
                        "error": f"{family} frame_index -> unparsable"}
            try:
                with open(os.path.join(fdir, "frame_index.json")) as f:
                    have = json.load(f)
            except (OSError, ValueError):
                have = {}
            have_chunks = have.get("chunks") or []
            os.makedirs(fdir, exist_ok=True)
            chunks = fidx.get("chunks") or []
            for pos, ch in enumerate(chunks):
                name = ch.get("file") or ""
                path = os.path.join(fdir, name)
                prev = have_chunks[pos] if pos < len(have_chunks) else None
                if prev and prev.get("sha") == ch.get("sha") \
                        and prev.get("rows") == ch.get("rows") \
                        and os.path.isfile(path):
                    reused += 1
                    continue
                status, data = self._get(
                    f"/v1/{tenant}/index/{family}/{name}")
                if status != 200:
                    # the primary refreshed under us and GC'd the chunk;
                    # abort THIS pull — the old commit stays served, the
                    # next cycle pulls the newer commit cleanly
                    return {"fetched_chunks": fetched,
                            "reused_chunks": reused, "unchanged": False,
                            "stale": False,
                            "error": f"{family}/{name} -> {status}"}
                with atomic_write(path, "wb") as f:
                    f.write(data)
                fetched += 1
            with atomic_write(os.path.join(fdir, "frame_index.json"),
                              fsync=True) as f:
                f.write(fbody.decode())
            for pos in range(len(chunks), len(have_chunks)):
                try:
                    os.unlink(os.path.join(
                        fdir, have_chunks[pos].get("file") or ""))
                except OSError:
                    pass
        # the commit lands LAST (fsync'd) — the replica's atomic cutover
        with atomic_write(aindex.commit_path(troot), fsync=True) as f:
            f.write(body.decode())
        aindex.pin_root(troot)
        self._note(tenant, sha=new_sha, upstream=new_sha)
        return {"fetched_chunks": fetched, "reused_chunks": reused,
                "unchanged": False, "stale": False}

    def pull_once(self) -> dict:
        """One pull across every upstream tenant; returns the summed
        stats plus per-tenant results.  Emits a ``replica_pull`` span
        and the ``replica_behind`` gauge (tenants whose served commit
        trails the upstream sha) into the root's metrics registry —
        the staleness history /v1/metrics serves."""
        from sofa_tpu_torch import metrics

        t0 = time.time()
        totals = {"fetched_chunks": 0, "reused_chunks": 0, "unchanged": 0,
                  "stale": 0, "errors": []}
        results: Dict[str, dict] = {}
        for tenant in self.upstream_tenants():
            res = self.pull_tenant(tenant)
            results[tenant] = res
            totals["fetched_chunks"] += res.get("fetched_chunks", 0)
            totals["reused_chunks"] += res.get("reused_chunks", 0)
            totals["unchanged"] += 1 if res.get("unchanged") else 0
            totals["stale"] += 1 if res.get("stale") else 0
            if res.get("error"):
                totals["errors"].append(f"{tenant}: {res['error']}")
        totals["tenants"] = results
        behind = sum(1 for s in self.state().values()
                     if s.get("upstream") and s.get("upstream")
                     != s.get("sha"))
        reg = metrics.for_root(self.root)
        reg.inc("replica_pulls")
        reg.set_gauge("replica_behind", behind)
        reg.observe("replica_pull", (time.time() - t0) * 1e3)
        reg.span("replica_pull", "replica", t0, time.time() - t0,
                 fetched=totals["fetched_chunks"],
                 stale=totals["stale"], behind=behind)
        return totals

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        try:
            poll = float(os.environ.get("SOFA_REPLICA_POLL_S",
                                        str(REPLICA_POLL_S)))
        except ValueError:
            poll = REPLICA_POLL_S

        def loop():
            while not self._stop.is_set():
                try:
                    self.pull_once()
                except OSError as e:
                    print_warning(f"replica: pull failed: {e}")
                self._stop.wait(poll)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sofa-replica-pull")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# The worker pool (``serve --workers N``).
# ---------------------------------------------------------------------------

def reuseport_available() -> bool:
    """SO_REUSEPORT where the platform has it; SOFA_TIER_NO_REUSEPORT=1
    forces the dispatcher fallback (tests prove both paths)."""
    if os.environ.get("SOFA_TIER_NO_REUSEPORT", "") == "1":
        return False
    return hasattr(socket, "SO_REUSEPORT")


def _reserve_port(bind: str, base_port: int):
    """(socket held open, port): a bound — NOT listening — SO_REUSEPORT
    socket reserves the port while workers come up; TCP delivers
    connections only to listeners, so holding it steals nothing."""
    ports = [0] if base_port == 0 else range(base_port, base_port + 20)
    last_err = None
    for port_try in ports:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind((bind, port_try))
            return s, s.getsockname()[1]
        except OSError as e:
            s.close()
            last_err = e
            if getattr(e, "errno", None) != errno.EADDRINUSE:
                break
    raise OSError(f"cannot bind {bind} near port {base_port}: {last_err}")


def _worker_main(spec: dict, worker: int, generation: int, ready) -> None:
    """One pool worker: bind (shared port with SO_REUSEPORT, else a
    loopback ephemeral the dispatcher proxies to), drain owned tenants,
    serve forever.  Runs in a child process; exits with it.

    SIGTERM is the graceful lifecycle: stop
    accepting (new writes answer a typed 503 ``draining``), drain every
    owned tenant's WAL to empty, flush metrics, exit 0 — an acked push
    can never ride out the door with a dying worker."""
    from sofa_tpu_torch import faults
    from sofa_tpu_torch.archive.service import (_FleetHandler,
                                                _FleetServer,
                                                graceful_drain)

    if spec.get("faults"):
        # the parent parsed the spec already: it cannot raise here
        import types

        faults.install_from(types.SimpleNamespace(
            inject_faults=spec["faults"]))
    addr = ((spec["bind"], spec["port"]) if spec["reuse"]
            else ("127.0.0.1", 0))
    try:
        httpd = _FleetServer(
            addr, _FleetHandler, root=spec["root"], token=spec["token"],
            quota_mb=spec["quota_mb"], max_inflight=spec["max_inflight"],
            worker=worker, workers=spec["workers"],
            reuse_port=spec["reuse"], generation=generation,
            slo=spec.get("slo", ""))
    except OSError as e:
        ready.put({"worker": worker, "error": str(e)})
        return
    got_term = threading.Event()

    def _on_term(signum, frame):  # noqa: ARG001 — signal handler contract
        got_term.set()
        with httpd._state_guard:
            httpd.draining = True
        # shutdown() blocks until serve_forever returns; the handler
        # runs ON the serve_forever thread — a direct call deadlocks
        threading.Thread(target=httpd.shutdown, daemon=True,  # sofa-lint: disable=SL023 — this thread IS the stop path: shutdown() unblocks serve_forever, the drain runs, and the process exits
                         name="sofa-tier-drain").start()

    import signal

    signal.signal(signal.SIGTERM, _on_term)
    ready.put({"worker": worker, "port": httpd.server_address[1],
               "pid": os.getpid()})
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if got_term.is_set():
            graceful_drain(httpd)
        httpd.server_close()
        served = httpd.stats_line()
        if served:
            print_progress(f"serve handled: worker {worker}: {served}")


class _DispatchHandler(http.server.BaseHTTPRequestHandler):
    """The SO_REUSEPORT fallback front door: proxies each request to a
    pool worker over loopback — tenant-affine (the ring) so a tenant's
    writes land on its owner first, with one retry onto a sibling when
    the chosen worker just died (the worker_die@<n> failover path)."""

    protocol_version = "HTTP/1.1"
    server_version = "sofa_tpu_torch-dispatch"

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _targets(self) -> List[int]:
        ports = self.server.worker_ports()
        if not ports:
            return []
        parts = [p for p in self.path.split("?", 1)[0].split("/") if p]
        if len(parts) >= 3 and parts[0] == "v1":
            first = ring_owner(parts[1], len(ports)) % len(ports)
        else:
            first = self.server.next_rr() % len(ports)
        return [ports[(first + i) % len(ports)]
                for i in range(len(ports))]

    def _relay(self):
        import http.client

        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            n = 0
        body = self.rfile.read(n) if n > 0 else b""
        fwd = {k: v for k, v in self.headers.items()
               if k.lower() in ("authorization", "content-type",
                                "if-none-match", "x-sofa-trace",
                                "x-sofa-deadline")}
        for port in self._targets():
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60.0)
            try:
                conn.request(self.command, self.path, body=body,
                             headers=fwd)
                resp = conn.getresponse()
                data = resp.read()
            except OSError:
                conn.close()
                continue  # the worker died mid-flight: try a sibling
            self.send_response(resp.status)
            passed = False
            for key, value in resp.getheaders():
                if key.lower() in ("date", "server", "connection",
                                   "transfer-encoding"):
                    continue
                if key.lower() == "content-length":
                    passed = True
                self.send_header(key, value)
            if not passed:
                self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            try:
                self.wfile.write(data)
            except OSError:
                pass
            conn.close()
            return
        body = json.dumps({"error": ERR_NO_WORKER}).encode()
        self.send_response(502)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = do_PUT = do_OPTIONS = _relay  # noqa: N815


class _DispatchServer(http.server.ThreadingHTTPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler):
        super().__init__(addr, handler)
        self._guard = Guard("tier.dispatch", protects=("_ports", "_rr"))
        self._ports: Dict[int, int] = {}
        self._rr = 0

    def set_worker_port(self, worker: int, port: int) -> None:
        with self._guard:
            self._ports[worker] = port

    def worker_ports(self) -> List[int]:
        with self._guard:
            return [self._ports[w] for w in sorted(self._ports)]

    def next_rr(self) -> int:
        with self._guard:
            self._rr += 1
            return self._rr


class TierHandle:
    """A running worker pool: the parent's supervisor + public address.
    ``stop()`` tears down workers, the dispatcher, and the reservation
    socket; the supervisor respawns a dead worker (generation + 1, so a
    ``worker_die`` fault fires once, not on every respawn)."""

    def __init__(self, root: str, bind: str, port: int, workers: int,
                 reuse: bool, spec: dict, ctx, ready):
        self.root = root
        self.bind = bind
        self.port = port
        self.workers = workers
        self.reuse = reuse
        self.spec = spec
        self._ctx = ctx
        self._ready = ready
        # The supervisor thread respawns into _procs/worker_pids while
        # the main thread reads them for stop()/status.
        self._guard = Guard("tier.handle",
                            protects=("_procs", "worker_pids"))
        self._procs: List = [None] * workers
        self._gens = [0] * workers
        self.worker_pids: Dict[int, int] = {}
        self.dispatcher: "_DispatchServer | None" = None
        self._dispatch_thread: "threading.Thread | None" = None
        self._reserve_sock = None
        self._stopping = threading.Event()
        self._supervisor: "threading.Thread | None" = None

    @property
    def url(self) -> str:
        host = self.bind if self.bind not in ("0.0.0.0", "::", "") \
            else "127.0.0.1"
        return f"http://{host}:{self.port}"

    def _spawn(self, worker: int) -> None:
        p = self._ctx.Process(
            target=_worker_main,
            args=(self.spec, worker, self._gens[worker], self._ready),
            daemon=True)
        p.start()
        with self._guard:
            self._procs[worker] = p

    def _collect_ready(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        seen = 0
        while seen < self.workers:
            remain = deadline - time.monotonic()
            if remain <= 0:
                return False
            try:
                msg = self._ready.get(timeout=remain)
            except Exception as e:  # noqa: BLE001 — queue.Empty across ctxs
                print_warning(f"serve: readiness wait interrupted: "
                              f"{e or type(e).__name__}")
                return False
            if msg.get("error"):
                print_error(f"serve: worker {msg['worker']} failed to "
                            f"bind: {msg['error']}")
                return False
            with self._guard:
                self.worker_pids[msg["worker"]] = msg.get("pid", 0)
            if self.dispatcher is not None:
                self.dispatcher.set_worker_port(msg["worker"], msg["port"])
            seen += 1
        return True

    def _supervise(self) -> None:
        while not self._stopping.is_set():
            for w, p in enumerate(self._procs):
                if p is None or p.exitcode is None:
                    continue
                if self._stopping.is_set():
                    return
                print_warning(
                    f"serve: worker {w} (pid {p.pid}) exited "
                    f"{p.exitcode} — respawning")
                if p.exitcode == 88:
                    # the SOFA_WAL_EXIT_AFTER knob fired: it means
                    # "die mid-drain ONCE" — the respawn must replay to
                    # convergence, not crash-loop on the same record
                    os.environ.pop("SOFA_WAL_EXIT_AFTER", None)
                self._gens[w] += 1
                self._spawn(w)
                # re-read its readiness (port may change in dispatcher
                # mode) without blocking the other workers' watch
                try:
                    msg = self._ready.get(timeout=15.0)
                except Exception as e:  # noqa: BLE001 — queue.Empty
                    print_warning(f"serve: respawned worker {w} not "
                                  f"ready yet: {e or type(e).__name__}")
                    continue
                if not msg.get("error"):
                    with self._guard:
                        self.worker_pids[msg["worker"]] = \
                            msg.get("pid", 0)
                    if self.dispatcher is not None:
                        self.dispatcher.set_worker_port(
                            msg["worker"], msg["port"])
            self._stopping.wait(0.2)

    def start(self) -> bool:
        for w in range(self.workers):
            self._spawn(w)
        if not self._collect_ready():
            self.stop()
            return False
        if self._reserve_sock is not None:
            self._reserve_sock.close()
            self._reserve_sock = None
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True, name="sofa-tier-sup")
        self._supervisor.start()
        return True

    def start_dispatcher(self, dispatcher) -> None:
        """Adopt a bound dispatcher and serve it from an owned thread —
        ``stop()`` is its reachable stop path (shutdown + join)."""
        self.dispatcher = dispatcher
        self._dispatch_thread = threading.Thread(
            target=dispatcher.serve_forever, daemon=True,
            name="sofa-tier-dispatch")
        self._dispatch_thread.start()

    def rolling_restart(self, timeout_s: float = 60.0) -> bool:
        """Restart the pool ONE worker at a time with zero acked-push
        loss: SIGTERM worker w (graceful drain — it refuses new writes,
        empties its WAL, exits 0), wait for the supervisor's respawn to
        report ready, then move on.  The ring makes the handoff safe:
        the dying worker's tenants are fully applied before it exits,
        siblings keep accepting all along (their WAL appends are
        fsync'd — the new life of the owner drains them), and at every
        instant N-1 workers serve."""
        import signal

        for w in range(self.workers):
            with self._guard:
                p = self._procs[w]
                old_pid = self.worker_pids.get(w, 0)
            if p is None or old_pid == 0:
                continue
            try:
                os.kill(old_pid, signal.SIGTERM)  # sofa-lint: disable=SL008 — graceful drain of our own child: TERM->KILL escalation would defeat the WAL drain; the supervisor respawn IS the fallback
            except OSError:
                continue  # already gone; the supervisor is on it
            deadline = time.monotonic() + timeout_s
            ok = False
            while time.monotonic() < deadline:
                with self._guard:
                    new_pid = self.worker_pids.get(w, 0)
                if new_pid and new_pid != old_pid:
                    ok = True
                    break
                time.sleep(0.05)
            if not ok:
                print_error(f"serve: rolling restart stalled waiting "
                            f"for worker {w} to respawn")
                return False
            print_warning(f"serve: rolling restart — worker {w} "
                          f"handed off (pid {old_pid} -> {new_pid})")
        return True

    def stop(self, join_s: float = 30.0) -> Dict[int, "int | None"]:
        """SIGTERM every worker (each drains its WAL and exits 0), wait
        for them, and stop the dispatcher; returns each worker's exit
        code (None: still running after ``join_s``)."""
        self._stopping.set()
        for p in self._procs:
            if p is not None and p.exitcode is None:
                p.terminate()
        for p in self._procs:
            if p is not None:
                p.join(timeout=join_s)
        if self.dispatcher is not None:
            self.dispatcher.shutdown()
            self.dispatcher.server_close()
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout=5.0)
        if self._reserve_sock is not None:
            self._reserve_sock.close()
            self._reserve_sock = None
        if self._supervisor is not None:
            self._supervisor.join(timeout=5.0)
        return {w: (p.exitcode if p is not None else None)
                for w, p in enumerate(self._procs)}


def supervisor_pidfile(root: str) -> str:
    """Where a long-running pool supervisor records its pid — the
    rendezvous ``serve --rolling-restart`` signals through."""
    return os.path.join(os.path.abspath(root), SUPERVISOR_PIDFILE_NAME)


def write_supervisor_pidfile(root: str) -> str:
    from sofa_tpu_torch.durability import atomic_write

    path = supervisor_pidfile(root)
    with atomic_write(path) as f:
        f.write(f"{os.getpid()}\n")
    return path


def remove_supervisor_pidfile(root: str) -> None:
    try:
        os.unlink(supervisor_pidfile(root))
    except OSError:
        pass


def signal_rolling_restart(root: str) -> int:
    """``serve --rolling-restart <root>``: SIGHUP the supervisor
    recorded in the root's pidfile.  Exit 0 signal delivered, 2 when no
    live supervisor is found (a stale pidfile is reported, not obeyed)."""
    import signal

    path = supervisor_pidfile(root)
    try:
        with open(path) as f:
            pid = int(f.read().strip() or "0")
    except (OSError, ValueError):
        print_error(f"serve --rolling-restart: no supervisor pidfile at "
                    f"{path} — is `serve --workers N` running on "
                    "this root?")
        return 2
    try:
        os.kill(pid, signal.SIGHUP)  # sofa-lint: disable=SL008 — SIGHUP is a control message to the supervisor (restart request), not a kill; nothing to escalate
    except OSError as e:
        print_error(f"serve --rolling-restart: supervisor pid {pid} from "
                    f"{path} is not signalable ({e}) — stale pidfile?")
        return 2
    print_warning(f"serve: rolling restart requested (SIGHUP -> "
                  f"supervisor pid {pid}); workers hand off one at a "
                  "time — watch the serving terminal")
    return 0


def start_pool(root: str, token: str, bind: str, base_port: int,
               quota_mb: float, max_inflight: int,
               workers: int, slo: str = "",
               fault_text: str = "") -> "TierHandle | None":
    """Spawn the N-worker pool; returns the running handle or None."""
    import multiprocessing

    # fork is cheap, but a forked child of a process that imported torch
    # is undefined: spawn there
    ctx = multiprocessing.get_context(
        "spawn" if "torch" in sys.modules else "fork")
    ready = ctx.Queue()
    reuse = reuseport_available()
    spec = {"root": os.path.abspath(root), "token": token,
            "quota_mb": quota_mb, "max_inflight": max_inflight,
            "bind": bind, "port": 0, "reuse": reuse, "workers": workers,
            "slo": slo, "faults": fault_text}
    reserve_sock = None
    dispatcher = None
    try:
        if reuse:
            reserve_sock, port = _reserve_port(bind, base_port)
            spec["port"] = port
        else:
            ports = [0] if base_port == 0 \
                else range(base_port, base_port + 20)
            last_err = None
            for port_try in ports:
                try:
                    dispatcher = _DispatchServer((bind, port_try),
                                                 _DispatchHandler)
                    break
                except OSError as e:
                    last_err = e
                    if getattr(e, "errno", None) != errno.EADDRINUSE:
                        break
            if dispatcher is None:
                raise OSError(f"cannot bind {bind} near port "
                              f"{base_port}: {last_err}")
            port = dispatcher.server_address[1]
    except OSError as e:
        print_error(f"serve: {e}")
        return None
    handle = TierHandle(root, bind, port, workers, reuse, spec, ctx, ready)
    handle._reserve_sock = reserve_sock
    if dispatcher is not None:
        handle.start_dispatcher(dispatcher)
    if not handle.start():
        return None
    return handle
