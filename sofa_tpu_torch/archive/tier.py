"""The fleet service's write-ahead ingest queue (the write-ahead half of
the JAX package's ``sofa_tpu/archive/tier.py``: ``:69-716``).

A commit lands as one fsync'd line in the tenant's
``_wal/wal.<worker>.<epoch>.jsonl`` (each worker appends only to its own
file, so appends never interleave); the ack returns once the owning
worker's :class:`Drainer` has applied it (the run doc and the catalog
line exist when the ack does), and the index refresh runs after the ack,
coalesced, on the drainer's refresher thread: a push never pays the
refresh's wall time.  Replay is a pure function of the WAL bytes (each
record carries its own timestamp), so a drain killed anywhere
(``SOFA_WAL_EXIT_AFTER``) and run again converges to the byte-identical
store, and the drain is journaled as the stage ``wal_drain``.

The consistent-hash ring (:func:`ring_owner`) names the worker that owns a
tenant's commit path; the drainer consults it at one worker too.

Not ported yet (the rest of the fleet tier): the worker pool (``--workers``
above 1), read replicas (``--replica-of``), ``/v1/tier`` and its topology
document, the rolling restart, and the fleet-pass refresh that
``refresh_tenant`` piggybacks on the index commit in the JAX package.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import re
import threading
import time
from typing import Dict, List, Tuple

from sofa_tpu_torch.archive import catalog
from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_warning

# The ``meta.tier`` manifest section and the commit ack's ``tier`` fold.
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

_WAL_FILE_RE = re.compile(r"^wal\.(\d{3})\.(\d{6})\.jsonl$")

# Virtual nodes per worker on the consistent-hash ring.
RING_VNODES = 64

# How long a commit ack waits for the drainer to apply its record before
# answering 503 (the client retries 5xx).
COMMIT_APPLY_TIMEOUT_S = 30.0

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
    with open(stage, "w") as f:
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
        from sofa_tpu_torch import metrics
        from sofa_tpu_torch.trace import fsync_append

        record = dict(record)
        record.setdefault("t", round(time.time(), 3))
        line = json.dumps(record, sort_keys=True) + "\n"
        t0 = time.time()
        with self._guard:
            name = self._name(self._epoch)
            path = os.path.join(wal_dir(self.tenant_root), name)
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size >= WAL_ROTATE_BYTES:
                self._gc_applied_epochs()
                self._epoch += 1
                name = self._name(self._epoch)
                path = os.path.join(wal_dir(self.tenant_root), name)
                size = 0
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
    """One coalesced index refresh covering everything applied so far; a
    no-op unless some applied offset is ahead of its refreshed offset.
    (The JAX package also refreshes its fleet passes here; they wait for
    the tier.)"""
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
