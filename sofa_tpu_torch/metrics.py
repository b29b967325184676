"""The fleet tier's observability plane: metrics, SLOs and push tracing
(the JAX package's ``sofa_tpu/metrics.py``, whole).

**Metrics.**  :class:`MetricsRegistry` holds guard-protected counters,
gauges and fixed-bucket histograms (p50 and p99 by linear interpolation
inside the bucket: no sample is kept).  A per-worker :class:`Scraper`
ticks every ``SCRAPE_INTERVAL_S``: it computes the tier's gauges (WAL
depth, drain lag; the replica puller sets ``replica_behind``), freezes a
flat snapshot and appends the values that changed to a history, persisted
under ``<root>/_metrics/worker<NNN>/`` as a chunk store (content-keyed
chunks, no clock in the index).  An idle window appends nothing, so the
``/v1/metrics`` ETag moves only when a value moves.

**Tracing.**  The agent stamps each push with a trace id
(:func:`new_trace_id`, header ``X-Sofa-Trace``); the handlers, the WAL
append, the drainer, the index refresh and the replica pulls emit spans
(:meth:`MetricsRegistry.span`) under that id, and the WAL record carries
it across the process boundary.  Each process's ring is flushed to
``_metrics/fleet_trace/ring.<worker>.<pid>.json`` (Chrome-trace JSON), and
:func:`export_fleet_trace` merges the rings into one ``fleet_trace.json``.

**SLOs.**  ``serve --slo 'push_p99_ms<50,wal_depth<1000'`` declares
targets (:func:`parse_slo`), evaluated per scrape window into a typed
``slo_verdict``: each target answers ``ok``, ``breach`` or ``no_data``.
The verdict persists at ``_metrics/slo_verdict.json``; a breach's first
window appends one ``slo_breach`` event to each tenant's catalog (worker 0
only), and ``status --fleet`` exits 1 while a breach is active.

``SOFA_TIER_METRICS=0`` turns every hook into a no-op.  The fault kinds
``slo_breach@<window>`` and ``scrape_stall`` (``faults.py``) drive the
breach and stale-scrape paths on demand.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sofa_tpu_torch.concurrency import Guard

METRICS_SCHEMA = "sofa_tpu/fleet_metrics"
METRICS_VERSION = 1
SLO_SCHEMA = "sofa_tpu/slo_verdict"
SLO_VERSION = 1

#: Per-root observability state lives under ``<root>/_metrics/``: derived
#: and skipped by the digests, so the scrape loop rewrites it freely.
METRICS_DIR_NAME = "_metrics"
FLEET_TRACE_DIR_NAME = "fleet_trace"
SLO_VERDICT_NAME = "slo_verdict.json"
FLEET_TRACE_NAME = "fleet_trace.json"

#: Scrape cadence (seconds).  Env-tunable for tests and chaos runs.
SCRAPE_INTERVAL_S = float(os.environ.get("SOFA_METRICS_SCRAPE_S", "2.0"))

#: A commit ack whose last scrape is older than this is a stale metrics
#: plane: ``manifest_warnings`` says so on the pushed run's manifest.
STALE_SCRAPE_S = 30.0

#: Span ring capacity per process — oldest spans fall off; a push trace
#: is a handful of spans, so the ring holds hundreds of recent pushes.
RING_EVENTS = 4096

#: History rows kept in memory / persisted per worker (newest kept).
HISTORY_ROWS = 4096
#: Rows per history chunk — small on purpose: the tail-chunk rewrite per
#: scrape stays a few KiB (frames.write_chunk_store reuses the rest).
HISTORY_CHUNK_ROWS = 2048

#: Fixed histogram bucket upper bounds (ms).  Log-spaced so p50/p99 of a
#: sub-ms ack and a multi-second drain both land with ~2x resolution;
#: the last bucket is open-ended.
BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
              1000.0, 2000.0, 5000.0, 10000.0, float("inf"))

#: Chrome-trace lanes (tids) for fleet spans, mirroring telemetry.py's
#: _SELF_TRACE_LANES discipline: one lane per tier component so Perfetto
#: renders the push path as parallel tracks under one process.
FLEET_TRACE_LANES = {"service": 1, "wal": 2, "drain": 3, "refresh": 4,
                     "replica": 5, "agent": 6}
_OTHER_LANE = 7

#: Snapshot keys excluded from change-detection and the /v1/metrics ETag:
#: they move every scrape even when the tier is idle.
_VOLATILE_KEYS = ("scrape_wall_ms",)


def metrics_enabled() -> bool:
    """The kill switch: ``SOFA_TIER_METRICS=0`` turns every hook into a
    no-op."""
    return os.environ.get("SOFA_TIER_METRICS", "1") != "0"


def new_trace_id() -> str:
    """A fresh 16-hex push trace id for the X-Sofa-Trace header."""
    return os.urandom(8).hex()


# ---------------------------------------------------------------------------
# Fixed-bucket histograms.
# ---------------------------------------------------------------------------

class Histogram:
    """Fixed-bucket latency histogram: O(len(BUCKETS_MS)) memory under
    any load, percentiles by linear interpolation inside the bucket.
    NOT self-locking — the owning registry's guard wraps every access."""

    __slots__ = ("counts", "count", "total")

    def __init__(self):
        self.counts = [0] * len(BUCKETS_MS)
        self.count = 0
        self.total = 0.0

    def observe(self, value_ms: float) -> None:
        for i, hi in enumerate(BUCKETS_MS):
            if value_ms <= hi:
                self.counts[i] += 1
                break
        self.count += 1
        self.total += float(value_ms)

    def percentile(self, p: float) -> float:
        """The p-th percentile estimate (0 < p <= 100).  Rank lands in a
        bucket; interpolate linearly between its bounds (the open last
        bucket answers its lower bound — honest saturation, not a made-up
        ceiling)."""
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if seen + n >= rank:
                lo = BUCKETS_MS[i - 1] if i else 0.0
                hi = BUCKETS_MS[i]
                if hi == float("inf"):
                    return lo
                frac = (rank - seen) / n
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += n
        return BUCKETS_MS[-2]


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """One process's counters/gauges/histograms/span-ring for one fleet
    root.  Obtain via :func:`for_root` (keyed by abspath — tests on
    distinct tmp roots never share state; a respawned pool worker is a
    fresh process and re-registers naturally)."""

    def __init__(self, root: str, worker: int = 0):
        self.root = root
        self.worker = int(worker)
        self.guard = Guard("metrics.registry", reentrant=True, protects=(
            "_counters", "_gauges", "_hists", "_events", "_pending",
            "_history", "_last_flat", "_last_counters", "scrape_seq",
            "last_scrape_unix", "_slo_breaching", "slo_verdict"))
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._events: collections.deque = collections.deque(
            maxlen=RING_EVENTS)
        #: tenant -> trace ids drained but not yet index-committed; the
        #: refresh span claims them (mark/take below).
        self._pending: Dict[str, List[str]] = {}
        self._history: collections.deque = collections.deque(
            maxlen=HISTORY_ROWS)
        self._last_flat: Dict[str, float] = {}
        self._last_counters: Dict[str, int] = {}
        self.scrape_seq = 0
        self.last_scrape_unix = 0.0
        self._slo_breaching: Tuple[str, ...] = ()
        self.slo_verdict: Optional[dict] = None

    # -- write side (hot path: every hook gates on metrics_enabled) --------

    def inc(self, name: str, n: int = 1) -> None:
        if not metrics_enabled():
            return
        with self.guard:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def set_gauge(self, name: str, value: float) -> None:
        if not metrics_enabled():
            return
        with self.guard:
            self._gauges[name] = float(value)

    def observe(self, name: str, value_ms: float) -> None:
        if not metrics_enabled():
            return
        with self.guard:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value_ms)

    def span(self, name: str, cat: str, t0_unix: float, dur_s: float,
             trace: str = "", **args) -> None:
        """One Chrome-trace complete ("X") span in the fleet ring.
        ``cat`` picks the Perfetto lane (FLEET_TRACE_LANES); ``trace``
        is the push's X-Sofa-Trace id — the join key the tentpole's
        "one push, one id" contract hangs on."""
        if not metrics_enabled():
            return
        ev_args = {k: v for k, v in args.items() if v not in (None, "")}
        if trace:
            ev_args["trace"] = trace
        with self.guard:
            self._events.append({
                "name": name, "cat": cat,
                "ts": int(t0_unix * 1e6),  # absolute µs; flush re-bases
                "dur": max(int(dur_s * 1e6), 1),
                "tid": FLEET_TRACE_LANES.get(cat, _OTHER_LANE),
                "args": ev_args,
            })

    def mark_pending_refresh(self, tenant: str,
                             trace_ids: List[str]) -> None:
        """Drained-but-not-committed trace ids: the next index refresh
        for ``tenant`` emits its commit span under each of these."""
        ids = [t for t in trace_ids if t]
        if not ids or not metrics_enabled():
            return
        with self.guard:
            cur = self._pending.setdefault(tenant, [])
            cur.extend(ids)
            del cur[:-64]  # bounded: a refresh covers at most 64 ids

    def take_pending_refresh(self, tenant: str) -> List[str]:
        with self.guard:
            return self._pending.pop(tenant, [])

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self.guard:
            return self._gauges.get(name, default)

    def record_window(self, t0: float, stable: Dict[str, float]) -> None:
        """Commit one scrape window: append CHANGED stable values to the
        history (idle windows append nothing — the /v1/metrics ETag only
        moves when a value moves), freeze counter baselines for the next
        window's rates, and stamp the scrape clock."""
        with self.guard:
            if stable != self._last_flat:
                for name in sorted(stable):
                    if stable[name] != self._last_flat.get(name):
                        self._history.append(
                            [round(t0, 3), name, float(stable[name])])
                self._last_flat = dict(stable)
            self._last_counters = dict(self._counters)
            self.scrape_seq += 1
            self.last_scrape_unix = t0

    def update_slo(self, verdict: dict) -> List[str]:
        """Install the window's verdict; returns the freshly-breaching
        target names (the TRANSITIONS — catalog events fire on these, not
        on every window a breach persists)."""
        with self.guard:
            prev = self._slo_breaching
            self._slo_breaching = tuple(verdict["breaching"])
            self.slo_verdict = verdict
        return [n for n in verdict["breaching"] if n not in prev]

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> Tuple[Dict[str, float], Dict[str, dict]]:
        """(flat values, histogram detail).  Flat keys are the SLO
        vocabulary: ``<counter>_total``/``<counter>_rps`` per counter,
        ``<hist>_p50_ms``/``<hist>_p99_ms``/``<hist>_count`` per
        histogram, gauges verbatim."""
        with self.guard:
            now = time.time()
            dt = max(now - self.last_scrape_unix, 1e-6) \
                if self.last_scrape_unix else 0.0
            flat: Dict[str, float] = dict(self._gauges)
            for name, n in sorted(self._counters.items()):
                flat[f"{name}_total"] = float(n)
                if dt:
                    delta = n - self._last_counters.get(name, 0)
                    flat[f"{name}_rps"] = round(delta / dt, 3)
            hists: Dict[str, dict] = {}
            for name, h in sorted(self._hists.items()):
                flat[f"{name}_p50_ms"] = round(h.percentile(50.0), 3)
                flat[f"{name}_p99_ms"] = round(h.percentile(99.0), 3)
                flat[f"{name}_count"] = float(h.count)
                hists[name] = {
                    "buckets_ms": [b for b in BUCKETS_MS
                                   if b != float("inf")],
                    "counts": list(h.counts),
                    "count": h.count,
                    "total_ms": round(h.total, 3),
                }
            return flat, hists

    def history_rows(self, offset: int = 0, limit: int = 0,
                     window_s: Optional[float] = None) -> Tuple[list, int]:
        """(rows, total): ``[t, name, value]`` rows oldest-first, after
        the window filter, paged by offset/limit (0 = no limit)."""
        with self.guard:
            rows = list(self._history)
        if window_s is not None:
            cut = time.time() - float(window_s)
            rows = [r for r in rows if r[0] >= cut]
        total = len(rows)
        rows = rows[offset:]
        if limit:
            rows = rows[:limit]
        return rows, total

    # -- trace ring flush --------------------------------------------------

    def flush_trace(self) -> Optional[str]:
        """Write this process's span ring to its per-pid file under
        ``_metrics/fleet_trace/`` — same Chrome-trace shape as
        ``sofa_self_trace.json`` (telemetry._write_self_trace), ts
        re-based to the ring's oldest span.  Returns the path, or None
        when the ring is empty."""
        with self.guard:
            events = list(self._events)
        if not events:
            return None
        from sofa_tpu_torch.durability import atomic_write

        pid = os.getpid()
        tdir = os.path.join(self.root, "_metrics", FLEET_TRACE_DIR_NAME)
        os.makedirs(tdir, exist_ok=True)
        ts_zero = min(e["ts"] for e in events)
        out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"sofa fleet worker{self.worker}"}}]
        for cat, lane in sorted(FLEET_TRACE_LANES.items(),
                                key=lambda kv: kv[1]):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": lane, "args": {"name": cat}})
        for e in events:
            out.append({"name": e["name"], "ph": "X", "cat": e["cat"],
                        "ts": e["ts"] - ts_zero, "dur": e["dur"],
                        "pid": pid, "tid": e["tid"], "args": e["args"]})
        path = os.path.join(tdir, f"ring.{self.worker:03d}.{pid}.json")
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"ts_zero_unix": ts_zero / 1e6,
                             "producer": "sofa_tpu_torch/metrics.py",
                             "worker": self.worker, "pid": pid}}
        with atomic_write(path) as f:
            json.dump(doc, f, separators=(",", ":"))
        return path

    # -- history persistence ----------------------------------------------

    def persist_history(self) -> Optional[dict]:
        """Persist the history ring as a chunked columnar store at
        ``_metrics/worker<NNN>/`` (frames.write_chunk_store: content-
        keyed chunks, index a pure function of the rows — identical under
        any ``--jobs``).  None when pyarrow is absent (the in-memory ring
        still serves /v1/metrics) or the history is empty."""
        from sofa_tpu_torch import frames

        if not frames.columnar_available():
            return None
        with self.guard:
            rows = list(self._history)
        if not rows:
            return None
        import pandas as pd

        df = pd.DataFrame(rows, columns=["t", "name", "value"])
        sdir = os.path.join(self.root, "_metrics",
                            f"worker{self.worker:03d}")
        return frames.write_chunk_store(
            df, sdir, f"metrics_worker{self.worker:03d}",
            columns=["t", "name", "value"],
            chunk_rows=HISTORY_CHUNK_ROWS, time_column="t")


# Process-wide registry cache, keyed by abspath(root): tier code reaches
# its root's registry from any module without threading a handle through
# every call signature (WalAppender and the drainer only know a tenant
# root — _root_of_tenant maps it back).
_REG_GUARD = Guard("metrics.roots", protects=("_REGISTRIES",))
_REGISTRIES: Dict[str, MetricsRegistry] = {}


def for_root(root: str, worker: Optional[int] = None) -> MetricsRegistry:
    key = os.path.abspath(root)
    with _REG_GUARD:
        reg = _REGISTRIES.get(key)
        if reg is None:
            reg = MetricsRegistry(key, worker=worker or 0)
            _REGISTRIES[key] = reg
        if worker is not None:
            reg.worker = int(worker)
        return reg


def for_tenant_root(tenant_root: str) -> MetricsRegistry:
    """The fleet root's registry for a ``<root>/tenants/<t>`` path; a
    bare store root (library/test callers) keys its own registry."""
    return for_root(_root_of_tenant(tenant_root))


def _root_of_tenant(tenant_root: str) -> str:
    t = os.path.abspath(tenant_root)
    parent = os.path.dirname(t)
    # literal, not service.TENANTS_DIR_NAME: service.py imports this
    # module, and the constant is schema-frozen ("tenants") either way
    if os.path.basename(parent) == "tenants":
        return os.path.dirname(parent)
    return t


# ---------------------------------------------------------------------------
# The fleet trace export.
# ---------------------------------------------------------------------------

def export_fleet_trace(root: str) -> Optional[dict]:
    """Merge every per-process ring under ``_metrics/fleet_trace/`` into
    one Perfetto-valid Chrome-trace doc, re-based to the oldest span
    across rings, and write it atomically as ``fleet_trace.json`` beside
    them.  Returns the doc (None when no ring has flushed) — the
    cross-process join the tentpole promises: the agent's push spans and
    the drainer's WAL-replay spans land in different rings from
    different pids, and come out as one timeline."""
    from sofa_tpu_torch.durability import atomic_write

    tdir = os.path.join(root, "_metrics", FLEET_TRACE_DIR_NAME)
    try:
        names = sorted(n for n in os.listdir(tdir)
                       if n.startswith("ring.") and n.endswith(".json"))
    except OSError:
        return None
    rings = []
    for name in names:
        try:
            with open(os.path.join(tdir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue  # torn/stale ring: the merge serves what is whole
        if isinstance(doc, dict) and isinstance(doc.get("traceEvents"),
                                                list):
            rings.append(doc)
    if not rings:
        return None
    zeros = [float((r.get("otherData") or {}).get("ts_zero_unix") or 0.0)
             for r in rings]
    base = min(z for z in zeros) if zeros else 0.0
    events: List[dict] = []
    for r, zero in zip(rings, zeros):
        shift = int((zero - base) * 1e6)
        for e in r["traceEvents"]:
            if not isinstance(e, dict):
                continue
            if e.get("ph") == "M":
                events.append(e)
            else:
                events.append({**e, "ts": int(e.get("ts", 0)) + shift})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"ts_zero_unix": base,
                         "producer": "sofa_tpu_torch/metrics.py",
                         "rings": len(rings)}}
    with atomic_write(os.path.join(tdir, FLEET_TRACE_NAME)) as f:
        json.dump(doc, f, separators=(",", ":"))
    return doc


# ---------------------------------------------------------------------------
# SLOs.
# ---------------------------------------------------------------------------

#: Two-char ops first: "<=" must not parse as "<" + "=5".
SLO_OPS = ("<=", ">=", "<", ">")

_SLO_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyz0123456789_.")


@dataclass(frozen=True)
class SloTarget:
    name: str
    op: str
    value: float


def parse_slo(spec: str) -> Tuple[SloTarget, ...]:
    """Parse ``'push_p99_ms<50,wal_depth<1000,replica_behind<3'``.
    Metric names are the flat snapshot vocabulary; a bad entry raises ValueError naming the offender — callers
    surface it as a usage error, never a traceback."""
    targets: List[SloTarget] = []
    for entry in (e.strip() for e in (spec or "").split(",")):
        if not entry:
            continue
        for op in SLO_OPS:
            name, sep, raw = entry.partition(op)
            if sep:
                break
        else:
            raise ValueError(
                f"SLO entry {entry!r}: expected <metric><op><value> "
                f"with op in {SLO_OPS}")
        name = name.strip()
        if not name or not set(name) <= _SLO_NAME_OK:
            raise ValueError(
                f"SLO entry {entry!r}: bad metric name {name!r} "
                "(lowercase, digits, '_', '.')")
        try:
            value = float(raw.strip())
        except ValueError:
            raise ValueError(
                f"SLO entry {entry!r}: bad threshold {raw.strip()!r}") \
                from None
        targets.append(SloTarget(name=name, op=op, value=value))
    return tuple(targets)


def _target_status(op: str, observed: float, value: float) -> str:
    ok = {"<": observed < value, "<=": observed <= value,
          ">": observed > value, ">=": observed >= value}[op]
    return "ok" if ok else "breach"


def evaluate_slo(targets: Tuple[SloTarget, ...],
                 values: Dict[str, float], window: int,
                 injected: bool = False) -> dict:
    """One scrape window's typed verdict.  Every declared target answers
    ``ok`` / ``breach`` / ``no_data`` — a metric the window never
    observed is said so, not silently skipped.  ``injected`` folds the slo_breach fault's
    synthetic target in, so the breach plumbing is testable on an
    otherwise healthy tier."""
    rows: List[dict] = []
    for t in targets:
        observed = values.get(t.name)
        if observed is None:
            rows.append({"name": t.name, "op": t.op, "value": t.value,
                         "observed": None, "status": "no_data"})
            continue
        rows.append({"name": t.name, "op": t.op, "value": t.value,
                     "observed": round(float(observed), 3),
                     "status": _target_status(t.op, float(observed),
                                              t.value)})
    if injected:
        rows.append({"name": "injected_fault", "op": "<", "value": 0.0,
                     "observed": 1.0, "status": "breach"})
    breaching = [r["name"] for r in rows if r["status"] == "breach"]
    return {"schema": SLO_SCHEMA, "version": SLO_VERSION,
            "window": int(window),
            "generated_unix": round(time.time(), 3),
            "targets": rows, "breaching": breaching,
            "ok": not breaching}


# ---------------------------------------------------------------------------
# The scrape loop.
# ---------------------------------------------------------------------------

class Scraper:
    """One worker's scrape loop: tick -> gauges -> snapshot -> history ->
    chunk store + trace flush -> SLO verdict.  Run as a daemon thread by
    the serving process (`start`/`close`), or driven tick-by-tick in
    tests (`tick` is the whole contract; the thread is just cadence)."""

    def __init__(self, reg: MetricsRegistry,
                 slo_targets: Tuple[SloTarget, ...] = (),
                 interval_s: Optional[float] = None,
                 role: str = "primary"):
        self.reg = reg
        self.slo_targets = tuple(slo_targets)
        self.interval_s = (SCRAPE_INTERVAL_S if interval_s is None
                           else float(interval_s))
        self.role = role
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # one window at a time: the loop's thread and a caller's final
        # flush (the SIGTERM drain) write the same ring, history and
        # verdict files
        self._tick_lock = threading.Lock()

    def start(self) -> None:
        if not metrics_enabled() or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="sofa-metrics-scrape", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # sofa-lint: disable=SL002 — the scrape loop must never kill the serving process; a failed window is simply absent from the history
                pass

    # -- one window --------------------------------------------------------

    def tick(self) -> Optional[dict]:
        """One scrape window.  Returns the SLO verdict (None when no
        targets are declared and no fault injected, or when a
        ``scrape_stall`` fault froze the window — last-scrape age then
        grows honestly, which is the point of that fault)."""
        with self._tick_lock:
            return self._tick()

    def _tick(self) -> Optional[dict]:
        from sofa_tpu_torch import faults

        reg = self.reg
        if not metrics_enabled():
            return None
        if faults.maybe_scrape_stall():
            reg.inc("scrape_stalled")
            return None
        t0 = time.time()
        self._collect_gauges()
        flat, _hists = reg.snapshot()
        window = reg.scrape_seq + 1
        stable = {k: v for k, v in flat.items()
                  if k not in _VOLATILE_KEYS}
        reg.record_window(t0, stable)
        reg.persist_history()
        reg.flush_trace()
        verdict = self._evaluate(flat, window)
        wall_ms = (time.time() - t0) * 1e3
        reg.set_gauge("scrape_wall_ms", round(wall_ms, 3))
        return verdict

    def _collect_gauges(self) -> None:
        """Tier gauges computed from disk each window: WAL depth across
        tenants and the drain lag behind the oldest pending work.
        Replica staleness is pushed by the puller itself
        (tier.ReplicaPuller sets ``replica_behind`` after each pull)."""
        from sofa_tpu_torch.archive import tier

        reg = self.reg
        tdir = os.path.join(reg.root, "tenants")
        depth = 0
        tenants = 0
        try:
            names = sorted(os.listdir(tdir))
        except OSError:
            names = []
        for name in names:
            troot = os.path.join(tdir, name)
            if not os.path.isdir(troot):
                continue
            tenants += 1
            try:
                depth += tier.wal_depth(troot)
            except OSError:
                continue
        reg.set_gauge("wal_depth", depth)
        reg.set_gauge("tenants", tenants)
        last_drain = reg.get_gauge("last_drain_unix", 0.0)
        lag = 0.0
        if depth and last_drain:
            lag = max(time.time() - last_drain, 0.0)
        reg.set_gauge("drain_lag_s", round(lag, 3))

    def _evaluate(self, flat: Dict[str, float], window: int) \
            -> Optional[dict]:
        from sofa_tpu_torch import faults

        injected = faults.maybe_slo_breach(window)
        if not self.slo_targets and not injected:
            return None
        verdict = evaluate_slo(self.slo_targets, flat, window,
                               injected=injected)
        reg = self.reg
        write_slo_verdict(reg.root, verdict)
        fresh = reg.update_slo(verdict)
        # Worker 0 alone writes catalog events: every pool worker scrapes
        # the same tier-level gauges, and a breach is one fact, not one
        # per worker.
        if fresh and reg.worker == 0:
            self._append_breach_events(verdict, fresh)
        return verdict

    def _append_breach_events(self, verdict: dict,
                              fresh: List[str]) -> None:
        from sofa_tpu_torch.archive import catalog

        by_name = {r["name"]: r for r in verdict["targets"]}
        tdir = os.path.join(self.reg.root, "tenants")
        try:
            tenants = sorted(n for n in os.listdir(tdir)
                             if os.path.isdir(os.path.join(tdir, n)))
        except OSError:
            tenants = []
        for tenant in tenants:
            for name in fresh:
                row = by_name.get(name) or {}
                try:
                    catalog.append_event(
                        os.path.join(tdir, tenant), "slo_breach",
                        metric=name, op=row.get("op"),
                        threshold=row.get("value"),
                        observed=row.get("observed"),
                        window=verdict["window"],
                        worker=self.reg.worker)
                except OSError:
                    continue  # an unwritable tenant must not stall the scrape


def write_slo_verdict(root: str, verdict: dict) -> str:
    """Atomically persist the window's verdict at
    ``_metrics/slo_verdict.json`` (derived, skipped by the digests).
    Every worker of a pool writes this one file, so each write stages
    under a name of its own (``mkstemp``) before the rename: a shared
    ``.tmp`` name lets one worker's rename take another's staged file."""
    import tempfile

    mdir = os.path.join(root, "_metrics")
    os.makedirs(mdir, exist_ok=True)
    path = os.path.join(mdir, SLO_VERDICT_NAME)
    fd, tmp = tempfile.mkstemp(dir=mdir, prefix=SLO_VERDICT_NAME + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(verdict, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return path


def load_slo_verdict(root: str) -> Optional[dict]:
    path = os.path.join(root, METRICS_DIR_NAME, SLO_VERDICT_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != SLO_SCHEMA:
        return None
    return doc


# ---------------------------------------------------------------------------
# The /v1/metrics document.
# ---------------------------------------------------------------------------

def metrics_doc(reg: MetricsRegistry, offset: int = 0, limit: int = 0,
                window_s: Optional[float] = None,
                role: str = "primary") -> Tuple[dict, str]:
    """(document, ETag) for ``GET /v1/metrics``.  The ETag hashes the
    doc minus its wall-clock stamps, so an idle tier — no counter moved,
    no history row appended, same verdict — answers 304 to If-None-Match
    polls no matter how many scrape windows passed."""
    flat, hists = reg.snapshot()
    rows, total = reg.history_rows(offset=offset, limit=limit,
                                   window_s=window_s)
    with reg.guard:
        verdict = reg.slo_verdict
        seq = reg.scrape_seq
        last = reg.last_scrape_unix
    doc = {
        "schema": METRICS_SCHEMA, "version": METRICS_VERSION,
        "role": role, "worker": reg.worker,
        "generated_unix": round(time.time(), 3),
        "last_scrape_unix": round(last, 3),
        "scrape_seq": seq,
        "interval_s": SCRAPE_INTERVAL_S,
        "snapshot": {k: v for k, v in sorted(flat.items())},
        "histograms": hists,
        "history": {"total": total, "offset": int(offset),
                    "limit": int(limit),
                    # ring rows are [t, name, value] triples; the wire
                    # shape is the named-row contract the board and
                    # manifest_check.validate_fleet_metrics consume
                    "rows": [{"t": r[0], "name": r[1], "value": r[2]}
                             for r in rows]},
        "slo": verdict,
    }
    return doc, _doc_etag(doc)


def _doc_etag(doc: dict) -> str:
    stable = {k: v for k, v in doc.items()
              if k not in ("generated_unix", "last_scrape_unix",
                           "scrape_seq")}
    stable["snapshot"] = {k: v for k, v in doc["snapshot"].items()
                          if k not in _VOLATILE_KEYS
                          and not k.endswith("_unix")
                          # rates divide by wall time since the last
                          # scrape, so they drift between identical
                          # polls — content, not the clock, moves the tag
                          and not k.endswith("_rps")
                          # the metrics GET is itself a response, so this
                          # counter bumps on every poll — keeping it in the
                          # tag would make an idle tier never answer 304
                          and k != "responses_total"}
    slo = doc.get("slo")
    if isinstance(slo, dict):
        stable["slo"] = {k: v for k, v in slo.items()
                         if k not in ("generated_unix", "window")}
    sig = hashlib.sha256(
        json.dumps(stable, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()[:16]
    return f'"met-{doc["worker"]}-{sig}"'


def metrics_summary(reg: MetricsRegistry) -> dict:
    """The compact fold for ``/v1/tier`` and commit acks: enough for
    ``status --fleet`` and the agent's ``meta.metrics``, without the
    history."""
    flat, _ = reg.snapshot()
    with reg.guard:
        verdict = reg.slo_verdict
        last = reg.last_scrape_unix
    out = {
        "last_scrape_unix": round(last, 3),
        "scrape_age_s": round(time.time() - last, 3) if last else None,
        "push_p99_ms": flat.get("push_p99_ms"),
        "wal_depth": flat.get("wal_depth"),
        "replica_behind": flat.get("replica_behind"),
        # the refusal-rate pair rides /v1/tier, per worker
        "refusals_total": flat.get("refusals_total"),
        "responses_total": flat.get("responses_total"),
        "slo_ok": None if verdict is None else bool(verdict.get("ok")),
        "slo_breaching": list((verdict or {}).get("breaching") or []),
    }
    return {k: v for k, v in out.items() if v is not None or
            k in ("slo_ok", "scrape_age_s")}
