"""The fleet service's metrics registry (the registry half of the JAX
package's ``sofa_tpu/metrics.py``: the constants of ``:69-114`` that it
reads, ``Histogram``,
``MetricsRegistry``'s write and snapshot side, ``for_root``,
``for_tenant_root`` and ``metrics_summary``, ``:825-847``).

One :class:`MetricsRegistry` per served root and process holds
guard-protected counters, gauges, fixed-bucket histograms (p50 and p99 by
linear interpolation inside the bucket: no sample is kept) and a bounded
ring of spans, each joined to the push's ``X-Sofa-Trace`` id.  The service
counts its responses and refusals into it, observes each push's latency,
and folds :func:`metrics_summary` into every commit ack, which the agent
writes into the run's ``meta.metrics``.

``SOFA_TIER_METRICS=0`` turns every hook into a no-op.

Not ported yet (they come with the fleet tier): the scrape loop
(``Scraper``), the windowed history and its chunk store, ``--slo`` and the
SLO verdicts, ``/v1/metrics``, and the span ring's flush into the fleet
trace (``flush_trace``, ``export_fleet_trace``).  Without a scrape the
summary's ``last_scrape_unix`` is 0 and its ``scrape_age_s`` null.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Optional, Tuple

from sofa_tpu_torch.concurrency import Guard

METRICS_SCHEMA = "sofa_tpu/fleet_metrics"
METRICS_VERSION = 1

# Span ring capacity per process: the oldest spans fall off.
RING_EVENTS = 4096

# Fixed histogram bucket upper bounds (ms), log-spaced; the last bucket is
# open-ended.
BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
              1000.0, 2000.0, 5000.0, 10000.0, float("inf"))

# Chrome-trace lanes (tids) for fleet spans, one per tier component.
FLEET_TRACE_LANES = {"service": 1, "wal": 2, "drain": 3, "refresh": 4,
                     "replica": 5, "agent": 6}
_OTHER_LANE = 7


def metrics_enabled() -> bool:
    """``SOFA_TIER_METRICS=0`` turns every hook into a no-op."""
    return os.environ.get("SOFA_TIER_METRICS", "1") != "0"


def new_trace_id() -> str:
    """A fresh 16-hex push trace id for the X-Sofa-Trace header."""
    return os.urandom(8).hex()


class Histogram:
    """Fixed-bucket latency histogram, percentiles by linear interpolation
    inside the bucket.  Not self-locking: the registry's guard wraps every
    access."""

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
        """The p-th percentile estimate (0 < p <= 100): the rank lands in a
        bucket and is interpolated between its bounds; the open last
        bucket answers its lower bound."""
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


class MetricsRegistry:
    """One process's counters, gauges, histograms and span ring for one
    fleet root.  Obtain it with :func:`for_root`."""

    def __init__(self, root: str, worker: int = 0):
        self.root = root
        self.worker = int(worker)
        self.guard = Guard("metrics.registry", reentrant=True, protects=(
            "_counters", "_gauges", "_hists", "_events", "_pending",
            "last_scrape_unix", "slo_verdict"))
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._events: collections.deque = collections.deque(
            maxlen=RING_EVENTS)
        # tenant -> trace ids drained but not yet index-committed; the
        # refresh span claims them
        self._pending: Dict[str, List[str]] = {}
        # set by the scrape loop of the tier; never set here yet
        self.last_scrape_unix = 0.0
        self.slo_verdict: Optional[dict] = None

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
        """One Chrome-trace complete ("X") span in the ring; ``cat`` picks
        the lane (FLEET_TRACE_LANES), ``trace`` is the push's id."""
        if not metrics_enabled():
            return
        ev_args = {k: v for k, v in args.items() if v not in (None, "")}
        if trace:
            ev_args["trace"] = trace
        with self.guard:
            self._events.append({
                "name": name, "cat": cat,
                "ts": int(t0_unix * 1e6),
                "dur": max(int(dur_s * 1e6), 1),
                "tid": FLEET_TRACE_LANES.get(cat, _OTHER_LANE),
                "args": ev_args,
            })

    def mark_pending_refresh(self, tenant: str,
                             trace_ids: List[str]) -> None:
        """Drained-but-not-committed trace ids: the next index refresh for
        ``tenant`` emits its commit span under each of them."""
        ids = [t for t in trace_ids if t]
        if not ids or not metrics_enabled():
            return
        with self.guard:
            cur = self._pending.setdefault(tenant, [])
            cur.extend(ids)
            del cur[:-64]  # a refresh covers at most 64 ids

    def take_pending_refresh(self, tenant: str) -> List[str]:
        with self.guard:
            return self._pending.pop(tenant, [])

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self.guard:
            return self._gauges.get(name, default)

    def snapshot(self) -> Tuple[Dict[str, float], Dict[str, dict]]:
        """(flat values, histogram detail).  Flat keys: ``<counter>_total``
        per counter, ``<hist>_p50_ms``/``_p99_ms``/``_count`` per
        histogram, gauges verbatim.  (The JAX package adds
        ``<counter>_rps`` per scrape window; without the scrape loop there
        is no window.)"""
        with self.guard:
            flat: Dict[str, float] = dict(self._gauges)
            for name, n in sorted(self._counters.items()):
                flat[f"{name}_total"] = float(n)
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


# One registry per served root and process, keyed by abspath(root): the WAL
# code reaches its root's registry from a tenant root alone.
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
    """The fleet root's registry for a ``<root>/tenants/<t>`` path; a bare
    store root keys its own registry."""
    return for_root(_root_of_tenant(tenant_root))


def _root_of_tenant(tenant_root: str) -> str:
    t = os.path.abspath(tenant_root)
    parent = os.path.dirname(t)
    # the literal, not service.TENANTS_DIR_NAME: service imports this
    # module, and the layout is schema-frozen either way
    if os.path.basename(parent) == "tenants":
        return os.path.dirname(parent)
    return t


def metrics_summary(reg: MetricsRegistry) -> dict:
    """The compact fold a commit ack carries (the agent's meta.metrics)."""
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
        "refusals_total": flat.get("refusals_total"),
        "responses_total": flat.get("responses_total"),
        "slo_ok": None if verdict is None else bool(verdict.get("ok")),
        "slo_breaching": list((verdict or {}).get("breaching") or []),
    }
    return {k: v for k, v in out.items() if v is not None or
            k in ("slo_ok", "scrape_age_s")}
