#!/usr/bin/env python
"""Fleet load harness: deterministic synthetic agents and query pollers
against a fleet service tier (the JAX package's ``tools/fleet_load.py``).

Drives N concurrent synthetic agents (each performing the real
have -> put -> commit protocol with unique content-addressed runs) plus
query pollers against a fleet service tier, and reports:

  fleet_push_p50_ms / fleet_push_p99_ms     end-to-end push latency
  fleet_query_p50_ms / fleet_query_p99_ms   /v1/query latency under load
  fleet_saturation_rps                      completed pushes per second

The workload is deterministic (payloads keyed by (tenant, agent, i)), so
two tiers fed the same parameters must commit the same run-id sets and
answer /v1/query with the same rows: ``--compare 1,4`` runs the workload
against a 1-worker and a 4-worker tier, asserts that equivalence, and
reports the saturation ratio.

Modes::

    python -m sofa_tpu_torch.tools.fleet_load --url http://host:8044 --token T
    python -m sofa_tpu_torch.tools.fleet_load --smoke        # self-hosted
    python -m sofa_tpu_torch.tools.fleet_load --compare 1,4  # the scaling

``--smoke`` is a tiny self-hosted fleet of a few seconds; every mode
prints its JSON on the last stdout line.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import socket
import sys
import tempfile
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

DEFAULT_TOKEN = "fleet-load-token"


def _pct(sorted_ms: List[float], pct: float) -> float:
    if not sorted_ms:
        return 0.0
    idx = min(int(len(sorted_ms) * pct / 100.0), len(sorted_ms) - 1)
    return sorted_ms[idx]


class _Conn:
    """One keep-alive connection to the tier (per worker thread)."""

    def __init__(self, url: str, token: str, timeout_s: float = 30.0):
        parsed = urllib.parse.urlparse(url)
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 80
        self.token = token
        self.timeout_s = timeout_s
        self._conn: "http.client.HTTPConnection | None" = None

    def request(self, method: str, path: str,
                body: "bytes | None" = None,
                extra: "Dict[str, str] | None" = None) -> Tuple[int, dict]:
        headers = {"Authorization": f"Bearer {self.token}"}
        if extra:
            headers.update(extra)
        if body is not None:
            headers["Content-Type"] = "application/json" \
                if method == "POST" else "application/octet-stream"
        # Closed-loop load: a dropped push would silently shrink the
        # committed run set and break cross-tier equivalence, so wait
        # out backpressure (503/429) patiently — the saturation number
        # comes from wall time, not from giving up.  The budget is
        # time-based: under deep saturation one request can eat many
        # 503 rounds, and a fixed attempt count quietly becomes a
        # latency ceiling that drops the slowest pushes.
        deadline = time.monotonic() + 120.0
        attempt = 0
        while time.monotonic() < deadline:
            attempt += 1
            if self._conn is None:
                self._conn = http.client.HTTPConnection(  # sofa-lint: disable=SL019 — each worker thread owns its own _Conn; no instance is shared across threads
                    self.host, self.port, timeout=self.timeout_s)
                try:
                    self._conn.connect()
                    # small-message request/response traffic: Nagle +
                    # delayed ACK would add ~40 ms per round trip
                    self._conn.sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    self._conn.close()
                    self._conn = None
                    time.sleep(min(0.05 * (attempt + 1), 0.5))
                    continue
            try:
                self._conn.request(method, path, body=body or b"",
                                   headers=headers)
                resp = self._conn.getresponse()
                data = resp.read()
            except OSError:
                # worker died / conn dropped: reconnect and retry — the
                # tier's failover contract is that a sibling answers
                self._conn.close()
                self._conn = None
                time.sleep(min(0.05 * (attempt + 1), 0.5))
                continue
            if resp.status in (503, 429, 507):
                # short fixed backoff: a long sleep leaves server write
                # slots idle and measures the sleep, not the tier.  507
                # is the fires-once disk_full refusal — the backed-off
                # retry proving recovery is the chaos_tier.py contract.
                time.sleep(0.05)
                continue
            try:
                return resp.status, json.loads(data) if data else {}
            except ValueError:
                return resp.status, {}
        return 599, {}

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


def _synthetic_run(tenant: str, agent: int, i: int,
                   payload_bytes: int) -> Dict[str, bytes]:
    """A deterministic tiny run: same (tenant, agent, i) -> same bytes ->
    same content-addressed run id on EVERY tier it is pushed to."""
    blob = (f"{tenant}/{agent}/{i}:".encode()
            * (payload_bytes // len(f"{tenant}/{agent}/{i}:") + 1)
            )[:payload_bytes]
    return {"run_manifest.json": json.dumps(
                {"synthetic": True, "agent": agent, "i": i},
                sort_keys=True).encode(),
            "payload.bin": blob}


def _push_run(conn: _Conn, tenant: str, files_bytes: Dict[str, bytes],
              trace: str = "") -> Tuple[bool, float]:
    """One full agent push (have -> missing puts -> commit); returns
    (committed, wall ms).  ``trace`` rides every request as X-Sofa-Trace
    (the cross-process push-tracing protocol), so the
    tier's spans join the harness's push under one id."""
    files = {rel: {"sha256": hashlib.sha256(data).hexdigest(),
                   "bytes": len(data)}
             for rel, data in files_bytes.items()}
    by_sha = {files[rel]["sha256"]: data
              for rel, data in files_bytes.items()}
    extra = {"X-Sofa-Trace": trace} if trace else None
    t0 = time.perf_counter()
    status, doc = conn.request("POST", f"/v1/{tenant}/have",
                               json.dumps({"files": files}).encode(),
                               extra=extra)
    if status != 200:
        return False, (time.perf_counter() - t0) * 1000.0
    for sha in doc.get("missing") or []:
        status, _ = conn.request("PUT", f"/v1/{tenant}/object/{sha}",
                                 by_sha[sha], extra=extra)
        if status != 200:
            return False, (time.perf_counter() - t0) * 1000.0
    status, ack = conn.request(
        "POST", f"/v1/{tenant}/commit",
        json.dumps({"files": files, "logdir": f"synthetic/{tenant}",
                    "hostname": "fleet-load"}).encode(), extra=extra)
    ms = (time.perf_counter() - t0) * 1000.0
    return status == 200 and bool(ack.get("committed")), ms


def run_fleet_load(url: str, token: str, *, agents: int = 8,
                   pushes: int = 8, pollers: int = 2, tenants: int = 4,
                   payload_bytes: int = 2048,
                   push_interval_s: float = 0.0) -> dict:
    """Drive the workload; returns the metrics document.  Deterministic
    run set: ``agents * pushes`` runs spread over ``tenants`` tenant
    namespaces.

    ``push_interval_s > 0`` switches the agents from closed-loop
    (back-to-back) to OPEN-LOOP pacing: agent ``a``'s push ``i`` is due
    at ``harness_start + i * push_interval_s`` on the shared absolute
    clock, and a thread that falls behind fires immediately without
    re-anchoring.  Per-iteration sleeps would let a slow tier quietly
    lower the offered load (each stall pushes every later request back),
    which inflates the saturation number exactly when the tier is
    struggling — the regime chaos_tier.py exists to measure."""
    push_ms: List[float] = []
    query_ms: List[float] = []
    errors: List[str] = []
    traces: List[dict] = []
    lock = threading.Lock()
    done = threading.Event()
    # The shared schedule origin: set ONCE just before the threads
    # start, never re-read per iteration — the absolute harness start.
    t_start = time.monotonic()

    def agent_main(a: int) -> None:
        tenant = f"lt{a % tenants}"
        for i in range(pushes):
            if push_interval_s > 0.0:
                due = t_start + i * push_interval_s
                lag = due - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
            # fresh connection per push, like the real short-lived
            # agent invocations, and it re-rolls the
            # SO_REUSEPORT hash, so demand rebalances across workers
            # between pushes instead of pinning to one for the run
            conn = _Conn(url, token)
            # deterministic per-push trace id (the workload is keyed
            # the same way): the fleet-trace test greps for exactly it
            trace = hashlib.sha256(
                f"trace:{tenant}/{a}/{i}".encode()).hexdigest()[:16]
            try:
                ok, ms = _push_run(
                    conn, tenant, _synthetic_run(tenant, a, i,
                                                 payload_bytes),
                    trace=trace)
            finally:
                conn.close()
            with lock:
                if ok:
                    push_ms.append(ms)
                    traces.append({"trace": trace, "tenant": tenant,
                                   "agent": a, "i": i})
                else:
                    errors.append(f"agent {a} push {i} failed")

    def poller_main(p: int) -> None:
        conn = _Conn(url, token)
        tenant = f"lt{p % tenants}"
        # Open-loop pacing from the absolute harness start: query k is
        # due at t_start + k * 0.05.  A sleep-after-each-query loop
        # would add each slow query's latency to every later deadline,
        # silently lowering the offered poll rate exactly when the tier
        # is slow — the case the p99 exists to expose.
        k = 0
        try:
            while not done.is_set():
                due = t_start + k * 0.05
                k += 1
                lag = due - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
                if done.is_set():
                    break
                t0 = time.perf_counter()
                status, _ = conn.request(
                    "GET", f"/v1/{tenant}/query?kind=runs&limit=50")
                ms = (time.perf_counter() - t0) * 1000.0
                with lock:
                    if status == 200:
                        query_ms.append(ms)
                    else:
                        errors.append(f"poller {p} query -> {status}")
        finally:
            conn.close()

    threads = [threading.Thread(target=agent_main, args=(a,), daemon=True)  # sofa-lint: disable=SL023 — joined below: every agent thread before wall_s
               for a in range(agents)]
    pthreads = [threading.Thread(target=poller_main, args=(p,),  # sofa-lint: disable=SL023 — joined below after done.set(), with a timeout
                                 daemon=True) for p in range(pollers)]
    t0 = time.perf_counter()
    for t in threads + pthreads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    done.set()
    for t in pthreads:
        t.join(timeout=5.0)
    push_ms.sort()
    query_ms.sort()
    metrics = {
        "fleet_push_p50_ms": round(_pct(push_ms, 50), 3),
        "fleet_push_p99_ms": round(_pct(push_ms, 99), 3),
        "fleet_query_p50_ms": round(_pct(query_ms, 50), 3),
        "fleet_query_p99_ms": round(_pct(query_ms, 99), 3),
        "fleet_saturation_rps": round(len(push_ms) / wall_s, 3)
        if wall_s > 0 else 0.0,
    }
    return {"metrics": metrics, "pushes": len(push_ms),
            "queries": len(query_ms), "wall_s": round(wall_s, 3),
            "errors": errors[:20], "error_count": len(errors),
            "traces": traces,
            "tenants": [f"lt{i}" for i in range(tenants)]}


def wait_drained(url: str, token: str, timeout_s: float = 60.0) -> bool:
    """Block until every tenant's WAL depth reads 0 on /v1/tier."""
    conn = _Conn(url, token)
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            status, doc = conn.request("GET", "/v1/tier")
            if status == 200 and all(
                    t.get("wal_depth") == 0
                    for t in doc.get("tenants") or []):
                return True
            time.sleep(0.2)
        return False
    finally:
        conn.close()


def fetch_metrics(url: str, token: str) -> Optional[dict]:
    """One authenticated ``GET /v1/metrics`` — the worker's observability
    document (None on any failure: a metrics-off tier still loads)."""
    conn = _Conn(url, token)
    try:
        status, doc = conn.request("GET", "/v1/metrics")
    finally:
        conn.close()
    return doc if status == 200 and isinstance(doc, dict) else None


def committed_runs(url: str, token: str,
                   tenants: List[str]) -> Dict[str, List[str]]:
    """Per tenant, the sorted committed run ids as /v1/query answers
    them — the cross-tier equivalence witness."""
    conn = _Conn(url, token)
    out: Dict[str, List[str]] = {}
    try:
        for tenant in tenants:
            rows: List[str] = []
            offset = 0
            while True:
                status, doc = conn.request(
                    "GET", f"/v1/{tenant}/query?kind=runs&limit=500"
                           f"&offset={offset}")
                if status != 200:
                    break
                batch = [r.get("run") for r in doc.get("rows") or []]
                rows.extend(r for r in batch if r)
                offset += len(batch)
                if not batch or offset >= int(doc.get("total") or 0):
                    break
            out[tenant] = sorted(rows)
    finally:
        conn.close()
    return out


def _start_tier(root: str, token: str, workers: int,
                inflight: int = 64, io_ms: float = 0.0):
    """Self-host a tier on an OS-assigned loopback port; returns
    (url, stop_callable).  Always the pool path: a --workers 1
    tier must be one worker process, not an in-process thread, or the
    cross-count comparison measures two different architectures.
    ``io_ms`` is the emulated storage latency (SOFA_TIER_IO_MS) slept
    per write while its admission slot is held: on a dev box the page
    cache makes writes CPU-cheap, which hides the storage-bound regime
    the worker pool exists to scale."""
    from sofa_tpu_torch.archive import service

    old_io = os.environ.get("SOFA_TIER_IO_MS")
    os.environ["SOFA_TIER_IO_MS"] = str(io_ms)
    try:
        handle = service._serve_pool(
            root, token, "127.0.0.1", 0, 0.0, inflight, workers,
            serve_forever=False)
    finally:
        if old_io is None:
            os.environ.pop("SOFA_TIER_IO_MS", None)
        else:
            os.environ["SOFA_TIER_IO_MS"] = old_io
    if handle is None:
        raise RuntimeError("tier failed to start")
    return handle.url, handle.stop


def _one_tier(workers: int, token: str, load_kw: dict,
              inflight: int = 64, io_ms: float = 0.0) -> dict:
    """Workload against a fresh self-hosted tier; returns the result doc
    plus the drained per-tenant run sets."""
    with tempfile.TemporaryDirectory(prefix="fleet_load_") as root:
        url, stop = _start_tier(root, token, workers,
                                inflight=inflight, io_ms=io_ms)
        try:
            res = run_fleet_load(url, token, **load_kw)
            res["drained"] = wait_drained(url, token)
            res["runs"] = committed_runs(url, token, res["tenants"])
            res["workers"] = workers
            mdoc = fetch_metrics(url, token)
            if mdoc is not None:
                snap = mdoc.get("snapshot") or {}
                res["tier_metrics"] = {
                    "scrape_seq": mdoc.get("scrape_seq"),
                    "scrape_wall_ms": snap.get("scrape_wall_ms"),
                    "push_p99_ms": snap.get("push_p99_ms"),
                    "wal_depth": snap.get("wal_depth"),
                }
        finally:
            stop()
    return res


def main(argv: "List[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", help="drive an existing tier at this URL")
    ap.add_argument("--token", default=os.environ.get(
        "SOFA_SERVE_TOKEN", DEFAULT_TOKEN))
    ap.add_argument("--agents", type=int, default=32)
    ap.add_argument("--pushes", type=int, default=8,
                    help="runs pushed per agent (closed loop)")
    ap.add_argument("--pollers", type=int, default=4)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--payload_bytes", type=int, default=2048)
    ap.add_argument("--push_interval_s", type=float, default=0.0,
                    help="open-loop pacing: agent push i is due at "
                         "harness_start + i * interval on the shared "
                         "absolute clock (0 = closed loop)")
    ap.add_argument("--workers", type=int, default=2,
                    help="self-hosted tier size (no --url)")
    ap.add_argument("--smoke", action="store_true",
                    help="a seconds-scale self-hosted fleet")
    ap.add_argument("--compare", metavar="N,M",
                    help="run the workload against each worker count, "
                         "assert equivalent results, report the ratio")
    ap.add_argument("--io_ms", type=float, default=None,
                    help="emulated storage latency per write "
                         "(SOFA_TIER_IO_MS); default 150 under "
                         "--compare, else 0")
    ap.add_argument("--inflight", type=int, default=None,
                    help="per-worker write-slot budget; default 4 "
                         "under --compare, else 64")
    ap.add_argument("--no_metrics", action="store_true",
                    help="self-hosted tiers run with the observability "
                         "plane off (SOFA_TIER_METRICS=0), the baseline "
                         "of its overhead")
    args = ap.parse_args(argv)
    if args.no_metrics:
        os.environ["SOFA_TIER_METRICS"] = "0"
    # --compare measures admission capacity (slots / storage latency),
    # which is what the worker pool multiplies.  With io_ms=0 on a
    # page-cached dev box the bottleneck is one core of Python HTTP
    # parsing, which no process count can scale.
    if args.io_ms is None:
        args.io_ms = 150.0 if args.compare else 0.0
    if args.inflight is None:
        args.inflight = 4 if args.compare else 64
    if args.smoke:
        args.agents, args.pushes = min(args.agents, 6), min(args.pushes, 4)
        args.pollers, args.tenants = min(args.pollers, 2), 2
    load_kw = dict(agents=args.agents, pushes=args.pushes,
                   pollers=args.pollers, tenants=args.tenants,
                   payload_bytes=args.payload_bytes,
                   push_interval_s=args.push_interval_s)

    if args.compare:
        counts = sorted({max(int(c), 1)
                         for c in args.compare.split(",") if c.strip()})
        results = {}
        for workers in counts:
            print(f"fleet_load: driving {args.agents} agents x "
                  f"{args.pushes} pushes against --workers {workers}",
                  file=sys.stderr)
            results[workers] = _one_tier(workers, args.token, load_kw,
                                         inflight=args.inflight,
                                         io_ms=args.io_ms)
        base = results[counts[0]]
        equivalent = all(r["runs"] == base["runs"]
                         and r["error_count"] == 0
                         for r in results.values())
        ratio = (results[counts[-1]]["metrics"]["fleet_saturation_rps"]
                 / max(base["metrics"]["fleet_saturation_rps"], 1e-9))
        doc = {"compare": {w: r["metrics"]
                           for w, r in results.items()},
               "io_ms": args.io_ms, "inflight": args.inflight,
               "equivalent": equivalent,
               "saturation_ratio": round(ratio, 2),
               "runs_per_tenant": {t: len(v)
                                   for t, v in base["runs"].items()}}
        for w in counts:
            m = results[w]["metrics"]
            print(f"  --workers {w}: {m['fleet_saturation_rps']} rps, "
                  f"push p99 {m['fleet_push_p99_ms']} ms, "
                  f"query p99 {m['fleet_query_p99_ms']} ms",
                  file=sys.stderr)
        print(f"  saturation ratio ({counts[-1]}w/{counts[0]}w): "
              f"{doc['saturation_ratio']}x; results equivalent: "
              f"{equivalent}", file=sys.stderr)
        print(json.dumps(doc))
        return 0 if equivalent else 1

    if args.url:
        res = run_fleet_load(args.url, args.token, **load_kw)
    else:
        res = _one_tier(args.workers, args.token, load_kw,
                        inflight=args.inflight, io_ms=args.io_ms)
    m = res["metrics"]
    print(f"fleet_load: {res['pushes']} pushes, {res['queries']} "
          f"queries in {res['wall_s']}s — {m['fleet_saturation_rps']} "
          f"rps, push p50/p99 {m['fleet_push_p50_ms']}/"
          f"{m['fleet_push_p99_ms']} ms, query p50/p99 "
          f"{m['fleet_query_p50_ms']}/{m['fleet_query_p99_ms']} ms, "
          f"{res['error_count']} error(s)", file=sys.stderr)
    print(json.dumps(res))
    return 0 if res["error_count"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
