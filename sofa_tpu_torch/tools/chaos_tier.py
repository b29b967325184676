"""Chaos-under-load harness: the self-healing tier's proof.

The counterpart of ``tools/chaos_tier.py``, over the port's tier
(``archive/tier.py``) and its ``tools/fleet_load.py``. Host only: it never
touches a card. Drives the deterministic fleet_load workload against a
self-hosted worker pool while injecting the failure matrix the tier claims
to survive — a SIGKILLed worker (supervisor respawn + WAL replay), a full
rolling restart (ring handoff, one worker at a time), a SIGSTOPped replica,
and a fires-once ``disk_full`` ENOSPC on a WAL append — and asserts the
tier invariants the whole fleet stack leans on:

* **no acked push is ever lost** — every push the workload offered is
  eventually committed (the client's spool/retry discipline plus WAL
  durability), and the committed run sets match an uninterrupted twin
  tier fed the identical workload;
* **no wrong answer** — ``/v1/query`` converges to the same rows as the
  twin, and every tenant store is fsck-clean;
* **convergence is byte-identical** — each tenant's index commit sha
  equals an uninterrupted single-pass index build over the same durable
  ledger (catalog + objects), the crash-consistency contract
  archive/index.py documents;
* **recovery is bounded** — after the load ends the tier reaches
  drained-and-healthy within ``--recovery_bound_s``.

Reported metrics::

    tier_recovery_wall_time_s   last push acked -> drained + healthy
    tier_refusal_rate_pct       typed refusals / responses, fleet-wide

Modes::

    python -m sofa_tpu_torch.tools.chaos_tier            # full harness
    python -m sofa_tpu_torch.tools.chaos_tier --smoke    # seconds-scale

JSON on the last stdout line; exit 0 iff every invariant held.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from sofa_tpu_torch.tools import fleet_load

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_TOKEN = "chaos-tier-token"

# The replica child: its own root, pulling the primary's immutable index
# commits.  A subprocess on purpose — SIGSTOP must freeze the WHOLE
# replica (accept loop included), which no in-process thread can model.
_REPLICA_SNIPPET = """
import sys
sys.path.insert(0, sys.argv[4])
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.archive.service import sofa_serve
cfg = SofaConfig(serve_token=sys.argv[3], serve_port=0,
                 serve_replica_of=sys.argv[2])
sys.exit(sofa_serve(cfg, root=sys.argv[1]) or 0)
"""


def _start_tier(root: str, token: str, workers: int, inflight: int = 16,
                io_ms: float = 0.0,
                env_extra: "Dict[str, str] | None" = None):
    """Self-hosted worker pool on an ephemeral port; returns the live
    TierHandle.  ``env_extra`` (e.g. an armed SOFA_FAULTS plan) is in
    the environment only while the INITIAL workers fork — supervisor
    respawns after a chaos kill come up clean, so a fires-once fault
    cannot re-arm itself across the recovery it exists to prove."""
    from sofa_tpu_torch.archive import service

    env_extra = dict(env_extra or {})
    env_extra.setdefault("SOFA_TIER_IO_MS", str(io_ms))
    old = {k: os.environ.get(k) for k in env_extra}
    os.environ.update(env_extra)
    try:
        handle = service._serve_pool(root, token, "127.0.0.1", 0, 0.0,
                                     inflight, workers,
                                     serve_forever=False)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if handle is None:
        raise RuntimeError("chaos tier failed to start")
    return handle


def _start_replica(workdir: str, primary_url: str, token: str):
    """Replica child process; returns (proc, url, the thread draining its
    output, which ends with the child)."""
    import re

    root = os.path.join(workdir, "replica")
    os.makedirs(root, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", _REPLICA_SNIPPET,
         root, primary_url, token, _REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 30.0
    url = None
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(r"at http://[^:/]+:(\d+)/v1/", line)
        if m:
            url = f"http://127.0.0.1:{m.group(1)}"
            break
    if url is None:
        proc.kill()  # sofa-lint: disable=SL008 — a replica child that never came up: no collector tree, nothing to drain or escalate
        proc.wait()
        raise RuntimeError("replica child never printed its URL")
    # keep the pipe drained so the child never blocks on a full buffer
    drainer = threading.Thread(target=lambda: proc.stdout.read(),  # sofa-lint: disable=SL023 — returned to run_chaos, which joins it once the child has exited
                               daemon=True)
    drainer.start()
    return proc, url, drainer


def _probe_health(url: str, timeout_s: float = 1.0) -> Tuple[bool, dict]:
    """One short-deadline unauthenticated ``GET /v1/health`` — unlike
    fleet_load._Conn this does NOT wait out failures; a frozen replica
    must read as unhealthy, promptly."""
    import http.client
    import urllib.parse

    parsed = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(parsed.hostname or "127.0.0.1",
                                      parsed.port or 80,
                                      timeout=timeout_s)
    try:
        conn.request("GET", "/v1/health")
        resp = conn.getresponse()
        doc = json.loads(resp.read() or b"{}")
        return resp.status == 200 and bool(doc.get("ok")), doc
    except (OSError, ValueError):
        return False, {}
    finally:
        conn.close()


class _CounterSampler(threading.Thread):
    """Polls ``/v1/tier`` and folds each worker's cumulative
    refusals/responses counters into fleet totals.  Respawned workers
    restart their counters at zero — a sample BELOW the previous one
    means a new process, so the delta restarts from its current value
    instead of going negative and eating the history."""

    def __init__(self, url: str, token: str):
        super().__init__(daemon=True, name="chaos-tier-sampler")
        self.url = url
        self.token = token
        self.totals: Dict[str, float] = {"refusals": 0.0,
                                         "responses": 0.0}
        self._last: Dict[tuple, float] = {}
        self._halt = threading.Event()

    def _fold(self, doc: dict) -> None:
        worker = doc.get("worker")
        summary = doc.get("metrics") or {}
        for name in ("refusals", "responses"):
            cur = summary.get(f"{name}_total")
            if cur is None:
                continue
            key = (worker, name)
            prev = self._last.get(key, 0.0)
            self.totals[name] += cur - prev if cur >= prev else cur
            self._last[key] = cur

    def run(self) -> None:
        conn = fleet_load._Conn(self.url, self.token, timeout_s=5.0)
        try:
            while not self._halt.is_set():
                status, doc = conn.request("GET", "/v1/tier")
                if status == 200:
                    self._fold(doc)
                self._halt.wait(0.2)
        finally:
            conn.close()

    def stop(self) -> None:
        self._halt.set()

    def refusal_rate_pct(self) -> float:
        responses = max(self.totals["responses"], 1.0)
        return round(100.0 * self.totals["refusals"] / responses, 3)


def _wait_respawn(handle, worker: int, old_pid: int,
                  timeout_s: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with handle._guard:
            pid = handle.worker_pids.get(worker, 0)
        if pid and pid != old_pid:
            return True
        time.sleep(0.05)
    return False


def _converged(url: str, token: str, timeout_s: float = 120.0,
               consecutive: int = 3) -> Tuple[float, Optional[str]]:
    """Wall seconds until the tier reads drained AND healthy on
    ``consecutive`` straight probes (samples land on random pool
    workers, so one good answer proves one worker, not the tier)."""
    t0 = time.monotonic()
    conn = fleet_load._Conn(url, token, timeout_s=5.0)
    good = 0
    try:
        while time.monotonic() - t0 < timeout_s:
            ok = False
            status, doc = conn.request("GET", "/v1/tier")
            if status == 200 and doc.get("tenants") and all(
                    t.get("wal_depth") == 0 for t in doc["tenants"]):
                ok, _ = _probe_health(url, timeout_s=2.0)
            good = good + 1 if ok else 0
            if good >= consecutive:
                return time.monotonic() - t0, None
            time.sleep(0.1)
        return (time.monotonic() - t0,
                f"tier not drained+healthy within {timeout_s:.0f}s")
    finally:
        conn.close()


def _fsck_problems(troot: str, tenant: str) -> List[str]:
    from sofa_tpu_torch.archive.store import archive_fsck

    report = archive_fsck(troot)
    if report is None:
        return [f"{tenant}: no archive store at {troot}"]
    problems = []
    for verdict in ("corrupt", "missing", "orphaned", "uncataloged"):
        if report.get(verdict):
            problems.append(f"{tenant}: fsck {verdict}: "
                            f"{report[verdict][:3]}")
    return problems


def _ledger_twin_sha(troot: str) -> Optional[str]:
    """The uninterrupted-twin index commit: copy the tenant's durable
    ledger (catalog + objects + run docs — everything BUT the index,
    WAL, and metrics planes) to a fresh root and build the index in one
    never-interrupted pass.  The chaos tier's own converged commit must
    be byte-identical to this."""
    from sofa_tpu_torch.archive import index as aindex

    tmp = tempfile.mkdtemp(prefix="chaos_ledger_twin_")
    try:
        dst = os.path.join(tmp, "twin")
        shutil.copytree(troot, dst, ignore=shutil.ignore_patterns(
            aindex.INDEX_DIR_NAME, "_wal", "_metrics", "*.tmp"))
        doc = aindex.refresh(dst, jobs=0)
        if doc and doc.get("commit_sha"):
            return doc["commit_sha"]
        commit = aindex.load_commit(dst)
        return (commit or {}).get("commit_sha")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_chaos(*, workers: int = 3, agents: int = 8, pushes: int = 6,
              pollers: int = 2, tenants: int = 2,
              payload_bytes: int = 2048, push_interval_s: float = 0.05,
              io_ms: float = 0.0, inflight: int = 16,
              recovery_bound_s: float = 60.0, replica: bool = True,
              disk_full_at: int = 2,
              token: str = DEFAULT_TOKEN) -> dict:
    """The full chaos-under-load pass; returns the result document
    (``problems`` empty iff every invariant held)."""
    problems: List[str] = []
    events: List[str] = []
    load_kw = dict(agents=agents, pushes=pushes, pollers=pollers,
                   tenants=tenants, payload_bytes=payload_bytes,
                   push_interval_s=push_interval_s)
    recovery_s = -1.0
    load_res: dict = {}
    runs: Dict[str, List[str]] = {}
    with tempfile.TemporaryDirectory(prefix="chaos_tier_") as work:
        chaos_root = os.path.join(work, "chaos")
        fault_env = {}
        if disk_full_at > 0:
            fault_env["SOFA_FAULTS"] = f"service:disk_full@{disk_full_at}"
            events.append(f"armed service:disk_full@{disk_full_at} "
                          "in every initial worker")
        handle = _start_tier(chaos_root, token, workers,
                             inflight=inflight, io_ms=io_ms,
                             env_extra=fault_env)
        rproc = None
        sampler = _CounterSampler(handle.url, token)
        try:
            sampler.start()
            if replica:
                rproc, rurl, rdrain = _start_replica(work, handle.url,
                                                     token)
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    ok, _doc = _probe_health(rurl)
                    if ok:
                        break
                    time.sleep(0.2)
                else:
                    problems.append("replica never reported healthy "
                                    "before the chaos run")
            loader = threading.Thread(
                target=lambda: load_res.update(
                    fleet_load.run_fleet_load(handle.url, token,
                                              **load_kw)),
                daemon=True, name="chaos-tier-load")
            loader.start()
            time.sleep(0.5)  # let traffic establish before the chaos

            # chaos 1: SIGKILL a worker mid-load; the supervisor must
            # respawn it and WAL replay must cover its tenants
            with handle._guard:
                victim = handle.worker_pids.get(0, 0)
            if victim:
                os.kill(victim, signal.SIGKILL)  # sofa-lint: disable=SL008 — chaos injection: this IS the simulated worker crash
                events.append(f"SIGKILL worker 0 (pid {victim})")
                if not _wait_respawn(handle, 0, victim):
                    problems.append("supervisor never respawned the "
                                    "SIGKILLed worker")
            else:
                problems.append("no worker pid to SIGKILL")

            # chaos 2: rolling restart of the WHOLE pool under load —
            # each worker drains gracefully, siblings keep serving
            if not handle.rolling_restart(timeout_s=60.0):
                problems.append("rolling restart stalled")
            events.append("rolling restart (all workers, one at a time)")

            # chaos 3: freeze the replica; the primary must keep
            # answering and the replica must read unhealthy — honestly —
            # until thawed
            if rproc is not None:
                os.kill(rproc.pid, signal.SIGSTOP)  # sofa-lint: disable=SL008 — chaos injection: the frozen replica under test
                events.append("replica SIGSTOP")
                time.sleep(0.3)
                ok, _doc = _probe_health(rurl)
                if ok:
                    problems.append("frozen replica still answered "
                                    "/v1/health ok")
                os.kill(rproc.pid, signal.SIGCONT)  # sofa-lint: disable=SL008 — chaos injection: thawing the replica it froze
                events.append("replica SIGCONT")
                deadline = time.monotonic() + 30.0
                while time.monotonic() < deadline:
                    ok, _doc = _probe_health(rurl)
                    if ok:
                        break
                    time.sleep(0.2)
                else:
                    problems.append("replica never recovered after "
                                    "SIGCONT")

            loader.join(timeout=600.0)
            if loader.is_alive():
                problems.append("fleet_load never finished under chaos")
            # invariant: no acked push lost — the workload's closed-loop
            # retry means every offered push must eventually commit
            if load_res.get("error_count"):
                problems.append(
                    f"{load_res['error_count']} push/query failure(s) "
                    f"under chaos: {load_res.get('errors', [])[:5]}")

            # bounded recovery: last push acked -> drained + healthy
            recovery_s, rec_problem = _converged(handle.url, token)
            if rec_problem:
                problems.append(rec_problem)
            elif recovery_s > recovery_bound_s:
                problems.append(
                    f"recovery took {recovery_s:.1f}s "
                    f"(bound {recovery_bound_s:.0f}s)")
            runs = fleet_load.committed_runs(
                handle.url, token, load_res.get("tenants") or [])
        finally:
            sampler.stop()
            if rproc is not None:
                try:
                    os.kill(rproc.pid, signal.SIGCONT)  # sofa-lint: disable=SL008 — thaw before the TERM below, or a frozen replica never sees it
                except OSError:
                    pass
                rproc.terminate()
                try:
                    rproc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    rproc.kill()  # sofa-lint: disable=SL008 — TERM already sent and waited on: this is the escalation
                    rproc.wait()
                rdrain.join(timeout=10)
            handle.stop()

        # the uninterrupted twin tier: identical deterministic workload,
        # zero chaos — same run sets or the tier answered wrong
        twin_root = os.path.join(work, "twin")
        twin_handle = _start_tier(twin_root, token, workers,
                                  inflight=inflight, io_ms=io_ms)
        try:
            twin_res = fleet_load.run_fleet_load(twin_handle.url, token,
                                                 **load_kw)
            if twin_res.get("error_count"):
                problems.append("uninterrupted twin saw errors — "
                                "harness bug, not a tier verdict")
            fleet_load.wait_drained(twin_handle.url, token)
            twin_runs = fleet_load.committed_runs(
                twin_handle.url, token, twin_res.get("tenants") or [])
        finally:
            twin_handle.stop()
        if runs != twin_runs:
            diff = {t: (len(runs.get(t, [])), len(twin_runs.get(t, [])))
                    for t in set(runs) | set(twin_runs)
                    if runs.get(t) != twin_runs.get(t)}
            problems.append(f"committed run sets diverge from the "
                            f"uninterrupted twin: {diff}")

        # per-tenant: fsck-clean, and the index commit byte-identical
        # to an uninterrupted build over the same ledger
        from sofa_tpu_torch.archive import index as aindex

        for tenant in load_res.get("tenants") or []:
            troot = os.path.join(chaos_root, "tenants", tenant)
            problems += _fsck_problems(troot, tenant)
            converged = aindex.refresh(troot, jobs=0) or {}
            sha = converged.get("commit_sha")
            twin_sha = _ledger_twin_sha(troot)
            if not sha or sha != twin_sha:
                problems.append(
                    f"{tenant}: converged commit sha {sha!r} != "
                    f"uninterrupted ledger twin {twin_sha!r}")

    return {
        "metrics": {
            "tier_recovery_wall_time_s": round(recovery_s, 3),
            "tier_refusal_rate_pct": sampler.refusal_rate_pct(),
        },
        "load": load_res.get("metrics") or {},
        "pushes": load_res.get("pushes", 0),
        "queries": load_res.get("queries", 0),
        "workers": workers,
        "replica": bool(replica),
        "events": events,
        "refusals": sampler.totals["refusals"],
        "responses": sampler.totals["responses"],
        "problems": problems,
        "ok": not problems,
    }


def main(argv: "List[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--pushes", type=int, default=6)
    ap.add_argument("--pollers", type=int, default=2)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--payload_bytes", type=int, default=2048)
    ap.add_argument("--push_interval_s", type=float, default=0.05,
                    help="open-loop pacing (fleet_load.py)")
    ap.add_argument("--io_ms", type=float, default=0.0,
                    help="emulated storage latency (SOFA_TIER_IO_MS)")
    ap.add_argument("--inflight", type=int, default=16)
    ap.add_argument("--recovery_bound_s", type=float, default=60.0)
    ap.add_argument("--disk_full_at", type=int, default=2,
                    help="arm service:disk_full@<n> in initial workers "
                         "(0 = no disk fault)")
    ap.add_argument("--no_replica", action="store_true")
    ap.add_argument("--token", default=os.environ.get(
        "SOFA_SERVE_TOKEN", DEFAULT_TOKEN))
    ap.add_argument("--smoke", action="store_true",
                    help="a seconds-scale run")
    args = ap.parse_args(argv)
    if args.smoke:
        args.workers = min(args.workers, 2)
        args.agents, args.pushes = min(args.agents, 4), min(args.pushes, 3)
        args.pollers, args.tenants = 1, 2
    doc = run_chaos(workers=args.workers, agents=args.agents,
                    pushes=args.pushes, pollers=args.pollers,
                    tenants=args.tenants,
                    payload_bytes=args.payload_bytes,
                    push_interval_s=args.push_interval_s,
                    io_ms=args.io_ms, inflight=args.inflight,
                    recovery_bound_s=args.recovery_bound_s,
                    replica=not args.no_replica,
                    disk_full_at=args.disk_full_at, token=args.token)
    m = doc["metrics"]
    print(f"chaos_tier: {doc['pushes']} pushes / {doc['queries']} "
          f"queries across {len(doc['events'])} chaos event(s) — "
          f"recovery {m['tier_recovery_wall_time_s']}s, refusal rate "
          f"{m['tier_refusal_rate_pct']}% "
          f"({int(doc['refusals'])}/{int(doc['responses'])}), "
          f"{len(doc['problems'])} problem(s)", file=sys.stderr)
    for p in doc["problems"]:
        print(f"  - {p}", file=sys.stderr)
    print(json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
