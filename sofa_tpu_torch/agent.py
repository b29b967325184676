"""``agent``: the per-host daemon of the fleet, which watches, spools and
forwards (the JAX package's ``sofa_tpu/agent.py``, whole).

1. **Watch** a directory for finished runs: a logdir is finished when its
   ``run_manifest.json`` exists, no verb holds the mid-write sentinel, its
   journal has no stage begun and not committed, and the manifest has
   been quiet for ``--settle_s``.
2. **Spool** each into a durable local archive (``archive/spool.py``):
   the bytes are safe before any network is involved.
3. **Forward** the spooled runs to the service (``serve``) over the
   idempotent, resumable upload protocol (``archive/client.py``).

An unreachable, loaded (503) or full (429) service never loses a run and
never wedges the loop: the run stays spooled and the next pass retries,
with the service's own attempts backed off (jittered) so that agents
whose service came back do not arrive as one wave.  A SIGKILLed agent
restarts into the same spool and journal and re-sends no committed
object.

Each run gets ``meta.agent`` in its manifest, and once the service acks
the commit ``meta.serve``, ``meta.tier``, ``meta.metrics`` and
``meta.health``, which ``status`` and ``tools/manifest_check.py`` read.

Exit codes (``--once``): 0 every run found is spooled and, with a
service, delivered; 1 degraded (spooled, not delivered); 2 a usage error.
Without ``--once`` it runs until interrupted.
"""

from __future__ import annotations

import os
import time
from typing import List

from sofa_tpu_torch import faults, telemetry
from sofa_tpu_torch.concurrency import jittered_backoff
from sofa_tpu_torch.printing import (
    print_error,
    print_progress,
    print_warning,
)


def discover_logdirs(watch: str) -> List[str]:
    """Candidate logdirs under ``watch``: the directory itself and its
    immediate children that carry a run manifest."""
    from sofa_tpu_torch.telemetry import MANIFEST_NAME

    out: List[str] = []
    candidates = [watch]
    try:
        candidates += sorted(
            os.path.join(watch, n) for n in os.listdir(watch)
            if os.path.isdir(os.path.join(watch, n)))
    except OSError:
        return []
    for d in candidates:
        if os.path.isfile(os.path.join(d, MANIFEST_NAME)):
            out.append(d if d.endswith("/") else d + "/")
    return out


def logdir_ready(logdir: str, settle_s: float = 0.5) -> bool:
    """A run is shippable when nothing is still writing it: no live
    mid-write sentinel, no begun-but-uncommitted journal stage, and the
    manifest quiet for ``settle_s`` (a recording host finishing analyze
    re-writes it within seconds)."""
    from sofa_tpu_torch.durability import journal_state, read_journal
    from sofa_tpu_torch.trace import derived_writing

    if derived_writing(logdir):
        return False
    for stage, st in journal_state(read_journal(logdir)).items():
        if stage != "push" and not st.get("committed"):
            return False
    from sofa_tpu_torch.archive.spool import _manifest_mtime

    mtime = _manifest_mtime(logdir)
    if mtime is None:
        return False
    return (time.time() - mtime / 1e9) >= max(settle_s, 0.0)


class _AgentPass:
    """One scan+drain pass; holds the tick's tallies for meta.agent and
    the exit code."""

    def __init__(self):
        self.discovered = 0
        self.spooled = 0
        self.pushed = 0
        self.failed = 0


def _push_meta(spool, client, logdir: str, run_id: str) -> dict:
    """Deliver one spooled run; returns the meta.agent ``push`` section
    (status pushed|spooled|rejected) and patches meta.serve on success."""
    from sofa_tpu_torch import metrics as fleet_metrics
    from sofa_tpu_torch.archive.client import (ServiceRejected,
                                               ServiceUnavailable)

    t0 = time.perf_counter()
    base_attempts = client.attempts
    # one trace id per push ATTEMPT: every request of this delivery
    # (have/put/commit) carries it as X-Sofa-Trace, and the service's
    # spans — handler, WAL append, drain, index commit — join under it
    # in the exported fleet trace (docs/FLEET.md "Observing the tier")
    client.trace_id = fleet_metrics.new_trace_id()
    try:
        result = spool.push(run_id, client)
    except ServiceRejected as e:
        print_warning(f"agent: service rejected {run_id[:12]}: {e} — "
                      "the run stays spooled"
                      + (" (over quota: raise --quota_mb server-side or "
                         "gc the tenant)" if e.quota else ""))
        return {"status": "rejected", "error": str(e)[:300],
                "quota": bool(e.quota),
                "trace": client.trace_id,
                "attempts": client.attempts - base_attempts,
                "wall_s": round(time.perf_counter() - t0, 3)}
    except ServiceUnavailable as e:
        print_warning(f"agent: service unreachable for {run_id[:12]}: "
                      f"{e} — spooled, will retry")
        return {"status": "spooled", "error": str(e)[:300],
                "trace": client.trace_id,
                "attempts": client.attempts - base_attempts,
                "wall_s": round(time.perf_counter() - t0, 3)}
    spool.mark_pushed(logdir, run_id, result.get("server") or {})
    return {"status": "pushed",
            "objects_sent": result.get("objects_sent", 0),
            "bytes_sent": result.get("bytes_sent", 0),
            "trace": client.trace_id,
            "attempts": client.attempts - base_attempts,
            "wall_s": round(time.perf_counter() - t0, 3),
            "server": result.get("server") or {}}


def _process_logdir(cfg, spool, client, logdir: str,
                    tick: _AgentPass) -> None:
    """Spool (if changed) and forward (if a service is configured) one
    finished logdir, recording meta.agent/meta.serve in its manifest."""
    import copy

    tick.discovered += 1
    ent = spool.entry(logdir)
    needs_spool = spool.needs_ingest(logdir)
    needs_push = client is not None and (needs_spool
                                         or not ent.get("pushed"))
    if not (needs_spool or needs_push):
        return
    lcfg = copy.deepcopy(cfg)
    lcfg.logdir = logdir
    lcfg.__post_init__()
    tel = telemetry.begin("agent")
    try:
        if needs_spool:
            summary = spool.spool(lcfg)
            if summary is None:
                tick.failed += 1
                return
            tick.spooled += 1
        run_id = spool.entry(logdir).get("run")
        meta_agent = {
            "spool": spool.root,
            "run": run_id,
            "service": client.base if client is not None else None,
            "tenant": client.tenant if client is not None else None,
        }
        push = None
        if client is not None and run_id:
            push = _push_meta(spool, client, logdir, run_id)
            meta_agent["push"] = push
            if push["status"] == "pushed":
                tick.pushed += 1
                ack = push.get("server") or {}
                tel.set_meta(serve={
                    "url": client.base,
                    "tenant": str(ack.get("tenant", client.tenant)),
                    "run": str(ack.get("run", run_id)),
                    "new": bool(ack.get("new")),
                    "quota_used_mb": ack.get("quota_used_mb"),
                    "committed_unix": round(time.time(), 3),
                })
                if isinstance(ack.get("tier"), dict):
                    # the scaled tier stamps which worker committed the
                    # run and how deep its ingest queue sat — the
                    # manifest's record of the placement decision
                    # (validated by tools/manifest_check.py)
                    tel.set_meta(tier={**ack["tier"],
                                       "url": client.base})
                if isinstance(ack.get("metrics"), dict):
                    # the tier's observability fold rides the ack home:
                    # the manifest records the push's trace id, wall,
                    # and the worker's scrape/SLO state at commit time
                    # (validated by tools/manifest_check.py)
                    tel.set_meta(metrics={
                        **ack["metrics"],
                        "trace": push.get("trace") or "",
                        "push_wall_s": push.get("wall_s"),
                    })
                    if ack["metrics"].get("slo_ok") is not None:
                        tel.set_meta(slo={
                            "ok": bool(ack["metrics"].get("slo_ok")),
                            "breaching": list(
                                ack["metrics"].get("slo_breaching")
                                or []),
                        })
            else:
                tick.failed += 1
        if client is not None:
            # the endpoint-health picture AFTER the push (meta.health,
            # docs/OBSERVABILITY.md): which endpoint served, how many
            # failovers this client has taken, which breakers stand
            # open — failover leaves a durable record in the manifest,
            # never just a log line
            from sofa_tpu_torch.archive.client import (HEALTH_SCHEMA,
                                                       HEALTH_VERSION)

            meta_agent["service"] = client.base  # post-failover truth
            tel.set_meta(health={
                "schema": HEALTH_SCHEMA, "version": HEALTH_VERSION,
                "endpoints": list(client.endpoints),
                "active": client.base,
                "failovers": int(client.failovers),
                "breakers_open": [u for u in client.endpoints
                                  if client.breaker_open(u)],
            })
        tel.set_meta(agent=meta_agent)
        tel.write(logdir, rc=0 if (push is None
                                   or push["status"] == "pushed") else 1,
                  cfg=lcfg)
        spool.refresh_fingerprint(logdir)
    finally:
        telemetry.end(tel)


def _drain_orphans(spool, client, tick: _AgentPass) -> None:
    """Push spooled runs whose source logdir is gone (deleted after
    spooling — the spool is the only surviving copy, which is the
    point): delivery must not depend on the source outliving the
    outage."""
    for run_id, logdir in spool.pending_runs().items():
        if os.path.isdir(logdir):
            continue  # the normal per-logdir path owns it
        push = _push_meta(spool, client, logdir, run_id)
        if push["status"] == "pushed":
            tick.pushed += 1
        else:
            tick.failed += 1


def sofa_agent(cfg, watch: "str | None" = None, once: bool = False) -> int:
    """``agent <watch_dir> [--service URL] [--once]``: see the
    module docstring for the loop and the exit contract."""
    from sofa_tpu_torch.archive.client import client_from_cfg
    from sofa_tpu_torch.archive.spool import Spool, resolve_spool

    watch = watch or cfg.logdir
    if not os.path.isdir(watch):
        print_error(f"agent: watch directory {watch} does not exist")
        return 2
    plan = faults.install_from(cfg)
    try:
        spool = Spool(resolve_spool(cfg))
        client = client_from_cfg(cfg)
        if client is None:
            print_progress(
                f"agent: no --service configured — spool-only mode "
                f"(runs land in {spool.root}; point --service at a "
                "`serve` endpoint to forward)")
        poll_s = max(float(getattr(cfg, "agent_poll_s", 5.0) or 5.0), 0.05)
        settle_s = float(getattr(cfg, "agent_settle_s", 0.5) or 0.0)
        service_failures = 0
        next_service_try = 0.0  # monotonic; 0 = try immediately
        while True:
            tick = _AgentPass()
            # Service attempts are themselves backed off (jittered):
            # after an outage, a fleet of agents must trickle back, not
            # stampede.  --once always makes one full attempt.
            gate_service = (client is not None and not once
                            and time.monotonic() < next_service_try)
            use_client = None if gate_service else client
            for logdir in discover_logdirs(watch):
                if os.path.abspath(logdir).startswith(spool.root):
                    continue  # never ship the spool into itself
                if not logdir_ready(logdir, settle_s=settle_s):
                    continue
                _process_logdir(cfg, spool, use_client, logdir, tick)
            if use_client is not None:
                _drain_orphans(spool, use_client, tick)
            if use_client is not None:
                if tick.failed:
                    service_failures += 1
                    backoff = jittered_backoff(
                        service_failures,
                        getattr(cfg, "agent_backoff_s", 0.5),
                        getattr(cfg, "agent_backoff_cap_s", 30.0))
                    next_service_try = time.monotonic() + backoff
                elif tick.pushed or tick.discovered:
                    service_failures = 0
            if once:
                undelivered = len(spool.pending_runs()) \
                    if client is not None else 0
                print_progress(
                    f"agent: {tick.discovered} run(s) discovered, "
                    f"{tick.spooled} spooled, {tick.pushed} pushed"
                    + (f", {undelivered} awaiting the service"
                       if undelivered else ""))
                return 1 if undelivered else 0
            time.sleep(poll_s)
    except KeyboardInterrupt:
        print_progress("agent: stopped")
        return 0
    finally:
        if plan is not None:
            faults.clear()
