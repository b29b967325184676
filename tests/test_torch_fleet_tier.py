"""The scaled fleet tier of the port: ``serve --workers N`` and
``--replica-of`` (``sofa_tpu_torch/archive/tier.py``), held to the JAX
package's recipes (``tests/test_fleet_tier.py``) and to the JAX package
itself.

The recipes: the consistent-hash ring under worker add and remove, the
write-ahead queue's replay byte identity after a kill mid-drain, commit
acks that do not wait on the index refresh, incremental replica pulls with
an mtime-proven no-op, primary and replica answering the same bytes at one
commit, the dispatcher path without SO_REUSEPORT, the tier fault kinds'
grammar, the deadline contract, a SIGTERMed worker draining its WAL, and
the ``/v1/tier`` document ``status --fleet`` renders.  The parity: a port
replica pulls from a JAX primary and a JAX replica from a port primary;
each package's agent pushes into the other's pool; the tenant roots are
fsck-clean under both packages.  Pool workers are spawned processes (the
test process has imported torch); every wait is bounded.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from sofa_tpu.agent import sofa_agent as jax_sofa_agent
from sofa_tpu.archive import service as jax_service
from sofa_tpu.archive import store as jax_store
from sofa_tpu.archive import tier as jax_tier
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu_torch import durability, faults, telemetry
from sofa_tpu_torch.agent import sofa_agent
from sofa_tpu_torch.archive import catalog as acat
from sofa_tpu_torch.archive import index as aindex
from sofa_tpu_torch.archive import tier
from sofa_tpu_torch.archive.service import (
    TENANTS_DIR_NAME,
    _serve_pool,
    _serve_replica,
    service_url,
    sofa_serve,
)
from sofa_tpu_torch.archive.store import archive_fsck
from sofa_tpu_torch.config import SofaConfig

TOKEN = "tier-test-token"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mklog(root, name="run1", files=None):
    """A minimal finished logdir: manifest + digest ledger + payload."""
    logdir = os.path.join(str(root), name) + "/"
    os.makedirs(logdir, exist_ok=True)
    payload = files or {"sofa_time.txt": "123.0\n",
                        "features.csv": "name,value\nelapsed_time,1.5\n"}
    for fname, content in payload.items():
        with open(logdir + fname, "w") as f:
            f.write(content)
    tel = telemetry.begin("analyze")
    tel.write(logdir, rc=0)
    telemetry.end(tel)
    durability.write_digests(logdir)
    return logdir


def _agent_cfg(tmp_path, url, **kw):
    kw.setdefault("serve_token", TOKEN)
    kw.setdefault("agent_service", url)
    kw.setdefault("agent_spool", str(tmp_path / "spool"))
    kw.setdefault("agent_settle_s", 0.0)
    kw.setdefault("agent_retries", 4)
    kw.setdefault("agent_backoff_s", 0.01)
    kw.setdefault("agent_backoff_cap_s", 0.05)
    return SofaConfig(logdir=str(tmp_path / "unused"), **kw)


def _wait_for(pred, timeout_s=15.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    pytest.fail(f"timed out after {timeout_s}s waiting for {what}")


def _fsck_clean(root):
    report = archive_fsck(root)
    assert report is not None, f"no archive at {root}"
    bad = {k: v for k, v in report.items()
           if isinstance(v, list) and v and k != "unreferenced"}
    assert not bad, f"store damage: {bad}"


def _tree_bytes(root, skip=("_journal.jsonl",)):
    """path -> content for every file under root, journal excluded (the
    killed drain legitimately carries an extra uncommitted begin)."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for n in sorted(names):
            if n in skip:
                continue
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture
def primary(tmp_path, monkeypatch):
    """An in-process single-worker PRIMARY (WAL drainer + refresher) on
    an ephemeral loopback port, with a fast refresh cadence."""
    monkeypatch.setattr(tier, "REFRESH_MIN_INTERVAL_S", 0.05)
    cfg = SofaConfig(logdir=str(tmp_path / "unused_srv"),
                     serve_token=TOKEN, serve_port=0)
    httpd = sofa_serve(cfg, root=str(tmp_path / "store"),
                       serve_forever=False)
    assert httpd is not None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)


def _get(url, headers=None):
    req = urllib.request.Request(
        url, headers={"Authorization": f"Bearer {TOKEN}",
                      **(headers or {})})
    with urllib.request.urlopen(req, timeout=10.0) as r:
        return r.status, dict(r.headers), r.read()


# ---------------------------------------------------------------------------
# The consistent-hash ring.
# ---------------------------------------------------------------------------

def test_ring_stable_under_worker_add():
    tenants = [f"team-{i:03d}" for i in range(200)]
    before = {t: tier.ring_owner(t, 4) for t in tenants}
    after = {t: tier.ring_owner(t, 5) for t in tenants}
    moved = [t for t in tenants if before[t] != after[t]]
    # only arcs the new worker's vnodes cover move — and they move TO it
    assert moved, "a new worker must steal some tenants"
    assert all(after[t] == 4 for t in moved)
    # ~1/5 expected; anything near a full reshuffle is a broken ring
    assert len(moved) < len(tenants) // 2


def test_ring_stable_under_worker_remove():
    tenants = [f"team-{i:03d}" for i in range(200)]
    before = {t: tier.ring_owner(t, 4) for t in tenants}
    after = {t: tier.ring_owner(t, (0, 1, 3)) for t in tenants}
    for t in tenants:
        if before[t] == 2:
            assert after[t] in (0, 1, 3)
        else:  # everyone else keeps their owner
            assert after[t] == before[t]


def test_ring_owner_deterministic_across_calls():
    assert tier.ring_owner("default", 4) == tier.ring_owner("default", 4)
    assert tier.ring_owner("default", (0, 1, 2, 3)) == \
        tier.ring_owner("default", 4)


# ---------------------------------------------------------------------------
# The write-ahead ingest queue.
# ---------------------------------------------------------------------------

def _wal_records(n, t0=1700000000.0):
    return [{"run": f"{i:02d}" + "ab" * 31, "t": round(t0 + i, 3),
             "logdir": f"/jobs/{i}/", "hostname": "host-a", "label": "",
             "tenant": "default", "files": {},
             "features": {"elapsed_time": 1.0 + i}}
            for i in range(n)]


def test_wal_depth_and_pending_runs(tmp_path):
    troot = str(tmp_path / "default")
    app = tier.WalAppender(troot, worker=0)
    recs = _wal_records(3)
    for rec in recs:
        app.append(rec)
    assert tier.wal_depth(troot) == 3
    assert tier.wal_pending_runs(troot) == {r["run"] for r in recs}
    stats = tier.drain_tenant(troot, refresh=False)
    assert stats["applied"] == 3
    assert tier.wal_depth(troot) == 0
    runs = acat.ingest_entries(acat.read_catalog(troot))
    assert [e["run"] for e in runs] == [r["run"] for r in recs]
    # caught-up drain is a no-op
    again = tier.drain_tenant(troot, refresh=False)
    assert again == {"applied": 0, "replayed": 0, "refreshed": False}


def test_sigkill_mid_drain_replays_byte_identical(tmp_path):
    """A drain hard-killed between the run-doc write and the catalog
    append (the widest replay window, SOFA_WAL_EXIT_AFTER) and then
    re-run converges to the byte-identical store an uninterrupted drain
    of the same WAL produces — and both fsck clean."""
    from sofa_tpu_torch.archive.store import ArchiveStore

    root_a = str(tmp_path / "a" / "default")
    # the archive marker carries a creation timestamp — stamp it BEFORE
    # the copy so both roots share one (replay identity is about the
    # WAL-derived bytes, not the store's birth certificate)
    ArchiveStore(root_a, create=True)
    app = tier.WalAppender(root_a, worker=0)
    for rec in _wal_records(3):
        app.append(rec)
    root_b = str(tmp_path / "b" / "default")
    shutil.copytree(root_a, root_b)

    code = ("import sys\nfrom sofa_tpu_torch.archive import tier\n"
            "tier.drain_tenant(sys.argv[1], refresh=False)\n")
    env = {**os.environ, "SOFA_WAL_EXIT_AFTER": "1", "PYTHONPATH": REPO}
    env.pop("SOFA_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", code, root_a], env=env,
                          capture_output=True, timeout=120)
    assert proc.returncode == 88, proc.stderr.decode()
    # the kill landed the first run doc but not its catalog line
    assert tier.wal_depth(root_a) == 3
    assert not os.path.isfile(os.path.join(root_a, "catalog.jsonl")) or \
        not acat.ingest_entries(acat.read_catalog(root_a))

    stats_a = tier.drain_tenant(root_a, refresh=False)   # the replay
    stats_b = tier.drain_tenant(root_b, refresh=False)   # uninterrupted
    assert stats_a["applied"] + stats_a["replayed"] == 3
    assert stats_b == {"applied": 3, "replayed": 0, "refreshed": False}
    assert _tree_bytes(root_a) == _tree_bytes(root_b)
    _fsck_clean(root_a)
    _fsck_clean(root_b)
    if aindex.available():
        # refresh lands the same index commit sha on both
        assert tier.refresh_tenant(root_a)
        assert tier.refresh_tenant(root_b)
        sha_a = (aindex.load_commit(root_a) or {}).get("commit_sha")
        sha_b = (aindex.load_commit(root_b) or {}).get("commit_sha")
        assert sha_a and sha_a == sha_b


def test_push_ack_not_gated_on_index_refresh(primary, tmp_path,
                                             monkeypatch):
    """The regression: commit acks must NOT queue behind
    ``refresh_after_ingest`` wall time (which grows with index size).
    With the server's refresh pinned at 1 s, the push must still ack
    fast — and the refresh must still happen, asynchronously."""
    from sofa_tpu_torch.archive.client import ServiceClient, push_run
    from sofa_tpu_torch.archive.store import ArchiveStore, ingest_run

    # spool the run BEFORE patching: the local spool ingest refreshes
    # its own index too, and its wall time is not what's under test
    logdir = _mklog(tmp_path / "watch")
    spool_root = str(tmp_path / "spoolstore")
    summary = ingest_run(SofaConfig(logdir=logdir), spool_root)

    refreshed = threading.Event()
    real = aindex.refresh_after_ingest

    def slow_refresh(root, *a, **kw):
        time.sleep(1.0)
        out = real(root, *a, **kw)
        refreshed.set()
        return out

    monkeypatch.setattr(aindex, "refresh_after_ingest", slow_refresh)
    client = ServiceClient(service_url(primary), TOKEN, timeout_s=10,
                           retries=2, backoff_s=0.01)
    t0 = time.monotonic()
    res = push_run(ArchiveStore(spool_root), summary["run"], client)
    elapsed = time.monotonic() - t0
    assert res["status"] in ("pushed", "committed")
    assert elapsed < 0.9, (
        f"push ack took {elapsed:.2f}s — it waited on the 1s index "
        "refresh, the inline-refresh bottleneck is back")
    troot = primary.tenant_root("default")
    assert len(acat.ingest_entries(acat.read_catalog(troot))) == 1
    if aindex.available():
        _wait_for(refreshed.is_set, what="async index refresh")


# ---------------------------------------------------------------------------
# Read replicas.
# ---------------------------------------------------------------------------

def _primary_commit_sha(primary, tenant="default"):
    troot = primary.tenant_root(tenant)
    return (aindex.load_commit(troot) or {}).get("commit_sha") or ""


@pytest.mark.skipif(not aindex.available(),
                    reason="columnar index needs pyarrow")
def test_replica_pull_incremental_and_noop(primary, tmp_path):
    watch = tmp_path / "watch"
    _mklog(watch, "run1")
    cfg = _agent_cfg(tmp_path, service_url(primary))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    sha1 = _wait_for(lambda: _primary_commit_sha(primary),
                     what="primary index commit")

    replica_root = str(tmp_path / "replica")
    puller = tier.ReplicaPuller(replica_root, service_url(primary), TOKEN)
    res = puller.pull_once()
    assert not res["errors"]
    assert res["fetched_chunks"] > 0
    rtroot = os.path.join(replica_root, TENANTS_DIR_NAME, "default")
    assert (aindex.load_commit(rtroot) or {}).get("commit_sha") == sha1

    # the no-op pull, proven by mtimes: same commit sha upstream means
    # NOTHING under the replica's _index/ is rewritten
    def _mtimes():
        out = {}
        for dirpath, _dirs, names in os.walk(rtroot):
            for n in names:
                p = os.path.join(dirpath, n)
                out[p] = os.stat(p).st_mtime_ns
        return out

    before = _mtimes()
    res2 = puller.pull_tenant("default")
    assert res2["unchanged"] and res2["fetched_chunks"] == 0
    assert _mtimes() == before

    # a second run moves the commit; the pull transfers only new chunks
    _mklog(watch, "run2")
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    sha2 = _wait_for(
        lambda: (_primary_commit_sha(primary) != sha1
                 and _primary_commit_sha(primary)),
        what="primary index commit to advance")
    res3 = puller.pull_tenant("default")
    assert not res3.get("error") and res3["fetched_chunks"] >= 1
    assert (aindex.load_commit(rtroot) or {}).get("commit_sha") == sha2


@pytest.mark.skipif(not aindex.available(),
                    reason="columnar index needs pyarrow")
def test_replica_query_byte_identical_and_stale_header(primary, tmp_path):
    watch = tmp_path / "watch"
    _mklog(watch, "run1")
    cfg = _agent_cfg(tmp_path, service_url(primary))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    sha1 = _wait_for(lambda: _primary_commit_sha(primary),
                     what="primary index commit")

    replica_root = str(tmp_path / "replica")
    os.environ["SOFA_REPLICA_POLL_S"] = "3600"  # tests drive pull_once
    try:
        httpd_r = _serve_replica(replica_root, TOKEN,
                                 service_url(primary), "127.0.0.1", 0, 8,
                                 serve_forever=False)
        assert httpd_r is not None
        t = threading.Thread(target=httpd_r.serve_forever, daemon=True)
        t.start()
        try:
            url_p = service_url(primary)
            url_r = service_url(httpd_r)
            q = "/v1/default/query?kind=runs"
            status_p, hdr_p, body_p = _get(url_p + q)
            status_r, hdr_r, body_r = _get(url_r + q)
            assert status_p == status_r == 200
            # same commit sha -> byte-identical answer, ETag == the sha
            assert body_p == body_r
            assert hdr_p["ETag"] == hdr_r["ETag"] == f'"idx-{sha1}"'
            assert hdr_r["X-Sofa-Replica"] == "1"
            assert hdr_r["X-Sofa-Replica-Commit"] == sha1
            assert "X-Sofa-Replica-Stale" not in hdr_r

            # advance the primary, THEN pin the replica (replica_stale;
            # installed after the push — the agent re-installs the
            # plan from ITS config, clearing a pre-set one): the replica
            # answers from its old commit and SAYS SO
            _mklog(watch, "run2")
            assert sofa_agent(cfg, watch=str(watch), once=True) == 0
            sha2 = _wait_for(
                lambda: (_primary_commit_sha(primary) != sha1
                         and _primary_commit_sha(primary)),
                what="primary index commit to advance")
            faults._PLAN = faults.parse("service:replica_stale")
            try:
                res = httpd_r.replica.pull_tenant("default")
                assert res["stale"] is True
                _status, hdr_s, body_s = _get(url_r + q)
                assert hdr_s["X-Sofa-Replica-Commit"] == sha1
                assert hdr_s["X-Sofa-Replica-Stale"] == "1"
                assert hdr_s["X-Sofa-Replica-Behind"] == sha2
                assert body_s == body_r  # still the old commit's bytes
            finally:
                faults.clear()
            # plan cleared: the next pull catches up and the flag drops
            res = httpd_r.replica.pull_tenant("default")
            assert not res.get("error") and not res["stale"]
            _status, hdr_c, _body = _get(url_r + q)
            assert hdr_c["X-Sofa-Replica-Commit"] == \
                _primary_commit_sha(primary)
            assert "X-Sofa-Replica-Stale" not in hdr_c
        finally:
            httpd_r.shutdown()
            httpd_r.server_close()
            t.join(timeout=5)
    finally:
        os.environ.pop("SOFA_REPLICA_POLL_S", None)


# ---------------------------------------------------------------------------
# The worker pool.
# ---------------------------------------------------------------------------

def test_reuseport_fallback_knob(monkeypatch):
    monkeypatch.setenv("SOFA_TIER_NO_REUSEPORT", "1")
    assert tier.reuseport_available() is False


def test_pool_dispatcher_fallback_serves(tmp_path, monkeypatch):
    """Without SO_REUSEPORT the pool fronts the workers with the
    dispatcher on ONE public port: pushes land, /v1/tier answers with
    the sharded topology."""
    monkeypatch.setenv("SOFA_TIER_NO_REUSEPORT", "1")
    handle = _serve_pool(str(tmp_path / "store"), TOKEN, "127.0.0.1", 0,
                         0.0, 8, 2, serve_forever=False)
    assert handle is not None
    try:
        assert handle.reuse is False and handle.dispatcher is not None
        watch = tmp_path / "watch"
        _mklog(watch)
        cfg = _agent_cfg(tmp_path, handle.url, agent_retries=8)
        assert sofa_agent(cfg, watch=str(watch), once=True) == 0
        _status, _hdr, body = _get(handle.url + "/v1/tier")
        doc = json.loads(body)
        assert doc["schema"] == tier.TIER_SCHEMA
        assert doc["version"] == tier.TIER_VERSION
        assert doc["workers"] == 2 and doc["reuseport"] is False
        rows = {r["tenant"]: r for r in doc["tenants"]}
        assert rows["default"]["worker"] == tier.ring_owner("default", 2)
        # the ack was read-your-writes: the WAL is already applied
        assert rows["default"]["wal_depth"] == 0
    finally:
        handle.stop()


# ---------------------------------------------------------------------------
# Fault grammar + topology rendering.
# ---------------------------------------------------------------------------

def test_tier_fault_kinds_parse_and_consume():
    plan = faults.parse("service:worker_die@2,service:replica_stale")
    assert plan.tier_replica_stale() is True
    # a respawned worker (generation > 0) must never re-fire
    assert plan.tier_worker_die(2, generation=1) is False
    assert plan.tier_worker_die(1, generation=0) is False
    assert plan.tier_worker_die(2, generation=0) is True
    assert plan.tier_worker_die(2, generation=0) is False  # consumed
    # tier kinds are the SERVER side's to absorb — the transport client
    # must skip them entirely
    assert plan.service_fault("service", "put", "k") is None
    with pytest.raises(ValueError):
        faults.parse("service:worker_die@zero")
    with pytest.raises(ValueError):
        faults.parse("service:replica_stale@start")


def test_tier_disk_full_and_conn_reset_grammar():
    """The two server-side kinds parse, consume, and stay on
    their own side of the client/server split."""
    plan = faults.parse("service:disk_full@2")
    # disk_full is the SERVER side's (TIER_KINDS) — the transport
    # client must skip it entirely
    assert plan.service_fault("service", "put", "k") is None
    assert plan.tier_disk_full() is False      # 1st consulted write
    assert plan.tier_disk_full() is True       # 2nd: ENOSPC fires once
    assert plan.tier_disk_full() is False      # consumed — retry lands
    # the ordinal defaults to the first write
    plan = faults.parse("service:disk_full")
    assert plan.tier_disk_full() is True
    with pytest.raises(ValueError):
        faults.parse("service:disk_full@zero")
    with pytest.raises(ValueError):
        faults.parse("service:disk_full@0.5")
    # conn_reset is a client-side NET kind: once per request key
    plan = faults.parse("service:conn_reset")
    assert plan.tier_disk_full() is False
    spec = plan.service_fault("service", "put", "a")
    assert spec is not None and spec.kind == "conn_reset"
    assert plan.service_fault("service", "put", "a") is None
    assert plan.service_fault("service", "put", "b") is not None


# ---------------------------------------------------------------------------
# Admission control: the X-Sofa-Deadline contract.
# ---------------------------------------------------------------------------

def _post(url, doc, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Authorization": f"Bearer {TOKEN}", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10.0) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


_HAVE_DOC = {"files": {"a.txt": {"sha256": "ab" * 32}}}


def test_deadline_expired_on_arrival_is_504(primary):
    """A request whose X-Sofa-Deadline already passed is refused with a
    typed 504 and NO Retry-After — the client gave up; doing the work
    would answer nobody."""
    url = service_url(primary) + "/v1/default/have"
    code, headers, doc = _post(url, _HAVE_DOC, headers={
        "X-Sofa-Deadline": f"{time.time() - 5.0:.3f}"})
    assert code == 504
    assert doc["error"] == "deadline_expired"
    assert "Retry-After" not in headers
    assert primary.stats.get("504_deadline_expired", 0) >= 1


def test_deadline_missing_header_serves_normally(primary):
    code, _headers, doc = _post(service_url(primary) +
                                "/v1/default/have", _HAVE_DOC)
    assert code == 200 and doc["missing"] == ["ab" * 32]


@pytest.mark.parametrize("raw", [
    # a clock-skewed agent 30 days in the future must not buy itself an
    # infinite deadline: beyond the skew cap the header is IGNORED (the
    # request serves), never obeyed
    lambda: f"{time.time() + 30 * 86400:.3f}",
    lambda: "not-a-deadline",                  # unparsable: ignored
])
def test_deadline_skew_and_garbage_are_ignored(primary, raw):
    code, _headers, doc = _post(
        service_url(primary) + "/v1/default/have", _HAVE_DOC,
        headers={"X-Sofa-Deadline": raw()})
    assert code == 200 and doc["missing"] == ["ab" * 32]


def test_deadline_within_cap_is_honored_not_refused(primary):
    """A sane near-future deadline serves: only EXPIRED refuses."""
    code, _headers, _doc = _post(
        service_url(primary) + "/v1/default/have", _HAVE_DOC,
        headers={"X-Sofa-Deadline": f"{time.time() + 30.0:.3f}"})
    assert code == 200


# ---------------------------------------------------------------------------
# Graceful lifecycle: SIGTERM drains the WAL and exits 0.
# ---------------------------------------------------------------------------

def test_sigterm_worker_drains_wal_and_exits_zero(tmp_path):
    """The graceful lifecycle: a SIGTERMed
    pool worker stops accepting, drains every owned tenant's WAL to
    EMPTY, and exits 0 — the acked pushes seeded into the WAL are
    committed state on disk after the exit, never lost."""
    import multiprocessing

    root = str(tmp_path / "store")
    troot = os.path.join(root, TENANTS_DIR_NAME, "default")
    app = tier.WalAppender(troot, worker=0)
    recs = _wal_records(3)
    for rec in recs:
        app.append(rec)
    assert tier.wal_depth(troot) == 3

    ctx = multiprocessing.get_context("spawn")
    ready = ctx.Queue()
    spec = {"root": root, "token": TOKEN, "bind": "127.0.0.1",
            "port": 0, "reuse": False, "quota_mb": 0.0,
            "max_inflight": 8, "workers": 1, "slo": ""}
    proc = ctx.Process(target=tier._worker_main,
                       args=(spec, 0, 0, ready), daemon=True)
    proc.start()
    msg = ready.get(timeout=30)
    assert "error" not in msg, msg
    # the worker is serving — health answers before the TERM
    _wait_for(lambda: _get(
        f"http://127.0.0.1:{msg['port']}/v1/health")[0] == 200,
        what="worker health")
    os.kill(proc.pid, signal.SIGTERM)
    proc.join(timeout=30)
    assert proc.exitcode == 0, f"worker exited {proc.exitcode}"
    assert tier.wal_depth(troot) == 0
    runs = acat.ingest_entries(acat.read_catalog(troot))
    assert [e["run"] for e in runs] == [r["run"] for r in recs]
    _fsck_clean(troot)


def test_fleet_status_renders_tier(primary, tmp_path, capsys):
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(primary))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    status_cfg = types.SimpleNamespace(status_fleet=service_url(primary),
                                       serve_token=TOKEN)
    assert tier.sofa_fleet_status(status_cfg) == 0
    out = capsys.readouterr().out
    assert "fleet tier at" in out and "role primary" in out
    assert "default" in out
    # a dead endpoint is a routed error, not a traceback
    bad = types.SimpleNamespace(status_fleet="http://127.0.0.1:1",
                                serve_token=TOKEN)
    assert tier.sofa_fleet_status(bad) == 1


# ---------------------------------------------------------------------------
# Parity with the JAX package: replicas and pools across the packages.
# ---------------------------------------------------------------------------

def _served(serve, cfg_cls, root):
    cfg = cfg_cls(logdir=os.path.join(root, "_unused"), serve_token=TOKEN,
                  serve_port=0)
    httpd = serve(cfg, root=root, serve_forever=False)
    assert httpd is not None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


@pytest.mark.skipif(not aindex.available(),
                    reason="columnar index needs pyarrow")
@pytest.mark.parametrize("primary_pkg", ["jax", "port"])
def test_replica_pulls_across_the_packages(tmp_path, monkeypatch,
                                           primary_pkg):
    """A port ReplicaPuller pulls from a JAX primary, a JAX one from a
    port primary; the replica's query rows are byte-identical to the
    primary's at the same commit."""
    monkeypatch.setattr(tier, "REFRESH_MIN_INTERVAL_S", 0.05)
    monkeypatch.setattr(jax_tier, "REFRESH_MIN_INTERVAL_S", 0.05)
    monkeypatch.setenv("SOFA_REPLICA_POLL_S", "3600")
    if primary_pkg == "jax":
        serve_p, cfg_p, replica_of = (jax_service.sofa_serve, JaxConfig,
                                      _serve_replica)
    else:
        serve_p, cfg_p, replica_of = (sofa_serve, SofaConfig,
                                      jax_service._serve_replica)
    httpd_p, t_p = _served(serve_p, cfg_p, str(tmp_path / "primary"))
    try:
        watch = tmp_path / "watch"
        _mklog(watch, "run1")
        _mklog(watch, "run2")
        cfg = _agent_cfg(tmp_path, service_url(httpd_p))
        assert sofa_agent(cfg, watch=str(watch), once=True) == 0
        q = "/v1/default/query?kind=runs"

        def current():
            # the primary answers from a current index over both runs
            doc = json.loads(_get(service_url(httpd_p) + q)[2])
            return len(doc.get("rows") or []) == 2 and doc.get("commit_sha")

        sha = _wait_for(current, what="primary index over both runs")
        httpd_r = replica_of(str(tmp_path / "replica"), TOKEN,
                             service_url(httpd_p), "127.0.0.1", 0, 8,
                             serve_forever=False)
        assert httpd_r is not None
        t_r = threading.Thread(target=httpd_r.serve_forever, daemon=True)
        t_r.start()
        try:
            _s, hdr_p, body_p = _get(service_url(httpd_p) + q)
            _s, hdr_r, body_r = _get(service_url(httpd_r) + q)
            assert body_p == body_r
            assert hdr_r["X-Sofa-Replica-Commit"] == sha
            assert hdr_p["ETag"] == hdr_r["ETag"] == f'"idx-{sha}"'
            # a second pull moves nothing
            res = httpd_r.replica.pull_tenant("default")
            assert res["unchanged"] and res["fetched_chunks"] == 0
        finally:
            httpd_r.shutdown()
            httpd_r.server_close()
            t_r.join(timeout=5)
    finally:
        httpd_p.shutdown()
        httpd_p.server_close()
        t_p.join(timeout=5)


@pytest.mark.parametrize("pool_pkg", ["port", "jax"])
def test_agents_push_into_the_other_packages_pool(tmp_path, monkeypatch,
                                                  pool_pkg):
    """A JAX agent pushes into a port pool of 2 workers, a port agent into
    a JAX pool of 2; the tenant root is fsck-clean under both packages'
    fsck."""
    monkeypatch.setenv("SOFA_REFRESH_MIN_INTERVAL_S", "0.05")
    root = str(tmp_path / "store")
    if pool_pkg == "port":
        handle = _serve_pool(root, TOKEN, "127.0.0.1", 0, 0.0, 8, 2,
                             serve_forever=False)
        agent, cfg_cls = jax_sofa_agent, JaxConfig
    else:
        handle = jax_service._serve_pool(root, TOKEN, "127.0.0.1", 0, 0.0,
                                         8, 2, serve_forever=False)
        agent, cfg_cls = sofa_agent, SofaConfig
    assert handle is not None
    try:
        watch = tmp_path / "watch"
        for name in ("run1", "run2", "run3"):
            _mklog(watch, name)
        cfg = cfg_cls(logdir=str(tmp_path / "unused"), serve_token=TOKEN,
                      agent_service=handle.url,
                      agent_spool=str(tmp_path / "spool"),
                      agent_settle_s=0.0, agent_retries=8,
                      agent_backoff_s=0.01, agent_backoff_cap_s=0.05)
        assert agent(cfg, watch=str(watch), once=True) == 0
        troot = os.path.join(root, TENANTS_DIR_NAME, "default")
        _wait_for(lambda: tier.wal_depth(troot) == 0, what="WAL drain")
        runs = acat.ingest_entries(acat.read_catalog(troot))
        assert len({e["run"] for e in runs}) == 3
        _, _, body = _get(handle.url + "/v1/tier")
        doc = json.loads(body)
        assert doc["workers"] == 2
        assert {r["tenant"]: r["worker"] for r in doc["tenants"]} == \
            {"default": tier.ring_owner("default", 2)}
    finally:
        handle.stop()
    _fsck_clean(troot)
    jreport = jax_store.archive_fsck(troot)
    assert not {k: v for k, v in jreport.items()
                if isinstance(v, list) and v and k != "unreferenced"}
