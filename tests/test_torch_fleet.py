"""The fleet transport of the port: ``serve`` and ``agent``
(``sofa_tpu_torch/archive/service.py``, ``client.py``, ``spool.py``,
``agent.py``), held to the JAX package's recipes (``tests/test_fleet.py``)
and to the JAX package itself.

The recipes: idempotent re-send, resume from the have-list under each
network fault kind, quota and auth refusals with the spool fallback, a
SIGKILLed agent resuming with no committed object re-sent, and the exit
codes of both verbs.  The parity: each package's agent pushing into the
other's service gives the tenant root the same package's pair gives; both
services answer the same bad requests alike; both clients raise the same
exceptions; the protocol vocabulary is one.  Every service binds a
loopback port 0; no wait is longer than the millisecond backoffs.
"""

import contextlib
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from sofa_tpu.agent import sofa_agent as jax_sofa_agent
from sofa_tpu.archive import client as jax_client
from sofa_tpu.archive import index as jax_index
from sofa_tpu.archive import protocol as jax_protocol
from sofa_tpu.archive import store as jax_store
from sofa_tpu.archive import tier as jax_tier
from sofa_tpu.archive.service import sofa_serve as jax_sofa_serve
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu_torch import durability, faults, telemetry
from sofa_tpu_torch.agent import discover_logdirs, logdir_ready, sofa_agent
from sofa_tpu_torch.archive import catalog as acat
from sofa_tpu_torch.archive import client as port_client
from sofa_tpu_torch.archive import index as aindex
from sofa_tpu_torch.archive import protocol, tier
from sofa_tpu_torch.archive.client import (ServiceClient, ServiceIncomplete,
                                           ServiceRejected,
                                           ServiceUnavailable)
from sofa_tpu_torch.archive.service import (UNPORTED_SERVE, service_url,
                                            sofa_serve)
from sofa_tpu_torch.archive.spool import Spool
from sofa_tpu_torch.archive.store import ArchiveStore, archive_fsck
from sofa_tpu_torch.cli import main as sofa_main
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.tools import manifest_check
from sofa_tpu_torch.trace import derived_write_guard
from test_torch_archive import jax_manifest_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "test-fleet-token"


def _mklog(root, name="run1", files=None):
    """A minimal finished logdir: a manifest, the digests and a payload
    (the JAX recipe's ``_mklog``; csv only, so no ``_frames/`` entry)."""
    logdir = os.path.join(str(root), name) + "/"
    os.makedirs(logdir, exist_ok=True)
    payload = files or {"sofa_time.txt": "123.0\n",
                        "report.js": f"var x = {name!r};\n",
                        "features.csv": "name,value\nelapsed_time,1.5\n"}
    for fname, content in payload.items():
        with open(logdir + fname, "w") as f:
            f.write(content)
    tel = telemetry.begin("analyze")
    tel.write(logdir, rc=0)
    telemetry.end(tel)
    durability.write_digests(logdir)
    return logdir


def _start(serve, cfg, root):
    """A bound service of either package, serving on a thread."""
    httpd = serve(cfg, root=root, serve_forever=False)
    assert httpd is not None
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


def _stop(httpd, t):
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=5)


@pytest.fixture
def service(tmp_path, monkeypatch):
    """The port's service on an ephemeral loopback port, with a fast index
    refresh cadence."""
    monkeypatch.setattr(tier, "REFRESH_MIN_INTERVAL_S", 0.05)
    cfg = SofaConfig(logdir=str(tmp_path / "unused"),
                     serve_token=TOKEN, serve_port=0)
    httpd, t = _start(sofa_serve, cfg, str(tmp_path / "store"))
    try:
        yield httpd
    finally:
        _stop(httpd, t)


def _agent_cfg(tmp_path, url, **kw):
    kw.setdefault("serve_token", TOKEN)
    kw.setdefault("agent_service", url)
    kw.setdefault("agent_spool", str(tmp_path / "spool"))
    kw.setdefault("agent_settle_s", 0.0)
    kw.setdefault("agent_retries", 4)
    kw.setdefault("agent_backoff_s", 0.01)
    kw.setdefault("agent_backoff_cap_s", 0.05)
    return SofaConfig(logdir=str(tmp_path / "unused2"), **kw)


def _tenant_root(httpd, tenant="default"):
    return httpd.tenant_root(tenant)


def _server_runs(httpd, tenant="default"):
    return acat.ingest_entries(acat.read_catalog(_tenant_root(httpd,
                                                              tenant)))


def _settled(root, timeout_s=30.0):
    """Wait until a served tenant's WAL is applied and its index refreshed
    (the refresher thread writes after the ack; an fsck racing it would
    read its stage files as orphans)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        state = tier.load_wal_state(root)
        if tier.wal_depth(root) == 0 and all(
                int(state["refreshed"].get(n, 0)) >= int(off)
                for n, off in state["applied"].items()):
            return
        time.sleep(0.01)
    pytest.fail(f"{root}: the WAL did not settle in {timeout_s} s")


def _fsck_clean(root):
    _settled(root)
    report = archive_fsck(root)
    assert report is not None, f"no archive at {root}"
    bad = {k: v for k, v in report.items()
           if isinstance(v, list) and v and k != "unreferenced"}
    assert not bad, f"store damage: {bad}"


def _store_shas(root):
    out = set()
    for _dirpath, _dirs, names in os.walk(os.path.join(root, "objects")):
        out.update(n for n in names if not n.endswith(".tmp"))
    return out


def _clear_delivered(spool_root):
    """Forget that the runs were delivered, so that the next pass pushes
    them again."""
    spool = Spool(spool_root)
    for ent in spool._state["logdirs"].values():
        ent["pushed"] = False
    spool._save_state()


# --- the upload protocol -----------------------------------------------------

def test_push_lands_run_and_meta(service, tmp_path):
    watch = tmp_path / "watch"
    logdir = _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    runs = _server_runs(service)
    assert len(runs) == 1
    _fsck_clean(_tenant_root(service))
    doc = telemetry.load_manifest(logdir)
    meta = doc["meta"]
    assert meta["agent"]["push"]["status"] == "pushed"
    assert meta["serve"]["run"] == runs[0]["run"]
    assert meta["tier"]["workers"] == 1 and meta["metrics"]["trace"]
    for validate in (manifest_check.validate_manifest,
                     jax_manifest_check().validate_manifest):
        assert validate(doc) == []
        assert validate(doc, require_healthy=True) == []


def test_triple_push_is_idempotent(service, tmp_path):
    """Re-pushing an unchanged run moves no object and appends no catalog
    line."""
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    troot = _tenant_root(service)
    shas = _store_shas(troot)
    catalog_bytes = open(acat.catalog_path(troot), "rb").read()
    for _ in range(2):
        _clear_delivered(str(tmp_path / "spool"))
        assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    assert _store_shas(troot) == shas
    assert open(acat.catalog_path(troot), "rb").read() == catalog_bytes
    assert len(_server_runs(service)) == 1
    stats = service.stats
    assert stats.get("object_stored", 0) == len(shas)
    # the re-pushes stop at the have-list's committed flag
    assert stats.get("commit", 0) == 1
    assert stats.get("have", 0) == 3
    assert stats.get("object_dedup", 0) == 0


@pytest.mark.parametrize("spec", [
    "service:conn_refused@start",
    "service:conn_refused",
    "service:conn_reset",
    "service:stall",
    "service:http_500",
    "service:partial@0.5",
])
def test_push_survives_each_fault_kind(service, tmp_path, spec):
    """Every network fault kind: the push lands, the store is fsck-clean,
    exactly one run is cataloged."""
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service), inject_faults=spec)
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    assert len(_server_runs(service)) == 1
    _fsck_clean(_tenant_root(service))
    if "partial" in spec:
        # the cut body reached the service and its hash check refused it
        assert service.stats.get("422_hash_mismatch", 0) >= 1
    assert faults.active() is None


def test_acceptance_faulted_push_is_byte_identical(service, tmp_path):
    """partial@0.5 and conn_refused@start: the run lands, the store is
    byte-identical to a fault-free push's, fsck exits 0, one catalog line,
    and three more pushes store no object."""
    watch = tmp_path / "watch"
    _mklog(watch)
    faulted = _agent_cfg(
        tmp_path, service_url(service),
        inject_faults="service:partial@0.5,service:conn_refused@start",
        fleet_tenant="faulted", agent_spool=str(tmp_path / "spool_f"))
    clean = _agent_cfg(tmp_path, service_url(service), fleet_tenant="clean",
                       agent_spool=str(tmp_path / "spool_c"))
    assert sofa_agent(faulted, watch=str(watch), once=True) == 0
    assert sofa_agent(clean, watch=str(watch), once=True) == 0
    ft, ct = _tenant_root(service, "faulted"), _tenant_root(service, "clean")
    _settled(ft)
    f_shas, c_shas = _store_shas(ft), _store_shas(ct)
    assert f_shas == c_shas
    for sha in f_shas:
        a = open(ArchiveStore(ft).object_path(sha), "rb").read()
        b = open(ArchiveStore(ct).object_path(sha), "rb").read()
        assert a == b
    assert sofa_main(["archive", "fsck", "--archive_root", ft]) == 0
    assert len(_server_runs(service, "faulted")) == 1
    before = service.stats.get("object_stored", 0)
    for _ in range(3):
        _clear_delivered(faulted.agent_spool)
        assert sofa_agent(faulted, watch=str(watch), once=True) == 0
    assert service.stats.get("object_stored", 0) == before
    assert len(_server_runs(service, "faulted")) == 1


# Sockets behind _dead_url ports, held for the session: the kernel keeps
# refusing connects and no other test's server can take the port.
_DEAD_SOCKETS = []


def _dead_url():
    """A loopback URL whose connects are refused (bound, never listening)."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    _DEAD_SOCKETS.append(s)
    return f"http://127.0.0.1:{s.getsockname()[1]}"


def test_client_fails_over_and_opens_breaker(service, tmp_path):
    """A dead first endpoint opens its breaker on the connection error,
    the next attempt moves to the live one, and the failover is counted."""
    dead = _dead_url()
    client = ServiceClient(f"{dead},{service_url(service)}", TOKEN,
                           timeout_s=5, retries=3,
                           backoff_s=0.01, backoff_cap_s=0.05)
    assert client.ping()["ok"] is True
    assert client.failovers >= 1
    assert client.base == service_url(service)
    assert client.breaker_open(dead)
    # an endpoint that answered stays trusted
    assert not client.breaker_open(service_url(service))


def test_failover_push_lands_and_stamps_meta_health(service, tmp_path):
    """``--service dead,live`` lands the run, and meta.health records the
    endpoint after the failover, the count and the open breaker."""
    dead = _dead_url()
    watch = tmp_path / "watch"
    logdir = _mklog(watch)
    cfg = _agent_cfg(tmp_path, f"{dead},{service_url(service)}")
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    assert len(_server_runs(service)) == 1
    _fsck_clean(_tenant_root(service))
    meta = telemetry.load_manifest(logdir)["meta"]
    mh = meta["health"]
    assert mh["schema"] == "sofa_tpu/fleet_health"
    assert mh["active"] == service_url(service)
    assert mh["endpoints"] == [dead, service_url(service)]
    assert mh["failovers"] >= 1 and mh["breakers_open"] == [dead]
    assert meta["agent"]["service"] == service_url(service)


def test_all_endpoints_dead_is_routed_not_hung(tmp_path):
    """Every endpoint down: the retryable typed error after the bounded
    retries, connection-level (no status)."""
    client = ServiceClient(f"{_dead_url()},{_dead_url()}", TOKEN,
                           timeout_s=1, retries=1,
                           backoff_s=0.01, backoff_cap_s=0.02)
    with pytest.raises(ServiceUnavailable) as exc:
        client.ping()
    assert exc.value.status is None


def test_offline_spools_then_drains(tmp_path, monkeypatch):
    """Service down: the run lands in the spool (exit 1, degraded, not
    lost); once the service exists, the next pass delivers it."""
    watch = tmp_path / "watch"
    logdir = _mklog(watch)
    cfg = _agent_cfg(tmp_path, _dead_url(), agent_retries=1)
    assert sofa_agent(cfg, watch=str(watch), once=True) == 1
    spool_store = ArchiveStore(str(tmp_path / "spool"))
    assert spool_store.exists
    assert len(acat.ingest_entries(acat.read_catalog(spool_store.root))) == 1
    _fsck_clean(spool_store.root)
    doc = telemetry.load_manifest(logdir)
    assert doc["meta"]["agent"]["push"]["status"] == "spooled"
    assert "serve" not in doc["meta"]
    assert any("could not deliver" in w
               for w in telemetry.manifest_warnings(doc))
    lines, rc_status = telemetry.render_status(doc, logdir)
    assert rc_status == 0
    assert any(line.strip().startswith("fleet:") for line in lines)
    assert manifest_check.validate_manifest(doc) == []
    assert any("could not deliver" in p for p in
               manifest_check.validate_manifest(doc, require_healthy=True))
    monkeypatch.setattr(tier, "REFRESH_MIN_INTERVAL_S", 0.05)
    scfg = SofaConfig(logdir=str(tmp_path / "u"), serve_token=TOKEN,
                      serve_port=0)
    httpd, t = _start(sofa_serve, scfg, str(tmp_path / "store"))
    try:
        cfg.agent_service = service_url(httpd)
        assert sofa_agent(cfg, watch=str(watch), once=True) == 0
        assert len(_server_runs(httpd)) == 1
        _fsck_clean(_tenant_root(httpd))
    finally:
        _stop(httpd, t)


def test_auth_reject_401(service, tmp_path):
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service), serve_token="wrong",
                     agent_retries=1)
    assert sofa_agent(cfg, watch=str(watch), once=True) == 1
    assert service.stats.get("401_unauthorized", 0) >= 1
    assert not os.path.isdir(_tenant_root(service))
    assert len(acat.ingest_entries(
        acat.read_catalog(str(tmp_path / "spool")))) == 1


def test_quota_429_spool_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(tier, "REFRESH_MIN_INTERVAL_S", 0.05)
    scfg = SofaConfig(logdir=str(tmp_path / "u"), serve_token=TOKEN,
                      serve_port=0, serve_quota_mb=0.05)
    httpd, t = _start(sofa_serve, scfg, str(tmp_path / "store"))
    try:
        watch = tmp_path / "watch"
        logdir = _mklog(watch, files={"sofa_time.txt": "1.0\n",
                                      "report.js": "x" * 200_000})
        cfg = _agent_cfg(tmp_path, service_url(httpd), agent_retries=1)
        assert sofa_agent(cfg, watch=str(watch), once=True) == 1
        assert httpd.stats.get("429_quota", 0) >= 1
        assert len(_server_runs(httpd)) == 0
        push = telemetry.load_manifest(logdir)["meta"]["agent"]["push"]
        assert push["status"] == "rejected" and push["quota"] is True
        _fsck_clean(str(tmp_path / "spool"))
    finally:
        _stop(httpd, t)


def test_backpressure_503_mid_gc(service, tmp_path):
    """A tenant root mid-gc answers 503 + Retry-After; the client raises
    the retryable error carrying the service's wait."""
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    client = ServiceClient(service_url(service), TOKEN, timeout_s=5,
                           retries=0)
    body = json.dumps({"files": {"a": {"sha256": "0" * 64}}}).encode()
    with derived_write_guard(_tenant_root(service)):
        with pytest.raises(ServiceUnavailable) as exc:
            client._attempt("POST", "/v1/default/have", body, "have", "")
        assert exc.value.status == 503
        assert exc.value.retry_after is not None
    assert service.stats.get("503_mid_gc", 0) >= 1
    doc = client._attempt("POST", "/v1/default/have", body, "have", "")
    assert doc["missing"] == ["0" * 64]


def test_sigkill_agent_resumes_with_zero_resent_objects(service, tmp_path):
    """SIGKILL the agent mid-upload; the restarted agent resumes from the
    have-list and re-sends no committed object."""
    watch = tmp_path / "watch"
    files = {f"f{i}.csv": f"col\n{i}\n" * (i + 1) for i in range(5)}
    files["sofa_time.txt"] = "1.0\n"
    _mklog(watch, files=files)
    url = service_url(service)
    snippet = f"""
import os, signal, sys
sys.path.insert(0, {REPO!r})
from sofa_tpu_torch.archive import client as aclient
orig = aclient.ServiceClient.put_object
count = [0]
def hook(self, sha, data):
    out = orig(self, sha, data)
    count[0] += 1
    if count[0] >= 2:
        os.kill(os.getpid(), signal.SIGKILL)
    return out
aclient.ServiceClient.put_object = hook
from sofa_tpu_torch.agent import sofa_agent
from sofa_tpu_torch.config import SofaConfig
cfg = SofaConfig(logdir={str(tmp_path / "u")!r}, serve_token={TOKEN!r},
                 agent_service={url!r},
                 agent_spool={str(tmp_path / "spool")!r},
                 agent_settle_s=0.0, agent_backoff_s=0.01)
sofa_agent(cfg, watch={str(watch)!r}, once=True)
"""
    r = subprocess.run([sys.executable, "-c", snippet],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-500:])
    assert service.stats.get("object_stored", 0) == 2
    assert len(_server_runs(service)) == 0
    entries = durability.read_journal(str(tmp_path / "spool"))
    pushes = [e for e in entries if e.get("stage") == "push"]
    assert pushes and pushes[-1]["ev"] == "begin"
    cfg = _agent_cfg(tmp_path, url)
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    assert len(_server_runs(service)) == 1
    _fsck_clean(_tenant_root(service))
    assert service.stats.get("object_dedup", 0) == 0
    assert service.stats.get("object_stored", 0) == \
        len(_store_shas(_tenant_root(service)))
    state = durability.journal_state(
        durability.read_journal(str(tmp_path / "spool")))
    assert state["push"]["committed"]


# --- the agent ---------------------------------------------------------------

def test_spool_only_mode_without_service(tmp_path, monkeypatch):
    monkeypatch.delenv("SOFA_AGENT_SERVICE", raising=False)
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, "")
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    assert len(acat.ingest_entries(
        acat.read_catalog(str(tmp_path / "spool")))) == 1


def test_unfinished_logdirs_are_skipped(tmp_path):
    watch = tmp_path / "watch"
    logdir = _mklog(watch)
    assert logdir_ready(logdir, settle_s=0.0)
    with derived_write_guard(logdir):
        assert not logdir_ready(logdir, settle_s=0.0)
    durability.Journal(logdir).begin("preprocess", key="k")
    assert not logdir_ready(logdir, settle_s=0.0)
    durability.Journal(logdir).commit("preprocess", key="k")
    assert logdir_ready(logdir, settle_s=0.0)
    assert not logdir_ready(logdir, settle_s=3600.0)
    os.makedirs(os.path.join(str(watch), "bare"))
    assert discover_logdirs(str(watch)) == [logdir]


def test_agent_discovers_watch_root_itself(tmp_path):
    logdir = _mklog(tmp_path, "selflog")
    assert discover_logdirs(logdir) == [logdir]


def test_agent_usage_errors(tmp_path):
    cfg = _agent_cfg(tmp_path, "")
    assert sofa_agent(cfg, watch=str(tmp_path / "nope"), once=True) == 2


def test_push_state_survives_unchanged_runs(service, tmp_path):
    """A second pass over a delivered, unchanged run does nothing."""
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    troot = _tenant_root(service)
    catalog_bytes = open(acat.catalog_path(troot), "rb").read()
    spool_cat = acat.catalog_path(str(tmp_path / "spool"))
    spool_bytes = open(spool_cat, "rb").read()
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    assert open(acat.catalog_path(troot), "rb").read() == catalog_bytes
    assert open(spool_cat, "rb").read() == spool_bytes


def test_orphaned_spool_runs_still_drain(service, tmp_path):
    """A source logdir removed after spooling: the spool's copy ships."""
    watch = tmp_path / "watch"
    logdir = _mklog(watch)
    cfg = _agent_cfg(tmp_path, _dead_url(), agent_retries=0)
    assert sofa_agent(cfg, watch=str(watch), once=True) == 1
    shutil.rmtree(logdir)
    cfg.agent_service = service_url(service)
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    assert len(_server_runs(service)) == 1
    _fsck_clean(_tenant_root(service))


# --- the fault grammar -------------------------------------------------------

def test_net_fault_grammar():
    plan = faults.parse("service:conn_refused@start,service:partial@0.25,"
                        "service:http_500@always,service:stall")
    kinds = {s.kind: s for s in plan.specs}
    assert kinds["conn_refused"].when == "start"
    assert kinds["partial"].fraction == 0.25
    assert kinds["http_500"].when == "always"
    assert kinds["stall"].when is None
    for bad in ("service:partial", "service:partial@1.5",
                "service:conn_refused@0.5"):
        with pytest.raises(ValueError):
            faults.parse(bad)
    # the JAX grammar's, spec for spec
    from sofa_tpu import faults as jax_faults

    text = ("service:conn_refused@start,service:partial@0.25,"
            "service:http_500@always,service:stall,service:conn_reset,"
            "gpumon:stall@2")
    assert [(s.target, s.kind, s.when, s.fraction, s.epoch)
            for s in faults.parse(text).specs] == \
        [(s.target, s.kind, s.when, s.fraction, s.epoch)
         for s in jax_faults.parse(text).specs]


def test_net_fault_firing_policies():
    plan = faults.parse("service:conn_refused@start")
    assert plan.service_fault("service", "have", "") is not None
    assert plan.service_fault("service", "put", "abc") is None

    plan = faults.parse("service:http_500")  # once per request key
    assert plan.service_fault("service", "put", "a") is not None
    assert plan.service_fault("service", "put", "a") is None
    assert plan.service_fault("service", "put", "b") is not None

    plan = faults.parse("service:stall@always")
    for _ in range(3):
        assert plan.service_fault("service", "have", "") is not None

    plan = faults.parse("service:partial@0.5")
    assert plan.service_fault("service", "have", "") is None  # put only
    assert plan.service_fault("service", "put", "x") is not None


# --- the verbs' exit codes ---------------------------------------------------

def test_serve_cli_exit_codes(tmp_path, monkeypatch):
    monkeypatch.delenv("SOFA_SERVE_TOKEN", raising=False)
    assert sofa_main(["serve", str(tmp_path / "store")]) == 2
    bad = tmp_path / "afile"
    bad.write_text("x")
    assert sofa_main(["serve", str(bad), "--token", TOKEN]) == 2


@pytest.mark.parametrize("flags", [
    ["--workers", "2"], ["--replica-of", "http://127.0.0.1:1"],
    ["--slo", "push_p99_ms<50"], ["--rolling-restart"]])
def test_serve_refuses_the_fleet_tier_options(tmp_path, capsys, flags):
    """What needs the fleet tier is a usage error that names it, before
    the root is touched."""
    root = tmp_path / "store"
    assert sofa_main(["serve", str(root), "--token", TOKEN,
                      "--serve_port", "0", *flags]) == 2
    err = capsys.readouterr().err
    assert "fleet tier" in err and flags[0] in err
    assert not root.exists()
    assert flags[0] in " ".join(UNPORTED_SERVE)


def test_agent_cli_exit_codes(service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    watch = tmp_path / "watch"
    _mklog(watch)
    assert sofa_main(["agent", str(tmp_path / "nope"), "--once"]) == 2
    assert sofa_main([
        "agent", str(watch), "--once", "--token", TOKEN,
        "--service", service_url(service),
        "--spool", str(tmp_path / "spool"), "--settle_s", "0",
        "--push_backoff_s", "0.01"]) == 0
    watch2 = tmp_path / "watch2"
    _mklog(watch2, "run2")
    assert sofa_main([
        "agent", str(watch2), "--once", "--token", TOKEN,
        "--service", _dead_url(),
        "--spool", str(tmp_path / "spool2"), "--settle_s", "0",
        "--push_retries", "0", "--push_backoff_s", "0.01"]) == 1


def test_archive_fsck_cli_action(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SOFA_AGENT_SERVICE", raising=False)
    assert sofa_main(["archive", "fsck",
                      "--archive_root", str(tmp_path / "none")]) == 2
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, "")
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    spool = str(tmp_path / "spool")
    assert sofa_main(["archive", "fsck", "--archive_root", spool]) == 0
    with open(os.path.join(spool, "objects", "zz.tmp"), "wb") as f:
        f.write(b"torn")
    assert sofa_main(["archive", "fsck", "--archive_root", spool]) == 1
    assert sofa_main(["archive", "fsck", "--archive_root", spool,
                      "--repair"]) == 0


def test_fleet_root_fsck_and_clean_guard(service, tmp_path):
    """``fsck <fleet root>`` checks every tenant's store, the worst exit
    winning; a fleet root nested under a logdir survives ``clean``."""
    from sofa_tpu_torch.record import sofa_clean

    assert durability.UNPORTED_ROOTS == {}
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    root = service.root
    _settled(_tenant_root(service))
    assert sofa_main(["fsck", root]) == 0
    sha = next(iter(_store_shas(_tenant_root(service))))
    with open(ArchiveStore(_tenant_root(service)).object_path(sha),
              "wb") as f:
        f.write(b"rotted")
    assert sofa_main(["fsck", root]) == 1
    logdir = _mklog(tmp_path, "cleanlog")
    shutil.copytree(root, os.path.join(logdir, "fleet"))
    sofa_clean(SofaConfig(logdir=logdir))
    assert os.path.isfile(os.path.join(logdir, "fleet", "sofa_fleet.json"))
    assert os.path.isfile(os.path.join(
        logdir, "fleet", "tenants", "default", "catalog.jsonl"))


def test_serve_refuses_foreign_marker_version(tmp_path):
    root = tmp_path / "store"
    root.mkdir()
    (root / "sofa_fleet.json").write_text(json.dumps(
        {"schema": "sofa_tpu/fleet_service", "version": 999}))
    cfg = SofaConfig(logdir=str(tmp_path / "u"), serve_token=TOKEN,
                     serve_port=0)
    assert sofa_serve(cfg, root=str(root), serve_forever=False) is None


# --- the service's protocol --------------------------------------------------

def test_service_rejects_bad_uploads(service, tmp_path):
    client = ServiceClient(service_url(service), TOKEN, timeout_s=5,
                           retries=0, backoff_s=0.01)
    assert client.ping()["ok"] is True
    sha = "a" * 64
    with pytest.raises(ServiceUnavailable) as exc:
        client.put_object(sha, b"not those bytes")
    assert exc.value.status == 422
    assert not ArchiveStore(_tenant_root(service)).has_object(sha)
    bad = ServiceClient(service_url(service), TOKEN, tenant="../evil",
                        timeout_s=5, retries=0)
    with pytest.raises((ServiceRejected, ServiceUnavailable)):
        bad.have({"a": {"sha256": "0" * 64}})
    blob = b"real bytes"
    real = hashlib.sha256(blob).hexdigest()
    doc = {"files": {"f.csv": {"sha256": real, "bytes": len(blob),
                               "kind": "derived"}}}
    with pytest.raises(ServiceIncomplete):
        client.commit(doc)
    assert client.put_object(real, blob)["new"] is True
    ack = client.commit(doc)
    assert ack["committed"] is True and ack["new"] is True
    assert client.commit(doc)["new"] is False


def test_service_catalog_and_run_read(service, tmp_path):
    watch = tmp_path / "watch"
    _mklog(watch)
    cfg = _agent_cfg(tmp_path, service_url(service))
    assert sofa_agent(cfg, watch=str(watch), once=True) == 0
    run_id = _server_runs(service)[0]["run"]
    auth = {"Authorization": f"Bearer {TOKEN}"}
    req = urllib.request.Request(
        f"{service_url(service)}/v1/default/run/{run_id}", headers=auth)
    with urllib.request.urlopen(req, timeout=5) as resp:
        doc = json.loads(resp.read())
    assert doc["run"] == run_id and doc["tenant"] == "default"
    req = urllib.request.Request(
        f"{service_url(service)}/v1/default/catalog", headers=auth)
    with urllib.request.urlopen(req, timeout=5) as resp:
        lines = [json.loads(s) for s in resp.read().splitlines() if s]
    assert any(e.get("run") == run_id for e in lines)


@pytest.mark.parametrize("route", ["/v1/tier", "/v1/metrics",
                                   "/v1/default/fleet"])
def test_unported_routes_answer_typed_404(service, route):
    """The fleet tier's routes: a 404 the protocol allows, naming what is
    missing."""
    code, _h, doc = _request(service_url(service), "GET", route,
                             token=TOKEN)
    assert code == 404
    assert doc == {"error": "no_such_route", "unported": "fleet tier"}
    assert doc["error"] in protocol.STATUS_ERRORS[404]


# --- the two packages against each other -------------------------------------

def test_protocol_vocabulary_is_the_jax_package_s():
    names = [n for n in dir(jax_protocol) if n.isupper()]
    assert names == [n for n in dir(protocol) if n.isupper()]
    for name in names:
        assert getattr(protocol, name) == getattr(jax_protocol, name), name


# The clock both packages' WAL appenders stamp with (frozen, so that the run
# docs and catalog lines of two services are comparable byte for byte).
FROZEN_T = 1_700_000_000.0


class _FrozenClock:
    """``time`` with ``time()`` frozen, for a module's ``time`` global."""

    def __init__(self, real):
        self._real = real

    def time(self):
        return FROZEN_T

    def __getattr__(self, name):
        return getattr(self._real, name)


@pytest.fixture
def frozen_wal(monkeypatch):
    for mod in (tier, jax_tier):
        monkeypatch.setattr(mod, "time", _FrozenClock(time))
        monkeypatch.setattr(mod, "REFRESH_MIN_INTERVAL_S", 0.05)


# Per package: its serve, its config, its agent and its index module.
_PACKAGES = {
    "port": (sofa_serve, SofaConfig, sofa_agent, aindex),
    "jax": (jax_sofa_serve, JaxConfig, jax_sofa_agent, jax_index),
}


def _push(tmp_path, template, agent_pkg, serve_pkg, tag):
    """One push of the template logdir (restored at one path) by
    ``agent_pkg``'s agent into ``serve_pkg``'s service; returns the tenant
    root after the drain and the index refresh."""
    serve, serve_cfg, _agent, serve_index = _PACKAGES[serve_pkg]
    _serve, agent_cfg, agent, _index = _PACKAGES[agent_pkg]
    watch = tmp_path / "watch"
    shutil.rmtree(watch, ignore_errors=True)
    shutil.copytree(template, watch / "run1")
    httpd, t = _start(serve, serve_cfg(logdir=str(tmp_path / "u"),
                                       serve_token=TOKEN, serve_port=0),
                      str(tmp_path / f"store_{tag}"))
    try:
        cfg = agent_cfg(logdir=str(tmp_path / "u2"), serve_token=TOKEN,
                        agent_service=service_url(httpd),
                        agent_spool=str(tmp_path / f"spool_{tag}"),
                        agent_settle_s=0.0, agent_backoff_s=0.01,
                        agent_backoff_cap_s=0.05)
        assert agent(cfg, watch=str(watch), once=True) == 0
        troot = httpd.tenant_root("default")
    finally:
        _stop(httpd, t)
    serve_index.refresh_after_ingest(troot)
    return troot


def _tenant_tree(troot):
    """What two pushes of one run must agree on: the run ids, the run
    docs, the objects, the catalog lines but ``t`` and the index commit."""
    runs = {}
    for name in sorted(os.listdir(os.path.join(troot, "runs"))):
        with open(os.path.join(troot, "runs", name), "rb") as f:
            runs[name] = f.read()
    objects = {}
    for dirpath, _dirs, names in os.walk(os.path.join(troot, "objects")):
        for n in names:
            with open(os.path.join(dirpath, n), "rb") as f:
                objects[n] = f.read()
    lines = [{k: v for k, v in e.items() if k != "t"}
             for e in acat.read_catalog(troot)]
    with open(aindex.commit_path(troot), "rb") as f:
        commit = f.read()
    return runs, objects, lines, commit


def test_each_agent_pushes_into_the_other_service(tmp_path, frozen_wal):
    """The JAX agent into the port's service and the port's agent into the
    JAX service, with the WAL's clock frozen: each tenant root equals the
    one the same package's agent and service give, and each package's
    archive fsck reads the other's tenant root as clean."""
    template = _mklog(tmp_path / "template", "run1")
    roots = {}
    for agent_pkg in ("port", "jax"):
        for serve_pkg in ("port", "jax"):
            tag = f"{agent_pkg}_{serve_pkg}"
            roots[tag] = _push(tmp_path, template, agent_pkg, serve_pkg,
                               tag)
    trees = {tag: _tenant_tree(root) for tag, root in roots.items()}
    assert trees["jax_port"] == trees["jax_jax"]
    assert trees["port_jax"] == trees["port_port"]
    # a csv logdir gets one run id in both packages, so all four agree
    assert trees["port_port"] == trees["jax_jax"]
    runs, _objects, lines, _commit = trees["port_port"]
    assert len(runs) == 1 and [e["ev"] for e in lines] == ["ingest"]
    assert json.loads(next(iter(runs.values())))["t"] == FROZEN_T
    for root in roots.values():
        for fsck in (archive_fsck, jax_store.archive_fsck):
            report = fsck(root)
            assert not {k: v for k, v in report.items()
                        if isinstance(v, list) and v
                        and k != "unreferenced"}


def _request(base, method, path, body=None, token=None, headers=None):
    """(status, headers, JSON body) of one request."""
    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers=dict(headers or {}))
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


_BLOB = b"the bytes of one object"
_BLOB_SHA = hashlib.sha256(_BLOB).hexdigest()
_FILES = {"f.csv": {"sha256": _BLOB_SHA, "bytes": len(_BLOB),
                    "kind": "derived"}}

# A bad request each: (method, path, body, token, mid_gc).
BAD_REQUESTS = {
    "bad_token": ("POST", "/v1/default/have",
                  json.dumps({"files": _FILES}).encode(), "wrong", False),
    "bad_tenant": ("POST", "/v1/..evil/have",
                   json.dumps({"files": _FILES}).encode(), TOKEN, False),
    "unknown_route": ("POST", "/v1/default/nope", b"{}", TOKEN, False),
    "hash_mismatch": ("PUT", f"/v1/default/object/{_BLOB_SHA}",
                      b"other bytes", TOKEN, False),
    "missing_objects": ("POST", "/v1/default/commit",
                        json.dumps({"files": _FILES}).encode(), TOKEN,
                        False),
    "bad_json": ("POST", "/v1/default/have", b"{not json", TOKEN, False),
    "bad_files_map": ("POST", "/v1/default/have",
                      json.dumps({"files": {"a": {"sha256": "x"}}}).encode(),
                      TOKEN, False),
    "mid_gc": ("POST", "/v1/default/have",
               json.dumps({"files": _FILES}).encode(), TOKEN, True),
}


@pytest.fixture(scope="module")
def both_services(tmp_path_factory):
    """One service of each package, with the default tenant created."""
    tmp = tmp_path_factory.mktemp("both")
    out = {}
    for pkg in ("port", "jax"):
        serve, cfg_cls = _PACKAGES[pkg][:2]
        httpd, t = _start(serve, cfg_cls(logdir=str(tmp / "u"),
                                         serve_token=TOKEN, serve_port=0),
                          str(tmp / f"store_{pkg}"))
        _request(service_url(httpd), "POST", "/v1/default/have",
                 json.dumps({"files": {"z": {"sha256": "0" * 64}}}).encode(),
                 TOKEN)
        out[pkg] = (httpd, t)
    yield {pkg: httpd for pkg, (httpd, _t) in out.items()}
    for httpd, t in out.values():
        _stop(httpd, t)


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_both_services_refuse_bad_requests_alike(both_services, case):
    method, path, body, token, mid_gc = BAD_REQUESTS[case]
    got = {}
    for pkg, httpd in both_services.items():
        guard = derived_write_guard(httpd.tenant_root("default")) \
            if mid_gc else contextlib.nullcontext()
        with guard:
            code, headers, doc = _request(service_url(httpd), method, path,
                                          body, token)
        got[pkg] = (code, doc.get("error"), "Retry-After" in headers)
    assert got["port"] == got["jax"]
    code, error, _ra = got["port"]
    assert code >= 400 and error in protocol.STATUS_ERRORS[code]


# A refusal each, as a client meets it: (op, tenant, token, arguments).
CLIENT_REFUSALS = {
    "unauthorized": ("have", "default", "wrong", (_FILES,)),
    "bad_tenant": ("have", "..evil", TOKEN, (_FILES,)),
    "hash_mismatch": ("put_object", "default", TOKEN,
                      (_BLOB_SHA, b"other bytes")),
    "missing_objects": ("commit", "default", TOKEN, ({"files": _FILES},)),
}


@pytest.mark.parametrize("case", sorted(CLIENT_REFUSALS))
def test_both_clients_raise_the_same_refusal(both_services, case):
    """Each package's client against each package's service: the same
    exception class (by name) and status for the same refusal."""
    op, tenant, token, args = CLIENT_REFUSALS[case]
    seen = set()
    for mod in (jax_client, port_client):
        for httpd in both_services.values():
            client = mod.ServiceClient(service_url(httpd), token,
                                       tenant=tenant, timeout_s=5,
                                       retries=0)
            with pytest.raises(Exception) as exc:
                getattr(client, op)(*args)
            seen.add((type(exc.value).__name__,
                      getattr(exc.value, "status", None)))
    assert len(seen) == 1, seen
    assert next(iter(seen))[0] in ("ServiceRejected", "ServiceUnavailable",
                                   "ServiceIncomplete")

