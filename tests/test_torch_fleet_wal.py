"""The fleet service's write-ahead queue and metrics registry in the port
(``sofa_tpu_torch/archive/tier.py``, ``sofa_tpu_torch/metrics.py``), held
to the JAX package's recipes (``tests/test_fleet_tier.py``'s ring, WAL
and deadline tests; ``tests/test_tier_metrics.py``'s histogram and
snapshot tests) and to the JAX package itself: the ring's owners and the
histograms' bucket counts are equal, and a WAL drained by either package
gives the same store.

The JAX package's SIGTERM test drives a pool worker; here a ``serve``
subprocess with three WAL records seeded (the tenant held mid-gc, so that
only the SIGTERM drain can apply them) gets SIGTERM, exits 0 and
catalogs the three runs in order.
"""

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

from sofa_tpu import metrics as jax_metrics
from sofa_tpu.archive import tier as jax_tier
from sofa_tpu_torch import durability, telemetry
from sofa_tpu_torch.archive import catalog as acat
from sofa_tpu_torch.archive import index as aindex
from sofa_tpu_torch.archive import tier
from sofa_tpu_torch.archive.service import (TENANTS_DIR_NAME, service_url,
                                            sofa_serve)
from sofa_tpu_torch.archive.store import ArchiveStore, archive_fsck
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.metrics import BUCKETS_MS, Histogram, MetricsRegistry
from sofa_tpu_torch.trace import derived_write_guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "tier-test-token"


def _mklog(root, name="run1"):
    """A minimal finished logdir: a manifest, the digests and a payload."""
    logdir = os.path.join(str(root), name) + "/"
    os.makedirs(logdir, exist_ok=True)
    for fname, content in (("sofa_time.txt", "123.0\n"),
                           ("features.csv",
                            "name,value\nelapsed_time,1.5\n")):
        with open(logdir + fname, "w") as f:
            f.write(content)
    tel = telemetry.begin("analyze")
    tel.write(logdir, rc=0)
    telemetry.end(tel)
    durability.write_digests(logdir)
    return logdir


def _wait_for(pred, timeout_s=15.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.01)
    pytest.fail(f"timed out after {timeout_s}s waiting for {what}")


def _fsck_clean(root):
    report = archive_fsck(root)
    assert report is not None, f"no archive at {root}"
    bad = {k: v for k, v in report.items()
           if isinstance(v, list) and v and k != "unreferenced"}
    assert not bad, f"store damage: {bad}"


def _tree_bytes(root, skip=("_journal.jsonl",)):
    """path -> bytes of every file under root, the journal excluded (a
    killed drain leaves one more uncommitted begin)."""
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
    """The port's service (WAL drainer and refresher) on a loopback port
    0, with a fast refresh cadence."""
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


# --- the consistent-hash ring -------------------------------------------------

TENANTS = [f"team-{i:03d}" for i in range(200)]


def test_ring_stable_under_worker_add():
    before = {t: tier.ring_owner(t, 4) for t in TENANTS}
    after = {t: tier.ring_owner(t, 5) for t in TENANTS}
    moved = [t for t in TENANTS if before[t] != after[t]]
    assert moved, "a new worker must steal some tenants"
    assert all(after[t] == 4 for t in moved)
    assert len(moved) < len(TENANTS) // 2
    assert after == {t: jax_tier.ring_owner(t, 5) for t in TENANTS}


def test_ring_stable_under_worker_remove():
    before = {t: tier.ring_owner(t, 4) for t in TENANTS}
    after = {t: tier.ring_owner(t, (0, 1, 3)) for t in TENANTS}
    for t in TENANTS:
        if before[t] == 2:
            assert after[t] in (0, 1, 3)
        else:
            assert after[t] == before[t]
    assert after == {t: jax_tier.ring_owner(t, (0, 1, 3)) for t in TENANTS}


def test_ring_owner_deterministic_across_calls():
    assert tier.ring_owner("default", 4) == tier.ring_owner("default", 4)
    assert tier.ring_owner("default", (0, 1, 2, 3)) == \
        tier.ring_owner("default", 4)
    assert tier.ring_owner("default", 1) == 0


# --- the write-ahead queue ----------------------------------------------------

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
    # the JAX package reads the port's WAL alike
    assert jax_tier.wal_depth(troot) == 3
    stats = tier.drain_tenant(troot, refresh=False)
    assert stats["applied"] == 3
    assert tier.wal_depth(troot) == 0
    runs = acat.ingest_entries(acat.read_catalog(troot))
    assert [e["run"] for e in runs] == [r["run"] for r in recs]
    again = tier.drain_tenant(troot, refresh=False)
    assert again == {"applied": 0, "replayed": 0, "refreshed": False}


def test_sigkill_mid_drain_replays_byte_identical(tmp_path):
    """A drain hard-killed between the run-doc write and the catalog line
    (SOFA_WAL_EXIT_AFTER), then run again, converges to the bytes of an
    uninterrupted drain of the same WAL, and so does the JAX package's
    drain of a third copy; all fsck clean."""
    root_a = str(tmp_path / "a" / "default")
    ArchiveStore(root_a, create=True)   # one marker stamp for all copies
    app = tier.WalAppender(root_a, worker=0)
    for rec in _wal_records(3):
        app.append(rec)
    root_b = str(tmp_path / "b" / "default")
    root_j = str(tmp_path / "j" / "default")
    shutil.copytree(root_a, root_b)
    shutil.copytree(root_a, root_j)

    code = ("import sys\nfrom sofa_tpu_torch.archive import tier\n"
            "tier.drain_tenant(sys.argv[1], refresh=False)\n")
    env = {**os.environ, "SOFA_WAL_EXIT_AFTER": "1"}
    env.pop("SOFA_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", code, root_a], env=env,
                          cwd=REPO, capture_output=True, timeout=120)
    assert proc.returncode == 88, proc.stderr.decode()
    assert tier.wal_depth(root_a) == 3
    assert not acat.ingest_entries(acat.read_catalog(root_a))

    stats_a = tier.drain_tenant(root_a, refresh=False)   # the replay
    stats_b = tier.drain_tenant(root_b, refresh=False)   # uninterrupted
    stats_j = jax_tier.drain_tenant(root_j, refresh=False)
    assert stats_a["applied"] + stats_a["replayed"] == 3
    assert stats_b == {"applied": 3, "replayed": 0, "refreshed": False}
    assert stats_j == stats_b
    assert _tree_bytes(root_a) == _tree_bytes(root_b)
    # the JAX package's drain of the same WAL writes the same bytes (each
    # catalog line carries its record's "t")
    assert _tree_bytes(root_j) == _tree_bytes(root_b)
    for root in (root_a, root_b, root_j):
        _fsck_clean(root)
    if aindex.available():
        assert tier.refresh_tenant(root_a)
        assert tier.refresh_tenant(root_b)
        sha_a = (aindex.load_commit(root_a) or {}).get("commit_sha")
        sha_b = (aindex.load_commit(root_b) or {}).get("commit_sha")
        assert sha_a and sha_a == sha_b


def test_push_ack_not_gated_on_index_refresh(primary, tmp_path,
                                             monkeypatch):
    """A commit ack does not wait for the index refresh: with the refresh
    pinned at 1 s the push still acks fast, and the refresh still happens
    after it."""
    from sofa_tpu_torch.archive.client import ServiceClient, push_run
    from sofa_tpu_torch.archive.store import ingest_run

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
    assert elapsed < 0.9, f"the push ack waited {elapsed:.2f} s"
    troot = primary.tenant_root("default")
    assert len(acat.ingest_entries(acat.read_catalog(troot))) == 1
    if aindex.available():
        _wait_for(refreshed.is_set, what="the index refresh after the ack")


# --- the deadline header ------------------------------------------------------

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
    """A request whose X-Sofa-Deadline has passed: a typed 504 with no
    Retry-After."""
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
    # 30 days ahead is a skewed clock: ignored (the request serves)
    lambda: f"{time.time() + 30 * 86400:.3f}",
    lambda: "not-a-deadline",
])
def test_deadline_skew_and_garbage_are_ignored(primary, raw):
    code, _headers, doc = _post(
        service_url(primary) + "/v1/default/have", _HAVE_DOC,
        headers={"X-Sofa-Deadline": raw()})
    assert code == 200 and doc["missing"] == ["ab" * 32]


def test_deadline_within_cap_is_honored_not_refused(primary):
    code, _headers, _doc = _post(
        service_url(primary) + "/v1/default/have", _HAVE_DOC,
        headers={"X-Sofa-Deadline": f"{time.time() + 30.0:.3f}"})
    assert code == 200


# --- the graceful stop ---------------------------------------------------------

def test_sigterm_serve_drains_wal_and_exits_zero(tmp_path):
    """A ``serve`` process with 3 WAL records seeded (its tenant held
    mid-gc, so its drainer skips them) gets SIGTERM: it exits 0 with the
    WAL drained to 0, and the 3 runs are cataloged in order."""
    root = str(tmp_path / "store")
    troot = os.path.join(root, TENANTS_DIR_NAME, "default")
    app = tier.WalAppender(troot, worker=0)
    recs = _wal_records(3)
    for rec in recs:
        app.append(rec)
    with derived_write_guard(troot):
        proc = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch", "serve", root,
             "--serve_port", "0", "--token", TOKEN], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            url = None
            for line in proc.stdout:
                if "fleet archive service:" in line:
                    url = line.split(" at ")[1].split("/v1/")[0]
                    break
            assert url, "serve printed no URL"
            with urllib.request.urlopen(url + "/v1/health",
                                        timeout=10) as r:
                assert r.status == 200
            time.sleep(0.1)   # a few drain polls: the guard holds them off
            assert tier.wal_depth(troot) == 3
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, out
    assert "drained 3 WAL record(s) on SIGTERM" in out
    assert tier.wal_depth(troot) == 0
    runs = acat.ingest_entries(acat.read_catalog(troot))
    assert [e["run"] for e in runs] == [r["run"] for r in recs]
    _fsck_clean(troot)


# --- the metrics registry -----------------------------------------------------

def _bucket_bounds(value):
    lo = 0.0
    for hi in BUCKETS_MS:
        if value <= hi:
            return lo, hi
        lo = hi
    return lo, BUCKETS_MS[-1]


def test_histogram_percentiles_bracket_exact():
    """The estimate lands inside the bucket that holds the exact
    percentile; the bucket counts are the JAX histogram's."""
    import random

    rng = random.Random(7)
    values = [rng.uniform(0.5, 400.0) for _ in range(2000)]
    h, jh = Histogram(), jax_metrics.Histogram()
    for v in values:
        h.observe(v)
        jh.observe(v)
    assert h.count == len(values)
    assert h.counts == jh.counts
    s = sorted(values)
    for p in (50.0, 90.0, 99.0):
        exact = s[min(int(p / 100.0 * len(s)), len(s) - 1)]
        lo, hi = _bucket_bounds(exact)
        assert lo <= h.percentile(p) <= hi, (p, exact, h.percentile(p))


def test_histogram_empty_and_open_bucket():
    h = Histogram()
    assert h.percentile(99.0) == 0.0
    h.observe(10 ** 9)
    assert h.percentile(99.0) == BUCKETS_MS[-2]


def test_snapshot_vocabulary():
    """Counters give ``_total``, histograms ``_p50_ms``/``_p99_ms``/
    ``_count``, gauges their name: the JAX registry's keys."""
    reg = MetricsRegistry("/nonexistent-metrics-root", worker=3)
    jreg = jax_metrics.MetricsRegistry("/nonexistent-metrics-root", worker=3)
    for r in (reg, jreg):
        r.inc("pushes", 2)
        r.observe("push", 7.0)
        r.set_gauge("wal_depth", 4)
    flat, hists = reg.snapshot()
    assert flat["pushes_total"] == 2.0
    assert flat["wal_depth"] == 4
    assert flat["push_count"] == 1.0
    lo, hi = _bucket_bounds(7.0)
    assert lo <= flat["push_p99_ms"] <= hi
    assert hists["push"]["count"] == 1
    jflat, jhists = jreg.snapshot()
    assert sorted(flat) == sorted(jflat)
    assert hists["push"]["counts"] == jhists["push"]["counts"]
