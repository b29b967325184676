"""The fleet tier's metrics plane of the port (``sofa_tpu_torch/metrics.py``),
held to the JAX package's recipes (``tests/test_tier_metrics.py``) and to
the JAX package itself.

The recipes: the histogram's percentiles against exact values, the flat
snapshot vocabulary the SLO grammar names, one X-Sofa-Trace id spanning
the committing process and a separate drain process in the merged fleet
trace, the history's chunk store as a pure function of its rows, the
authenticated ``/v1/metrics`` (401, the ETag's 304 when idle, pages, bad
parameters), SLO parsing and typed verdicts, breach events in the catalog,
``status --fleet`` exiting 1 while breaching, the ``slo_breach`` and
``scrape_stall`` fault kinds, and the tier board's contract.  The parity:
the same spec and windows give each package the same ``slo_verdict``, and
the same registry the same ``/v1/metrics`` document apart from its
volatile keys.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from sofa_tpu import metrics as jax_metrics
from sofa_tpu_torch import durability, faults, telemetry
from sofa_tpu_torch import metrics
from sofa_tpu_torch.agent import sofa_agent
from sofa_tpu_torch.archive import catalog as acat
from sofa_tpu_torch.archive import tier
from sofa_tpu_torch.archive.service import sofa_serve
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.metrics import (
    BUCKETS_MS,
    Histogram,
    MetricsRegistry,
    Scraper,
    evaluate_slo,
    metrics_doc,
    metrics_summary,
    parse_slo,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "tier-metrics-token"


def _load_manifest_check():
    from sofa_tpu_torch.tools import manifest_check

    return manifest_check


def _mklog(root, name="run1"):
    logdir = os.path.join(str(root), name) + "/"
    os.makedirs(logdir, exist_ok=True)
    with open(logdir + "sofa_time.txt", "w") as f:
        f.write("123.0\n")
    with open(logdir + "features.csv", "w") as f:
        f.write("name,value\nelapsed_time,1.5\n")
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


@pytest.fixture
def primary(tmp_path, monkeypatch):
    """In-process single-worker primary with the background scrape
    thread STOPPED: tests drive `httpd.scraper.tick()` themselves so
    every window is deterministic."""
    monkeypatch.setattr(tier, "REFRESH_MIN_INTERVAL_S", 0.05)
    cfg = SofaConfig(logdir=str(tmp_path / "unused_srv"),
                     serve_token=TOKEN, serve_port=0)
    httpd = sofa_serve(cfg, root=str(tmp_path / "store"),
                       serve_forever=False)
    assert httpd is not None
    httpd.scraper.close()
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)


def _url(httpd):
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url, headers=None, token=TOKEN):
    hdr = {}
    if token is not None:
        hdr["Authorization"] = f"Bearer {token}"
    hdr.update(headers or {})
    req = urllib.request.Request(url, headers=hdr)
    try:
        with urllib.request.urlopen(req, timeout=10.0) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ---------------------------------------------------------------------------
# Histogram math.
# ---------------------------------------------------------------------------

def _bucket_bounds(value):
    lo = 0.0
    for hi in BUCKETS_MS:
        if value <= hi:
            return lo, hi
        lo = hi
    return lo, BUCKETS_MS[-1]


def test_histogram_percentiles_bracket_exact():
    """Fixed buckets cannot beat their own resolution, but the estimate
    must land inside the bucket that holds the exact percentile."""
    import random

    rng = random.Random(7)
    values = [rng.uniform(0.5, 400.0) for _ in range(2000)]
    h = Histogram()
    for v in values:
        h.observe(v)
    assert h.count == len(values)
    s = sorted(values)
    for p in (50.0, 90.0, 99.0):
        exact = s[min(int(p / 100.0 * len(s)), len(s) - 1)]
        lo, hi = _bucket_bounds(exact)
        got = h.percentile(p)
        assert lo <= got <= hi, (p, exact, got)


def test_histogram_empty_and_open_bucket():
    h = Histogram()
    assert h.percentile(99.0) == 0.0
    h.observe(10 ** 9)  # lands in the open-ended last bucket
    # honest saturation: the open bucket answers its lower bound
    assert h.percentile(99.0) == BUCKETS_MS[-2]


def test_snapshot_vocabulary():
    """Counters -> _total/_rps, histograms -> _p50_ms/_p99_ms/_count,
    gauges verbatim — the names the SLO grammar targets."""
    reg = MetricsRegistry("/nonexistent-metrics-root", worker=3)
    reg.inc("pushes", 2)
    reg.observe("push", 7.0)
    reg.set_gauge("wal_depth", 4)
    flat, hists = reg.snapshot()
    assert flat["pushes_total"] == 2.0
    assert flat["wal_depth"] == 4
    assert flat["push_count"] == 1.0
    lo, hi = _bucket_bounds(7.0)
    assert lo <= flat["push_p99_ms"] <= hi
    assert hists["push"]["count"] == 1


# ---------------------------------------------------------------------------
# SLO parsing and evaluation.
# ---------------------------------------------------------------------------

def test_parse_slo_grammar():
    targets = parse_slo("push_p99_ms<50,wal_depth<=1000,replica_behind<3")
    assert [(t.name, t.op, t.value) for t in targets] == [
        ("push_p99_ms", "<", 50.0), ("wal_depth", "<=", 1000.0),
        ("replica_behind", "<", 3.0)]
    assert parse_slo("") == ()
    for bad in ("push_p99_ms", "push_p99_ms<", "<5", "a=5",
                "push_p99_ms<abc", "Push<5"):
        with pytest.raises(ValueError):
            parse_slo(bad)


def test_evaluate_slo_breach_and_no_data():
    targets = parse_slo("push_p99_ms<50,wal_depth<10")
    v = evaluate_slo(targets, {"push_p99_ms": 80.0, "wal_depth": 3.0}, 1)
    assert v["schema"] == metrics.SLO_SCHEMA
    assert v["ok"] is False
    assert v["breaching"] == ["push_p99_ms"]
    by = {t["name"]: t for t in v["targets"]}
    assert by["push_p99_ms"]["status"] == "breach"
    assert by["wal_depth"]["status"] == "ok"
    # a metric with no samples yet is no_data, which does NOT breach
    v2 = evaluate_slo(targets, {"wal_depth": 3.0}, 2)
    assert v2["ok"] is True
    assert {t["name"]: t["status"] for t in v2["targets"]} == {
        "push_p99_ms": "no_data", "wal_depth": "ok"}


def test_slo_verdict_roundtrip_and_validators(tmp_path):
    mc = _load_manifest_check()
    root = str(tmp_path)
    targets = parse_slo("wal_depth<10")
    ok = evaluate_slo(targets, {"wal_depth": 3.0}, 1)
    metrics.write_slo_verdict(root, ok)
    loaded = metrics.load_slo_verdict(root)
    assert loaded is not None and loaded["ok"] is True
    assert mc.validate_slo_verdict(loaded) == []
    breach = evaluate_slo(targets, {"wal_depth": 99.0}, 2)
    assert mc.validate_slo_verdict(breach) == []
    # gate mode: a breaching verdict fails --require-healthy
    assert any("breach" in p.lower() for p in
               mc.validate_slo_verdict(breach, require_passing=True))
    # inconsistent ok-vs-breached-names is flagged
    assert mc.validate_slo_verdict(dict(breach, ok=True))


def test_scraper_evaluates_slo_and_appends_breach_event(tmp_path):
    root = str(tmp_path / "fleetroot")
    os.makedirs(os.path.join(root, "tenants", "default"))
    reg = metrics.for_root(root, worker=0)
    reg.observe("push", 80.0)
    scraper = Scraper(reg, slo_targets=parse_slo("push_p99_ms<50"),
                      role="primary")
    verdict = scraper.tick()
    assert verdict is not None and verdict["ok"] is False
    assert metrics.load_slo_verdict(root)["breaching"] == ["push_p99_ms"]
    events = [e for e in acat.read_catalog(
        os.path.join(root, "tenants", "default"))
        if e.get("ev") == "slo_breach"]
    assert len(events) == 1
    assert events[0]["metric"] == "push_p99_ms"
    assert events[0]["op"] == "<" and events[0]["threshold"] == 50.0
    # a PERSISTING breach is one fact, not one event per window
    scraper.tick()
    events2 = [e for e in acat.read_catalog(
        os.path.join(root, "tenants", "default"))
        if e.get("ev") == "slo_breach"]
    assert len(events2) == 1
    # the regress feed still parses the catalog cleanly around events
    assert acat.ingest_entries(acat.read_catalog(
        os.path.join(root, "tenants", "default"))) == []


# ---------------------------------------------------------------------------
# Fault kinds.
# ---------------------------------------------------------------------------

def test_slo_breach_fault_fires_once(tmp_path):
    reg = MetricsRegistry(str(tmp_path / "faultroot"), worker=0)
    scraper = Scraper(reg)
    old = faults._PLAN
    faults._PLAN = faults.parse("service:slo_breach@1")
    try:
        v = scraper.tick()
        assert v is not None and v["ok"] is False
        assert "injected_fault" in v["breaching"]
        assert scraper.tick() is None  # fires once, not per window
    finally:
        faults._PLAN = old


def test_scrape_stall_fault_freezes_window(tmp_path):
    reg = MetricsRegistry(str(tmp_path / "stallroot"), worker=0)
    scraper = Scraper(reg)
    old = faults._PLAN
    faults._PLAN = faults.parse("service:scrape_stall")
    try:
        assert scraper.tick() is None
        assert reg.scrape_seq == 0  # the window never committed
    finally:
        faults._PLAN = old
    scraper.tick()
    assert reg.scrape_seq == 1


# ---------------------------------------------------------------------------
# History persistence.
# ---------------------------------------------------------------------------

def test_history_persist_deterministic(tmp_path):
    """The persisted history store is a pure function of the rows —
    byte-identical across independent scrapes of the same windows (the
    same discipline that makes preprocess --jobs 1 == --jobs 4)."""
    from sofa_tpu_torch import frames

    if not frames.columnar_available():
        pytest.skip("pyarrow not available")
    trees = []
    for sub in ("a", "b"):
        root = str(tmp_path / sub)
        reg = MetricsRegistry(root, worker=1)
        for i in range(5):
            reg.record_window(1700000000.0 + i, {"wal_depth": float(i)})
        assert reg.persist_history() is not None
        sdir = os.path.join(root, "_metrics", "worker001")
        tree = {}
        for dirpath, _d, names in os.walk(sdir):
            for n in sorted(names):
                with open(os.path.join(dirpath, n), "rb") as f:
                    tree[os.path.relpath(os.path.join(dirpath, n),
                                         sdir)] = f.read()
        assert frames.verify_chunk_store(sdir, "m") == []
        trees.append(tree)
    assert trees[0] == trees[1]


def test_record_window_idle_appends_nothing():
    reg = MetricsRegistry("/nonexistent-idle-root", worker=0)
    reg.record_window(1700000000.0, {"wal_depth": 1.0})
    rows, total = reg.history_rows()
    assert total == 1
    reg.record_window(1700000002.0, {"wal_depth": 1.0})  # unchanged
    rows, total = reg.history_rows()
    assert total == 1
    reg.record_window(1700000004.0, {"wal_depth": 2.0})
    rows, total = reg.history_rows()
    assert total == 2
    assert rows[-1] == [1700000004.0, "wal_depth", 2.0]


# ---------------------------------------------------------------------------
# Cross-process push tracing.
# ---------------------------------------------------------------------------

_DRAIN_SNIPPET = """
import sys
sys.path.insert(0, {repo!r})
from sofa_tpu_torch.archive import tier
from sofa_tpu_torch import metrics
stats = tier.drain_tenant({troot!r}, refresh=True)
assert stats["applied"] == 1, stats
metrics.for_tenant_root({troot!r}).flush_trace()
"""


def test_trace_id_spans_wal_replay_across_processes(tmp_path):
    """One trace id: the committing process's spans and a SEPARATE
    drain process's replay spans merge into one Perfetto-valid fleet
    trace under the same id — the WAL record is the carrier."""
    root = str(tmp_path / "fleetroot")
    troot = os.path.join(root, "tenants", "default")
    os.makedirs(troot)
    trace = "feedc0de12345678"
    reg = metrics.for_root(root, worker=0)
    # the service leg: commit span + the WAL record carrying the id
    t0 = time.time()
    reg.span("commit", "service", t0, 0.002, trace=trace, run="ab" * 32)
    app = tier.WalAppender(troot, worker=0)
    app.append({"run": "ab" * 32, "t": round(t0, 3), "logdir": "/j/",
                "hostname": "h", "label": "", "tenant": "default",
                "files": {}, "features": {"elapsed_time": 1.0},
                "trace": trace})
    assert reg.flush_trace() is not None
    # the drain leg runs in ANOTHER process — the trace id must cross
    subprocess.run(
        [sys.executable, "-c",
         _DRAIN_SNIPPET.format(repo=REPO, troot=troot)],
        check=True, env=dict(os.environ),
        timeout=120)
    doc = metrics.export_fleet_trace(root)
    assert doc is not None
    path = os.path.join(root, "_metrics", "fleet_trace",
                        metrics.FLEET_TRACE_NAME)
    on_disk = json.load(open(path))
    assert on_disk["traceEvents"] == doc["traceEvents"]
    # Perfetto validity: X events carry int ts/dur >= 0, pid/tid, name
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    for e in spans:
        assert isinstance(e["ts"], int) and e["ts"] >= 0
        assert isinstance(e["dur"], int) and e["dur"] >= 1
        assert e["name"] and "pid" in e and "tid" in e
    mine = [e for e in spans
            if (e.get("args") or {}).get("trace") == trace]
    names = {e["name"] for e in mine}
    assert "commit" in names, names
    assert "wal_apply" in names, names
    # genuinely cross-process: the joined spans come from >= 2 pids
    assert len({e["pid"] for e in mine}) >= 2


def test_fleet_load_push_traceable_end_to_end(primary, tmp_path):
    """The acceptance walk: one fleet_load-style push with a known
    X-Sofa-Trace id is followable in the exported fleet trace."""
    from sofa_tpu_torch.tools import fleet_load

    url = _url(primary)
    trace = "abad1dea00000001"
    conn = fleet_load._Conn(url, TOKEN)
    committed, _ms = fleet_load._push_run(
        conn, "default", {"features.csv": b"name,value\nx,1\n"},
        trace=trace)
    assert committed
    troot = os.path.join(primary.root, "tenants", "default")
    _wait_for(lambda: tier.wal_depth(troot) == 0, what="WAL drain")
    reg = metrics.for_root(primary.root)
    reg.flush_trace()
    doc = metrics.export_fleet_trace(primary.root)
    assert doc is not None
    mine = [e for e in doc["traceEvents"] if e.get("ph") == "X"
            and (e.get("args") or {}).get("trace") == trace]
    names = {e["name"] for e in mine}
    assert {"have", "commit", "wal_apply"} <= names, names


# ---------------------------------------------------------------------------
# GET /v1/metrics.
# ---------------------------------------------------------------------------

def test_metrics_endpoint_auth_and_etag(primary):
    url = _url(primary) + "/v1/metrics"
    code, _h, _b = _get(url, token="wrong")
    assert code == 401
    status, hdr, body = _get(url)
    assert status == 200
    doc = json.loads(body)
    assert doc["schema"] == metrics.METRICS_SCHEMA
    assert doc["version"] == metrics.METRICS_VERSION
    etag = hdr["ETag"]
    assert etag.startswith('"met-')
    # idle tier: the poll costs a 304, not a payload
    code, hdr304, body304 = _get(url, {"If-None-Match": etag})
    assert code == 304
    assert hdr304["ETag"] == etag
    assert not body304
    # activity moves the tag
    reg = metrics.for_root(primary.root)
    reg.inc("pushes")
    _status, hdr2, _body = _get(url)
    assert hdr2["ETag"] != etag


def test_metrics_endpoint_pagination_and_params(primary):
    reg = metrics.for_root(primary.root)
    for i in range(6):
        reg.record_window(time.time() - 5 + i, {"wal_depth": float(i)})
    base = _url(primary) + "/v1/metrics"
    _s, _h, body = _get(base + "?offset=2&limit=2")
    doc = json.loads(body)
    assert doc["history"]["total"] == 6
    assert doc["history"]["offset"] == 2
    assert [r["value"] for r in doc["history"]["rows"]] == [2.0, 3.0]
    assert [r["name"] for r in doc["history"]["rows"]] == \
        ["wal_depth", "wal_depth"]
    # the window filter bounds by age
    _s, _h, body = _get(base + "?window=1000000")
    assert json.loads(body)["history"]["total"] == 6
    for bad in ("?offset=-1", "?limit=x", "?window=0"):
        code, _h, _b = _get(base + bad)
        assert code == 400, bad
    mc = _load_manifest_check()
    assert mc.validate_fleet_metrics(doc) == []


def test_commit_ack_and_tier_carry_metrics_summary(primary, tmp_path):
    logdir = _mklog(tmp_path)
    rc = sofa_agent(_agent_cfg(tmp_path, _url(primary)),
                    watch=str(tmp_path), once=True)
    assert rc == 0
    doc = telemetry.load_manifest(logdir)
    mm = (doc.get("meta") or {}).get("metrics")
    assert isinstance(mm, dict)
    assert mm["trace"] == doc["meta"]["agent"]["push"]["trace"]
    assert len(mm["trace"]) == 16
    mc = _load_manifest_check()
    assert mc.validate_manifest(doc) == []
    _s, _h, body = _get(_url(primary) + "/v1/tier")
    tdoc = json.loads(body)
    assert isinstance(tdoc.get("metrics"), dict)
    summary = metrics_summary(metrics.for_root(primary.root))
    assert summary.get("push_p99_ms") is not None


def test_stale_scrape_and_breach_manifest_warnings():
    doc = {"meta": {"metrics": {"scrape_age_s": 120.0}}}
    assert any("scrape" in w for w in telemetry.manifest_warnings(doc))
    doc = {"meta": {"metrics": {"scrape_age_s": 1.0}}}
    assert not any("scrape" in w
                   for w in telemetry.manifest_warnings(doc))
    doc = {"meta": {"slo": {"ok": False,
                            "breaching": ["push_p99_ms"]}}}
    assert any("push_p99_ms" in w
               for w in telemetry.manifest_warnings(doc))


# ---------------------------------------------------------------------------
# --slo wiring and sofa status --fleet.
# ---------------------------------------------------------------------------

def test_serve_rejects_bad_slo_spec(tmp_path):
    cfg = SofaConfig(logdir=str(tmp_path / "u"), serve_token=TOKEN,
                     serve_port=0, serve_slo="push_p99_ms<<50")
    assert sofa_serve(cfg, root=str(tmp_path / "store"),
                      serve_forever=True) == 2


def test_status_fleet_exit_codes_on_breach(primary, tmp_path, capsys):
    cfg = SofaConfig(logdir=str(tmp_path / "u"), serve_token=TOKEN,
                     status_fleet=_url(primary))
    assert tier.sofa_fleet_status(cfg) == 0
    reg = metrics.for_root(primary.root)
    verdict = evaluate_slo(parse_slo("wal_depth<0"),
                           {"wal_depth": 5.0}, 1)
    assert verdict["ok"] is False
    reg.update_slo(verdict)
    assert tier.sofa_fleet_status(cfg) == 1
    out = capsys.readouterr()
    assert "wal_depth" in out.out + out.err
    # recovery: a passing verdict clears the exit code
    reg.update_slo(evaluate_slo(parse_slo("wal_depth<10"),
                                {"wal_depth": 5.0}, 2))
    assert tier.sofa_fleet_status(cfg) == 0


# ---------------------------------------------------------------------------
# Kill switch.
# ---------------------------------------------------------------------------

def test_metrics_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("SOFA_TIER_METRICS", "0")
    root = str(tmp_path / "off")
    reg = MetricsRegistry(root, worker=0)
    reg.span("commit", "service", time.time(), 0.01, trace="aa" * 8)
    assert reg.flush_trace() is None
    assert Scraper(reg).tick() is None
    assert reg.scrape_seq == 0
    assert not os.path.isdir(os.path.join(root, "_metrics"))


# ---------------------------------------------------------------------------
# The tier board contract.
# ---------------------------------------------------------------------------

def test_tier_board_contract():
    board = os.path.join(REPO, "sofa_tpu_torch", "board")
    with open(os.path.join(board, "tier.html")) as f:
        page = f.read()
    # the page speaks the endpoint's actual protocol
    assert "/v1/metrics" in page
    assert "If-None-Match" in page and "304" in page
    assert "Authorization" in page and "Bearer" in page
    assert "breaching" in page  # the breach banner names metrics
    # nav closure: every board page links Tier, and Tier links back
    pages = sorted(n for n in os.listdir(board) if n.endswith(".html"))
    for name in pages:
        with open(os.path.join(board, name)) as f:
            src = f.read()
        assert 'href="tier.html"' in src, f"{name} misses the Tier link"
        if name != "tier.html":
            assert f'href="{name}"' in page, f"Tier misses {name}"


# ---------------------------------------------------------------------------
# Parity with the JAX package.
# ---------------------------------------------------------------------------

_WINDOWS = [{"push_p99_ms": 12.5, "wal_depth": 3.0},
            {"push_p99_ms": 80.0, "wal_depth": 3.0},
            {"wal_depth": 1200.0}]


@pytest.mark.parametrize("spec", [
    "push_p99_ms<50,wal_depth<1000",
    "push_p99_ms<=80,wal_depth>=1,replica_behind<3"])
def test_slo_verdict_matches_the_jax_package(spec):
    """The same spec and the same windows give the same slo_verdict
    document in both packages (its wall-clock stamp aside)."""
    for w, values in enumerate(_WINDOWS, 1):
        got = evaluate_slo(parse_slo(spec), values, w)
        want = jax_metrics.evaluate_slo(jax_metrics.parse_slo(spec),
                                        values, w)
        for doc in (got, want):
            doc.pop("generated_unix")
        assert got == want
    with pytest.raises(ValueError):
        jax_metrics.parse_slo("push_p99_ms<<50")
    with pytest.raises(ValueError):
        parse_slo("push_p99_ms<<50")


def _fill(mod, root):
    reg = mod.MetricsRegistry(root, worker=2)
    for name, n in (("pushes", 5), ("responses", 9), ("refusals", 1)):
        reg.inc(name, n)
    for ms in (0.7, 3.0, 18.0, 240.0):
        reg.observe("push", ms)
    reg.set_gauge("wal_depth", 4)
    for i in range(5):
        reg.record_window(1700000000.0 + i, {"wal_depth": float(i % 3)})
    reg.update_slo(mod.evaluate_slo(mod.parse_slo("wal_depth<2"),
                                    {"wal_depth": 4.0}, 1))
    return reg


def test_metrics_doc_matches_the_jax_package(tmp_path):
    """The same registry gives the same /v1/metrics document and ETag in
    both packages, apart from the keys that move every scrape."""
    reg = _fill(metrics, str(tmp_path / "port"))
    jreg = _fill(jax_metrics, str(tmp_path / "jax"))
    got, etag = metrics_doc(reg, offset=1, limit=3, role="primary")
    want, jetag = jax_metrics.metrics_doc(jreg, offset=1, limit=3,
                                          role="primary")
    clock = ("generated_unix", "last_scrape_unix") + metrics._VOLATILE_KEYS
    for doc in (got, want):
        for key in clock:
            doc.pop(key, None)
        doc["snapshot"] = {k: v for k, v in doc["snapshot"].items()
                           if not k.endswith("_rps")}
        doc["slo"].pop("generated_unix")
    assert got == want
    assert etag == jetag
    assert metrics._VOLATILE_KEYS == jax_metrics._VOLATILE_KEYS


def test_slo_verdict_writers_of_one_root_never_collide(tmp_path):
    """Every worker of a pool writes the root's one slo_verdict.json: 8
    threads writing it 200 times each all succeed, the file is always a
    whole verdict, and no staged file is left.  (Staged under one shared
    ``.tmp`` name, one writer's rename took another's staged file: 324 of
    1600 writes raised FileNotFoundError, and a pool worker's final
    scrape on SIGTERM exited 1.)"""
    import threading

    root = str(tmp_path)
    verdict = evaluate_slo(parse_slo("wal_depth<1"), {"wal_depth": 3.0}, 1)
    errors = []

    def writer():
        for _ in range(200):
            try:
                metrics.write_slo_verdict(root, verdict)
            except OSError as e:
                errors.append(e)

    threads = [threading.Thread(target=writer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    assert metrics.load_slo_verdict(root) == verdict
    assert os.listdir(os.path.join(root, "_metrics")) == \
        [metrics.SLO_VERDICT_NAME]


def test_scrape_ticks_of_one_process_never_collide(tmp_path):
    """The scrape loop's thread and the SIGTERM drain's final flush tick
    one Scraper at once: 8 threads ticking it 100 times each all succeed.
    (Unserialized, two ticks staged the same ring file, and 551 of 800
    raised FileNotFoundError; a SIGTERMed service exited 1.)"""
    import threading

    reg = MetricsRegistry(str(tmp_path), worker=0)
    scraper = Scraper(reg, slo_targets=parse_slo("wal_depth<1"))
    errors = []

    def ticker():
        for _ in range(100):
            reg.span("commit", "service", time.time(), 0.001,
                     trace="ab" * 8)
            try:
                scraper.tick()
            except OSError as e:
                errors.append(e)

    threads = [threading.Thread(target=ticker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert errors == []
    assert reg.scrape_seq == 800
    assert metrics.load_slo_verdict(str(tmp_path))["ok"] is True
