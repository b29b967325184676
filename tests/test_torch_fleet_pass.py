"""The incremental fleet-pass engine of the port: the ``@fleet_pass``
registry domain over the archive's ``_index/`` column families
(``sofa_tpu_torch/analysis/fleet.py``), held to the JAX package's recipes
(``tests/test_fleet_pass.py``) and to the JAX package itself.

The recipes: contract validation, the schedule's waves, the memo, delta
and full modes (warm byte-identical to cold at any ``--jobs``, the memoized
no-op with its mtimes untouched), the full recompute after a fingerprint
change or a ``catalog.gen`` bump, the fold substrate, a kill between the
report and the memo converging, ``/v1/<tenant>/fleet``, the ``fleet``
verb's exit ladder, fsck's detection and repair of a rotted ``_fleet/``,
the refresh after an ingest, the validators, and the vectorized index
functions against per-row folds.  The parity: over one archive root, each
package's ``analyze`` writes the same report and memo bytes (the SOL
feature name mapped), cold, after a delta ingest and after a fingerprint
change.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import pytest

from sofa_tpu.analysis import fleet as jax_fleet
from sofa_tpu_torch.analysis import fleet as afleet
from sofa_tpu_torch.analysis import registry as areg
from sofa_tpu_torch.archive import catalog
from sofa_tpu_torch.archive import index as aindex
from sofa_tpu_torch.archive.service import service_url, sofa_serve
from sofa_tpu_torch.archive.store import ArchiveStore, archive_fsck
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.durability import atomic_write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "test-fleet-pass-token"

pytestmark = pytest.mark.skipif(not aindex.available(),
                                reason="pyarrow unavailable")


def _mkarchive(tmp_path, n=10, hosts=3, name="arch"):
    """A synthetic archive shaped like a real ingest's output."""
    root = str(tmp_path / name)
    store = ArchiveStore(root, create=True)
    for i in range(n):
        run = f"{i:064x}"
        doc = {"schema": "sofa_tpu/archive_run", "version": 1,
               "run": run, "t": 1000.0 + i, "hostname": f"h{i % hosts}",
               "label": "nightly" if i % 2 else "release",
               "logdir": f"/fleet/h{i % hosts}/job{i}",
               "files": {"report.js": {"sha256": "0" * 64, "bytes": 10,
                                       "kind": "derived"}},
               "features": {"elapsed_time": 10.0 + i,
                            "step_time_mean": 0.05,
                            "gpu0_sol_distance": 2.0 + i * 0.25,
                            "gpu1_sol_distance": 1.5 + (n - i) * 0.125}}
        with atomic_write(store.run_doc_path(run)) as f:
            json.dump(doc, f, sort_keys=True)
        catalog.append_event(
            root, "ingest", run=run, logdir=doc["logdir"], files=1,
            new_objects=1, bytes_added=128,
            **({"label": doc["label"]} if doc["label"] else {}))
    return root, store


def _append_run(root, store, i, features=None):
    run = f"{i:064x}"
    doc = {"run": run, "t": 1000.0 + i, "hostname": f"h{i % 3}",
           "logdir": f"/fleet/h{i % 3}/job{i}", "files": {},
           "features": features if features is not None
           else {"elapsed_time": 10.0 + i,
                 "step_time_mean": 0.05,
                 "gpu0_sol_distance": 2.0 + i * 0.25}}
    with atomic_write(store.run_doc_path(run)) as f:
        json.dump(doc, f, sort_keys=True)
    catalog.append_event(root, "ingest", run=run, logdir=doc["logdir"],
                         files=0, new_objects=0, bytes_added=0)
    return run


def _report_bytes(root):
    with open(afleet.report_path(root), "rb") as f:
        return f.read()


def _modes(report):
    return {n: s["mode"]
            for n, s in (report["_stats"]["passes"] or {}).items()}


# ---------------------------------------------------------------------------
# Registration contracts.
# ---------------------------------------------------------------------------

def _noop_pass(state, tables, ctx, features):
    return {"state": None, "report": {}}


def test_register_validates_contract_literals():
    with afleet.scoped():
        with pytest.raises(afleet.FleetError, match="non-empty string"):
            afleet.register_fleet_pass(_noop_pass, name="")
        with pytest.raises(afleet.FleetError, match="not an index family"):
            afleet.register_fleet_pass(_noop_pass, name="bad_family",
                                       reads_frames=("tputrace",))
        with pytest.raises(afleet.FleetError,
                           match="not a declared-family column"):
            afleet.register_fleet_pass(
                _noop_pass, name="bad_col",
                reads_frames=("features",),
                reads_columns=("features.bogus",))
        with pytest.raises(afleet.FleetError,
                           match="not a declared-family column"):
            # right column, family absent from reads_frames
            afleet.register_fleet_pass(
                _noop_pass, name="bad_qual",
                reads_frames=("features",),
                reads_columns=("catalog.verb",))
        afleet.register_fleet_pass(_noop_pass, name="dup",
                                   reads_frames=("features",))
        with pytest.raises(afleet.FleetError, match="already registered"):
            afleet.register_fleet_pass(_noop_pass, name="dup")


def test_register_rejects_cross_domain_after():
    with areg.scoped(), afleet.scoped():
        areg.register_pass(lambda frames, cfg, features: None,
                           name="per_run_pass")
        with pytest.raises(afleet.FleetError, match="crosses into"):
            afleet.register_fleet_pass(_noop_pass, name="crosser",
                                       after=("per_run_pass",))
        # fleet->fleet edges are fine
        afleet.register_fleet_pass(_noop_pass, name="base_pass",
                                   reads_frames=("features",))
        afleet.register_fleet_pass(_noop_pass, name="downstream",
                                   after=("base_pass",))


def test_fingerprint_is_pure_function_of_declaration():
    with afleet.scoped():
        a = afleet.register_fleet_pass(
            _noop_pass, name="fp", order=5, reads_frames=("features",),
            reads_columns=("features.value",))
    with afleet.scoped():
        b = afleet.register_fleet_pass(
            _noop_pass, name="fp", order=5, reads_frames=("features",),
            reads_columns=("features.value",))
    with afleet.scoped():
        c = afleet.register_fleet_pass(
            _noop_pass, name="fp", order=5, reads_frames=("features",),
            reads_columns=("features.value", "features.name"))
    assert afleet.fingerprint(a) == afleet.fingerprint(b)
    assert afleet.fingerprint(a) != afleet.fingerprint(c)


# ---------------------------------------------------------------------------
# The mode ladder: cold -> delta -> memo no-op, all byte-identical.
# ---------------------------------------------------------------------------

def test_cold_warm_noop_ladder_byte_identical(tmp_path):
    root, store = _mkarchive(tmp_path, n=8)
    cold = afleet.analyze(root)
    assert cold["_stats"]["noop"] is False
    assert set(_modes(cold).values()) == {"full"}
    assert cold["order"] == [s.name for s in afleet.registered()]
    # schedule covers exactly the registered passes, wave edges honored
    assert sorted(n for w in cold["schedule"] for n in w) \
        == sorted(cold["order"])

    # warm: one appended run -> every pass folds only the delta window
    _append_run(root, store, 100)
    warm = afleet.analyze(root)
    assert set(_modes(warm).values()) == {"delta"}
    warm_bytes = _report_bytes(root)

    # memoized no-op: same commit, same contracts -> zero writes
    mtime = os.path.getmtime(afleet.report_path(root))
    noop = afleet.analyze(root)
    assert noop["_stats"]["noop"] is True
    assert set(_modes(noop).values()) == {"memo"}
    assert os.path.getmtime(afleet.report_path(root)) == mtime

    # the warm fold is byte-identical to a cold recompute, at any width
    afleet.drop(root)
    afleet.analyze(root, jobs=1)
    assert _report_bytes(root) == warm_bytes
    afleet.drop(root)
    afleet.analyze(root, jobs=4)
    assert _report_bytes(root) == warm_bytes


def test_report_and_state_pass_manifest_check(tmp_path):
    root, _store = _mkarchive(tmp_path, n=6)
    afleet.analyze(root)
    from sofa_tpu_torch.tools import manifest_check

    report = json.load(open(afleet.report_path(root)))
    state = json.load(open(afleet.state_path(root)))
    assert manifest_check.validate_fleet_report(
        report, require_healthy=True) == []
    assert manifest_check.validate_fleet_state(state) == []
    # and a mangled report is caught
    bad = dict(report, version=99, commit_sha="")
    assert manifest_check.validate_fleet_report(bad) != []


def test_fingerprint_change_forces_full_recompute(tmp_path):
    root, store = _mkarchive(tmp_path, n=6)

    def counting(state, tables, ctx, features):
        return {"state": {"n": (state or {}).get("n", 0) + 1},
                "report": {"mode_seen": ctx.mode}}

    with afleet.scoped():
        afleet.register_fleet_pass(counting, name="counting",
                                   reads_frames=("features",),
                                   reads_columns=("features.value",))
        afleet.analyze(root)
        _append_run(root, store, 50)
        warm = afleet.analyze(root)
        assert _modes(warm)["counting"] == "delta"
    # same pass, edited contract -> its memoized state is unusable
    with afleet.scoped():
        afleet.register_fleet_pass(counting, name="counting",
                                   reads_frames=("features",),
                                   reads_columns=("features.value",
                                                  "features.name"))
        _append_run(root, store, 51)
        again = afleet.analyze(root)
        modes = _modes(again)
        assert modes["counting"] == "full"
        # the untouched builtins still ride the delta path
        assert all(m == "delta" for n, m in modes.items()
                   if n != "counting")


def test_catalog_gen_bump_forces_full_recompute(tmp_path):
    root, store = _mkarchive(tmp_path, n=6)
    afleet.analyze(root)
    _append_run(root, store, 60)
    assert set(_modes(afleet.analyze(root)).values()) == {"delta"}
    # a catalog rewrite bumps catalog.gen: history changed, no delta
    # window is sound
    catalog.rewrite(root, catalog.read_catalog(root))
    full = afleet.analyze(root)
    assert set(_modes(full).values()) == {"full"}


def test_schedule_orders_after_edges_and_feature_reads(tmp_path):
    root, _store = _mkarchive(tmp_path, n=4)
    seen = []

    def producer(state, tables, ctx, features):
        features.add("fleet_custom_signal", 41.0)
        seen.append("producer")
        return {"state": None, "report": {}}

    def consumer(state, tables, ctx, features):
        seen.append("consumer")
        v = features.get("fleet_custom_signal")
        return {"state": None, "report": {"got": v}}

    with afleet.scoped():
        afleet.register_fleet_pass(
            producer, name="producer", reads_frames=("features",),
            provides_features=("fleet_custom_signal",))
        afleet.register_fleet_pass(
            consumer, name="consumer",
            reads_features=("fleet_custom_signal",), after=("producer",))
        report = afleet.analyze(root)
    waves = {n: i for i, wave in enumerate(report["schedule"])
             for n in wave}
    assert waves["producer"] < waves["consumer"]
    assert seen.index("producer") < seen.index("consumer")
    assert report["passes"]["consumer"]["report"]["got"] == 41.0
    assert report["features"]["fleet_custom_signal"] == 41.0


def test_failing_pass_is_isolated_and_report_commits(tmp_path):
    root, _store = _mkarchive(tmp_path, n=4)

    def boom(state, tables, ctx, features):
        raise RuntimeError("synthetic fleet fault")

    with afleet.scoped():
        afleet.register_fleet_pass(boom, name="boom",
                                   reads_frames=("runs",))
        report = afleet.analyze(root)
    entry = report["passes"]["boom"]
    assert entry["status"] == "failed"
    assert "synthetic fleet fault" in entry["error"]
    # the other passes ran and the artifact still committed
    assert all(report["passes"][n]["status"] == "ok"
               for n in report["order"] if n != "boom")
    assert afleet.load_report(root) is not None


# ---------------------------------------------------------------------------
# The fold substrate.
# ---------------------------------------------------------------------------

def test_fold_chunks_partials_and_order():
    import pyarrow as pa

    tbl = pa.table({"v": list(range(10))})
    parts = {}
    afleet.fold_chunks(parts, tbl, 0, 4, lambda t: t.num_rows)
    assert parts == {"0": 4, "1": 4, "2": 2}
    # a delta fold drops partials at/past base, keeps the prefix
    parts["0"] = "kept"
    suffix = tbl.slice(4)  # rows of chunks 1..2
    afleet.fold_chunks(parts, suffix, 1, 4, lambda t: t.num_rows)
    assert parts == {"0": "kept", "1": 4, "2": 2}
    # chunk-ordinal ordering is numeric, not lexicographic
    many = {str(i): i for i in (0, 2, 10, 1)}
    assert afleet.parts_in_order(many) == [0, 1, 2, 10]


def test_runs_meta_point_lookups_memoized(tmp_path):
    root, _store = _mkarchive(tmp_path, n=6)
    commit = aindex.refresh(root)
    ctx = afleet.FleetContext(root=root, commit=commit, mode="full",
                              chunk_rows=aindex.INDEX_CHUNK_ROWS)
    run0, run_missing = f"{0:064x}", "f" * 64
    meta = ctx.runs_meta({run0, run_missing})
    assert set(meta) == {run0}
    assert meta[run0]["host"] == "h0"
    assert meta[run0]["label"] == "release"
    # second call is served from the per-context cache (absent ids too)
    assert run_missing in ctx._meta_absent
    again = ctx.runs_meta({run0, run_missing})
    assert again == meta


# ---------------------------------------------------------------------------
# Crash-window convergence (the in-tree cousin of the chaos cell).
# ---------------------------------------------------------------------------

def test_kill_between_report_and_memo_converges(tmp_path):
    root, store = _mkarchive(tmp_path, n=6)
    afleet.analyze(root)
    want = _report_bytes(root)
    afleet.drop(root)
    env = dict(os.environ, SOFA_FLEET_EXIT_AFTER="1", PYTHONPATH=REPO)
    env.pop("_SOFA_FLEET_TICKS", None)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""
            import sys
            from sofa_tpu_torch.analysis import fleet
            fleet.analyze(sys.argv[1])
            sys.exit(3)  # unreachable: the chaos knob exits first
        """), root], env=env, timeout=120, capture_output=True)
    assert proc.returncode == 86, proc.stderr.decode()
    # torn state: report committed, memo missing — healthy-pending, not
    # damage
    assert os.path.exists(afleet.report_path(root))
    assert not os.path.exists(afleet.state_path(root))
    assert afleet.verify(root) == []
    # the report that DID land is already the right bytes, and the
    # re-run converges the memo without changing them
    assert _report_bytes(root) == want
    afleet.analyze(root)
    assert _report_bytes(root) == want
    assert afleet._load_state(root) is not None


def test_fsck_detects_and_repairs_rotted_fleet_tier(tmp_path):
    root, _store = _mkarchive(tmp_path, n=4)
    afleet.analyze(root)
    assert archive_fsck(root)["fleet"] == []
    with open(afleet.report_path(root), "w") as f:
        f.write("{not json")
    assert afleet.verify(root) == ["_fleet/fleet_report.json"]
    assert archive_fsck(root)["fleet"] == ["_fleet/fleet_report.json"]
    # repair drops the derived tier; the next analyze rebuilds it
    assert archive_fsck(root, repair=True)["fleet"] == []
    assert not os.path.isdir(afleet.fleet_dir(root))
    afleet.analyze(root)
    assert archive_fsck(root)["fleet"] == []


def test_refresh_after_ingest_gate_and_degrade(tmp_path, monkeypatch):
    root, _store = _mkarchive(tmp_path, n=4)
    aindex.refresh(root)
    monkeypatch.setenv("SOFA_FLEET_REFRESH", "0")
    assert afleet.refresh_after_ingest(root) is None
    assert not os.path.isdir(afleet.fleet_dir(root))
    monkeypatch.delenv("SOFA_FLEET_REFRESH")
    report = afleet.refresh_after_ingest(root)
    assert report is not None and afleet.load_report(root) is not None
    # derived state must never fail the drain: a broken substrate
    # degrades to None instead of raising
    assert afleet.refresh_after_ingest(str(tmp_path / "nowhere")) is None


# ---------------------------------------------------------------------------
# The `fleet` verb.
# ---------------------------------------------------------------------------

def test_sofa_fleet_verb_exit_ladder(tmp_path, capsys):
    cfg = SofaConfig(logdir=str(tmp_path / "unused"))
    assert afleet.sofa_fleet(cfg, "analyze", "") == 2
    assert afleet.sofa_fleet(cfg, "bogus", "x") == 2
    assert afleet.sofa_fleet(cfg, "analyze",
                             str(tmp_path / "missing")) == 2
    root, _store = _mkarchive(tmp_path, n=4)
    assert afleet.sofa_fleet(cfg, "analyze", root) == 0
    out = capsys.readouterr().out
    assert "SOFA fleet analyze" in out
    for name in [s.name for s in afleet.registered()]:
        assert name in out

    def boom(state, tables, ctx, features):
        raise RuntimeError("verb fault")

    with afleet.scoped():
        afleet.register_fleet_pass(boom, name="boom",
                                   reads_frames=("runs",))
        afleet.drop(root)
        assert afleet.sofa_fleet(cfg, "analyze", root) == 1


# ---------------------------------------------------------------------------
# GET /v1/<tenant>/fleet.
# ---------------------------------------------------------------------------

@pytest.fixture
def service(tmp_path):
    cfg = SofaConfig(logdir=str(tmp_path / "unused"),
                     serve_token=TOKEN, serve_port=0)
    httpd = sofa_serve(cfg, root=str(tmp_path / "fleet"),
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
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_v1_fleet_auth_etag_304(service, tmp_path):
    root = service.tenant_root("default")
    store = ArchiveStore(root, create=True)
    for i in range(5):
        _append_run(root, store, i)
    aindex.refresh(root)
    base = service_url(service)
    auth = {"Authorization": f"Bearer {TOKEN}"}
    # auth first, artifact second: no token -> 401
    code, _h, _b = _get(f"{base}/v1/default/fleet")
    assert code == 401
    # no committed report yet -> an explicit 404, not an empty 200
    code, _h, body = _get(f"{base}/v1/default/fleet", auth)
    assert code == 404
    assert json.loads(body)["error"] == "no_fleet_report"
    report = afleet.analyze(root)
    code, hdrs, body = _get(f"{base}/v1/default/fleet", auth)
    assert code == 200
    etag = hdrs.get("ETag")
    assert etag == f'"idx-{report["commit_sha"]}"'
    doc = json.loads(body)
    assert doc["schema"] == afleet.FLEET_REPORT_SCHEMA
    assert doc["tenant"] == "default"
    assert doc["commit_sha"] == report["commit_sha"]
    assert doc["order"] == report["order"]
    # idle poll: the ETag round-trips as a 304
    code, _h, _b = _get(f"{base}/v1/default/fleet",
                        {**auth, "If-None-Match": etag})
    assert code == 304
    # a new ingest moves the commit sha -> the poll turns 200 again
    _append_run(root, store, 50)
    afleet.analyze(root)
    code, hdrs, _b = _get(f"{base}/v1/default/fleet",
                          {**auth, "If-None-Match": etag})
    assert code == 200 and hdrs.get("ETag") != etag


# ---------------------------------------------------------------------------
# The lint: SL010-SL013 over @fleet_pass declarations, both engines
# ---------------------------------------------------------------------------

def _fleet_lint(tmp_path, files):
    """Lint {relname: src} with the port's engine and the JAX package's,
    the pinned family schemas from each package's archive/index.py; the
    pass-rule findings must agree.  Returns the port's."""
    from sofa_tpu.lint.core import ProjectContext as JaxProjectContext
    from sofa_tpu.lint.core import lint_paths as jax_lint_paths
    from sofa_tpu.lint.rules import default_rules as jax_default_rules
    from sofa_tpu_torch.lint.core import ProjectContext, lint_paths
    from sofa_tpu_torch.lint.rules import default_rules

    paths = []
    for rel, body in files.items():
        p = tmp_path / rel
        p.write_text(textwrap.dedent(body))
        paths.append(str(p))
    base = str(tmp_path)
    ids = ("SL010", "SL011", "SL012", "SL013")
    project = ProjectContext.detect(paths, base=base)
    assert project.index_columns
    port = [f for f in lint_paths(paths, default_rules(), project=project,
                                  base=base) if f.rule_id in ids]
    jax = [f for f in jax_lint_paths(
        paths, jax_default_rules(),
        project=JaxProjectContext.detect(paths, base=base), base=base)
        if f.rule_id in ids]
    assert sorted((f.rule_id, f.file, f.line, f.severity) for f in port) \
        == sorted((f.rule_id, f.file, f.line, f.severity) for f in jax)
    return port


def test_lint_flags_undeclared_fleet_reads(tmp_path):
    fs = _fleet_lint(tmp_path, {"p.py": '''
        from sofa_tpu_torch.analysis.fleet import fleet_pass

        @fleet_pass(name="leaky", reads_frames=("features",),
                    reads_columns=("features.value",))
        def leaky(state, tables, ctx, features):
            tbl = tables["catalog"]
            col = tables["features"]["name"]
            return {"state": None, "report": {}}
    '''})
    msgs = [f.message for f in fs if f.rule_id == "SL010"]
    assert any("'catalog'" in m for m in msgs), msgs
    assert any("'name'" in m for m in msgs), msgs


def test_lint_flags_phantom_fleet_declaration(tmp_path):
    fs = _fleet_lint(tmp_path, {"p.py": '''
        from sofa_tpu_torch.analysis.fleet import fleet_pass

        @fleet_pass(name="phantom", reads_frames=("notafamily",),
                    reads_columns=("features.bogus",))
        def phantom(state, tables, ctx, features):
            return {"state": None, "report": {}}
    '''})
    msgs = [f.message for f in fs if f.rule_id == "SL010"]
    assert any("'notafamily'" in m for m in msgs), msgs
    assert any("'features.bogus'" in m for m in msgs), msgs


def test_lint_flags_cross_domain_after_edge(tmp_path):
    fs = _fleet_lint(tmp_path, {"p.py": '''
        from sofa_tpu_torch.analysis.fleet import fleet_pass
        from sofa_tpu_torch.analysis.registry import analysis_pass

        @analysis_pass(name="per_run")
        def per_run(frames, cfg, features):
            pass

        @fleet_pass(name="crosser", reads_frames=("runs",),
                    after=("per_run",))
        def crosser(state, tables, ctx, features):
            return {"state": None, "report": {}}
    '''})
    msgs = [f.message for f in fs if f.rule_id == "SL012"]
    assert any("cross-domain" in m for m in msgs), msgs


def test_lint_clean_fleet_pass(tmp_path):
    fs = _fleet_lint(tmp_path, {"p.py": '''
        from sofa_tpu_torch.analysis.fleet import fleet_pass

        @fleet_pass(name="tidy", reads_frames=("features",),
                    reads_columns=("features.name", "features.value"),
                    provides_features=("fleet_tidy_total",))
        def tidy(state, tables, ctx, features):
            tbl = tables["features"]
            vals = tbl["value"]
            features.add("fleet_tidy_total", 1.0)
            return {"state": None, "report": {}}
    '''})
    assert fs == []


# ---------------------------------------------------------------------------
# The vectorized index functions stay identical to per-row reference
# folds (the perf-rewrite safety net).
# ---------------------------------------------------------------------------

def test_runs_rows_vectorized_matches_reference_fold():
    import random

    import pandas as pd

    random.seed(7)

    def ref_runs_rows(ev_all, ft_all):
        ing = ev_all[(ev_all["verb"] == "ingest") & (ev_all["run"] != "")]
        latest = {}
        for rec in ing.to_dict("records"):
            latest[rec["run"]] = rec
        ordered = sorted(latest.values(),
                         key=lambda r: (r.get("timestamp") or 0))
        counts = {}
        if len(ft_all):
            dd = ft_all[~ft_all.duplicated(["run", "name"], keep="last")]
            counts = dd["run"].value_counts().to_dict()
        rows = [{"run": r["run"], "label": r["label"], "host": r["host"],
                 "logdir": r["logdir"], "timestamp": r["timestamp"],
                 "bytes": r["bytes"], "files": r["files"],
                 "n_features": float(counts.get(r["run"], 0))}
                for r in ordered]
        return aindex._conform_family(
            pd.DataFrame(rows, columns=aindex.RUNS_COLUMNS),
            aindex.RUNS_COLUMNS)

    # re-ingested runs, timestamp ties, non-ingest verbs, empty-run rows
    ev_rows, t = [], 1000.0
    runs = [f"r{i:03d}" for i in range(40)]
    for k in range(300):
        r = random.choice(runs)
        verb = random.choice(["ingest", "ingest", "ingest", "gc", "serve"])
        t += random.choice([0.0, 0.0, 1.0])
        ev_rows.append({
            "run": r if verb == "ingest"
            else (r if random.random() < .5 else ""),
            "verb": verb, "label": random.choice(["", "nightly", "rel"]),
            "host": f"h{k % 7}", "logdir": f"/ld/{r}", "timestamp": t,
            "bytes": float(k), "files": float(k % 9)})
    ev_all = aindex._conform_family(
        pd.DataFrame(ev_rows, columns=aindex.CATALOG_COLUMNS),
        aindex.CATALOG_COLUMNS)
    ft_rows = []
    for r in runs[:30]:
        for j in range(random.randrange(0, 6)):
            ft_rows.append({"run": r, "name": f"f{j}", "value": float(j),
                            "timestamp": 1.0})
    ft_rows += ft_rows[:10]  # duplicate (run, name) pairs: keep-last
    ft_all = aindex._conform_family(
        pd.DataFrame(ft_rows, columns=aindex.FEATURE_COLUMNS),
        aindex.FEATURE_COLUMNS)

    for ev, ft in [(ev_all, ft_all),
                   (ev_all.iloc[0:0], ft_all),
                   (ev_all, ft_all.iloc[0:0])]:
        got = aindex._runs_rows(ev, ft).reset_index(drop=True)
        want = ref_runs_rows(ev, ft).reset_index(drop=True)
        pd.testing.assert_frame_equal(got, want)


# ---------------------------------------------------------------------------
# Parity: the same archive gives the same report and memo bytes.
# ---------------------------------------------------------------------------

def _both_sol(features):
    """The run's features under each package's SOL name: the port's
    analysis/sol.py writes ``gpu<N>_sol_distance``, the JAX package's
    ``tpu<N>_sol_distance``; one root carries both, so that its index (and
    the commit sha every report is stamped with) is one."""
    out = dict(features)
    for name, value in features.items():
        if name.startswith("gpu") and name.endswith("_sol_distance"):
            out["tpu" + name[3:]] = value
    return out


def _counting(state, tables, ctx, features):
    return {"state": {"n": (state or {}).get("n", 0) + 1},
            "report": {"mode_seen": ctx.mode}}


def _register_counting(columns):
    for mod in (afleet, jax_fleet):
        mod.register_fleet_pass(_counting, name="counting", order=100,
                                reads_frames=("features",),
                                reads_columns=columns)


def _fleet_bytes(root, mapped=False):
    out = []
    for path in (afleet.report_path(root), afleet.state_path(root)):
        with open(path, "rb") as f:
            data = f.read()
        # the SOL name and its device label; not the schema strings
        out.append(re.sub(rb"(?<![a-z_])tpu", b"gpu", data) if mapped
                   else data)
    return out


@pytest.mark.parametrize("stage", ["cold", "delta", "fingerprint"])
def test_fleet_report_bytes_match_the_jax_package(tmp_path, stage):
    """Over copies of one archive root, JAX ``analysis.fleet.analyze`` and
    the port's write the same ``fleet_report.json`` and
    ``fleet_state.json``, byte for byte once the JAX package's SOL name is
    mapped to the port's: cold, after a delta ingest, and after a pass's
    contract changed."""
    import shutil

    root, store = _mkarchive(tmp_path, n=10, name="port")
    for run in store.run_ids():
        doc = store.load_run(run)
        doc["features"] = _both_sol(doc["features"])
        with atomic_write(store.run_doc_path(run)) as f:
            json.dump(doc, f, sort_keys=True)
    aindex.refresh(root)
    jroot = str(tmp_path / "jax")
    shutil.copytree(root, jroot)

    def append(i):
        # one ingest, copied: the catalog line carries its own clock
        run = _append_run(root, store, i, features=_both_sol(
            {"elapsed_time": 10.0 + i, "step_time_mean": 0.05,
             "swarm_0_mean": 1.0 + i, "gpu0_sol_distance": 2.0 + i}))
        for path in (catalog.catalog_path(root), store.run_doc_path(run)):
            shutil.copyfile(path, os.path.join(
                jroot, os.path.relpath(path, root)))

    def both():
        afleet.analyze(root)
        jax_fleet.analyze(jroot)
        assert (aindex.load_commit(root)["commit_sha"]
                == aindex.load_commit(jroot)["commit_sha"])
        got, want = _fleet_bytes(root), _fleet_bytes(jroot, mapped=True)
        for g, w in zip(got, want):
            assert g.decode().splitlines() == w.decode().splitlines()

    afleet.load_builtin_passes()
    jax_fleet.load_builtin_passes()
    columns = ("features.value",)
    with afleet.scoped(), jax_fleet.scoped():
        if stage == "fingerprint":
            _register_counting(columns)
        both()
    if stage == "cold":
        return
    append(100)
    if stage == "fingerprint":
        columns = ("features.value", "features.name")
    with afleet.scoped(), jax_fleet.scoped():
        if stage == "fingerprint":
            _register_counting(columns)
        both()
        report = afleet.analyze(root)
    assert {m["mode"] for m in report["_stats"]["passes"].values()} \
        == {"memo"}
    if stage == "fingerprint":
        assert report["passes"]["counting"]["report"]["mode_seen"] == "full"
