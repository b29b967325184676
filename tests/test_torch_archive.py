"""The port's trace archive and ``regress`` (``sofa_tpu_torch/archive/``)
held against the JAX package's ``sofa_tpu/archive/`` in one process.

The JAX package's recipes (``tests/test_archive.py``, all but its bench
tests, which need the bench importer) run on the port: dedup across
ingests, gc, the catalog's torn tail, the store's fsck (corrupt,
quarantine, adopt, the verb's dispatch), ``resume`` of a killed ingest,
``clean`` sparing a nested archive root, the baseline math, ``regress``'s
exit codes through a subprocess, the verdict schema, the hash-only tile
diff, ``show``, ``extract``, the root's precedence, and backup and
restore.  Then the packages against each other: one logdir ingested by
both gives one run id, one ``files`` map, one catalog line and one
``index_commit.json`` (the clock frozen, so that ``t`` agrees); a
columnar logdir differs only by the chunk stores the port archives too;
the verdict files agree apart from their timestamp; each package's
``ls``, ``show``, ``regress`` and ``fsck`` read the other's root; the
baseline functions agree on drawn samples to 1e-12.  Bytes and verdicts
are compared exactly.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sofa_tpu.archive import baseline as jax_bl
from sofa_tpu.archive import catalog as jax_catalog
from sofa_tpu.archive import index as jax_index
from sofa_tpu.archive import store as jax_store
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu_torch import durability, telemetry
from sofa_tpu_torch.archive import (catalog, index as aindex,
                                    is_archive_root, resolve_root)
from sofa_tpu_torch.archive import baseline as bl
from sofa_tpu_torch.archive.store import (ArchiveStore, archive_fsck, gc,
                                          ingest_run, run_content_id,
                                          tile_diff)
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.preprocess import sofa_preprocess
from sofa_tpu_torch.record import sofa_clean
from sofa_tpu_torch.tools import manifest_check
from test_torch_faults import jax_validator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's own limit for the baseline math (float64 order stats
# and interpolation: the same operations in the same order)
MATH_TOL = 1e-12


def jax_manifest_check():
    """The JAX package's ``tools/manifest_check.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_manifest_check", os.path.join(REPO, "tools", "manifest_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mini_logdir(tmp_path, name="log", elapsed=1.5, step_time=0.05,
                 fmt="") -> SofaConfig:
    """The smallest archivable logdir (the JAX recipe's ``_mini_logdir``):
    the port's preprocess over a clock and a misc.txt, and a feature
    vector."""
    ld = str(tmp_path / name) + "/"
    os.makedirs(ld, exist_ok=True)
    with open(ld + "sofa_time.txt", "w") as f:
        f.write("1000.0\n")
    with open(ld + "misc.txt", "w") as f:
        f.write(f"elapsed_time {elapsed}\ncores 2\npid 1\nrc 0\n")
    cfg = SofaConfig(logdir=ld, trace_format=fmt)
    sofa_preprocess(cfg)
    with open(ld + "features.csv", "w") as f:
        f.write("name,value\n"
                f"elapsed_time,{elapsed}\n"
                f"step_time_mean,{step_time}\n"
                "gpu_kernels,100\n")
    durability.write_digests(ld)
    return cfg


def _store_bytes(root: str) -> int:
    total = 0
    for dirpath, _dirs, names in os.walk(os.path.join(root, "objects")):
        total += sum(os.path.getsize(os.path.join(dirpath, n))
                     for n in names)
    return total


def _cli(*args, package="sofa_tpu_torch"):
    return subprocess.run([sys.executable, "-m", package, *args],
                          capture_output=True, text=True, timeout=180,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                                             JAX_PLATFORMS="cpu"))


# --- dedup ------------------------------------------------------------------

def test_double_ingest_grows_store_by_catalog_entry_only(tmp_path):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    s1 = ingest_run(cfg, root)
    bytes_after_first = _store_bytes(root)
    cat_lines = len(catalog.read_catalog(root))
    s2 = ingest_run(cfg, root)
    assert s2["run"] == s1["run"]          # a content address
    assert s2["new_objects"] == 0 and s2["bytes_added"] == 0
    assert _store_bytes(root) == bytes_after_first
    assert len(catalog.read_catalog(root)) == cat_lines + 1
    assert len(catalog.ingest_entries(catalog.read_catalog(root))) == 1


def test_shared_objects_dedup_across_different_runs(tmp_path):
    root = str(tmp_path / "arch")
    s1 = ingest_run(_mini_logdir(tmp_path, "a", elapsed=1.5), root)
    s2 = ingest_run(_mini_logdir(tmp_path, "b", elapsed=2.5), root)
    assert s2["run"] != s1["run"]
    # the unchanged artifacts (sofa_time.txt, the empty frames) landed once
    assert s2["new_objects"] < s2["files"]


def test_run_content_id_is_order_independent():
    files = {"a.csv": {"sha256": "aa"}, "b.csv": {"sha256": "bb"}}
    flipped = dict(reversed(list(files.items())))
    assert run_content_id(files) == run_content_id(flipped) == \
        jax_store.run_content_id(files)
    assert run_content_id(files) != run_content_id(
        {"a.csv": {"sha256": "aa"}})


def test_ingest_archives_the_chunk_stores(tmp_path):
    """The port archives each committed chunk store (the digests skip
    ``_frames/``; ``<name>.csv`` is the board's downsampled copy), so that
    an extracted run reads back the frames it had."""
    from test_torch_board import write_sink_logdir

    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.trace import read_frame

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    cfg = SofaConfig(logdir=d, viz_downsample_to=8)
    sofa_analyze(cfg, sofa_preprocess(cfg))
    root = str(tmp_path / "arch")
    s = ingest_run(cfg, root)
    doc = ArchiveStore(root).load_run(s["run"])
    frames_files = [r for r in doc["files"] if r.startswith("_frames/")]
    assert "_frames/gputrace/frame_index.json" in frames_files
    assert "_frames/gputrace/000000.arrow" in frames_files
    assert all(doc["files"][r]["kind"] == "frame" for r in frames_files)
    assert any(r.startswith("kineto/") for r in doc["files"])
    dest = str(tmp_path / "extracted") + "/"
    assert ArchiveStore(root).extract(s["run"], dest) == s["files"]
    pd.testing.assert_frame_equal(read_frame(dest + "gputrace"),
                                  read_frame(d + "gputrace"))
    # re-archiving the same run stores nothing new
    again = ingest_run(cfg, root)
    assert again["run"] == s["run"] and again["new_objects"] == 0


# --- catalog ----------------------------------------------------------------

def test_catalog_torn_tail_tolerated(tmp_path):
    root = str(tmp_path / "arch")
    ArchiveStore(root, create=True)
    catalog.append_event(root, "ingest", run="x" * 64, files=1)
    catalog.append_event(root, "bench", metric="m", value=1.0)
    with open(catalog.catalog_path(root), "a") as f:
        f.write('{"ev":"ingest","run":"torn-mid-wri')
    entries = catalog.read_catalog(root)
    assert len(entries) == 2 and entries == jax_catalog.read_catalog(root)
    assert catalog.bench_entries(entries)[0]["value"] == 1.0


# --- gc ---------------------------------------------------------------------

def test_gc_keep_retention_sweeps_unreferenced_objects(tmp_path):
    root = str(tmp_path / "arch")
    for i in range(3):
        ingest_run(_mini_logdir(tmp_path, f"r{i}", elapsed=1.0 + i), root)
    store = ArchiveStore(root)
    assert len(store.run_ids()) == 3
    bytes_before = _store_bytes(root)
    summary = gc(root, keep=2)
    assert summary["dropped_runs"] == 1 and summary["swept_objects"] > 0
    assert len(store.run_ids()) == 2
    assert _store_bytes(root) < bytes_before
    report = archive_fsck(root)
    assert not report["missing"] and not report["corrupt"]
    assert len(catalog.ingest_entries(catalog.read_catalog(root))) == 2


def test_gc_requires_policy_via_cli(tmp_path):
    r = _cli("archive", "gc", "--archive_root", str(tmp_path / "arch"))
    assert r.returncode == 2    # refuses to guess a retention policy


# --- fsck -------------------------------------------------------------------

def test_fsck_detects_and_repairs_corrupted_frame(tmp_path):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    ingest_run(cfg, root)
    store = ArchiveStore(root)
    doc = store.load_run(store.run_ids()[0])
    sha = doc["files"]["gputrace.csv"]["sha256"]
    with open(store.object_path(sha), "ab") as f:
        f.write(b"rot")                       # silent rot
    report = archive_fsck(root)
    assert any(sha in c for c in report["corrupt"])
    report = archive_fsck(root, repair=True)  # the logdir still has it
    assert not report["corrupt"]
    report = archive_fsck(root)
    assert not report["corrupt"] and not report["missing"]


def test_fsck_quarantines_when_source_gone(tmp_path):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    ingest_run(cfg, root)
    store = ArchiveStore(root)
    sha = store.load_run(store.run_ids()[0])["files"]["gputrace.csv"][
        "sha256"]
    with open(store.object_path(sha), "ab") as f:
        f.write(b"rot")
    shutil.rmtree(cfg.logdir)                 # the source is gone
    report = archive_fsck(root, repair=True)
    assert not report["corrupt"]
    assert any("quarantined" in m for m in report["missing"])
    assert os.path.isfile(os.path.join(root, "_quarantine", sha))


def test_fsck_adopts_uncataloged_run(tmp_path):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    ingest_run(cfg, root)
    os.unlink(catalog.catalog_path(root))     # a crash before the append
    assert len(archive_fsck(root)["uncataloged"]) == 1
    assert not archive_fsck(root, repair=True)["uncataloged"]
    entries = catalog.ingest_entries(catalog.read_catalog(root))
    assert len(entries) == 1 and entries[0]["run"] == \
        ArchiveStore(root).run_ids()[0]


def test_fsck_verb_dispatches_on_archive_root(tmp_path):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    ingest_run(cfg, root)
    assert durability.sofa_fsck(SofaConfig(logdir=root)) == 0
    stage = os.path.join(root, "objects", "zz")
    os.makedirs(stage, exist_ok=True)
    with open(os.path.join(stage, "dead.tmp"), "w") as f:
        f.write("x")
    assert durability.sofa_fsck(SofaConfig(logdir=root)) == 1
    assert durability.sofa_fsck(SofaConfig(logdir=root), repair=True) == 0


def test_fsck_leaves_the_fleet_tier_unchecked(tmp_path, capsys):
    """A ``_fleet/`` (the JAX package's fleet-pass tier) is reported
    unchecked, never as damage, and ``--repair`` leaves it alone; the
    report keeps the JAX package's keys."""
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    ingest_run(cfg, root)
    fleet = os.path.join(root, durability.UNPORTED_FLEET_TIER[0])
    os.makedirs(fleet)
    with open(os.path.join(fleet, "fleet_report.json"), "w") as f:
        f.write("not json")
    capsys.readouterr()
    report = archive_fsck(root, repair=True)
    assert report["fleet"] == [] and "not checked" in capsys.readouterr().err
    assert os.path.isfile(os.path.join(fleet, "fleet_report.json"))
    want = jax_store.archive_fsck(root)
    assert set(report) == set(want) and want["fleet"]   # JAX: damage


# --- resume replay ----------------------------------------------------------

def test_resume_replays_uncommitted_archive_stage(tmp_path, monkeypatch):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    ingest_run(cfg, root)
    run_id = ArchiveStore(root).run_ids()[0]
    jpath = cfg.path(durability.JOURNAL_NAME)
    with open(jpath) as f:
        lines = [ln for ln in f.read().splitlines()
                 if not ('"commit"' in ln and '"archive"' in ln)]
    with open(jpath, "w") as f:
        f.write("\n".join(lines) + "\n")
    # resume from elsewhere: the root comes from the begin entry
    monkeypatch.chdir(tmp_path)
    assert durability.sofa_resume(cfg) == 0
    entries = catalog.ingest_entries(catalog.read_catalog(root))
    assert len(entries) == 1 and entries[0]["run"] == run_id
    assert not os.path.isdir(tmp_path / "sofa_archive")
    report = archive_fsck(root)
    assert not any(report[v] for v in ("corrupt", "missing", "orphaned",
                                       "uncataloged", "index"))


# --- clean and the digests --------------------------------------------------

def test_clean_never_sweeps_nested_archive_root(tmp_path, capsys):
    cfg = _mini_logdir(tmp_path)
    nested = cfg.path("sofa_hints")   # a DERIVED_DIRS name, the worst case
    ingest_run(cfg, nested)
    assert is_archive_root(nested)
    marker = os.path.join(nested, "sofa_archive.json")
    marker_mtime = os.path.getmtime(marker)
    leftover = os.path.join(nested, "objects", "zz", "dead.tmp")
    os.makedirs(os.path.dirname(leftover))
    with open(leftover, "w") as f:
        f.write("x")
    with open(cfg.path("stray.tmp"), "w") as f:
        f.write("x")
    sofa_clean(cfg)
    assert is_archive_root(nested) and os.path.getmtime(marker) == \
        marker_mtime
    assert os.path.isfile(catalog.catalog_path(nested))
    assert len(ArchiveStore(nested).run_ids()) == 1
    assert os.path.isfile(leftover)     # the archive's fsck owns it
    assert archive_fsck(nested)["orphaned"] == ["objects/zz/dead.tmp"]
    assert not os.path.isfile(cfg.path("report.js"))   # clean still cleaned
    assert not os.path.isfile(cfg.path("stray.tmp"))
    assert "trace archive" in capsys.readouterr().err


def test_digests_skip_nested_archive(tmp_path):
    cfg = _mini_logdir(tmp_path)
    ingest_run(cfg, cfg.path("my_archive"))
    doc = durability.compute_digests(cfg.logdir)
    assert not any(rel.startswith("my_archive/") for rel in doc["files"])


# --- rolling baseline math --------------------------------------------------

def test_median_ci_floor_and_coverage():
    assert bl.median_ci([1.0] * 5) is None          # below the floor
    lo, hi = bl.median_ci([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    assert lo <= 4.0 <= hi and lo >= 1.0 and hi <= 7.0


def test_percentile_interpolation():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert bl.percentile(xs, 0) == 1.0 and bl.percentile(xs, 100) == 4.0
    assert bl.percentile(xs, 50) == pytest.approx(2.5)


@pytest.mark.parametrize("name", [
    "elapsed_time", "step_time_mean", "resnet50_profiling_overhead",
    "comm_h2d_bandwidth", "gpu_kernels", "tier_recovery_wall_time_s",
    "tier_refusal_rate_pct", "fleet_saturation_rps", "gpu0_sol_distance",
    "gpu0_busy_pct", "hbm_gbps_max", "whatif_overlap_payoff_pct"])
def test_polarity_classes(name):
    want = {"elapsed_time": 1, "step_time_mean": 1,
            "resnet50_profiling_overhead": 1, "comm_h2d_bandwidth": -1,
            "gpu_kernels": 0, "tier_recovery_wall_time_s": 1,
            "tier_refusal_rate_pct": 1, "fleet_saturation_rps": -1,
            "gpu0_sol_distance": 1}
    assert bl.polarity(name) == jax_bl.polarity(name)
    if name in want:
        assert bl.polarity(name) == want[name]


def test_rolling_verdict_discipline():
    samples = [1.0, 1.01, 0.99, 1.02, 0.98, 1.0, 1.01]
    v = bl.rolling_verdict(2.0, samples, 50.0, 10.0, 1)
    assert v["verdict"] == "regressed" and "CI" in v["reason"]
    assert bl.rolling_verdict(0.5, samples, 50.0, 10.0, 1)["verdict"] == \
        "improved"
    assert bl.rolling_verdict(1.05, samples, 50.0, 10.0, 1)["verdict"] == \
        "noise"
    v = bl.rolling_verdict(9.9, samples[:4], 50.0, 10.0, 1)
    assert v["verdict"] == "noise" and "4" in v["reason"]
    v = bl.rolling_verdict(9.9, samples, 50.0, 10.0, 0)
    assert v["verdict"] == "noise" and "polarity" in v["reason"]


def test_pairwise_ratio_inf_convention():
    v = bl.pairwise_verdict(3.0, 0.0, 10.0, 1)
    assert v["ratio"] == float("inf") and v["verdict"] == "regressed"
    v = bl.pairwise_verdict(0.0, 0.0, 10.0, 1)
    assert v["ratio"] == 1.0 and v["verdict"] == "noise"
    assert bl.pairwise_verdict(3.0, 0.0, 10.0, -1)["verdict"] == "improved"


_samples = st.lists(st.floats(0.001, 1e6, allow_nan=False), min_size=1,
                    max_size=40)


@settings(max_examples=80, deadline=None)
@given(_samples, st.floats(0.0, 100.0), st.floats(0.0, 2e6),
       st.floats(0.0, 50.0), st.sampled_from([-1, 0, 1]))
def test_baseline_math_matches_jax(xs, pct, value, threshold, pol):
    assert bl.percentile(xs, pct) == pytest.approx(
        jax_bl.percentile(xs, pct), rel=MATH_TOL, abs=MATH_TOL)
    assert bl.median(xs) == jax_bl.median(xs)
    assert bl.median_ci(xs) == jax_bl.median_ci(xs)
    got = bl.rolling_verdict(value, xs, pct, threshold, pol)
    want = jax_bl.rolling_verdict(value, xs, pct, threshold, pol)
    assert got.pop("baseline") == pytest.approx(want.pop("baseline"),
                                                rel=MATH_TOL, abs=MATH_TOL)
    assert got == want
    assert bl.pairwise_verdict(value, xs[0], threshold, pol) == \
        jax_bl.pairwise_verdict(value, xs[0], threshold, pol)


# --- typed-verdict exit codes (real subprocess) -----------------------------

def test_regress_exit_codes_via_subprocess(tmp_path):
    cfg = _mini_logdir(tmp_path, "base", elapsed=1.5, step_time=0.05)
    slow = _mini_logdir(tmp_path, "slow", elapsed=2.9, step_time=0.09)
    r = _cli("regress", cfg.logdir, cfg.logdir)
    assert r.returncode == 0, r.stderr
    doc = json.load(open(cfg.path("regress_verdict.json")))
    assert doc["verdict"] == "noise" and doc["counts"]["regressed"] == 0
    assert all(row["verdict"] == "noise" for row in doc["features"])
    r = _cli("regress", slow.logdir, cfg.logdir)
    assert r.returncode == 1, r.stdout + r.stderr
    doc = json.load(open(slow.path("regress_verdict.json")))
    assert doc["verdict"] == "regressed"
    assert doc["schema"] == "sofa_tpu/regress_verdict"
    assert "elapsed_time" in {row["name"] for row in doc["features"]
                              if row["verdict"] == "regressed"}
    assert _cli("regress", cfg.logdir).returncode == 2   # no baseline


def test_archive_and_regress_rolling_via_subprocess(tmp_path):
    root = str(tmp_path / "arch")
    for i in range(6):
        c = _mini_logdir(tmp_path, f"r{i}", elapsed=1.5 + i * 0.001)
        assert ingest_run(c, root)["files"] > 0
    slow = _mini_logdir(tmp_path, "slow", elapsed=3.0)
    r = _cli("regress", slow.logdir, "--rolling", "6", "--archive_root",
             root)
    assert r.returncode == 1, r.stdout + r.stderr
    r = _cli("archive", "ls", "--archive_root", root)
    assert r.returncode == 0 and "6 run(s)" in r.stdout


def test_verdict_schema_validates(tmp_path):
    from sofa_tpu_torch.archive.verdict import sofa_regress

    cfg = _mini_logdir(tmp_path, "base")
    assert sofa_regress(cfg, cfg.logdir, cfg.logdir) == 0
    jax_mc = jax_manifest_check()
    doc = json.load(open(cfg.path("regress_verdict.json")))
    assert manifest_check.validate_verdict(doc) == [] == \
        jax_mc.validate_verdict(doc)
    bad = dict(doc, verdict="maybe")
    assert manifest_check.validate_verdict(bad) and \
        jax_mc.validate_verdict(bad)
    assert manifest_check.check_path(cfg.path("regress_verdict.json")) == 0
    regressed = dict(doc, verdict="regressed")
    assert manifest_check.validate_verdict(regressed,
                                           require_passing=True) == \
        ["gate: overall verdict is regressed"]
    manifest = json.load(open(cfg.path("run_manifest.json")))
    assert "regress" in manifest["runs"]
    assert manifest_check.validate_manifest(manifest) == [] == \
        jax_validator()(manifest)


# --- tile diff --------------------------------------------------------------

def test_tile_diff_unchanged_fast_path():
    files_a = {
        "_tiles/s1/0/0.json.gz": {"sha256": "aaa"},
        "_tiles/s1/1/0.json.gz": {"sha256": "bbb"},
        "_tiles/s2/0/0.json.gz": {"sha256": "ccc"},
        "report.js": {"sha256": "zzz"},
    }
    files_b = {
        "_tiles/s1/0/0.json.gz": {"sha256": "aaa"},
        "_tiles/s1/1/0.json.gz": {"sha256": "BBB"},
        "_tiles/s3/0/0.json.gz": {"sha256": "ddd"},
    }
    d = tile_diff({"files": files_a}, {"files": files_b})
    assert d == jax_store.tile_diff({"files": files_a}, {"files": files_b})
    assert d["series"]["s1"] == {"unchanged": 1, "changed": 1,
                                 "only_a": 0, "only_b": 0}
    assert d["series"]["s2"]["only_a"] == 1
    assert d["series"]["s3"]["only_b"] == 1
    assert d["totals"]["unchanged"] == 1


def test_tile_diff_never_reads_payloads(monkeypatch):
    import builtins

    files = {f"_tiles/s/0/{i}.json.gz": {"sha256": f"s{i}"}
             for i in range(32)}

    def boom(*a, **kw):
        raise AssertionError("tile_diff read a payload")

    monkeypatch.setattr(builtins, "open", boom)
    d = tile_diff({"files": files}, {"files": dict(files)})
    assert d["totals"]["unchanged"] == 32 and d["totals"]["changed"] == 0


# --- ml/diff robustness -----------------------------------------------------

def test_swarm_diff_degrades_without_cluster_columns(tmp_path, capsys):
    from sofa_tpu_torch.ml.diff import sofa_swarm_diff

    base, match = tmp_path / "b", tmp_path / "m"
    for d in (base, match):
        d.mkdir()
    pd.DataFrame({"cluster_ID": [0, 0], "name": ["f", "g"],
                  "duration": [1.0, 2.0]}).to_csv(
        base / "auto_caption.csv", index=False)
    pd.DataFrame({"name": ["f"], "duration": [1.0]}).to_csv(
        match / "auto_caption.csv", index=False)
    cfg = SofaConfig(logdir=str(tmp_path / "out"),
                     base_logdir=str(base), match_logdir=str(match))
    assert sofa_swarm_diff(cfg) is None    # warns, never raises
    assert "cluster_ID" in capsys.readouterr().err


def test_regress_clusters_match_jax(tmp_path):
    """``compare_clusters`` over two auto_caption tables: the port's rows
    equal the JAX package's (matched, vanished and new clusters)."""
    from sofa_tpu.archive import verdict as jax_verdict
    from sofa_tpu_torch.archive import verdict

    base = pd.DataFrame({"cluster_ID": [0, 0, 1, 2],
                         "name": ["f", "g", "h", "gone"],
                         "duration": [1.0, 2.0, 4.0, 1.0]})
    run = pd.DataFrame({"cluster_ID": [0, 0, 1, 3],
                        "name": ["f", "g", "h", "brand_new_thing"],
                        "duration": [1.0, 2.5, 4.1, 3.0]})
    got = verdict.compare_clusters(
        verdict._Side("run", {}, run), verdict._Side("base", {}, base), 10.0)
    want = jax_verdict.compare_clusters(
        jax_verdict._Side("run", {}, run),
        jax_verdict._Side("base", {}, base), 10.0)
    assert got == want
    assert {r["verdict"] for r in got} == {"noise", "regressed"}


def test_delta_table_ratio_inf_convention(tmp_path):
    from sofa_tpu_torch.ml.diff import _delta_table

    base = pd.DataFrame({"time": [1.0, 0.0]}, index=["stays", "zeros"])
    match = pd.DataFrame({"time": [2.0, 0.0, 3.0]},
                         index=["stays", "zeros", "appears"])
    out = str(tmp_path / "d.csv")
    table = _delta_table(base, match, "time", out).set_index("index")
    assert table.loc["appears", "ratio"] == float("inf")
    assert table.loc["zeros", "ratio"] == 1.0
    assert table.loc["stays", "ratio"] == 2.0
    assert os.path.isfile(out)


# --- the verb's surface -----------------------------------------------------

def test_archive_show_and_resolve_prefix(tmp_path):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    s = ingest_run(cfg, root)
    store = ArchiveStore(root)
    assert store.resolve_run_id(s["run"][:8]) == s["run"]
    assert store.resolve_run_id("abc") is None      # too short
    r = _cli("archive", "show", s["run"][:12], "--archive_root", root)
    assert r.returncode == 0 and "features" in r.stdout
    assert "elapsed_time" in r.stdout


def test_extract_roundtrip(tmp_path):
    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    s = ingest_run(cfg, root)
    dest = str(tmp_path / "restored")
    assert ArchiveStore(root).extract(s["run"], dest) == s["files"]
    with open(cfg.path("features.csv")) as a, \
            open(os.path.join(dest, "features.csv")) as b:
        assert a.read() == b.read()


def test_resolve_root_precedence(monkeypatch):
    assert resolve_root(SofaConfig(archive_root="/x/y")) == "/x/y"
    monkeypatch.setenv("SOFA_ARCHIVE_ROOT", "/env/root")
    assert resolve_root(SofaConfig()) == "/env/root"
    monkeypatch.delenv("SOFA_ARCHIVE_ROOT")
    assert resolve_root(None) == "sofa_archive"


def test_viz_serves_the_archive_read_only(tmp_path):
    """``viz`` maps ``/archive/`` onto the archive root: the catalog and
    a run doc are served, a ``..`` is refused, and archive-diff.html is
    staged beside the data."""
    import threading
    import urllib.error
    import urllib.request

    from sofa_tpu_torch.viz import sofa_viz

    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    s = ingest_run(cfg, root)
    vcfg = SofaConfig(logdir=cfg.logdir, archive_root=root, viz_port=8790)
    httpd = sofa_viz(vcfg, serve_forever=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        try:
            with urllib.request.urlopen(base + path) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, b""

    try:
        code, body = get("/archive/catalog.jsonl")
        assert code == 200 and body == open(catalog.catalog_path(root),
                                            "rb").read()
        code, body = get(f"/archive/runs/{s['run']}.json")
        assert code == 200 and json.loads(body)["run"] == s["run"]
        assert get("/archive/../log/misc.txt")[0] == 404
        assert get("/archive/%2e%2e/arch/catalog.jsonl")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)


# --- backup and restore -----------------------------------------------------

def _tree_bytes(root):
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for n in sorted(names):
            if not n.endswith(".tmp"):
                p = os.path.join(dirpath, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def test_backup_restore_is_byte_identical(tmp_path):
    from sofa_tpu_torch.archive.store import backup_archive, restore_archive

    root = str(tmp_path / "arch")
    ingest_run(_mini_logdir(tmp_path, "a", elapsed=1.5), root)
    ingest_run(_mini_logdir(tmp_path, "b", elapsed=2.5), root)
    aindex.refresh(root, jobs=0)
    dest = str(tmp_path / "backup")
    stats = backup_archive(root, dest)
    assert stats["snapshot"] == 1 and stats["files"] > 0
    assert stats["new_objects"] > 0
    target = str(tmp_path / "restored")
    verdict = restore_archive(dest, target)
    assert verdict["ok"], verdict
    assert verdict["missing"] == [] and verdict["fsck_problems"] == 0
    assert verdict["commit_sha"] == verdict["commit_sha_expected"]
    assert _tree_bytes(target) == _tree_bytes(root)
    restored = ArchiveStore(target)
    for ent in catalog.ingest_entries(catalog.read_catalog(target)):
        assert restored.load_run(ent["run"]) is not None
    # the JAX package restores the port's backup too
    other = jax_store.restore_archive(dest, str(tmp_path / "jax_restored"))
    assert other["ok"] and other["commit_sha"] == verdict["commit_sha"]


def test_backup_is_incremental(tmp_path):
    from sofa_tpu_torch.archive.store import backup_archive, restore_archive

    root = str(tmp_path / "arch")
    ingest_run(_mini_logdir(tmp_path, "a", elapsed=1.5), root)
    dest = str(tmp_path / "backup")
    backup_archive(root, dest)
    ingest_run(_mini_logdir(tmp_path, "b", elapsed=2.5), root)
    s2 = backup_archive(root, dest)
    assert s2["snapshot"] == 2 and s2["reused_objects"] > 0
    old = restore_archive(dest, str(tmp_path / "r1"), snapshot=1)
    assert old["missing"] == [] and old["fsck_problems"] == 0
    new = restore_archive(dest, str(tmp_path / "r2"))
    assert new["missing"] == [] and new["fsck_problems"] == 0
    assert len(_tree_bytes(str(tmp_path / "r2"))) > \
        len(_tree_bytes(str(tmp_path / "r1")))


def test_backup_restore_guardrails(tmp_path):
    from sofa_tpu_torch.archive.store import backup_archive, restore_archive

    root = str(tmp_path / "arch")
    ingest_run(_mini_logdir(tmp_path), root)
    with pytest.raises(OSError):
        backup_archive(root, os.path.join(root, "nested"))
    dest = str(tmp_path / "backup")
    backup_archive(root, dest)
    dirty = tmp_path / "dirty"
    dirty.mkdir()
    (dirty / "leftover.txt").write_text("x")
    with pytest.raises(OSError):
        restore_archive(dest, str(dirty))
    with pytest.raises(OSError):
        restore_archive(str(tmp_path / "not_a_backup"), str(tmp_path / "t"))


def test_backup_verb_stamps_meta_backup(tmp_path):
    """``archive backup <root> <dest>`` with a logdir in scope stamps
    ``meta.backup``, which both packages' validators accept."""
    from sofa_tpu_torch.archive.store import sofa_archive

    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    ingest_run(cfg, root)
    assert sofa_archive(cfg, "backup", root, str(tmp_path / "bk")) == 0
    doc = telemetry.load_manifest(cfg.logdir)
    assert doc["meta"]["backup"]["snapshot"] == 1
    assert manifest_check.validate_manifest(doc) == [] == \
        jax_validator()(doc)
    bad = dict(doc, meta={**doc["meta"], "backup": {"snapshot": 0}})
    assert manifest_check.validate_manifest(bad)
    assert sofa_archive(cfg, "restore", str(tmp_path / "bk"),
                        str(tmp_path / "back")) == 0


# --- the verbs' manifest sections and status --------------------------------

def test_archive_and_regress_sections_and_status(tmp_path):
    from sofa_tpu_torch.archive.store import sofa_archive
    from sofa_tpu_torch.archive.verdict import sofa_regress

    cfg = _mini_logdir(tmp_path)
    root = str(tmp_path / "arch")
    acfg = SofaConfig(logdir=cfg.logdir, archive_root=root)
    assert sofa_archive(acfg, cfg.logdir) == 0
    assert sofa_regress(acfg, cfg.logdir, cfg.logdir) == 0
    doc = telemetry.load_manifest(cfg.logdir)
    assert doc["meta"]["archive"]["run"] == ArchiveStore(root).run_ids()[0]
    assert doc["meta"]["regress"]["verdict"] == "noise"
    assert manifest_check.validate_manifest(doc) == [] == \
        jax_validator()(doc)
    bad = dict(doc, meta={**doc["meta"], "archive": {"run": "x"}})
    assert len(manifest_check.validate_manifest(bad)) == \
        len(jax_validator()(bad)) == 4
    lines, rc = telemetry.render_status(doc, cfg.logdir)
    assert rc == 0
    assert any(ln.startswith("  archive: run ") for ln in lines)
    assert any(ln.startswith("  regress: noise") for ln in lines)
    trace = telemetry.load_self_trace(cfg.logdir)
    lanes = {e["args"]["name"]: e["tid"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert lanes["sofa archive"] == 5 and lanes["sofa regress"] == 6
    spans = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"archive_scan", "archive_objects", "archive_commit",
            "archive_index", "regress_verdict"} <= spans


# --- the packages against each other ----------------------------------------

def _freeze(monkeypatch, t=1700000000.5):
    monkeypatch.setattr(time, "time", lambda: t)


def _jax_cfg(logdir):
    return JaxConfig(logdir=logdir)


def _catalog_lines(root):
    with open(catalog.catalog_path(root), "rb") as f:
        return f.read().splitlines()


def test_one_logdir_is_one_run_in_both_packages(tmp_path, monkeypatch):
    """A csv logdir (no chunk store), its digests written by the port,
    ingested by each package into a root of its own: one run id, one
    ``files`` map, catalog lines equal (the clock frozen: ``t`` too), and
    ``index_commit.json`` byte-identical."""
    cfg = _mini_logdir(tmp_path, fmt="csv")
    _freeze(monkeypatch)
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    got = ingest_run(cfg, port_root)
    want = jax_store.ingest_run(_jax_cfg(cfg.logdir), jax_root)
    assert got["run"] == want["run"]
    assert {k: got[k] for k in ("files", "new_objects", "bytes_added")} == \
        {k: want[k] for k in ("files", "new_objects", "bytes_added")}
    port_doc = ArchiveStore(port_root).load_run(got["run"])
    jax_doc = jax_store.ArchiveStore(jax_root).load_run(want["run"])
    assert port_doc["files"] == jax_doc["files"]
    assert port_doc == jax_doc
    assert _catalog_lines(port_root) == _catalog_lines(jax_root)
    with open(aindex.commit_path(port_root), "rb") as a, \
            open(jax_index.commit_path(jax_root), "rb") as b:
        assert a.read() == b.read()
    # and the roots' files, object for object
    assert _tree_bytes(os.path.join(port_root, "objects")) == \
        _tree_bytes(os.path.join(jax_root, "objects"))


def test_columnar_logdir_differs_only_by_its_chunk_stores(tmp_path):
    """The port also archives ``_frames/`` (a deliberate difference): the
    two runs' maps agree on every other file."""
    cfg = _mini_logdir(tmp_path)
    got = ingest_run(cfg, str(tmp_path / "port"))
    want = jax_store.ingest_run(_jax_cfg(cfg.logdir), str(tmp_path / "jax"))
    port_files = ArchiveStore(str(tmp_path / "port")).load_run(
        got["run"])["files"]
    jax_files = jax_store.ArchiveStore(str(tmp_path / "jax")).load_run(
        want["run"])["files"]
    frames_only = {r: e for r, e in port_files.items()
                   if r.startswith("_frames/")}
    assert frames_only and all(e["kind"] == "frame"
                               for e in frames_only.values())
    assert {r: e for r, e in port_files.items() if r not in frames_only} \
        == jax_files
    assert got["run"] != want["run"]


def test_regress_verdict_equal_across_packages(tmp_path):
    from sofa_tpu.archive import verdict as jax_verdict
    from sofa_tpu_torch.archive import verdict

    base = _mini_logdir(tmp_path, "base", elapsed=1.5, step_time=0.05)
    slow = _mini_logdir(tmp_path, "slow", elapsed=2.9, step_time=0.09)
    docs = []
    for mod, cfg in ((verdict, SofaConfig(logdir=slow.logdir)),
                     (jax_verdict, JaxConfig(logdir=slow.logdir))):
        assert mod.sofa_regress(cfg, slow.logdir, base.logdir) == 1
        with open(slow.path("regress_verdict.json")) as f:
            doc = json.load(f)
        doc.pop("generated_unix")
        docs.append(doc)
    assert docs[0] == docs[1] and docs[0]["verdict"] == "regressed"


def test_each_package_reads_the_others_root(tmp_path):
    """``ls``, ``show``, ``regress`` (by archived run id and rolling) and
    ``fsck`` of each package over a root the other wrote."""
    logs = [_mini_logdir(tmp_path, f"r{i}", elapsed=1.5 + i * 0.5)
            for i in range(2)]
    roots = {"sofa_tpu_torch": str(tmp_path / "port"),
             "sofa_tpu": str(tmp_path / "jax")}
    for c in logs:
        ingest_run(c, roots["sofa_tpu_torch"])
        jax_store.ingest_run(_jax_cfg(c.logdir), roots["sofa_tpu"])
    for writer, reader in (("sofa_tpu_torch", "sofa_tpu"),
                           ("sofa_tpu", "sofa_tpu_torch")):
        root = roots[writer]
        runs = ArchiveStore(root).run_ids()
        r = _cli("archive", "ls", "--archive_root", root, package=reader)
        assert r.returncode == 0 and "2 run(s)" in r.stdout, r.stderr
        r = _cli("archive", "show", runs[0][:12], "--archive_root", root,
                 package=reader)
        assert r.returncode == 0 and "elapsed_time" in r.stdout, r.stderr
        r = _cli("regress", runs[0][:12], runs[0][:12], "--archive_root",
                 root, package=reader)
        assert r.returncode == 0, r.stdout + r.stderr
        r = _cli("regress", logs[0].logdir, "--rolling", "3",
                 "--archive_root", root, package=reader)
        assert r.returncode == 0, r.stdout + r.stderr
        r = _cli("fsck", root, package=reader)
        assert r.returncode == 0, r.stdout + r.stderr
    # in process: the two fsck reports agree on each root
    for root in roots.values():
        got, want = archive_fsck(root), jax_store.archive_fsck(root)
        assert got == want
