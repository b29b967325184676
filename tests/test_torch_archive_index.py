"""The port's columnar catalog index (``sofa_tpu_torch/archive/index.py``)
held against the JAX package's ``sofa_tpu/archive/index.py``, and the
frame store's string-rot repair that its ``verify`` stands on.

The JAX package's recipes (``tests/test_archive_index.py``, all but its
fleet-service tests) run on the port: the tail-aware refresh (the
suffix-only parse proven by a parser that raises on a committed line, the
warm no-op touching no file, the torn-tail back-off, gc and rewrite
invalidation, the write guard), ``ls`` and the rolling verdict
byte-identical from the index and from the scan, offenders and query
pagination, a refresh killed mid-way converging, the archive fsck
repairing a rotted index chunk (the JAX package's own test of it fails:
its ``verify_chunk_store`` raises), a commitless index, the port's
``validate_index_commit``, drop and rebuild, and the ingest's commit
point.  Then both packages build the index over one catalog: the commit,
every family's index and every chunk are byte-identical, and each
package's readers answer alike over the other's index.  Bytes are
compared exactly.
"""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest

from sofa_tpu.archive import index as jax_index
from sofa_tpu.archive import store as jax_store
from sofa_tpu_torch import durability, frames
from sofa_tpu_torch.archive import baseline, catalog
from sofa_tpu_torch.archive import index as aindex
from sofa_tpu_torch.archive.store import (ArchiveStore, _ls_runs,
                                          archive_fsck, gc, render_ls,
                                          sofa_archive)
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.tools import manifest_check
from sofa_tpu_torch.trace import (atomic_write, derived_write_guard,
                                  derived_writing)
from test_torch_archive import jax_manifest_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mkarchive(tmp_path, n=12, hosts=3, name="arch"):
    """A synthetic archive: run docs and fsync'd catalog lines of the
    shapes an ingest writes, with the port's per-card sol distances."""
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
    catalog.append_event(root, "bench", metric="m", value=1.0,
                         round="r01")
    return root, store


def _append_run(root, store, i, t=None, features=None):
    run = f"{i:064x}"
    doc = {"run": run, "t": t or (1000.0 + i), "hostname": f"h{i % 3}",
           "logdir": f"/fleet/h{i % 3}/job{i}", "files": {},
           "features": features if features is not None
           else {"elapsed_time": 10.0 + i,
                 "gpu0_sol_distance": 2.0 + i * 0.25}}
    with atomic_write(store.run_doc_path(run)) as f:
        json.dump(doc, f, sort_keys=True)
    catalog.append_event(root, "ingest", run=run, logdir=doc["logdir"],
                         files=0, new_objects=0, bytes_added=0)
    return run


def _index_mtimes(root):
    out = {}
    for dirpath, _dirs, names in os.walk(aindex.index_dir(root)):
        for n in names:
            p = os.path.join(dirpath, n)
            out[p] = os.stat(p).st_mtime_ns
    return out


def _index_bytes(root):
    out = {}
    for dirpath, _dirs, names in os.walk(aindex.index_dir(root)):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# --- the refresh contract ---------------------------------------------------

def test_refresh_builds_and_is_current(tmp_path):
    root, _store = _mkarchive(tmp_path)
    c = aindex.refresh(root)
    assert c["_stats"]["full"] and c["runs"] == 12
    assert c["events"] == 13 and c["bench_events"] == 1
    assert aindex.is_current(root) and aindex.verify(root) == []


def test_warm_refresh_parses_zero_bytes_and_touches_nothing(tmp_path):
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    before = _index_mtimes(root)
    c = aindex.refresh(root)
    assert c["_stats"] == {"full": False, "parsed_bytes": 0,
                           "new_events": 0, "chunks_wrote": 0}
    assert _index_mtimes(root) == before


def test_append_refresh_parses_only_the_suffix(tmp_path, monkeypatch):
    root, store = _mkarchive(tmp_path)
    aindex.refresh(root)
    committed_lines = set(open(catalog.catalog_path(root),
                               "rb").read().splitlines())
    real = aindex._parse_events

    def paranoid(buf):
        for line in buf.splitlines():
            assert line not in committed_lines, (
                "refresh re-parsed a committed catalog line")
        return real(buf)

    monkeypatch.setattr(aindex, "_parse_events", paranoid)
    _append_run(root, store, 100)
    c = aindex.refresh(root)
    assert not c["_stats"]["full"] and c["_stats"]["new_events"] == 1
    assert c["runs"] == 13 and c["_stats"]["chunks_wrote"] <= 3


def test_torn_tail_backs_off_to_last_whole_record(tmp_path):
    root, store = _mkarchive(tmp_path, n=4)
    aindex.refresh(root)
    run = _append_run(root, store, 50)
    with open(catalog.catalog_path(root), "a") as f:
        f.write('{"ev":"ingest","run":"torn-mid-wri')
    c = aindex.refresh(root)
    assert c["_stats"]["new_events"] == 1
    assert c["catalog_offset"] < os.path.getsize(catalog.catalog_path(root))
    assert aindex.is_current(root)
    assert any(e["run"] == run for e in aindex.run_entries(root))
    with open(catalog.catalog_path(root), "a") as f:
        f.write('tten"}\n')
    assert not aindex.is_current(root)
    c2 = aindex.refresh(root)
    assert c2["_stats"]["new_events"] == 1
    assert c2["catalog_offset"] == os.path.getsize(
        catalog.catalog_path(root))


def test_gc_compaction_invalidates_and_rebuilds(tmp_path):
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    gen0 = catalog.generation(root)
    gc(root, keep=5)
    assert catalog.generation(root) == gen0 + 1
    assert aindex.is_current(root)
    runs = aindex.run_entries(root)
    scan = catalog.ingest_entries(catalog.read_catalog(root))
    assert [e["run"] for e in runs] == [e["run"] for e in scan]
    assert len(runs) == 5


def test_manual_rewrite_is_detected_not_served_stale(tmp_path):
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    catalog.rewrite(root, catalog.read_catalog(root)[:6])
    assert not aindex.is_current(root)
    assert aindex.run_entries(root) is None
    assert aindex.refresh(root)["_stats"]["full"]


def test_rewrite_holds_write_guard_and_bumps_generation(tmp_path,
                                                        monkeypatch):
    from sofa_tpu_torch import trace

    root, _store = _mkarchive(tmp_path, n=3)
    gen0 = catalog.generation(root)
    seen = []
    real = trace.atomic_write

    def spying(path, *a, **kw):
        seen.append((os.path.basename(path), derived_writing(root)))
        return real(path, *a, **kw)

    monkeypatch.setattr(trace, "atomic_write", spying)
    catalog.rewrite(root, catalog.read_catalog(root)[:2])
    assert ("catalog.jsonl", True) in seen
    assert catalog.generation(root) == gen0 + 1
    assert not derived_writing(root)


def test_write_guard_is_reentrant(tmp_path):
    root = str(tmp_path)
    with derived_write_guard(root):
        with derived_write_guard(root):
            assert derived_writing(root)
        assert derived_writing(root)
    assert not derived_writing(root)


# --- scan against index -----------------------------------------------------

def _ls_output(root, **cfg_kw):
    cfg = SofaConfig(logdir=str(root) + "-unused", archive_root=root,
                     **cfg_kw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert sofa_archive(cfg, "ls") == 0
    return buf.getvalue()


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"archive_limit": 4},
    {"archive_label": "nightly"},
    {"archive_host": "h1"},
    {"archive_host": "h2", "archive_limit": 2},
    {"archive_since": "1005"},
])
def test_ls_byte_identical_index_vs_scan(tmp_path, monkeypatch, cfg_kw):
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    out_idx = _ls_output(root, **cfg_kw)
    monkeypatch.setenv("SOFA_ARCHIVE_INDEX", "0")
    assert out_idx == _ls_output(root, **cfg_kw)
    assert out_idx.count("\n") >= 2


def test_ls_limit_uses_tail_chunks_only(tmp_path, monkeypatch):
    root, store = _mkarchive(tmp_path, n=5)
    monkeypatch.setattr(aindex, "INDEX_CHUNK_ROWS", 4)
    for i in range(20, 60):
        _append_run(root, store, i)
    aindex.refresh(root)
    handle = frames.open_chunk_store(aindex.family_dir(root,
                                                       aindex.RUNS_FAMILY))
    assert len(handle.index["chunks"]) > 5
    runs, total, _bench, source = _ls_runs(
        root, SofaConfig(logdir="u", archive_root=root, archive_limit=3))
    assert source == "index" and len(runs) == 3 and total == 45
    reads = []
    real = frames.FrameHandle.read_chunk_table

    def counting(self, i, columns=None):
        reads.append(i)
        return real(self, i, columns)

    monkeypatch.setattr(frames.FrameHandle, "read_chunk_table", counting)
    entries, total, _bench = aindex.run_entries_tail(root, 3)
    assert [e["run"] for e in entries] == [e["run"] for e in runs]
    # 45 rows in chunks of 4: the newest 3 are in the last two chunks only
    n = len(handle.index["chunks"])
    assert reads == [n - 1, n - 2]


def test_regress_rolling_verdict_byte_identical(tmp_path, monkeypatch):
    from sofa_tpu_torch.archive.verdict import sofa_regress

    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    logdir = str(tmp_path / "run") + "/"
    os.makedirs(logdir)
    with open(logdir + "features.csv", "w") as f:
        f.write("name,value\nelapsed_time,25.0\n"
                "gpu0_sol_distance,9.5\nstep_time_mean,0.05\n")
    monkeypatch.setattr(time, "time", lambda: 1234567.0)

    def verdict_bytes():
        cfg = SofaConfig(logdir=logdir, archive_root=root,
                         regress_rolling=8)
        rc = sofa_regress(cfg, logdir)
        with open(os.path.join(logdir, "regress_verdict.json"), "rb") as f:
            return rc, f.read()

    rc_idx, doc_idx = verdict_bytes()
    monkeypatch.setenv("SOFA_ARCHIVE_INDEX", "0")
    assert (rc_idx, doc_idx) == verdict_bytes()
    sol = next(r for r in json.loads(doc_idx)["features"]
               if r["name"] == "gpu0_sol_distance")
    assert sol["verdict"] == "regressed" and rc_idx == 1


def test_rolling_samples_equal_and_docless(tmp_path, monkeypatch):
    root, store = _mkarchive(tmp_path)
    _append_run(root, store, 70, features={})
    os.unlink(store.run_doc_path(_append_run(root, store, 71)))
    aindex.refresh(root)
    idx = aindex.rolling_samples(root, 6)
    monkeypatch.setenv("SOFA_ARCHIVE_INDEX", "0")
    assert idx == baseline.rolling_samples(store, 6)
    assert len(idx["elapsed_time"]) == 6


def test_offenders_equal_index_vs_scan(tmp_path):
    root, store = _mkarchive(tmp_path)
    aindex.refresh(root)
    idx = aindex.offenders(root, limit=7)        # gpu*_sol_distance
    assert idx == aindex.offenders_scan(store, limit=7)
    assert idx[0]["value"] >= idx[-1]["value"]
    assert idx[0]["host"] and idx[0]["logdir"]
    assert {r["name"] for r in idx} <= {"gpu0_sol_distance",
                                        "gpu1_sol_distance"}


def test_reingest_duplicates_dedup_newest_wins(tmp_path):
    root, store = _mkarchive(tmp_path, n=4)
    run = f"{2:064x}"
    catalog.append_event(root, "ingest", run=run, logdir="/fleet/h2/job2",
                         files=0, new_objects=0, bytes_added=0)
    aindex.refresh(root)
    runs = aindex.run_entries(root)
    scan = catalog.ingest_entries(catalog.read_catalog(root))
    assert [e["run"] for e in runs] == [e["run"] for e in scan]
    assert len([e for e in runs if e["run"] == run]) == 1
    assert aindex.offenders(root, "*", 10) == \
        aindex.offenders_scan(store, "*", 10)


# --- query and its fallbacks ------------------------------------------------

def test_query_runs_pagination_and_filters(tmp_path):
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    q = aindex.query(root, kind="runs", limit=5)
    assert q["source"] == "index" and q["total"] == 12
    assert len(q["rows"]) == 5 and q["rows"][0]["t"] >= q["rows"][1]["t"]
    q2 = aindex.query(root, kind="runs", limit=5, offset=5)
    assert [r["run"] for r in q2["rows"]] != [r["run"] for r in q["rows"]]
    qh = aindex.query(root, kind="runs", host="h1")
    assert qh["total"] == 4 and all(r["host"] == "h1" for r in qh["rows"])
    assert q["commit_sha"]


def test_query_features_page_matches_unpaged(tmp_path):
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    full = aindex.query(root, kind="features",
                        feature="gpu*_sol_distance", limit=24)
    page = aindex.query(root, kind="features",
                        feature="gpu*_sol_distance", limit=5, offset=3)
    assert page["rows"] == full["rows"][3:8]
    assert page["total"] == full["total"] == 24


def test_query_scan_fallback_without_index(tmp_path):
    root, _store = _mkarchive(tmp_path, n=3)
    q = aindex.query(root, kind="runs")
    assert q["source"] == "scan" and q["total"] == 3
    assert q["commit_sha"] is None
    qf = aindex.query(root, kind="features", feature="gpu0_*")
    assert qf["source"] == "scan" and qf["total"] == 3


def test_query_empty_archive(tmp_path):
    root = str(tmp_path / "empty")
    ArchiveStore(root, create=True)
    q = aindex.query(root, kind="runs")
    assert q["total"] == 0 and q["rows"] == []
    c = aindex.refresh(root)
    assert c["events"] == 0 and aindex.is_current(root)
    assert aindex.query(root, kind="features")["rows"] == []


# --- crash, integrity, repair -----------------------------------------------

def test_kill_mid_refresh_leaves_old_commit_then_converges(tmp_path):
    root, store = _mkarchive(tmp_path, n=5)
    aindex.refresh(root)
    commit0 = open(aindex.commit_path(root), "rb").read()
    _append_run(root, store, 90)
    env = dict(os.environ, SOFA_INDEX_EXIT_AFTER="2")
    env.pop("_SOFA_INDEX_WRITES", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[2]);"
         "from sofa_tpu_torch.archive import index;"
         "index.refresh(sys.argv[1])", root, REPO],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 87, r.stderr[-300:]
    assert open(aindex.commit_path(root), "rb").read() == commit0
    assert not aindex.is_current(root)
    assert aindex.run_entries(root) is None
    aindex.refresh(root)
    assert aindex.is_current(root)
    recovered = open(aindex.commit_path(root), "rb").read()
    aindex.drop(root)
    aindex.refresh(root)
    assert open(aindex.commit_path(root), "rb").read() == recovered


def _rot(path, marker=None):
    """6 bytes into the middle of a chunk (or into the string data after
    ``marker``): invalid UTF-8 where it lands in a string buffer."""
    data = open(path, "rb").read()
    at = len(data) // 2 if marker is None else \
        data.index(marker, len(data) // 3) + 4
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(b"\xde\xad\xbe\xef\xde\xad")


def test_fsck_detects_and_repairs_rotted_index_chunk(tmp_path):
    """The JAX package's test of the same name, which fails there (its
    ``verify_chunk_store`` hashes outside its ``try`` and raises)."""
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    chunk = sorted(glob.glob(os.path.join(root, "_index", "features",
                                          "*.arrow")))[0]
    _rot(chunk)
    report = archive_fsck(root)
    assert report["index"] == ["_index/features/000000.arrow"]
    report = archive_fsck(root, repair=True)
    assert report["index"] == []
    assert aindex.is_current(root) and aindex.verify(root) == []
    # the same rot raises out of the JAX package's verify
    _rot(chunk)
    with pytest.raises(Exception):
        jax_index.verify(root)


def test_fsck_names_a_string_rotted_frame_chunk(tmp_path):
    """A 2000-row gputrace chunk store with 6 bytes written into a kernel
    name: the logdir's ``fsck`` exits 1 naming the chunk, ``--repair``
    exits 0, and ``fsck`` then 0."""
    from test_torch_board import write_sink_logdir

    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.trace import _conform

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    cfg = SofaConfig(logdir=d, viz_downsample_to=8)
    sofa_analyze(cfg, sofa_preprocess(cfg))
    n = 2000
    frames.write_frame_chunks(_conform(pd.DataFrame({
        "timestamp": np.arange(n) * 1e-3, "duration": 1e-4,
        "name": [f"sofa_flash_fwd_kernel_{i % 7}" for i in range(n)]})),
        d, "gputrace")
    chunk = "_frames/gputrace/000000.arrow"
    _rot(d + chunk, marker=b"sofa_flash_fwd_kernel_3")
    report = durability.fsck_scan(d)
    assert report["corrupt"] == [chunk]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert durability.sofa_fsck(cfg) == 1
    assert f"corrupt   {chunk}" in buf.getvalue()
    assert durability.sofa_fsck(cfg, repair=True) == 0
    assert durability.sofa_fsck(cfg) == 0


def test_fsck_flags_commitless_index_dir(tmp_path):
    root, _store = _mkarchive(tmp_path, n=2)
    aindex.refresh(root)
    os.unlink(aindex.commit_path(root))
    assert aindex.verify(root) == ["_index/index_commit.json"]
    report = archive_fsck(root, repair=True)
    assert report["index"] == [] and aindex.is_current(root)


def test_manifest_check_validates_index_commit(tmp_path):
    root, _store = _mkarchive(tmp_path, n=3)
    aindex.refresh(root)
    jax_mc = jax_manifest_check()
    doc = json.load(open(aindex.commit_path(root)))
    assert manifest_check.validate_index_commit(doc) == [] == \
        jax_mc.validate_index_commit(doc)
    assert manifest_check.check_path(root) == 0 == jax_mc.check_path(root)
    bad = dict(doc, version=99, commit_sha="")
    probs = manifest_check.validate_index_commit(bad)
    assert any("version" in p for p in probs)
    assert any("commit_sha" in p for p in probs)
    assert len(probs) == len(jax_mc.validate_index_commit(bad))
    fpath = os.path.join(aindex.family_dir(root, "runs"), "frame_index.json")
    fdoc = json.load(open(fpath))
    fdoc["rows"] = 999
    with open(fpath, "w") as f:
        json.dump(fdoc, f)
    assert manifest_check.check_path(root) == 1 == jax_mc.check_path(root)


def test_index_is_pure_derived_state_drop_rebuild(tmp_path, monkeypatch):
    root, _store = _mkarchive(tmp_path)
    aindex.refresh(root)
    before = open(aindex.commit_path(root), "rb").read()
    aindex.drop(root)
    assert not os.path.isdir(aindex.index_dir(root))
    assert aindex.run_entries(root) is None
    aindex.refresh(root)
    assert open(aindex.commit_path(root), "rb").read() == before
    monkeypatch.setenv("SOFA_ARCHIVE_INDEX", "0")
    assert aindex.run_entries(root) is None
    assert aindex.query(root, kind="runs")["source"] == "scan"


def test_ingest_commit_point_refreshes_index(tmp_path):
    from sofa_tpu_torch.archive.store import ingest_run

    logdir = str(tmp_path / "log") + "/"
    os.makedirs(logdir)
    with open(logdir + "sofa_time.txt", "w") as f:
        f.write("1000.0\n")
    with open(logdir + "features.csv", "w") as f:
        f.write("name,value\nelapsed_time,1.5\n")
    durability.write_digests(logdir)
    root = str(tmp_path / "arch")
    summary = ingest_run(SofaConfig(logdir=logdir), root)
    assert aindex.is_current(root)
    assert [e["run"] for e in aindex.run_entries(root)] == [summary["run"]]


def test_render_ls_backcompat_scan_signature(tmp_path):
    root, _store = _mkarchive(tmp_path, n=2)
    lines = render_ls(root)
    assert "2 run(s)" in lines[0] and len(lines) == 4


# --- the packages against each other ----------------------------------------

def test_both_packages_build_one_index(tmp_path):
    """One catalog, two builds: the commit, every family's index and
    every chunk are byte-identical; so are an append's suffix refresh and
    a gc's rebuild."""
    root, store = _mkarchive(tmp_path)
    aindex.refresh(root)
    port = _index_bytes(root)
    aindex.drop(root)
    jax_index.refresh(root)
    assert _index_bytes(root) == port
    _append_run(root, store, 40)
    aindex.refresh(root)
    port = _index_bytes(root)
    aindex.drop(root)
    jax_index.refresh(root)
    jax_index.refresh(root)
    assert _index_bytes(root) == port


def test_each_package_reads_the_others_index(tmp_path, monkeypatch):
    root, store = _mkarchive(tmp_path)
    for build, other in ((aindex, jax_index), (jax_index, aindex)):
        aindex.drop(root)
        build.refresh(root)
        assert other.is_current(root) and other.verify(root) == []
        assert aindex.run_entries(root) == jax_index.run_entries(root)
        assert aindex.rolling_samples(root, 5) == \
            jax_index.rolling_samples(root, 5)
        assert aindex.offenders(root, "gpu*_sol_distance", 9) == \
            jax_index.offenders(root, "gpu*_sol_distance", 9)
        for kind in ("runs", "features"):
            assert aindex.query(root, kind=kind, limit=7, offset=2) == \
                jax_index.query(root, kind=kind, limit=7, offset=2)
    # the JAX package's ranking default is its own per-chip name
    assert jax_index.offenders(root) == []
    assert len(aindex.offenders(root)) == 20
    assert aindex.offenders_scan(store) == jax_index.offenders_scan(
        jax_store.ArchiveStore(root), "gpu*_sol_distance")
