"""The port's tile pyramid (sofa_tpu_torch/tiles.py) against the JAX
package's, and the invariants the board relies on (as
``tests/test_tiles.py`` holds them for the JAX package):

  * the same series through both ``build_tiles`` give the same manifest
    and the same tiles, byte for byte;
  * each tile's min/max envelope holds every raw point of its window;
  * a decimated tile keeps every bucket's extrema;
  * level N+1 refines level N, and the leaves are exact;
  * 1 and 4 threads build the same bytes; a warm rebuild writes nothing;
  * a series the overview already holds gets no pyramid;
  * series directory names are sanitized; the write sentinel.

Inputs are made with numpy from a seed.
"""

import os

import numpy as np
import pytest

from sofa_tpu import tiles as jax_tiles
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.trace import SofaSeries as JaxSeries
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu_torch import tiles
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.trace import (SofaSeries, derived_write_guard,
                                  derived_writing, make_frame,
                                  reap_stale_sentinel)

N_POINTS = 30000


def _cols(n=N_POINTS, seed=0):
    rng = np.random.default_rng(seed)
    return {"timestamp": np.sort(rng.uniform(0.0, 10.0, n)),
            "event": rng.normal(5.0, 2.0, n),
            "duration": rng.exponential(1e-4, n),
            "name": [f"kernel_{i % 50}" for i in range(n)]}


def _series(n=N_POINTS, seed=0, name="gputrace"):
    return SofaSeries(name, "GPU kernels", "darkorchid",
                      make_frame(_cols(n, seed)))


def _tree(root):
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiles")) + "/"
    cfg = SofaConfig(logdir=d)
    s = _series()
    return cfg, s, tiles.build_tiles(cfg, [s])


@pytest.mark.parametrize("n,seed", [(N_POINTS, 0), (12001, 5), (70000, 9)])
def test_tiles_match_jax(tmp_path, n, seed):
    """Same series (and a second, host one) through both packages: the
    same manifest and the same tile files, byte for byte."""
    cols = [(_cols(n, seed), "gputrace"), (_cols(15000, seed + 1),
                                           "cputrace")]
    port_cfg = SofaConfig(logdir=str(tmp_path / "port") + "/")
    jax_cfg = JaxConfig(logdir=str(tmp_path / "jax") + "/")
    got = tiles.build_tiles(port_cfg, [
        SofaSeries(name, "t", "c", make_frame(c)) for c, name in cols],
        jobs=2)
    want = jax_tiles.build_tiles(jax_cfg, [
        JaxSeries(name, "t", "c", jax_make_frame(c)) for c, name in cols],
        jobs=2)
    assert got == want
    port_tree = _tree(port_cfg.path(tiles.TILES_DIR_NAME))
    jax_tree = _tree(jax_cfg.path(jax_tiles.TILES_DIR_NAME))
    assert set(port_tree) == set(jax_tree)
    differ = [k for k in port_tree if port_tree[k] != jax_tree[k]]
    assert not differ
    ent = got["series"]["gputrace"]
    for level in range(ent["levels"]):
        for i in range(1 << level):
            assert tiles.read_tile(port_cfg.logdir, ent["path"], level, i) \
                == jax_tiles.read_tile(jax_cfg.logdir, ent["path"], level, i)


def _all_tiles(cfg, ent):
    for level in range(ent["levels"]):
        for i in range(1 << level):
            t = tiles.read_tile(cfg.logdir, ent["path"], level, i)
            if t is not None:
                yield level, i, t


def _sorted_raw(s):
    df = s.data
    order = np.argsort(df["timestamp"].to_numpy(), kind="stable")
    return (df["timestamp"].to_numpy()[order],
            df["event"].to_numpy()[order],
            df["name"].astype(str).to_numpy()[order])


def test_envelope_contains_every_raw_point(built):
    cfg, s, manifest = built
    ent = manifest["series"]["gputrace"]
    xs, ys, _ = _sorted_raw(s)
    n_checked = 0
    for _level, _i, t in _all_tiles(cfg, ent):
        a, _b = np.searchsorted(xs, [t["x0"], t["x1"]], side="left")
        seg = ys[a:a + t["count"]]
        assert len(seg) == t["count"]
        # tile values are rounded at 1e-6 before the envelope is taken
        assert t["ymin"] <= seg.min() + 1e-5
        assert t["ymax"] >= seg.max() - 1e-5
        n_checked += 1
    assert n_checked == ent["tile_count"]


def test_decimated_tile_keeps_per_bucket_extrema(built):
    cfg, s, manifest = built
    ent = manifest["series"]["gputrace"]
    t = tiles.read_tile(cfg.logdir, ent["path"], 0, 0)
    assert not t["exact"] and t["buckets"] > 0
    xs, ys, _ = _sorted_raw(s)
    pts = tiles.tile_points(t)
    width = t["x1"] - t["x0"]
    raw_b = np.clip(((xs - t["x0"]) / width * t["buckets"]).astype(int),
                    0, t["buckets"] - 1)
    kept_b = np.clip(((pts["x"] - t["x0"]) / width * t["buckets"])
                     .astype(int), 0, t["buckets"] - 1)
    assert sum(t["density"]) == t["count"] == len(xs)
    for b in range(t["buckets"]):
        raw = ys[raw_b == b]
        if raw.size == 0:
            assert t["density"][b] == 0
            continue
        kept = pts["y"][kept_b == b]
        assert t["density"][b] == raw.size
        assert kept.size, f"bucket {b} lost all its points"
        assert kept.min() == pytest.approx(raw.min(), abs=1e-5)
        assert kept.max() == pytest.approx(raw.max(), abs=1e-5)


def test_levels_refine(built):
    cfg, _s, manifest = built
    ent = manifest["series"]["gputrace"]
    for level in range(ent["levels"] - 1):
        for i in range(1 << level):
            t = tiles.read_tile(cfg.logdir, ent["path"], level, i)
            if t is None:
                continue
            kids = [tiles.read_tile(cfg.logdir, ent["path"], level + 1, k)
                    for k in (2 * i, 2 * i + 1)]
            assert t["count"] == sum(k["count"] for k in kids if k)
            if kids[0] is not None:
                assert kids[0]["x0"] == pytest.approx(t["x0"])
            if kids[1] is not None:
                assert kids[1]["x1"] == pytest.approx(t["x1"])
    leaf = ent["levels"] - 1
    total = sum(t["count"] for lv, _i, t in _all_tiles(cfg, ent)
                if lv == leaf)
    assert total == ent["count"] == N_POINTS


def test_deepest_zoom_is_exact(built):
    cfg, s, manifest = built
    ent = manifest["series"]["gputrace"]
    xs, ys, names = _sorted_raw(s)
    leaf = ent["levels"] - 1
    got_x, got_y, got_names = [], [], []
    for lv, _i, t in _all_tiles(cfg, ent):
        if lv != leaf:
            continue
        assert t["exact"]
        pts = tiles.tile_points(t)
        got_x.extend(pts["x"])
        got_y.extend(pts["y"])
        got_names.extend(pts["name"])
    assert len(got_x) == len(xs)
    np.testing.assert_allclose(got_x, xs, atol=1e-6)
    np.testing.assert_allclose(got_y, ys, atol=1e-5)
    assert got_names == list(names)


def test_build_deterministic_threads_1_vs_4(tmp_path):
    trees = {}
    for jobs in (1, 4):
        cfg = SofaConfig(logdir=str(tmp_path / f"j{jobs}") + "/")
        tiles.build_tiles(cfg, [_series(), _series(15000, seed=3,
                                                   name="cputrace")],
                          jobs=jobs)
        trees[jobs] = _tree(cfg.path(tiles.TILES_DIR_NAME))
    assert set(trees[1]) == set(trees[4])
    assert not [k for k in trees[1] if trees[1][k] != trees[4][k]]


def test_warm_rebuild_is_content_keyed_noop(built):
    cfg, s, manifest = built
    ent = manifest["series"]["gputrace"]
    tile0 = os.path.join(cfg.path(tiles.TILES_DIR_NAME), ent["path"], "0",
                         "0.json.gz")
    before = os.stat(tile0).st_mtime_ns
    assert tiles.build_tiles(cfg, [s]) == manifest
    assert os.stat(tile0).st_mtime_ns == before, "a warm build rewrote tiles"
    tiles.build_tiles(cfg, [_series(seed=9)])          # data change
    assert os.stat(tile0).st_mtime_ns != before
    tiles.build_tiles(cfg, [s])                        # restore for others


def test_small_series_has_no_pyramid(tmp_path):
    cfg = SofaConfig(logdir=str(tmp_path / "small") + "/")
    assert tiles.build_tiles(cfg, [_series(n=500)])["series"] == {}


def test_gone_series_pyramid_is_pruned(tmp_path):
    cfg = SofaConfig(logdir=str(tmp_path / "prune") + "/")
    tiles.build_tiles(cfg, [_series(), _series(15000, 2, "gpu_sofa_flash")])
    assert os.path.isdir(cfg.path("_tiles", "gpu_sofa_flash"))
    tiles.build_tiles(cfg, [_series()])
    assert os.listdir(cfg.path("_tiles")) == ["gputrace"]


def test_series_dir_name_sanitizes_user_keywords():
    assert os.sep not in tiles.series_dir_name("gpu_a/b")
    assert tiles.series_dir_name("gpu_a/b") != tiles.series_dir_name("gpu_a_b")
    assert not tiles.series_dir_name("../evil").startswith(".")
    assert tiles.series_dir_name("gputrace") == "gputrace"
    for name in ("gpu_a/b", "../evil", "cpu idle", "gputrace"):
        assert tiles.series_dir_name(name) == jax_tiles.series_dir_name(name)


def test_derived_writing_sentinel(tmp_path):
    d = str(tmp_path)
    assert not derived_writing(d)
    with derived_write_guard(d):
        assert derived_writing(d)
        with derived_write_guard(d):       # reentrant: the outer owns it
            pass
        assert derived_writing(d)
    assert not derived_writing(d)
    # a sentinel left by a dead writer must not wedge the server forever
    with open(os.path.join(d, "_derived.writing"), "w") as f:
        f.write("999999999")
    assert not derived_writing(d)
    assert reap_stale_sentinel(d)
    assert not os.path.exists(os.path.join(d, "_derived.writing"))
    # a torn sentinel (no pid yet) still reads as mid-write, and stays
    with open(os.path.join(d, "_derived.writing"), "w") as f:
        f.write("")
    assert derived_writing(d)
    assert not reap_stale_sentinel(d)
    # ... until it is older than the stale limit
    old = os.stat(os.path.join(d, "_derived.writing")).st_mtime - 3600
    os.utime(os.path.join(d, "_derived.writing"), (old, old))
    assert not derived_writing(d)


def test_ensure_tiles_patches_an_older_report(tmp_path):
    """analyze over a logdir whose report.js has no pyramid yet builds it
    and patches meta.tiles; a second run leaves report.js untouched."""
    from sofa_tpu_torch.trace import read_report_js_doc, series_to_report_js

    cfg = SofaConfig(logdir=str(tmp_path / "old") + "/")
    os.makedirs(cfg.logdir)
    frames = {"gputrace": make_frame(_cols())}
    series_to_report_js([_series()], cfg.path("report.js"), 10000, {"a": 1})
    manifest = tiles.ensure_tiles(cfg, frames)
    doc = read_report_js_doc(cfg.path("report.js"))
    assert doc["meta"] == {"a": 1, "tiles": manifest}
    assert "gputrace" in manifest["series"]
    before = os.stat(cfg.path("report.js")).st_mtime_ns
    assert tiles.ensure_tiles(cfg, frames) == manifest
    assert os.stat(cfg.path("report.js")).st_mtime_ns == before
    cfg.enable_tiles = False
    assert tiles.ensure_tiles(cfg, frames) is None
