"""Level-of-detail timeline tiles: the board's deep-zoom data.

``report.js`` carries a downsampled overview of every series (about
``viz_downsample_to`` points however large the trace), so zooming in on it
shows less, not more.  This module builds the complement: for each series
larger than the overview, a multi-resolution tile pyramid under
``<logdir>/_tiles/`` that the board fetches for the viewport as it zooms.

Layout (each tile gzipped columnar JSON)::

    <logdir>/_tiles/<series>/<level>/<n>.json.gz   one tile
    <logdir>/_tiles/<series>/tile_index.json       the series' content key

At level ``L`` the series' time domain [x0, x1] splits into ``2**L`` equal
windows, so tile ``n`` covers exactly tiles ``2n`` and ``2n+1`` of level
``L+1``.  Levels deepen until every leaf holds at most ``TILE_RAW_MAX``
events (``MAX_LEVELS`` at most).  Leaf tiles are exact: the raw events of
their window.  A coarser tile over the budget is decimated to an envelope:
each of ``TILE_BUCKETS`` equal sub-windows keeps its lowest and highest
point, plus the tile's ``TILE_STRAGGLERS`` longest events and a per-bucket
``density`` histogram.  Empty windows get no file (the board reads a 404
as an empty tile).

The per-series key signs the series' data and the pyramid's parameters, so
a rebuild over unchanged frames writes nothing.  Series build on a small
thread pool (json and gzip release the GIL); the bytes do not depend on
the number of threads.

``build_tiles_live`` refreshes the pyramids of a ``live`` epoch (the JAX
package's ``tiles.py:498-659``): the grid is anchored at the series' first
event over a power-of-two horizon, so appends land in the right-hand
windows and only the tiles whose window reaches the new suffix are
rewritten.  Its ``tile_index.json`` holds a ``live`` section (anchor,
width, depth, committed rows, a sha of the committed prefix) and no batch
``key``, so the next batch build rebuilds from scratch and converges to
the batch bytes.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.printing import print_progress, print_warning
from sofa_tpu_torch.trace import atomic_write

TILES_DIR_NAME = "_tiles"
TILE_INDEX_NAME = "tile_index.json"
TILES_VERSION = 1

# A leaf holds at most this many raw events (a worst-case exact tile gzips
# well under 64 KiB).
TILE_RAW_MAX = 4096
# Decimation buckets of a coarse tile (min and max point each) and the
# longest events it keeps besides.
TILE_BUCKETS = 256
TILE_STRAGGLERS = 64
# 12 levels of exact leaves cover ~8M events (TILE_RAW_MAX * 2**11).
MAX_LEVELS = 12

# Fixed-point scales of the tile encoding: x at 0.1 us, y at 1e-6, d at
# 1 ns; x is delta-encoded, so it gzips into small integers.
X_SCALE, Y_SCALE, D_SCALE = 1e-7, 1e-6, 1e-9

_SAFE_NAME = re.compile(r"[^A-Za-z0-9_.-]")


def thread_map(fn: Callable, items, jobs: int) -> list:
    """Ordered map over a thread pool; serial for one job or one item."""
    items = list(items)
    if jobs <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(jobs, len(items))) as pool:
        return list(pool.map(fn, items))


def default_jobs() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def series_dir_name(name: str) -> str:
    """A filesystem-safe directory for a series name (filter keywords are
    user input); a changed name gets a hash suffix, so no two collide."""
    safe = _SAFE_NAME.sub("_", name).lstrip(".") or "series"
    if safe != name:
        safe += "-" + hashlib.sha1(name.encode()).hexdigest()[:8]
    return safe


def _scrub(values, digits: int) -> np.ndarray:
    a = np.asarray(values, dtype=float)
    a = np.where(np.isfinite(a), a, 0.0)
    return np.round(a, digits)


def _tile_params(levels_cap: int) -> dict:
    return {"version": TILES_VERSION, "raw_max": TILE_RAW_MAX,
            "buckets": TILE_BUCKETS, "stragglers": TILE_STRAGGLERS,
            "levels_cap": int(levels_cap)}


def _series_key(df: pd.DataFrame, ycol: str, params: dict) -> str:
    """Content key over the series' raw columns and the parameters
    (``hash_pandas_object`` is the same in every process)."""
    h = hashlib.sha1()
    h.update(repr(sorted(params.items())).encode())
    for col in ("timestamp", ycol, "duration"):
        h.update(np.ascontiguousarray(
            df[col].to_numpy(dtype=float)).tobytes())
    h.update(pd.util.hash_pandas_object(df["name"], index=False)
             .to_numpy().tobytes())
    return h.hexdigest()


def _levels_for(xs: np.ndarray, cap: int, x0: Optional[float] = None,
                width: Optional[float] = None) -> int:
    """The least depth whose leaves all hold <= TILE_RAW_MAX events (xs
    sorted), at most ``cap``.  ``x0`` and ``width`` anchor the grid (a
    live build's horizon); by default it spans the data."""
    n = len(xs)
    if x0 is None:
        x0 = float(xs[0])
    if width is None:
        width = (float(xs[-1]) - x0) or 1e-9
    level = 0
    while level < cap - 1:
        nt = 1 << level
        edges = x0 + width * np.arange(1, nt) / nt
        splits = np.searchsorted(xs, edges, side="left")
        counts = np.diff(np.concatenate([[0], splits, [n]]))
        if counts.max() <= TILE_RAW_MAX:
            break
        level += 1
    return level + 1


def _write_tile(path: str, doc: dict) -> int:
    """Gzip a tile with mtime 0 (so builds are byte-identical), at level 1
    (a tile is fetched rarely; the integer encoding did most of the
    compression's work); returns the compressed size."""
    blob = gzip.compress(
        json.dumps(doc, separators=(",", ":")).encode(), 1, mtime=0)
    with atomic_write(path, "wb") as f:
        f.write(blob)
    return len(blob)


def _first_match_per_run(values, target_per_run, run_of):
    """First index in each contiguous run whose value equals the run's
    target."""
    eq = np.flatnonzero(values == target_per_run[run_of])
    _uniq, first = np.unique(run_of[eq], return_index=True)
    return eq[first]


def _level_envelope(xs, ys, x0: float, width: float, nt: int):
    """Per-bucket min- and max-y point indices of a whole level.  ``xs`` is
    sorted, so each bucket's points form one contiguous run and
    ``reduceat`` finds the extrema without a sort.  Returns (bucket id per
    occupied run, min index, max index, bucket id per point)."""
    nb = nt * TILE_BUCKETS
    gb = ((xs - x0) / width * nb).astype(np.int64)
    np.clip(gb, 0, nb - 1, out=gb)
    starts = np.flatnonzero(np.concatenate([[True], gb[1:] != gb[:-1]]))
    run_of = np.repeat(np.arange(len(starts)),
                       np.diff(np.concatenate([starts, [len(gb)]])))
    min_idx = _first_match_per_run(ys, np.minimum.reduceat(ys, starts),
                                   run_of)
    max_idx = _first_match_per_run(ys, np.maximum.reduceat(ys, starts),
                                   run_of)
    return gb[starts], min_idx, max_idx, gb


def _build_pyramid(sdir: str, xs, ys, ds, names: pd.Series,
                   levels: int, x0: Optional[float] = None,
                   width: Optional[float] = None,
                   dirty_from: Optional[float] = None,
                   stats: Optional[dict] = None) -> dict:
    """Write every tile of one series (xs sorted) under ``sdir``; returns
    its manifest entry.  ``x0`` and ``width`` anchor the grid (a live
    build's horizon, so that appends never shift it); an occupied tile
    whose window ends at or before ``dirty_from`` is kept on disk as it
    is.  ``stats`` receives the tiles written and kept."""
    n = len(xs)
    if x0 is None:
        x0 = float(xs[0])
    if width is None:
        width = (float(xs[-1]) - x0) or 1e-9
    # one string table per series; each tile ships its own slice of it
    codes, uniques = pd.factorize(names, use_na_sentinel=False)
    uniques = [str(u) for u in uniques]
    xi = np.round(xs / X_SCALE).astype(np.int64)
    yi = np.round(ys / Y_SCALE).astype(np.int64)
    di = np.round(ds / D_SCALE).astype(np.int64)
    n_tiles = n_bytes = wrote = kept = 0
    per_level: List[int] = []
    for level in range(levels):
        nt = 1 << level
        edges = x0 + width * np.arange(1, nt) / nt
        bounds = np.concatenate(
            [[0], np.searchsorted(xs, edges, side="left"), [n]])
        counts = np.diff(bounds)
        ldir = os.path.join(sdir, str(level))
        os.makedirs(ldir, exist_ok=True)
        leaf = level == levels - 1
        env = None
        if not leaf and counts.max() > TILE_RAW_MAX:
            env = _level_envelope(xs, ys, x0, width, nt)
        occupied = 0
        for i in range(nt):
            a, b = int(bounds[i]), int(bounds[i + 1])
            if a == b:
                continue
            occupied += 1
            tx0 = x0 + width * i / nt
            tw = width / nt
            if dirty_from is not None and tx0 + tw <= dirty_from:
                # every event of the window was committed by an earlier
                # epoch: the file stands
                kept += 1
                with contextlib.suppress(OSError):
                    n_bytes += os.path.getsize(
                        os.path.join(ldir, f"{i}.json.gz"))
                continue
            exact = leaf or (b - a) <= TILE_RAW_MAX
            doc = {"level": level, "n": i, "x0": round(tx0, 9),
                   "x1": round(tx0 + tw, 9), "count": b - a,
                   "exact": bool(exact)}
            if exact:
                keep = np.arange(a, b)
            else:
                run_b, run_min, run_max, gb = env
                lo, hi = i * TILE_BUCKETS, (i + 1) * TILE_BUCKETS
                r0, r1 = np.searchsorted(run_b, [lo, hi])
                seg_d = ds[a:b]
                k = min(TILE_STRAGGLERS, b - a)
                top = a + np.argpartition(seg_d, len(seg_d) - k)[-k:]
                keep = np.unique(np.concatenate(
                    [run_min[r0:r1], run_max[r0:r1], top]))
                doc["buckets"] = TILE_BUCKETS
                doc["density"] = np.bincount(
                    gb[a:b] - lo, minlength=TILE_BUCKETS).tolist()
            # the envelope of every raw point in the window, kept or not
            doc["ymin"] = float(ys[a:b].min())
            doc["ymax"] = float(ys[a:b].max())
            xk = xi[keep]
            doc["sx"], doc["sy"], doc["sd"] = X_SCALE, Y_SCALE, D_SCALE
            doc["xd"] = np.diff(xk, prepend=0).tolist()
            doc["yv"] = yi[keep].tolist()
            doc["dv"] = di[keep].tolist()
            local, inv = np.unique(codes[keep], return_inverse=True)
            doc["names"] = [uniques[int(j)] for j in local]
            doc["ni"] = inv.tolist()
            n_bytes += _write_tile(os.path.join(ldir, f"{i}.json.gz"), doc)
            wrote += 1
        per_level.append(occupied)
        n_tiles += occupied
    if stats is not None:
        stats["wrote"], stats["kept"] = wrote, kept
    return {"levels": levels, "x0": round(x0, 9),
            "x1": round(x0 + width, 9), "count": int(n),
            "tiles": per_level, "tile_count": n_tiles, "bytes": n_bytes}


def tile_points(doc: dict) -> dict:
    """Decode one tile to values: {"x", "y", "d" (arrays), "name" (list)},
    as the board's ``pointsFromTile`` does."""
    xk = np.cumsum(np.asarray(doc["xd"], dtype=np.int64))
    table = doc.get("names") or []
    return {"x": xk * doc["sx"],
            "y": np.asarray(doc["yv"], dtype=np.int64) * doc["sy"],
            "d": np.asarray(doc["dv"], dtype=np.int64) * doc["sd"],
            "name": [table[i] for i in doc.get("ni") or []]}


def _series_arrays(s) -> tuple:
    """(xs, ys, ds, names) sorted by time and scrubbed: the values the
    board draws."""
    df = s.data
    ycol = s.y_axis if s.y_axis in df.columns else "event"
    xs = _scrub(df["timestamp"].to_numpy(), 7)
    ys = _scrub(df[ycol].to_numpy(), 6)
    ds = _scrub(df["duration"].to_numpy(), 9)
    order = np.argsort(xs, kind="stable")
    names = df["name"].astype(str)
    return (xs[order], ys[order], ds[order],
            names.iloc[order].reset_index(drop=True))


def build_tiles(cfg, series, jobs: Optional[int] = None) -> Dict[str, object]:
    """Build (or keep) the pyramid of every series larger than the
    overview; returns the manifest report.js carries as ``meta.tiles``.
    Pyramids of series that no longer exist are removed."""
    jobs = jobs or default_jobs()
    # --tile_levels caps the depth; 0 deepens until every leaf is exact
    cap = cfg.tile_levels if cfg.tile_levels > 0 else MAX_LEVELS
    params = _tile_params(cap)
    root = cfg.path(TILES_DIR_NAME)
    overview_max = int(cfg.viz_downsample_to)
    work = [s for s in series if len(s.data) > overview_max]

    def build_one(s):
        try:
            ycol = s.y_axis if s.y_axis in s.data.columns else "event"
            key = _series_key(s.data, ycol, params)
            dname = series_dir_name(s.name)
            sdir = os.path.join(root, dname)
            index_path = os.path.join(sdir, TILE_INDEX_NAME)
            try:
                with open(index_path) as f:
                    index = json.load(f)
            except (OSError, ValueError):
                index = None
            if isinstance(index, dict) and index.get("key") == key:
                entry = dict(index.get("entry") or {})
                entry["path"] = dname
                return s.name, entry, True
            # a rebuild starts empty: stale levels must not shadow new ones
            shutil.rmtree(sdir, ignore_errors=True)
            os.makedirs(sdir, exist_ok=True)
            xs, ys, ds, names = _series_arrays(s)
            entry = _build_pyramid(sdir, xs, ys, ds, names,
                                   _levels_for(xs, cap))
            # the index is the pyramid's commit point: written last
            with atomic_write(index_path, fsync=True) as f:
                json.dump({"key": key, "params": params, "entry": entry}, f)
            entry = dict(entry)
            entry["path"] = dname
            return s.name, entry, False
        except Exception as e:  # noqa: BLE001 - costs this series' zoom
            print_warning(f"tiles: cannot build the pyramid of {s.name}: "
                          f"{e!r}")
            return None

    built = [r for r in thread_map(build_one, work, jobs) if r is not None]
    manifest: Dict[str, object] = {
        "dir": TILES_DIR_NAME, "version": TILES_VERSION,
        "raw_max": TILE_RAW_MAX,
        "series": {name: entry for name, entry, _cached in built}}
    keep_dirs = {series_dir_name(name) for name, _e, _c in built}
    if os.path.isdir(root):
        for entry in os.listdir(root):
            if entry not in keep_dirs and \
                    os.path.isdir(os.path.join(root, entry)):
                shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
    if built:
        n_cached = sum(1 for _n, _e, cached in built if cached)
        total_tiles = sum(e["tile_count"] for _n, e, _c in built)
        total_bytes = sum(e["bytes"] for _n, e, _c in built)
        print_progress(
            f"tiles: {len(built)} series pyramids ({total_tiles} tiles, "
            f"{total_bytes / 2**20:.1f} MiB, {n_cached} kept) -> {root}")
    return manifest


def ensure_tiles(cfg, frames) -> Optional[dict]:
    """Build or refresh the pyramid of a logdir that has a report.js (an
    ``analyze`` over an older preprocess) and patch its manifest into
    report.js.  Nothing is written when every content key matches.  None
    when tiles are off or there is no report.js."""
    if not cfg.enable_tiles or frames is None:
        return None
    report = cfg.path("report.js")
    if not os.path.isfile(report):
        return None
    from sofa_tpu_torch.frames import materialize
    from sofa_tpu_torch.preprocess import VIZ_COLUMNS, build_series

    # a columnar frame reads the viz columns only (the JAX package's
    # tiles.py:426-452); an eager frame passes as it is
    frames = {name: materialize(v, list(VIZ_COLUMNS))
              for name, v in frames.items()}
    manifest = build_tiles(cfg, build_series(cfg, frames))
    try:
        patch_report_meta(report, manifest)
    except (OSError, ValueError) as e:
        print_warning(f"tiles: cannot patch report.js's manifest: {e}")
    return manifest


def patch_report_meta(report_path: str, manifest: dict) -> None:
    """Set report.js's ``meta.tiles`` (atomically), leaving its series
    alone; an unchanged manifest leaves the file untouched."""
    from sofa_tpu_torch.trace import read_report_js_doc, write_report_js_doc

    doc = read_report_js_doc(report_path)
    meta = doc.setdefault("meta", {})
    if meta.get("tiles") == manifest:
        return
    meta["tiles"] = manifest
    write_report_js_doc(doc, report_path)


def read_tile(logdir: str, series_path: str, level: int,
              n: int) -> Optional[dict]:
    """One tile's document, or None where the window is empty."""
    path = os.path.join(logdir, TILES_DIR_NAME, series_path, str(level),
                        f"{n}.json.gz")
    try:
        with gzip.open(path, "rt") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# --- live builds --------------------------------------------------------------

# The live horizon: the least power-of-two multiple of this many seconds
# that covers PAD times the span seen so far.  Outgrowing it re-anchors (one
# full rebuild, O(log n) of them over a run's life).
LIVE_HORIZON_BASE_S = 1.0
LIVE_HORIZON_PAD = 2.0


def _live_horizon(span: float) -> float:
    width = LIVE_HORIZON_BASE_S
    target = max(span, 1e-3) * LIVE_HORIZON_PAD
    while width < target:
        width *= 2.0
    return width


def _prefix_sha(xs, ys, ds, names: pd.Series, rows: int) -> str:
    """sha1 over the first ``rows`` sorted events: the committed prefix an
    append build must find unchanged before it keeps old tiles."""
    h = hashlib.sha1()
    for a in (xs, ys, ds):
        h.update(np.ascontiguousarray(a[:rows]).tobytes())
    h.update(pd.util.hash_pandas_object(names.iloc[:rows], index=False)
             .to_numpy().tobytes())
    return h.hexdigest()


def build_tiles_live(cfg, series, jobs: Optional[int] = None
                     ) -> "tuple[dict, dict]":
    """Refresh the pyramids of a live epoch.  Returns ``(manifest,
    stats)``: report.js's ``meta.tiles`` as ``build_tiles`` gives it, and
    the epoch's ``rebuilt`` tiles, ``kept`` tiles, ``unchanged_series``
    (skipped whole) and ``full_rebuilds`` (a first build, a re-anchor, a
    deeper pyramid or a changed prefix).  Pyramids are not pruned: a
    series a live epoch does not see stays until the batch build."""
    jobs = jobs or default_jobs()
    cap = cfg.tile_levels if cfg.tile_levels > 0 else MAX_LEVELS
    params = _tile_params(cap)
    root = cfg.path(TILES_DIR_NAME)
    work = [s for s in series if len(s.data) > int(cfg.viz_downsample_to)]

    def build_one(s):
        try:
            dname = series_dir_name(s.name)
            sdir = os.path.join(root, dname)
            index_path = os.path.join(sdir, TILE_INDEX_NAME)
            try:
                with open(index_path) as f:
                    index = json.load(f)
            except (OSError, ValueError):
                index = None
            live = index.get("live") if isinstance(index, dict) else None
            xs, ys, ds, names = _series_arrays(s)
            n = len(xs)
            mode, dirty_from = "full", None
            if isinstance(live, dict) and live.get("params") == params:
                dx0, dwidth = float(live["x0"]), float(live["width"])
                levels = int(live["levels"])
                rows = int(live.get("rows", 0))
                if 0 < rows <= n and float(xs[0]) >= dx0 \
                        and float(xs[-1]) < dx0 + dwidth \
                        and _prefix_sha(xs, ys, ds, names, rows) \
                        == live.get("prefix_sha"):
                    if rows == n:
                        mode = "unchanged"
                    elif _levels_for(xs, cap, dx0, dwidth) <= levels:
                        mode, dirty_from = "append", float(xs[rows])
            if mode == "unchanged":
                entry = dict(index.get("entry") or {})
                entry["path"] = dname
                return s.name, entry, {"kept": entry.get("tile_count", 0),
                                       "wrote": 0, "unchanged": True}
            if mode == "full":
                dx0 = float(xs[0])
                dwidth = _live_horizon(float(xs[-1]) - dx0)
                levels = _levels_for(xs, cap, dx0, dwidth)
                shutil.rmtree(sdir, ignore_errors=True)
            os.makedirs(sdir, exist_ok=True)
            stats: dict = {"full": mode == "full"}
            entry = _build_pyramid(sdir, xs, ys, ds, names, levels,
                                   x0=dx0, width=dwidth,
                                   dirty_from=dirty_from, stats=stats)
            live_doc = {"x0": dx0, "width": dwidth, "levels": levels,
                        "rows": n,
                        "prefix_sha": _prefix_sha(xs, ys, ds, names, n),
                        "params": params}
            # the commit point, as in the batch build; no batch key
            with atomic_write(index_path, fsync=True) as f:
                json.dump({"live": live_doc, "entry": entry}, f)
            entry = dict(entry)
            entry["path"] = dname
            return s.name, entry, stats
        except Exception as e:  # noqa: BLE001 - costs this series' zoom
            print_warning(f"tiles: cannot live-build the pyramid of "
                          f"{s.name}: {e!r}")
            return None

    built = [r for r in thread_map(build_one, work, jobs) if r is not None]
    manifest: Dict[str, object] = {
        "dir": TILES_DIR_NAME, "version": TILES_VERSION,
        "raw_max": TILE_RAW_MAX,
        "series": {name: entry for name, entry, _st in built}}
    stats = {
        "series": len(built),
        "rebuilt": sum(st.get("wrote", 0) for _n, _e, st in built),
        "kept": sum(st.get("kept", 0) for _n, _e, st in built),
        "unchanged_series": sum(1 for _n, _e, st in built
                                if st.get("unchanged")),
        "full_rebuilds": sum(1 for _n, _e, st in built if st.get("full")),
    }
    return manifest, stats
