"""The builtin fleet passes (the JAX package's
``sofa_tpu/analysis/fleet_passes.py``).

Three first folds over the archive's column families, all chunk-aligned
(``fleet.fold_chunks``): each keeps one small partial per index chunk —
a pure function of that chunk's bytes, computed with Arrow/numpy
kernels, never a per-row pandas round-trip over the archive — and
renders the report section by combining partials with ``math.fsum``
(exactly rounded, so a warm fold over the delta chunks is
byte-identical to a cold recompute).

* ``swarm_regress``  — cross-run regression mining over the swarm/
  cluster feature families: per-name running stats, z-score of the
  newest sample against fleet history, co-regressing names grouped by
  the run that moved them.
* ``regress_attrib`` — attribution of the fleet's SoL-distance
  regression mass over the label / host / device (config) axes: which
  axis value's mean most exceeds the fleet mean.
* ``sol_headroom``   — fleet-wide speed-of-light headroom: per device
  class totals plus the global worst-offender ranking the fleet board
  renders (provenance joined at render time, O(result)).
"""

from __future__ import annotations

import math
from fnmatch import fnmatchcase
from typing import Dict, List

from sofa_tpu_torch.analysis.fleet import (fleet_pass, fold_chunks,
                                           parts_in_order)

#: Feature-name patterns each fold tracks — plain literals so the
#: report is self-describing about what was mined.
SWARM_PATTERNS = ("swarm*", "cluster*")
# the name analysis/sol.py writes per card (the JAX package's passes read
# its own ``tpu*_sol_distance``)
SOL_PATTERN = "gpu*_sol_distance"
#: Minimum fleet history and z-score for a swarm regression verdict.
SWARM_MIN_SAMPLES = 8
SWARM_Z_THRESHOLD = 2.0
#: Worst-offender rows kept per chunk partial and in the final ranking.
SOL_TOP_K = 20


def _match_filter(tbl, patterns):
    """Rows whose ``name`` matches any pattern: fnmatch the UNIQUE names
    (dozens), then one is_in kernel over the rows — the `_offender_page`
    discipline, no per-row python."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if not tbl.num_rows:
        return tbl
    names = pc.unique(tbl["name"]).to_pylist()
    keep = [n for n in names
            if any(fnmatchcase(n, p) for p in patterns)]
    return tbl.filter(pc.is_in(tbl["name"],
                               value_set=pa.array(keep or [""])))


@fleet_pass(name="swarm_regress", order=10,
            reads_frames=("features",),
            reads_columns=("features.run", "features.name",
                           "features.value", "features.timestamp"),
            provides_features=("fleet_swarm_regressions",))
def swarm_regress(state, tables, ctx, features):
    """Cross-run swarm-cluster regression mining: per tracked feature
    name, does the newest sample sit more than ``SWARM_Z_THRESHOLD``
    standard deviations above the fleet's history?  Names regressing off
    the same run are reported together — the "which kernel families
    moved together" view."""
    import numpy as np

    def partial(chunk):
        sub = _match_filter(chunk, SWARM_PATTERNS)
        names: Dict[str, list] = {}
        if sub.num_rows:
            nm = sub["name"].to_numpy(zero_copy_only=False)
            vals = sub["value"].to_numpy()
            runs = sub["run"].to_numpy(zero_copy_only=False)
            ts = sub["timestamp"].to_numpy()
            for name in sorted(set(nm.tolist())):
                mask = nm == name
                mv = vals[mask]
                last = int(np.nonzero(mask)[0][-1])
                names[name] = [int(mv.size), float(np.sum(mv)),
                               float(np.sum(mv * mv)),
                               str(runs[last]), float(vals[last]),
                               float(ts[last])]
        return {"names": names}

    st = state or {"chunks": {}}
    fold_chunks(st["chunks"], tables["features"],
                ctx.base.get("features", 0), ctx.chunk_rows, partial)

    ordered = parts_in_order(st["chunks"])
    totals: Dict[str, dict] = {}
    for part in ordered:
        for name, (n, s, sq, run, last, last_t) in part["names"].items():
            t = totals.setdefault(name, {"ns": [], "sums": [], "sqs": []})
            t["ns"].append(n)
            t["sums"].append(s)
            t["sqs"].append(sq)
            # the newest chunk containing the name wins the "last" slot
            t["last"] = [run, last, last_t]
    regressions = []
    for name, t in totals.items():
        n = int(sum(t["ns"]))
        mean = math.fsum(t["sums"]) / n if n else 0.0
        var = max(math.fsum(t["sqs"]) / n - mean * mean, 0.0) if n else 0.0
        std = math.sqrt(var)
        run, last, last_t = t["last"]
        z = (last - mean) / std if std > 0 else 0.0
        if n >= SWARM_MIN_SAMPLES and z > SWARM_Z_THRESHOLD \
                and last > mean:
            regressions.append({"name": name, "z": z, "n": n,
                                "mean": mean, "last_value": last,
                                "last_run": run, "last_t": last_t})
    regressions.sort(key=lambda r: (-r["z"], r["name"]))
    by_run: Dict[str, List[str]] = {}
    for r in regressions:
        by_run.setdefault(r["last_run"], []).append(r["name"])
    clusters = [{"run": run, "names": names}
                for run, names in sorted(by_run.items())
                if len(names) >= 2]
    features.add("fleet_swarm_regressions", float(len(regressions)))
    return {"state": st,
            "report": {"patterns": list(SWARM_PATTERNS),
                       "tracked": len(totals),
                       "regressions": regressions,
                       "clusters": clusters}}


@fleet_pass(name="regress_attrib", order=20,
            reads_frames=("features", "runs"),
            reads_columns=("features.run", "features.name",
                           "features.value", "runs.run", "runs.label",
                           "runs.host"),
            provides_features=("fleet_attrib_worst_excess",))
def regress_attrib(state, tables, ctx, features):
    """Regression attribution over the label / host / device (config)
    axes: per axis value, how far the mean SoL distance sits above the
    fleet mean.  The per-chunk join resolves each run's label/host via
    ``ctx.runs_meta`` at fold time — a re-ingest that CHANGES a run's
    axes re-attributes its old rows on the next full recompute (the
    documented fold-time-lookup caveat); the device axis is pure (it is
    the feature name's prefix)."""
    import numpy as np

    def partial(chunk):
        sub = _match_filter(chunk, (SOL_PATTERN,))
        axes: Dict[str, List[float]] = {}
        if sub.num_rows:
            runs = sub["run"].to_numpy(zero_copy_only=False)
            vals = sub["value"].to_numpy()
            nm = sub["name"].to_numpy(zero_copy_only=False)
            # per-UNIQUE python work fanned back out through np.unique's
            # inverse index — the per-row dict gets and str splits this
            # replaces were the fold's hot spot at catalog scale
            uruns, rinv = np.unique(runs, return_inverse=True)
            unm, ninv = np.unique(nm, return_inverse=True)
            meta = ctx.runs_meta(set(uruns.tolist()))
            keys = {
                "label": np.array([str((meta.get(r) or {})
                                       .get("label") or "")
                                   for r in uruns.tolist()],
                                  dtype=object)[rinv],
                "host": np.array([str((meta.get(r) or {})
                                      .get("host") or "")
                                  for r in uruns.tolist()],
                                 dtype=object)[rinv],
                "device": np.array([n.split("_", 1)[0]
                                    for n in unm.tolist()],
                                   dtype=object)[ninv],
            }
            axes["_all"] = [float(vals.size), float(np.sum(vals))]
            for axis, col in keys.items():
                # integer-code masks: np.unique's sorted uniques are the
                # old sorted(set(...)) walk, and ``codes == k`` selects
                # the same rows in the same order, so np.sum reproduces
                # the object-compare path's floats exactly
                uvals, codes = np.unique(col, return_inverse=True)
                for k, value in enumerate(uvals.tolist()):
                    mv = vals[codes == k]
                    axes[f"{axis}:{value}"] = [float(mv.size),
                                               float(np.sum(mv))]
        return {"axes": axes}

    st = state or {"chunks": {}}
    fold_chunks(st["chunks"], tables["features"],
                ctx.base.get("features", 0), ctx.chunk_rows, partial)

    sums: Dict[str, dict] = {}
    for part in parts_in_order(st["chunks"]):
        for key, (n, s) in part["axes"].items():
            t = sums.setdefault(key, {"ns": [], "sums": []})
            t["ns"].append(n)
            t["sums"].append(s)

    def mean_of(key):
        t = sums.get(key)
        if not t:
            return 0, 0.0
        n = int(sum(t["ns"]))
        return n, (math.fsum(t["sums"]) / n if n else 0.0)

    n_all, mean_all = mean_of("_all")
    axes_report: Dict[str, list] = {"label": [], "host": [], "device": []}
    worst = 0.0
    for key in sums:
        axis, _, value = key.partition(":")
        if axis not in axes_report:
            continue
        n, mean = mean_of(key)
        excess = mean - mean_all
        worst = max(worst, excess)
        axes_report[axis].append({"value": value, "n": n, "mean": mean,
                                  "excess": excess})
    for axis in axes_report:
        axes_report[axis].sort(key=lambda r: (-r["excess"], r["value"]))
        del axes_report[axis][10:]
    features.add("fleet_attrib_worst_excess", worst)
    return {"state": st,
            "report": {"metric": SOL_PATTERN,
                       "overall": {"n": n_all, "mean": mean_all},
                       "axes": axes_report}}


@fleet_pass(name="sol_headroom", order=30,
            reads_frames=("features", "runs"),
            reads_columns=("features.run", "features.name",
                           "features.value", "runs.run", "runs.label",
                           "runs.host", "runs.timestamp"),
            provides_features=("fleet_sol_*",))
def sol_headroom(state, tables, ctx, features):
    """Fleet-wide speed-of-light headroom: per device class (the
    ``gpu<N>_sol_distance`` family name), how far the fleet runs from
    the hardware's speed of light — plus the global worst-offender
    ranking `board/fleet.html` renders.  Offender provenance joins at
    RENDER time against the current runs family (byte-identity safe and
    O(result))."""
    import numpy as np

    def partial(chunk):
        sub = _match_filter(chunk, (SOL_PATTERN,))
        classes: Dict[str, list] = {}
        top: List[list] = []
        if sub.num_rows:
            nm = sub["name"].to_numpy(zero_copy_only=False)
            vals = sub["value"].to_numpy()
            runs = sub["run"].to_numpy(zero_copy_only=False)
            for name in sorted(set(nm.tolist())):
                mv = vals[nm == name]
                classes[name] = [int(mv.size), float(np.sum(mv)),
                                 float(np.max(mv))]
            # np.partition narrows to the boundary-tie candidates; only
            # those few materialize as python rows for the exact
            # (-value, run, name) ordering — no per-row python over the
            # whole chunk
            k = min(SOL_TOP_K, int(vals.size))
            kth = np.partition(vals, vals.size - k)[vals.size - k]
            cand = np.nonzero(vals >= kth)[0]
            top = sorted(([float(vals[i]), str(runs[i]), str(nm[i])]
                          for i in cand),
                         key=lambda r: (-r[0], r[1], r[2]))[:SOL_TOP_K]
        return {"classes": classes, "top": top}

    st = state or {"chunks": {}}
    fold_chunks(st["chunks"], tables["features"],
                ctx.base.get("features", 0), ctx.chunk_rows, partial)

    ordered = parts_in_order(st["chunks"])
    classes: Dict[str, dict] = {}
    merged: List[list] = []
    for part in ordered:
        for name, (n, s, mx) in part["classes"].items():
            t = classes.setdefault(name, {"ns": [], "sums": [], "max": mx})
            t["ns"].append(n)
            t["sums"].append(s)
            t["max"] = max(t["max"], mx)
        merged.extend(part["top"])
    merged.sort(key=lambda r: (-r[0], r[1], r[2]))
    merged = merged[:SOL_TOP_K]
    meta = ctx.runs_meta({run for _v, run, _n in merged})
    worst_rows = [{"run": run, "name": name, "value": value,
                   "host": str((meta.get(run) or {}).get("host") or ""),
                   "label": str((meta.get(run) or {}).get("label") or ""),
                   "t": float((meta.get(run) or {}).get("timestamp")
                              or 0.0)}
                  for value, run, name in merged]
    class_report = {}
    total_n, total_sums = [], []
    for name, t in sorted(classes.items()):
        n = int(sum(t["ns"]))
        class_report[name] = {"n": n,
                              "mean": (math.fsum(t["sums"]) / n
                                       if n else 0.0),
                              "worst": t["max"]}
        total_n.append(n)
        total_sums.extend(t["sums"])
    n_all = int(sum(total_n))
    features.add("fleet_sol_classes", float(len(class_report)))
    features.add("fleet_sol_mean",
                 math.fsum(total_sums) / n_all if n_all else 0.0)
    features.add("fleet_sol_worst",
                 worst_rows[0]["value"] if worst_rows else 0.0)
    return {"state": st,
            "report": {"pattern": SOL_PATTERN,
                       "classes": class_report,
                       "worst": worst_rows}}
