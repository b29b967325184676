"""``regress``: the typed regression engine over the archive (the JAX
package's ``sofa_tpu/archive/verdict.py``).

Compares a run (a logdir, or an archived run id) with another run, or with
a rolling percentile baseline over the catalog, and gives each feature and
each swarm cluster a typed verdict, ``regressed``, ``improved`` or
``noise``, under baseline.py's interval rules: no verdict without a
defensible interval, and a short history or a feature without polarity
says ``noise`` and why.  Clusters are matched with ml/diff.py's matcher.

Writes ``regress_verdict.json`` (schema below, checked by the port's
``tools/manifest_check.validate_verdict``) beside the run (its logdir, or
the archive root for an archived id) and prints a table.  Exit codes: 0
noise or improved, 1 regressed, 2 usage errors, so that CI can gate on
it.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Dict, List, Optional

from sofa_tpu_torch.archive import VERDICT_NAME, baseline, resolve_root
from sofa_tpu_torch.archive.store import ArchiveStore, _read_features_csv
from sofa_tpu_torch.printing import (
    print_error,
    print_progress,
    print_title,
    print_warning,
)

VERDICT_SCHEMA = "sofa_tpu/regress_verdict"
VERDICT_VERSION = 1

VERDICTS = ("regressed", "improved", "noise")

# A new swarm cluster only earns a verdict when it carries at least this
# fraction of the base run's total clustered duration — tiny new clusters
# are churn, not regressions.
_NEW_CLUSTER_MIN_SHARE = 0.05


class _Side:
    """One comparison side: a logdir path or an archived run."""

    def __init__(self, label: str, features: Dict[str, float],
                 clusters, run_id: "str | None" = None):
        self.label = label
        self.features = features
        self.clusters = clusters            # DataFrame or None
        self.run_id = run_id


def _clusters_ok(df) -> bool:
    return df is not None and not df.empty and \
        {"cluster_ID", "name", "duration"}.issubset(df.columns)


def _load_clusters_csv(path_or_buf) -> "object | None":
    import pandas as pd

    try:
        df = pd.read_csv(path_or_buf)
    except Exception as e:  # noqa: BLE001 - degrade to the features
        print_warning(f"regress: cannot read auto_caption table ({e}) — "
                      "cluster verdicts skipped")
        return None
    return df


def resolve_side(store: "ArchiveStore | None", arg: str) -> "_Side | None":
    """A logdir path, or a (>= 6 char) archived run-id prefix."""
    if os.path.isdir(arg):
        feats = _read_features_csv(os.path.join(arg, "features.csv"))
        cpath = os.path.join(arg, "auto_caption.csv")
        clusters = _load_clusters_csv(cpath) if os.path.isfile(cpath) \
            else None
        return _Side(arg, feats, clusters)
    if store is not None and store.exists:
        run_id = store.resolve_run_id(arg)
        if run_id is not None:
            doc = store.load_run(run_id) or {}
            clusters = None
            ent = (doc.get("files") or {}).get("auto_caption.csv")
            if ent:
                blob = store.read_object(ent.get("sha256", ""))
                if blob is not None:
                    clusters = _load_clusters_csv(io.BytesIO(blob))
            return _Side(run_id[:12], doc.get("features") or {}, clusters,
                         run_id=run_id)
    return None


# ---------------------------------------------------------------------------
# The comparison.
# ---------------------------------------------------------------------------

def compare_features(run: _Side, base: "_Side | None", store,
                     rolling: int, pct: float,
                     threshold_pct: float) -> List[dict]:
    rows: List[dict] = []
    if base is not None:
        names = sorted(set(run.features) | set(base.features))
        for name in names:
            v = float(run.features.get(name, 0.0))
            b = float(base.features.get(name, 0.0))
            row = baseline.pairwise_verdict(v, b, threshold_pct,
                                            baseline.polarity(name))
            rows.append({"name": name, "value": v, **row})
        return rows
    samples = baseline.rolling_samples(store, rolling,
                                       exclude_run=run.run_id)
    for name in sorted(run.features):
        v = float(run.features[name])
        row = baseline.rolling_verdict(v, samples.get(name, []), pct,
                                       threshold_pct,
                                       baseline.polarity(name))
        rows.append({"name": name, "value": v, **row})
    return rows


def compare_clusters(run: _Side, base: _Side,
                     threshold_pct: float) -> List[dict]:
    """Per-swarm-cluster verdicts (pairwise only): fuzzy-match clusters
    with ml/diff.py's greedy matcher, verdict each matched pair's
    duration ratio, and surface new clusters that carry real weight."""
    from sofa_tpu_torch.ml.diff import _cluster_signatures, match_swarms

    if not (_clusters_ok(run.clusters) and _clusters_ok(base.clusters)):
        return []
    base_sig = _cluster_signatures(base.clusters)
    run_sig = _cluster_signatures(run.clusters)
    mapping = match_swarms(base_sig, run_sig)
    rows: List[dict] = []
    total_base = sum(s["duration"] for s in base_sig.values()) or 1.0
    matched_run = {m for m in mapping.values() if m is not None}
    for b, m in sorted(mapping.items()):
        bs = base_sig[b]
        name = f"cluster {b} ({bs['names'][:48]})"
        if m is None:
            rows.append({"name": name, "value": 0.0,
                         "baseline": bs["duration"], "ratio": 0.0,
                         "verdict": "noise",
                         "reason": "no matching cluster in the run "
                                   "(vanished or renamed beyond the "
                                   "fuzzy matcher)"})
            continue
        row = baseline.pairwise_verdict(
            run_sig[m]["duration"], bs["duration"], threshold_pct, 1)
        rows.append({"name": name, "value": run_sig[m]["duration"],
                     "matched_cluster": m, **row})
    for m, ms in sorted(run_sig.items()):
        if m in matched_run:
            continue
        share = ms["duration"] / total_base
        if share >= _NEW_CLUSTER_MIN_SHARE:
            rows.append({"name": f"cluster new:{m} ({ms['names'][:48]})",
                         "value": ms["duration"], "baseline": 0.0,
                         "ratio": float("inf"), "verdict": "regressed",
                         "reason": f"new cluster carrying "
                                   f"{share * 100:.1f}% of the base run's "
                                   "clustered time (ratio inf)"})
        else:
            rows.append({"name": f"cluster new:{m}", "value": ms["duration"],
                         "baseline": 0.0, "ratio": float("inf"),
                         "verdict": "noise",
                         "reason": f"new cluster below the "
                                   f"{_NEW_CLUSTER_MIN_SHARE * 100:.0f}% "
                                   "weight floor"})
    return rows


def overall_verdict(rows: List[dict]) -> str:
    verdicts = {r.get("verdict") for r in rows}
    if "regressed" in verdicts:
        return "regressed"
    if "improved" in verdicts:
        return "improved"
    return "noise"


def build_verdict_doc(run: _Side, base: "_Side | None", mode: dict,
                      features: List[dict], clusters: List[dict]) -> dict:
    counts = {v: 0 for v in VERDICTS}
    for r in features + clusters:
        counts[r.get("verdict", "noise")] += 1
    return {
        "schema": VERDICT_SCHEMA,
        "version": VERDICT_VERSION,
        "generated_unix": round(time.time(), 3),
        "run": {"label": run.label, "run_id": run.run_id},
        "baseline": mode if base is None else {
            "mode": "pairwise", "label": base.label,
            "run_id": base.run_id, **mode},
        "features": features,
        "clusters": clusters,
        "counts": counts,
        "verdict": overall_verdict(features + clusters),
    }


def write_verdict(doc: dict, out_path: str) -> None:
    from sofa_tpu_torch.trace import atomic_write

    # json.dumps(inf) emits the non-standard Infinity token; the board's
    # JSON.parse (and any strict consumer) rejects it, so encode inf as
    # the string "inf" — the one sentinel the diff tables already use.
    def _clean(v):
        if isinstance(v, float) and (v != v or v in (float("inf"),
                                                     float("-inf"))):
            return "inf" if v > 0 else ("-inf" if v < 0 else "nan")
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, list):
            return [_clean(x) for x in v]
        return v

    with atomic_write(out_path, fsync=True) as f:
        json.dump(_clean(doc), f, indent=1, sort_keys=True)


def render_verdict(doc: dict) -> List[str]:
    lines: List[str] = []
    rows = [["FEATURE", "VALUE", "BASELINE", "RATIO", "VERDICT", "WHY"]]

    def fmt(v):
        if isinstance(v, str):
            return v
        if not isinstance(v, (int, float)):
            return "-"
        return f"{v:.6g}"

    for r in (doc.get("features") or []) + (doc.get("clusters") or []):
        if r.get("verdict") == "noise" and len(rows) > 40:
            continue  # past 40 rows only signal; the counts sum the noise
        rows.append([str(r.get("name", "?"))[:48], fmt(r.get("value")),
                     fmt(r.get("baseline")), fmt(r.get("ratio")),
                     str(r.get("verdict", "?")),
                     str(r.get("reason", ""))[:60]])
    rows[1:] = sorted(
        rows[1:],
        key=lambda r: ("regressed", "improved", "noise").index(r[4])
        if r[4] in VERDICTS else 3)
    from sofa_tpu_torch.telemetry import _table

    lines += _table(rows)
    counts = doc.get("counts") or {}
    lines.append("")
    lines.append(
        f"verdict: {doc.get('verdict', '?').upper()} — "
        + ", ".join(f"{counts.get(v, 0)} {v}" for v in VERDICTS))
    return lines


# ---------------------------------------------------------------------------
# The verb.
# ---------------------------------------------------------------------------

def sofa_regress(cfg, run_arg: str, base_arg: str = "") -> int:
    """``regress <run> [<baseline>] [--rolling N --pct P]`` — exit 0
    noise/improved, 1 regressed, 2 usage errors."""
    from sofa_tpu_torch import telemetry

    root = resolve_root(cfg)
    store = ArchiveStore(root)
    if not run_arg:
        print_error("regress needs a run: `regress <logdir-or-run-id> "
                    "[<baseline>]` (or --rolling N for a catalog baseline)")
        return 2
    run = resolve_side(store, run_arg)
    if run is None:
        print_error(f"regress: {run_arg!r} is neither a logdir nor a "
                    f"unique archived run id (archive: {root})")
        return 2
    rolling = int(getattr(cfg, "regress_rolling", 0) or 0)
    base: "Optional[_Side]" = None
    if base_arg:
        base = resolve_side(store, base_arg)
        if base is None:
            print_error(f"regress: baseline {base_arg!r} is neither a "
                        "logdir nor a unique archived run id")
            return 2
    elif rolling <= 0:
        print_error("regress needs a baseline: a second run argument, or "
                    "--rolling N to compare against the last N archived "
                    "runs")
        return 2
    elif not store.exists:
        print_error(f"regress --rolling: no archive at {root} — "
                    "`archive <logdir>` some runs first")
        return 2
    if not run.features:
        print_warning(f"regress: {run.label} has no features "
                      "(features.csv missing — run `analyze` / "
                      "`report` before archiving); every verdict "
                      "will be noise")

    pct = float(getattr(cfg, "regress_pct", 50.0) or 50.0)
    threshold = float(getattr(cfg, "regress_threshold", 10.0) or 10.0)
    mode = ({"mode": "rolling", "rolling": rolling, "pct": pct,
             "threshold_pct": threshold} if base is None
            else {"threshold_pct": threshold})

    tel = None
    out_dir = run_arg if os.path.isdir(run_arg) else root
    if os.path.isdir(run_arg):
        tel = telemetry.begin("regress")
    try:
        with telemetry.maybe_span("regress_verdict", cat="stage"):
            features = compare_features(run, base, store, rolling, pct,
                                        threshold)
            clusters = compare_clusters(run, base, threshold) \
                if base is not None else []
            doc = build_verdict_doc(run, base, mode, features, clusters)
            out_path = os.path.join(out_dir, VERDICT_NAME)
            write_verdict(doc, out_path)
        if tel is not None:
            tel.set_meta(regress={"verdict": doc["verdict"],
                                  "counts": doc["counts"],
                                  "out": out_path})
            tel.write(run_arg, rc=0 if doc["verdict"] != "regressed"
                      else 1, cfg=cfg)
    finally:
        if tel is not None:
            telemetry.end(tel)
    print_title(
        f"regression verdict — {run.label} vs "
        + (base.label if base is not None
           else f"rolling p{pct:g} of last {rolling}"))
    print("\n".join(render_verdict(doc)))
    print_progress(f"regress: wrote {out_path}")
    return 1 if doc["verdict"] == "regressed" else 0
