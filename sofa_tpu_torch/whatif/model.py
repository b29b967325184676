"""Step-timeline model extraction: the frame the replayer re-times (the
JAX package's ``sofa_tpu/whatif/model.py`` over the CUDA trace).

For every device step span (``gpusteps``, the spans AISI and the
step-skew pass read) the kernels decompose into three kinds whose seconds
sum to the measured step exactly:

  compute     kernel time that is not a collective (interval union), split
              per class so that ``scale:`` scenarios can target classes
  collective  collective kernel time NOT hidden under compute (the exposed
              part, what ``overlap:`` and ``link:`` shrink), per class
  gap         step time with no kernel at all (host or input stalls: no
              scenario touches it)

A class is the kernel's ``hlo_category``: the aten op that launched it or
the flash kernel's cost range (``ingest/kineto.py``), else its name.

That exactness is the calibration's foundation: replaying the model with
no scenario reproduces the measured steps, so an identity error measures
damage to the model, not arithmetic (``whatif/calibrate.py`` gates on
it).  The extraction is the ``whatif_model`` analysis pass, which also
prices the two canonical scenarios (``overlap:*`` and ``scale:*=sol``)
into the ``whatif_*_payoff_pct`` features that the ``[whatif]`` hints
rank.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd

from sofa_tpu_torch.analysis.device import (_intersect_intervals,
                                            _union_coverage)
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import analysis_pass
from sofa_tpu_torch.trace import (merged_intervals, narrow, roi_bounds,
                                  roi_clip)

#: The model artifact (`sofa clean` removes it with the report).
MODEL_NAME = "whatif_model.csv"

#: Component vocabulary, in canonical row order.
COMPONENT_KINDS = ("compute", "collective", "gap")

#: Model-frame columns (long format, one row per device/step/kind/class).
MODEL_COLUMNS = ("deviceId", "step", "t0", "dur", "kind", "cls", "seconds")

_UNCLASSIFIED = "uncategorized"


def _class_of(hlo_category: pd.Series, name: pd.Series) -> pd.Series:
    """Component class: the kernel's ``hlo_category`` (its launching op
    or cost range), else its name, else ``uncategorized`` — what scenario
    patterns match."""
    cls = hlo_category.astype(str)
    cls = cls.where(cls != "", name.astype(str))
    return cls.where(cls != "", _UNCLASSIFIED).str.lower()


def _class_unions(rows: pd.DataFrame) -> "Dict[str, np.ndarray]":
    out: Dict[str, np.ndarray] = {}
    for cls, sel in rows.groupby("cls", sort=True):
        out[str(cls)] = merged_intervals(
            sel["timestamp"].to_numpy(float),
            (sel["timestamp"] + sel["duration"]).to_numpy(float))
    return out


def _normalized(per_cls: "Dict[str, np.ndarray]",
                total: np.ndarray) -> "Dict[str, np.ndarray]":
    """Rescale per-class coverage so the classes sum exactly to the
    step-level total — per-class unions may overlap each other, and the
    identity (components sum == step duration) is the calibration
    contract, so the step total is authoritative."""
    if not per_cls:
        return {}
    stack = np.vstack([per_cls[c] for c in sorted(per_cls)])
    sums = stack.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(sums > 0, total / np.where(sums > 0, sums, 1.0),
                         0.0)
    return {c: np.maximum(per_cls[c] * scale, 0.0)
            for c in sorted(per_cls)}


def build_model(frames, cfg) -> pd.DataFrame:
    """The long-format component table (MODEL_COLUMNS) for every device
    step span; empty frame when there are no usable steps.  Deterministic:
    canonical (deviceId, step, kind, cls) row order, independent of pool
    width — the whole build is plain column math."""
    steps = frames.get("gpusteps") if frames else None
    ops = frames.get("gputrace") if frames else None
    empty = pd.DataFrame(columns=list(MODEL_COLUMNS))
    if steps is None or steps.empty:
        return empty
    steps = roi_clip(steps, cfg)
    if steps.empty:
        return empty
    if ops is None or ops.empty:
        ops = pd.DataFrame(columns=["timestamp", "duration", "deviceId",
                                    "category", "copyKind", "name",
                                    "hlo_category"])
    else:
        ops = narrow(ops, ["timestamp", "duration", "deviceId", "category",
                           "copyKind", "name", "hlo_category"])
        ops = roi_clip(ops, cfg)
    bounds = roi_bounds(cfg)

    rows: List[dict] = []
    for device_id, dev_steps in steps.groupby("deviceId"):
        dev_steps = dev_steps.sort_values("timestamp")
        t0s = dev_steps["timestamp"].to_numpy(float)
        t1s = t0s + dev_steps["duration"].to_numpy(float)
        if bounds is not None:
            # ROI-straddling steps keep only their in-window portion so
            # the clipped-away ops cannot read as phantom gap.
            t0s = np.maximum(t0s, bounds[0])
            t1s = np.minimum(t1s, bounds[1])
        # Step identity: the ingest's step number (event) when it is
        # distinct per span, else the per-device ordinal — the model must
        # never collapse different spans into one step.
        ev = dev_steps["event"].to_numpy(float)
        step_ids = (ev if len(np.unique(ev)) == len(ev)
                    else np.arange(len(ev), dtype=float))

        dev_ops = ops[ops["deviceId"] == device_id]
        sync = dev_ops[dev_ops["category"] == 0]
        comp = sync[sync["copyKind"] < 20].copy()
        coll = sync[sync["copyKind"] >= 20].copy()
        all_arr = merged_intervals(
            sync["timestamp"].to_numpy(float),
            (sync["timestamp"] + sync["duration"]).to_numpy(float)) \
            if not sync.empty else np.empty((0, 2))
        comp_arr = merged_intervals(
            comp["timestamp"].to_numpy(float),
            (comp["timestamp"] + comp["duration"]).to_numpy(float)) \
            if not comp.empty else np.empty((0, 2))

        busy_all = _union_coverage(all_arr, t0s, t1s)
        comp_busy = _union_coverage(comp_arr, t0s, t1s)
        coll_exposed = np.maximum(busy_all - comp_busy, 0.0)

        comp_cls: Dict[str, np.ndarray] = {}
        if not comp.empty:
            comp["cls"] = _class_of(comp["hlo_category"], comp["name"])
            comp_cls = {c: _union_coverage(arr, t0s, t1s)
                        for c, arr in _class_unions(comp).items()}
        comp_cls = _normalized(comp_cls, comp_busy)

        coll_cls: Dict[str, np.ndarray] = {}
        if not coll.empty:
            coll["cls"] = _class_of(coll["hlo_category"], coll["name"])
            for c, arr in _class_unions(coll).items():
                hidden = _intersect_intervals(arr, comp_arr)
                coll_cls[c] = np.maximum(
                    _union_coverage(arr, t0s, t1s)
                    - _union_coverage(hidden, t0s, t1s), 0.0)
        coll_cls = _normalized(coll_cls, coll_exposed)

        for i in range(len(t0s)):
            dur = t1s[i] - t0s[i]
            if dur <= 0:
                continue
            base = {"deviceId": int(device_id), "step": float(step_ids[i]),
                    "t0": float(t0s[i]), "dur": float(dur)}
            comp_total = 0.0
            for c in sorted(comp_cls):
                s = float(comp_cls[c][i])
                if s > 0:
                    rows.append({**base, "kind": "compute", "cls": c,
                                 "seconds": s})
                    comp_total += s
            coll_total = 0.0
            for c in sorted(coll_cls):
                s = float(coll_cls[c][i])
                if s > 0:
                    rows.append({**base, "kind": "collective", "cls": c,
                                 "seconds": s})
                    coll_total += s
            rows.append({**base, "kind": "gap", "cls": "",
                         "seconds": max(dur - comp_total - coll_total,
                                        0.0)})
    if not rows:
        return empty
    return pd.DataFrame(rows, columns=list(MODEL_COLUMNS))


@analysis_pass(
    name="whatif_model", order=280,
    reads_frames=("gpusteps", "gputrace"),
    reads_columns=("timestamp", "duration", "deviceId", "category",
                   "copyKind", "name", "hlo_category", "event"),
    reads_features=("gpu*_sol_distance",),
    provides_features=("whatif_steps", "whatif_step_time_mean",
                       "whatif_identity_error_pct",
                       "whatif_overlap_payoff_pct",
                       "whatif_sol_payoff_pct"),
    provides_artifacts=("whatif_model.csv",),
    after=("spotlight",),
)
def whatif_model(frames, cfg, features: Features) -> None:
    """Extract the step-timeline model, write ``whatif_model.csv``, and
    price the two canonical scenarios into payoff features.

    Runs after ``sol_roofline`` (declared via the ``gpu*_sol_distance``
    read) so the headroom table exists when ``scale:*=sol`` is priced;
    the payoff features feed the ``[whatif]`` advice rules."""
    from sofa_tpu_torch.trace import atomic_write
    from sofa_tpu_torch.whatif.replay import (load_sol_table,
                                              measured_mean, replay)
    from sofa_tpu_torch.whatif.scenarios import parse_scenarios

    model = build_model(frames, cfg)
    if model.empty:
        return
    with atomic_write(cfg.path("whatif_model.csv")) as f:
        model.to_csv(f, index=False)
    measured = measured_mean(model)
    n_steps = model.drop_duplicates(["deviceId", "step"]).shape[0]
    features.add("whatif_steps", n_steps)
    features.add("whatif_step_time_mean", measured)
    identity = replay(model, [])
    if measured > 0:
        features.add(
            "whatif_identity_error_pct",
            100.0 * abs(identity["mean_predicted_s"] - measured) / measured)
    sol = load_sol_table(cfg)
    for feat, spec in (("whatif_overlap_payoff_pct", "overlap:*"),
                       ("whatif_sol_payoff_pct", "scale:*=sol")):
        if spec.endswith("=sol") and not sol:
            continue  # no headroom table: no defensible sol payoff
        scenarios, _problems = parse_scenarios(spec)
        result = replay(model, scenarios, sol)
        if measured > 0:
            features.add(feat, 100.0 * max(
                measured - result["mean_predicted_s"], 0.0) / measured)
