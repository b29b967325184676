"""Deterministic analytical replay of the step-timeline model (the JAX
package's ``sofa_tpu/whatif/replay.py``).

Given the component model (``whatif/model.py``) and the parsed scenarios
(``whatif/scenarios.py``), every step is re-timed under the composed
edits, in their declared order; each scenario's attribution is the change
in mean step time it caused on top of those before it, so the deltas sum
to the total predicted saving.  Plain dictionary arithmetic over (device,
step) states: no pool, no randomness, no clock, so the zero-scenario
identity gate (``whatif/calibrate.py``) measures the model alone.
"""

from __future__ import annotations

import os
from fnmatch import fnmatchcase
from typing import Dict, List, Optional, Tuple

import pandas as pd

from sofa_tpu_torch.whatif.scenarios import SOL, Scenario


class _Step:
    """Mutable component state of one (device, step) during a replay."""

    __slots__ = ("t0", "dur", "compute", "collective", "gap")

    def __init__(self, t0: float, dur: float, compute: Dict[str, float],
                 collective: Dict[str, float], gap: float):
        self.t0 = t0
        self.dur = dur
        self.compute = compute
        self.collective = collective
        self.gap = gap

    def predicted(self) -> float:
        return (sum(self.compute.values())
                + sum(self.collective.values()) + self.gap)


def _states(model: pd.DataFrame) -> "Dict[Tuple[int, float], _Step]":
    states: Dict[Tuple[int, float], _Step] = {}
    for row in model.itertuples(index=False):
        key = (int(row.deviceId), float(row.step))
        st = states.get(key)
        if st is None:
            st = states[key] = _Step(float(row.t0), float(row.dur), {}, {},
                                     0.0)
        if row.kind == "compute":
            st.compute[str(row.cls)] = st.compute.get(str(row.cls), 0.0) \
                + float(row.seconds)
        elif row.kind == "collective":
            st.collective[str(row.cls)] = \
                st.collective.get(str(row.cls), 0.0) + float(row.seconds)
        else:
            st.gap += float(row.seconds)
    return states


def measured_step_times(model: pd.DataFrame) -> List[float]:
    """Measured per-step durations in canonical (device, step) order."""
    if model.empty:
        return []
    per = model.drop_duplicates(["deviceId", "step"]) \
        .sort_values(["deviceId", "step"])
    return [float(v) for v in per["dur"]]


def measured_mean(model: pd.DataFrame) -> float:
    times = measured_step_times(model)
    return sum(times) / len(times) if times else 0.0


def load_sol_table(cfg) -> "Dict[Tuple[int, str], float]":
    """(deviceId, class) -> speed-of-light scale factor (attainable time
    over measured time, <= 1) from the ``sol_roofline`` pass's
    ``sol_roofline.csv``; empty when the pass has not run (then
    ``scale:*=sol`` degrades to factor 1 with a stated reason)."""
    path = cfg.path("sol_roofline.csv")
    if not os.path.isfile(path):
        return {}
    try:
        table = pd.read_csv(path)
    except (OSError, ValueError):
        return {}
    needed = {"deviceId", "hlo_category", "time", "sol_time"}
    if not needed.issubset(table.columns):
        return {}
    out: Dict[Tuple[int, str], float] = {}
    for row in table.itertuples(index=False):
        t = float(row.time)
        sol = float(row.sol_time)
        if t > 0 and sol > 0:
            out[(int(row.deviceId), str(row.hlo_category).lower())] = \
                min(sol / t, 1.0)
    return out


def _match(cls: str, pattern: str) -> bool:
    return fnmatchcase(cls.lower(), pattern.lower())


def _apply(states: "Dict[Tuple[int, float], _Step]", s: Scenario,
           sol: "Dict[Tuple[int, str], float]") -> "Tuple[float, str]":
    """Mutate every step state under one scenario.  Returns (matched
    seconds touched, degradation note or '')."""
    matched = 0.0
    note = ""
    if s.kind == "scale" and s.factor == SOL and not sol:
        return 0.0, ("no sol_roofline.csv in this logdir — run "
                     "`analyze` first; sol scaling degraded to "
                     "factor 1")
    for (device_id, _step), st in sorted(states.items()):
        if s.kind == "scale":
            for cls in sorted(st.compute):
                if not _match(cls, s.pattern):
                    continue
                f = (sol.get((device_id, cls), 1.0)
                     if s.factor == SOL else float(s.factor))
                matched += st.compute[cls]
                st.compute[cls] *= f
        elif s.kind == "batch":
            for cls in sorted(st.compute):
                matched += st.compute[cls]
                st.compute[cls] *= float(s.factor)
        elif s.kind == "link":
            for cls in sorted(st.collective):
                matched += st.collective[cls]
                st.collective[cls] /= float(s.factor)
        elif s.kind == "overlap":
            # A collective can hide behind concurrent compute, bounded by
            # the compute actually in the step (post any scale/batch edits
            # applied before this scenario — declared order is semantic).
            capacity = sum(st.compute.values())
            for cls in sorted(st.collective):
                if not _match(cls, s.pattern):
                    continue
                hide = min(capacity, st.collective[cls])
                matched += st.collective[cls]
                st.collective[cls] -= hide
                capacity -= hide
    return matched, note


def replay(model: pd.DataFrame, scenarios: List[Scenario],
           sol: "Optional[Dict[Tuple[int, str], float]]" = None) -> dict:
    """Re-time the model under the composed scenarios.

    Returns a dict with ``mean_measured_s``, ``mean_predicted_s``,
    ``attribution`` (one entry per scenario, declared order, marginal
    mean-step-time delta — unknown scenarios ride along with status
    ``unknown`` and delta 0), and ``steps`` (per device/step measured vs
    predicted, for the board overlay and the report)."""
    sol = sol or {}
    states = _states(model)
    n = len(states)
    mean0 = (sum(st.dur for st in states.values()) / n) if n else 0.0
    prev = mean0
    attribution: List[dict] = []
    for s in scenarios:
        if not s.known:
            attribution.append({
                "scenario": s.spec, "status": "unknown",
                "note": s.problem, "delta_s": 0.0, "delta_pct": 0.0,
                "matched_s": 0.0,
            })
            continue
        matched, note = _apply(states, s, sol)
        mean_now = (sum(st.predicted() for st in states.values()) / n) \
            if n else 0.0
        delta = prev - mean_now
        entry = {
            "scenario": s.spec,
            "status": "applied" if matched > 0 else "no_match",
            "delta_s": round(delta, 9),
            "delta_pct": round(100.0 * delta / mean0, 6) if mean0 else 0.0,
            "matched_s": round(matched, 9),
        }
        if note:
            entry["note"] = note
        attribution.append(entry)
        prev = mean_now
    steps = [{
        "deviceId": key[0], "step": key[1], "t0": round(st.t0, 9),
        "measured_s": round(st.dur, 9),
        "predicted_s": round(st.predicted(), 9),
    } for key, st in sorted(states.items())]
    return {
        "mean_measured_s": mean0,
        "mean_predicted_s": prev,
        "attribution": attribution,
        "steps": steps,
    }
