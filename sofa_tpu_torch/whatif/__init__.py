"""``whatif``: predict what a fix would pay, from the capture alone (the
JAX package's ``sofa_tpu/whatif/``).

    python -m sofa_tpu_torch whatif LOGDIR --apply overlap:*,scale:*=sol

The captured run is re-timed under typed scenario edits and the step
time predicted analytically:

  model.py      each device step decomposed into compute, exposed
                collective and gap, summing to the measured step exactly;
                also the ``whatif_model`` analysis pass
  scenarios.py  the scenario vocabulary and its parser
  replay.py     the re-timing, with each scenario's share of the saving
  calibrate.py  error bars from the run's own step-time spread, and the
                zero-scenario identity gate

Outputs: ``whatif_report.json`` (schema ``sofa_tpu/whatif_report`` v1,
which ``tools/manifest_check.py`` validates), a table, ``[whatif]`` hint
lines, ``meta.whatif`` in the run manifest, and the board's whatif.html.
The verb journals a ``whatif`` stage (its ``--apply`` on the begin line),
which ``resume`` replays.  Exit 0 calibrated, 1 uncalibrated (the gate
failed, or too few steps for a defensible interval), 2 nothing to replay
(no logdir).
"""

from __future__ import annotations

import json
import os
import time
from typing import List

WHATIF_SCHEMA = "sofa_tpu/whatif_report"
WHATIF_VERSION = 1
REPORT_NAME = "whatif_report.json"


def build_report(calib: dict, scenarios, problems: List[str],
                 result: dict) -> dict:
    """The schema-versioned report document."""
    from sofa_tpu_torch.whatif.calibrate import error_bars

    predicted = result["mean_predicted_s"]
    measured = result["mean_measured_s"]
    return {
        "schema": WHATIF_SCHEMA,
        "version": WHATIF_VERSION,
        "generated_unix": round(time.time(), 3),
        "calibration": calib,
        "scenarios": [{
            "spec": s.spec, "kind": s.kind, "pattern": s.pattern,
            "factor": s.factor,
            "status": "parsed" if s.known else "unknown",
            **({"problem": s.problem} if s.problem else {}),
        } for s in scenarios],
        "problems": list(problems),
        "predicted": {
            "step_time_mean_s": round(predicted, 9),
            "speedup": round(measured / predicted, 6)
            if predicted > 0 else None,
            "error_bars": error_bars(calib, predicted),
            "attribution": result["attribution"],
        },
        "steps": result["steps"],
    }


def render_report(doc: dict) -> List[str]:
    """The table printed beside the JSON."""
    lines: List[str] = []
    calib = doc.get("calibration") or {}
    pred = doc.get("predicted") or {}
    lines.append(f"{'steps':<26} {calib.get('n_steps', 0)}")
    if calib.get("measured_mean_s") is not None:
        lines.append(f"{'measured mean step':<26} "
                     f"{calib['measured_mean_s'] * 1e3:.3f} ms")
    if calib.get("ci"):
        lo, hi = calib["ci"]
        lines.append(f"{'measured median 95% CI':<26} "
                     f"[{lo * 1e3:.3f}, {hi * 1e3:.3f}] ms")
    lines.append(f"{'identity gate':<26} {calib.get('verdict', '?')}"
                 f" — {calib.get('reason', '')}")
    mean = pred.get("step_time_mean_s")
    if mean is not None:
        bars = pred.get("error_bars")
        tail = (f"  ± [{bars[0] * 1e3:.3f}, {bars[1] * 1e3:.3f}] ms"
                if bars else "  (no error bars: run too short)")
        lines.append(f"{'predicted mean step':<26} {mean * 1e3:.3f} ms"
                     + tail)
    if pred.get("speedup") is not None:
        lines.append(f"{'predicted speedup':<26} {pred['speedup']:.3f}x")
    att = pred.get("attribution") or []
    if att:
        lines.append("")
        lines.append(f"{'scenario':<30} {'status':<9} {'saving':>12} "
                     f"{'of step':>8}")
        for a in att:
            lines.append(
                f"{a['scenario']:<30} {a['status']:<9} "
                f"{a['delta_s'] * 1e3:>10.3f}ms "
                f"{a['delta_pct']:>7.2f}%"
                + (f"  ({a['note']})" if a.get("note") else ""))
    for p in doc.get("problems") or []:
        lines.append(f"problem: {p}")
    return lines


def run_whatif(cfg, frames=None, apply_spec: "str | None" = None) -> dict:
    """The replay without the verb around it: frames -> the report
    document, written to ``whatif_report.json``."""
    from sofa_tpu_torch.preprocess import load_frames
    from sofa_tpu_torch.trace import atomic_write
    from sofa_tpu_torch.whatif.calibrate import calibration
    from sofa_tpu_torch.whatif.model import build_model
    from sofa_tpu_torch.whatif.replay import (load_sol_table,
                                              measured_step_times, replay)
    from sofa_tpu_torch.whatif.scenarios import parse_scenarios

    if frames is None:
        frames = load_frames(cfg, only=("gpusteps", "gputrace"))
    model = build_model(frames, cfg)
    spec = cfg.whatif_apply if apply_spec is None else apply_spec
    scenarios, problems = parse_scenarios(spec)
    sol = load_sol_table(cfg)
    identity = replay(model, [])
    calib = calibration(measured_step_times(model),
                        identity["mean_predicted_s"])
    result = replay(model, scenarios, sol)
    doc = build_report(calib, scenarios, problems, result)
    os.makedirs(cfg.logdir, exist_ok=True)
    with atomic_write(cfg.path(REPORT_NAME)) as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def sofa_whatif(cfg) -> int:
    """``whatif LOGDIR [--apply s1,s2,...]``: exit 0 calibrated, 1
    uncalibrated, 2 nothing to replay.  Journaled (``whatif`` stage) and
    recorded (``meta.whatif``); the digests are refreshed before the
    commit, as after every verb that writes into a logdir."""
    from sofa_tpu_torch import durability, telemetry
    from sofa_tpu_torch.printing import (print_error, print_hint,
                                         print_progress, print_title,
                                         print_warning)
    from sofa_tpu_torch.trace import reap_stale_sentinel

    if not os.path.isdir(cfg.logdir):
        print_error(f"whatif: logdir {cfg.logdir} does not exist")
        return 2
    if cfg.profile_region:
        try:
            begin_s, _, end_s = cfg.profile_region.partition(":")
            cfg.roi_begin = float(begin_s or 0)
            cfg.roi_end = float(end_s or 0)
        except ValueError:
            print_warning(
                f"bad --profile_region {cfg.profile_region!r}; ignoring")
    reap_stale_sentinel(cfg.logdir)
    tel = telemetry.begin("whatif")
    journal = durability.Journal(cfg.logdir)
    journal.begin("whatif", key=durability.logdir_raw_key(cfg.logdir),
                  apply=cfg.whatif_apply)
    rc = 2
    try:
        with tel.span("whatif_replay", cat="stage"):
            doc = run_whatif(cfg)
        calib = doc["calibration"]
        rc = 0 if calib.get("verdict") == "calibrated" else 1
        tel.set_meta(whatif={
            "report": REPORT_NAME,
            "verdict": calib.get("verdict"),
            "identity_error_pct": calib.get("identity_error_pct", 0.0),
            "n_steps": calib.get("n_steps", 0),
            "scenarios": len(doc["scenarios"]),
            "predicted_step_time_s":
                doc["predicted"]["step_time_mean_s"],
        })
        print_title("What-if replay — predicted step time (no hardware)")
        print("\n".join(render_report(doc)))
        for hint in whatif_hints(doc):
            print_hint(hint)
        print_progress(f"whatif: wrote {cfg.path(REPORT_NAME)}")
    finally:
        tel.write(cfg.logdir, rc=rc, cfg=cfg)
        telemetry.end(tel)
    durability.write_digests(cfg.logdir)
    journal.commit("whatif", key=durability.logdir_raw_key(cfg.logdir),
                   rc=rc)
    return rc


def whatif_hints(doc: dict) -> List[str]:
    """``[whatif]`` lines ranking the top predicted payoffs, the largest
    saving first."""
    att = (doc.get("predicted") or {}).get("attribution") or []
    ranked = sorted((a for a in att if a.get("status") == "applied"
                     and a.get("delta_pct", 0) >= 0.05),
                    key=lambda a: -a["delta_pct"])
    return [f"[whatif] {a['scenario']}: predicted to cut mean step time "
            f"by {a['delta_pct']:.1f}% ({a['delta_s'] * 1e3:.3f} ms)"
            for a in ranked[:3]]
