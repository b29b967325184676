"""The port's ``whatif`` (``sofa_tpu_torch/whatif/``) against the JAX
package's ``sofa_tpu/whatif/``: the same seeded step timeline, in the
shared schema (``gputrace``/``gpusteps`` here, ``tputrace``/``tpusteps``
there), gives the same model frame, the same replay for every scenario
kind (to 1e-12 relative) and the same calibration verdict; the report
passes both packages' validators.  Then the verb: its exit codes,
``meta.whatif``, the ``[whatif]`` hints, ``clean``, and the ``whatif``
stage through a SIGKILL and ``resume``."""

import importlib.util
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu.whatif import calibrate as jax_calibrate
from sofa_tpu.whatif import model as jax_model
from sofa_tpu.whatif import replay as jax_replay
from sofa_tpu.whatif import scenarios as jax_scenarios
from sofa_tpu_torch import durability, telemetry
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.tools.manifest_check import (validate_manifest,
                                                 validate_whatif)
from sofa_tpu_torch.trace import make_frame, write_csv
from sofa_tpu_torch.whatif import (REPORT_NAME, run_whatif, sofa_whatif,
                                   whatif_hints)
from sofa_tpu_torch.whatif import calibrate, model, replay, scenarios

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["aten::mm", "sofa_flash_fwd", "sofa_flash_bwd_kv",
           "aten::cudnn_convolution", ""]


def jax_mc():
    spec = importlib.util.spec_from_file_location(
        "jax_manifest_check", os.path.join(REPO, "tools",
                                           "manifest_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timeline(seed=0, n_dev=2, n_steps=10, jitter=0.2):
    """Seeded per-device steps: kernels of five classes (one unclassed,
    named by its kernel), some overlapping each other, an all-reduce and
    an all-gather partly hidden under compute, and a gap."""
    rng = np.random.default_rng(seed)
    ops, steps = [], []
    for dev in range(n_dev):
        t = 0.0
        for s in range(n_steps):
            t0 = t
            for cls in CLASSES:
                d = float(0.002 * (1 + jitter * rng.random()))
                ops.append({"timestamp": t, "duration": d, "deviceId": dev,
                            "category": 0, "copyKind": 0,
                            "name": f"kern_{cls or 'x'}",
                            "hlo_category": cls, "device_kind": "gpu"})
                t += d * float(rng.uniform(0.7, 1.0))   # some overlap
            for kind, name in ((20, "nccl:all_reduce"),
                               (21, "nccl:all_gather")):
                d = float(0.001 * (1 + rng.random()))
                ops.append({"timestamp": t - 0.0005, "duration": d,
                            "deviceId": dev, "category": 0,
                            "copyKind": kind, "name": "ncclDevKernel",
                            "hlo_category": name, "device_kind": "gpu"})
                t += d
            t += float(0.001 * rng.random())            # the gap
            steps.append({"timestamp": t0, "duration": t - t0,
                          "deviceId": dev, "event": float(s),
                          "name": f"sofa_step_{s}", "device_kind": "gpu"})
            t += 0.0005
    return {"gputrace": make_frame(ops), "gpusteps": make_frame(steps)}


def jax_frames(frames):
    return {"tputrace": jax_make_frame(frames["gputrace"].to_dict(
        "records")), "tpusteps": jax_make_frame(frames["gpusteps"].to_dict(
            "records"))}


def write_logdir(d, frames, sol=True):
    os.makedirs(d, exist_ok=True)
    for name, df in frames.items():
        write_csv(df, os.path.join(d, f"{name}.csv"))
    with open(os.path.join(d, "misc.txt"), "w") as f:
        f.write("elapsed_time 0.5\ncores 2\npid 1\nrc 0\n")
    if sol:
        rows = [{"deviceId": dev, "hlo_category": cls, "time": 1.0,
                 "sol_time": f} for dev in (0, 1)
                for cls, f in (("aten::mm", 0.25), ("sofa_flash_fwd", 0.5),
                               ("aten::cudnn_convolution", 2.0))]
        pd.DataFrame(rows).to_csv(os.path.join(d, "sol_roofline.csv"),
                                  index=False)


@pytest.fixture
def logdir(tmp_path):
    d = str(tmp_path / "run") + "/"
    write_logdir(d, timeline())
    return d


# --- the model, the replay, the calibration against the JAX package --------

ROI = [None, (0.005, 0.09)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("roi", ROI, ids=["whole", "roi"])
def test_model_frame_equals_jax(seed, roi):
    frames = timeline(seed)
    cfg, jcfg = SofaConfig(), JaxConfig()
    if roi:
        cfg.roi_begin = jcfg.roi_begin = roi[0]
        cfg.roi_end = jcfg.roi_end = roi[1]
    got = model.build_model(frames, cfg)
    want = jax_model.build_model(jax_frames(frames), jcfg)
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, want)
    # the components sum to each step exactly
    per = got.groupby(["deviceId", "step"]).agg(
        dur=("dur", "first"), s=("seconds", "sum"))
    assert np.allclose(per["dur"], per["s"], rtol=1e-12, atol=0)


SPECS = ["", "overlap:*", "overlap:nccl:all_reduce", "scale:aten::mm=0.5",
         "scale:*=sol", "scale:sofa_flash_*=sol", "link:2", "batch:1.5",
         "overlap:*,scale:*=sol,link:4", "scale:nothing=2,bogus:1",
         "scale:*=abc,link:0"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("with_sol", [True, False], ids=["sol", "no_sol"])
def test_replay_equals_jax_for_every_scenario_kind(tmp_path, spec, with_sol):
    frames = timeline(4)
    d = str(tmp_path / "run") + "/"
    write_logdir(d, frames, sol=with_sol)
    sol = replay.load_sol_table(SofaConfig(logdir=d))
    jsol = jax_replay.load_sol_table(JaxConfig(logdir=d))
    assert sol == jsol and bool(sol) == with_sol
    m = model.build_model(frames, SofaConfig())
    jm = jax_model.build_model(jax_frames(frames), JaxConfig())
    sc, probs = scenarios.parse_scenarios(spec)
    jsc, jprobs = jax_scenarios.parse_scenarios(spec)
    assert [(s.kind, s.spec, s.pattern, s.factor, s.problem) for s in sc] \
        == [(s.kind, s.spec, s.pattern, s.factor, s.problem) for s in jsc]
    assert probs == jprobs
    got = replay.replay(m, sc, sol)
    want = jax_replay.replay(jm, jsc, jsol)
    for key in ("mean_measured_s", "mean_predicted_s"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)
    assert got["steps"] == want["steps"]
    assert len(got["attribution"]) == len(want["attribution"])
    for a, b in zip(got["attribution"], want["attribution"]):
        # the one difference is the verb's name in the degradation note
        assert {k: v for k, v in a.items() if k != "note"} == \
            {k: v for k, v in b.items() if k != "note"}
        assert ("note" in a) == ("note" in b)
    assert replay.measured_step_times(m) == \
        jax_replay.measured_step_times(jm)


@pytest.mark.parametrize("n,damage", [(10, 0.0), (10, 0.5), (4, 0.0),
                                      (0, 0.0), (7, 1e-9)])
def test_calibration_verdict_equals_jax(n, damage):
    rng = np.random.default_rng(n)
    measured = list(0.05 + 0.005 * rng.random(n))
    identity = (sum(measured) / n) * (1 + damage) if n else 0.0
    got = calibrate.calibration(measured, identity)
    want = jax_calibrate.calibration(measured, identity)
    # the frame a reason names is the port's
    want["reason"] = want["reason"].replace("tpusteps", "gpusteps")
    assert got == want
    assert calibrate.error_bars(got, 0.04) == \
        jax_calibrate.error_bars(want, 0.04)
    assert calibrate.median_ci(measured) == \
        __import__("sofa_tpu.archive.baseline", fromlist=["x"]).median_ci(
            measured)
    assert calibrate.MIN_CI_SAMPLES == 6


# --- the report and the verb ---------------------------------------------------

def test_report_passes_both_validators(logdir):
    doc = run_whatif(SofaConfig(logdir=logdir,
                                whatif_apply="overlap:*,scale:*=sol,oops:1"))
    assert validate_whatif(doc) == [] == jax_mc().validate_whatif(doc)
    assert doc["calibration"]["verdict"] == "calibrated"
    assert doc["scenarios"][-1]["status"] == "unknown"
    with open(os.path.join(logdir, REPORT_NAME)) as f:
        assert json.load(f) == doc
    bad = dict(doc, schema="nope")
    assert validate_whatif(bad) and jax_mc().validate_whatif(bad)


def test_verb_exit_codes_and_meta(logdir, tmp_path, capsys):
    from sofa_tpu_torch.cli import main

    assert main(["whatif", logdir, "--apply", "overlap:*,scale:*=sol"]) == 0
    out = capsys.readouterr().out
    assert "identity gate" in out and "calibrated" in out
    doc = telemetry.load_manifest(logdir)
    meta = doc["meta"]["whatif"]
    assert meta["verdict"] == "calibrated" and meta["scenarios"] == 2
    assert validate_manifest(doc) == [] == jax_mc().validate_manifest(doc)
    assert validate_manifest(doc, require_healthy=True) == []
    # too few steps: uncalibrated, exit 1, and unhealthy by the validator
    short = str(tmp_path / "short") + "/"
    write_logdir(short, timeline(n_dev=1, n_steps=3))
    assert main(["whatif", short]) == 1
    doc = telemetry.load_manifest(short)
    assert doc["meta"]["whatif"]["verdict"] == "uncalibrated"
    assert any("uncalibrated" in p for p in
               validate_manifest(doc, require_healthy=True))
    assert main(["whatif", str(tmp_path / "missing")]) == 2
    # the manifest check over the logdir validates the report too
    from sofa_tpu_torch.tools.manifest_check import main as mc_main

    assert mc_main([logdir]) == 0
    with open(os.path.join(logdir, REPORT_NAME), "w") as f:
        json.dump({"schema": "x"}, f)
    assert mc_main([logdir]) == 1


def test_fsck_is_clean_after_whatif(logdir):
    cfg = SofaConfig(logdir=logdir)
    durability.write_digests(logdir)
    assert sofa_whatif(cfg) == 0
    assert durability.sofa_fsck(cfg) == 0
    assert sofa_whatif(cfg) == 0        # rewrites its report
    assert durability.sofa_fsck(cfg) == 0


def test_hints_rank_the_payoffs(logdir):
    doc = run_whatif(SofaConfig(logdir=logdir,
                                whatif_apply="link:2,scale:*=sol,batch:1"))
    hints = whatif_hints(doc)
    pcts = [float(h.split("by ")[1].split("%")[0]) for h in hints]
    assert pcts == sorted(pcts, reverse=True) and hints[0].startswith(
        "[whatif] scale:*=sol")


def test_the_pass_writes_the_model_and_the_payoffs(logdir):
    from sofa_tpu_torch.analysis.features import Features
    from sofa_tpu_torch.analysis.registry import get, load_builtin_passes

    load_builtin_passes()
    spec = get("whatif_model")
    assert spec.reads_frames == ("gpusteps", "gputrace")
    assert spec.reads_features == ("gpu*_sol_distance",)
    f = Features()
    frames = timeline()
    spec.fn(frames, SofaConfig(logdir=logdir), f)
    got = pd.read_csv(os.path.join(logdir, "whatif_model.csv"))
    assert len(got) == len(model.build_model(frames, SofaConfig()))
    assert f.get("whatif_steps") == 20
    assert f.get("whatif_identity_error_pct") == pytest.approx(0, abs=1e-9)
    assert f.get("whatif_sol_payoff_pct") > 0
    assert f.get("whatif_overlap_payoff_pct") >= 0


def test_clean_removes_the_whatif_artifacts(logdir):
    from sofa_tpu_torch.record import sofa_clean

    cfg = SofaConfig(logdir=logdir)
    assert sofa_whatif(cfg) == 0
    with open(cfg.path("whatif_model.csv"), "w") as f:
        f.write("x\n")
    sofa_clean(cfg)
    assert not os.path.exists(cfg.path(REPORT_NAME))
    assert not os.path.exists(cfg.path("whatif_model.csv"))
    assert os.path.exists(cfg.path("misc.txt"))


_KILL_WHATIF = """
import os, signal, sys
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.whatif import replay, sofa_whatif
def boom(*a, **kw):
    os.kill(os.getpid(), signal.SIGKILL)
replay.load_sol_table = boom
sofa_whatif(SofaConfig(logdir=sys.argv[1], whatif_apply=sys.argv[2]))
"""


def test_the_whatif_stage_survives_a_sigkill_and_resume(logdir):
    """whatif killed mid-replay: the journal's whatif stage is begun, not
    committed; resume replays it with the --apply of its begin entry."""
    from sofa_tpu_torch.durability import journal_state, read_journal

    r = subprocess.run([sys.executable, "-c", _KILL_WHATIF, logdir,
                        "overlap:*,link:2"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    state = journal_state(read_journal(logdir))
    assert not state["whatif"]["committed"]
    assert not os.path.exists(os.path.join(logdir, REPORT_NAME))
    cfg = SofaConfig(logdir=logdir)         # no --apply: the journal's
    assert durability.sofa_resume(cfg) == 0
    with open(os.path.join(logdir, REPORT_NAME)) as f:
        doc = json.load(f)
    assert [s["spec"] for s in doc["scenarios"]] == ["overlap:*", "link:2"]
    assert journal_state(read_journal(logdir))["whatif"]["committed"]
    assert durability.sofa_fsck(cfg) == 0
    assert durability.sofa_resume(SofaConfig(logdir=logdir)) == 0
