"""sofa_tpu_torch's self-telemetry: the run manifest and self trace.

The manifest readers (``manifest_warnings``, ``preprocess_summary``,
``render_status``) give the JAX package's lines and exit codes on the same
documents, the ``[self]`` hints are the same in both packages' advice, and
every manifest the port writes here passes the JAX package's
``tools/manifest_check.validate_manifest`` as well as the port's own.  Then
the record side: every collector in the ledger, stops in the reverse order
of the starts, a failed launch that surfaces its own error and still leaves
the manifest, and a real CPU ``stat`` of the entry forward under a
``procmon:die@1s`` fault.  And the analyze repair: ``cpu_profile`` clips
the CPU samples to the region of interest as the JAX pass does.
"""

import copy
import json
import os
import subprocess
import sys

import pandas as pd
import pytest

from sofa_tpu import telemetry as jax_telemetry
from sofa_tpu.analysis import advice as jax_advice
from sofa_tpu.analysis import host as jax_host
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu_torch import telemetry
import sofa_tpu_torch.record as record_mod
from sofa_tpu_torch.analysis import advice, host
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.cli import main as cli_main
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import perf_script
from sofa_tpu_torch.record import build_collectors, sofa_clean, sofa_record

from test_torch_faults import jax_validator, manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = {
    "schema": "sofa_tpu/run_manifest", "schema_version": 5,
    "generated_unix": 1700000100.0,
    "env": {"sofa_tpu_version": "0.1.0"},
    "runs": {
        "record": {"started_unix": 1700000000.0, "wall_s": 12.5, "rc": 0,
                   "counters": {"warnings": 2, "errors": 0},
                   "warning_tail": []},
        "preprocess": {"started_unix": 1700000013.0, "wall_s": 3.25,
                       "rc": 0, "counters": {"warnings": 0, "errors": 0},
                       "warning_tail": []},
    },
    "collectors": {
        "timebase": {"status": "stopped", "bytes_captured": 393},
        "procmon": {"status": "stopped", "bytes_captured": 58000},
    },
    "sources": {
        "mpstat": {"status": "parsed", "cache": "miss", "wall_s": 0.2,
                   "events": 5000},
        "kineto": {"status": "cached", "cache": "hit", "wall_s": 0.06,
                   "events": 5295},
    },
    "meta": {"pool": {"jobs": 4, "cpu_count": 8}},
    "stages": [
        {"verb": "preprocess", "name": "ingest", "cat": "stage",
         "t0_unix": 1700000013.1, "dur_s": 1.5, "args": {}},
        {"verb": "preprocess", "name": "write_frames", "cat": "stage",
         "t0_unix": 1700000014.6, "dur_s": 0.5, "args": {}},
        {"verb": "preprocess", "name": "tiles", "cat": "stage",
         "t0_unix": 1700000015.1, "dur_s": 0.25, "args": {}},
        {"verb": "preprocess", "name": "report_js", "cat": "stage",
         "t0_unix": 1700000015.4, "dur_s": 0.125, "args": {}},
    ],
}


def _doc(collectors=None, sources=None, runs=None, meta=None):
    doc = copy.deepcopy(BASE)
    doc["collectors"].update(collectors or {})
    doc["sources"].update(sources or {})
    for verb, fields in (runs or {}).items():
        doc["runs"].setdefault(verb, copy.deepcopy(
            BASE["runs"]["preprocess"])).update(fields)
    doc["meta"].update(meta or {})
    return doc


DOCS = {
    "healthy": _doc(),
    "died": _doc(collectors={"procmon": {
        "status": "died", "died": True, "deaths": 1, "exit_code": -9}}),
    "restarted": _doc(collectors={"procmon": {
        "status": "stopped", "died": True, "deaths": 1, "restarts": 1}}),
    "timed_out": _doc(collectors={"kineto": {
        "status": "timed_out", "timed_out": True, "phase": "harvest"}}),
    "stop_timed_out": _doc(collectors={"vmstat": {
        "status": "timed_out", "timed_out": True, "phase": "stop",
        "exit_code": -9}}),
    "truncated_by_budget": _doc(
        collectors={"tcpdump": {"status": "truncated_by_budget",
                                "budget_bytes": 1048576, "rotated_files": 2,
                                "bytes_captured": 1048000}},
        meta={"disk_budget": {"budget_mb": None, "collector_budget_mb": 1,
                              "rotated_files": 2,
                              "truncated": ["tcpdump"]}}),
    "rotated": _doc(collectors={"vmstat": {
        "status": "stopped", "rotated_files": 3, "budget_bytes": 2048}},
        meta={"disk_budget": {"budget_mb": 4, "collector_budget_mb": None,
                              "rotated_files": 3, "truncated": []}}),
    "failed_and_killed": _doc(collectors={
        "perf": {"status": "failed", "phase": "start",
                 "error": "injected perf failure at start"},
        "blktrace": {"status": "killed"}}),
    "degraded_collector": _doc(collectors={"perf": {
        "status": "stopped", "degraded": True,
        "degraded_reason": "perf_event_paranoid=2"}}),
    "stalled": _doc(collectors={"procmon": {
        "status": "stopped", "output_stalled": True}}),
    "quarantined": _doc(sources={"kineto": {
        "status": "quarantined", "cache": "miss", "wall_s": 0.01,
        "events": 0, "error": "trace_1.json: not a JSON document",
        "quarantined_file": "/x/_quarantine/trace_1.json"}}),
    "failed_source": _doc(sources={"cputrace": {
        "status": "failed", "cache": "miss", "wall_s": 1.0, "events": 0,
        "error": "perf script timed out"}}),
    "degraded_source": _doc(sources={"nettrace": {
        "status": "degraded", "cache": "bypass", "wall_s": 0.0,
        "events": 0, "error": "bad magic"}}),
    "errors_and_rc": _doc(runs={
        "record": {"rc": 3, "counters": {"warnings": 1, "errors": 2}},
        "analyze": {"rc": 1, "counters": {"warnings": 0, "errors": 1}}}),
    "unknown_status": _doc(collectors={"x": {"status": "?"}}),
    "pass_failed": _doc(meta={"passes": {
        "schedule": [["spotlight", "boom"], ["cpu_profile"]],
        "order": ["spotlight", "cpu_profile", "boom"], "jobs": 4,
        "passes": {
            "spotlight": {"status": "ok", "origin": "builtin", "wave": 0,
                          "wall_s": 0.01},
            "cpu_profile": {"status": "ok", "origin": "builtin", "wave": 1,
                            "wall_s": 0.02},
            "boom": {"status": "failed", "origin": "plugin:boom",
                     "wave": 0, "wall_s": 0.0,
                     "error": "KeyError: 'gputrace'"},
            "gated": {"status": "skipped", "origin": "builtin",
                      "skip_reason": "enable_aisi off"}}}}),
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_manifest_readers_match_the_jax_package(name):
    doc = DOCS[name]
    assert telemetry.manifest_warnings(doc) == \
        jax_telemetry.manifest_warnings(doc)
    assert telemetry.preprocess_summary(doc) == \
        jax_telemetry.preprocess_summary(doc)
    assert telemetry.render_status(doc, "/logs/run/") == \
        jax_telemetry.render_status(doc, "/logs/run/")


def test_readers_of_documents_without_sections():
    for reader in (telemetry.manifest_warnings,
                   telemetry.preprocess_summary):
        assert reader(None) == jax_telemetry.__dict__[reader.__name__](None)
        assert reader({}) == jax_telemetry.__dict__[reader.__name__]({})
    assert telemetry.render_status({}, "d/") == \
        jax_telemetry.render_status({}, "d/")


def test_vocabularies_match_the_jax_package():
    for name in ("MANIFEST_NAME", "SELF_TRACE_NAME", "MANIFEST_SCHEMA",
                 "MANIFEST_VERSION", "COLLECTOR_STATUSES", "SOURCE_STATUSES",
                 "CACHE_OUTCOMES", "PASS_STATUSES"):
        assert getattr(telemetry, name) == getattr(jax_telemetry, name)


@pytest.mark.parametrize("name", ["died", "timed_out", "quarantined",
                                  "truncated_by_budget", "errors_and_rc"])
def test_self_hints_match_the_jax_package(tmp_path, name):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for d in ("port", "jax"):
        (tmp_path / d / "run_manifest.json").write_text(
            json.dumps(DOCS[name]))
    advice.hint_report(Features(), SofaConfig(logdir=str(tmp_path / "port")))
    jax_advice.hint_report(JaxFeatures(),
                           JaxConfig(logdir=str(tmp_path / "jax")))

    def self_lines(d):
        return [h for h in (tmp_path / d / "hints.txt").read_text()
                .splitlines() if h.startswith("[self] ")]

    assert self_lines("port") == self_lines("jax")
    assert self_lines("port")


def test_status_exit_codes(tmp_path, capsys):
    d = str(tmp_path / "run")
    os.makedirs(d)
    assert cli_main(["status", d]) == 2                # no manifest
    for name, want in (("healthy", 0), ("restarted", 0), ("quarantined", 0),
                       ("died", 1), ("timed_out", 1),
                       ("truncated_by_budget", 1)):
        with open(os.path.join(d, "run_manifest.json"), "w") as f:
            json.dump(DOCS[name], f)
        assert cli_main(["status", "--logdir", d]) == want, name
    assert "died mid-run" in capsys.readouterr().out


def test_validator_rejects_what_the_jax_one_rejects():
    from sofa_tpu_torch.tools.manifest_check import validate_manifest

    for name, doc in DOCS.items():
        ours, theirs = validate_manifest(doc), jax_validator()(doc)
        assert bool(ours) == bool(theirs), name
    bad = copy.deepcopy(BASE)
    bad["sources"]["mpstat"]["cache"] = "warm"
    bad["collectors"]["procmon"]["restarts"] = -1
    bad["runs"]["record"]["counters"]["errors"] = "x"
    assert len(validate_manifest(bad)) == 3
    assert len(jax_validator()(bad)) == 3
    sick = DOCS["died"]
    assert validate_manifest(sick) == []
    assert validate_manifest(sick, require_healthy=True) == \
        ["unhealthy: collector procmon died"]


# --- the record side -------------------------------------------------------------

def test_record_manifest_covers_every_collector(logdir):
    cfg = SofaConfig(logdir=logdir, enable_kineto=False,
                     enable_gpu_mon=False)
    assert sofa_record("true", cfg) == 0
    doc = manifest(logdir)
    names = {c.name for c in build_collectors(cfg)}
    assert set(doc["collectors"]) == names
    started = {n: e for n, e in doc["collectors"].items()
               if e["status"] == "stopped"}
    assert {"timebase", "procmon"} <= set(started)
    # stops run in the reverse order of the starts
    by_start = sorted(started, key=lambda n: started[n]["start_seq"])
    by_stop = sorted(started, key=lambda n: started[n]["stop_seq"])
    assert by_stop == by_start[::-1]
    assert doc["runs"]["record"]["rc"] == 0
    assert doc["config"]["logdir"] == logdir
    names = [s["name"] for s in doc["stages"]]
    assert {"prologue", "launch", "epilogue"} <= set(names)
    trace = telemetry.load_self_trace(logdir)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert spans and all(e["dur"] >= 0 and e["tid"] == 1 for e in spans)
    assert any(e["ph"] == "M" and e["name"] == "process_name"
               for e in trace["traceEvents"])


def test_failed_launch_surfaces_its_own_error(logdir, monkeypatch):
    """A launch that raises surfaces that error (not a later one), kills
    the collectors, and still leaves the manifest (rc null)."""
    real_popen = subprocess.Popen

    def failing_popen(argv, *a, **kw):
        if argv[-3:-1] == ["/bin/sh", "-c"]:
            raise OSError(7, "launch refused")
        return real_popen(argv, *a, **kw)

    monkeypatch.setattr(record_mod.subprocess, "Popen", failing_popen)
    cfg = SofaConfig(logdir=logdir, enable_kineto=False,
                     enable_gpu_mon=False)
    with pytest.raises(OSError, match="launch refused"):
        sofa_record("true", cfg)
    doc = manifest(logdir)
    assert doc["runs"]["record"]["rc"] is None
    assert doc["runs"]["record"]["counters"]["errors"] == 1
    assert doc["collectors"]["procmon"]["status"] == "killed"
    assert not os.path.exists(os.path.join(logdir, "misc.txt"))


def test_stat_of_the_entry_forward_under_a_procmon_death(tmp_path):
    """A real CPU ``stat`` of the entry forward with procmon killed one
    second in: one restart, a valid manifest, report completes."""
    logdir = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO, SOFA_SUPERVISOR_POLL_S="0.05")
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch", "stat", "--logdir", logdir,
         "--inject_faults", "procmon:die@1s", "--sys_mon_rate", "20",
         f"{sys.executable} -m sofa_tpu_torch.entry --device cpu --steps 2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "Complete!!" in r.stdout
    doc = manifest(logdir)
    ent = doc["collectors"]["procmon"]
    assert ent["restarts"] == 1 and ent["died"] is True
    assert ent["status"] == "stopped"
    assert doc["collectors"]["kineto"]["status"] == "stopped"
    assert doc["sources"]["kineto"]["events"] > 0
    assert set(doc["runs"]) == {"record", "preprocess", "analyze"}
    hints = open(os.path.join(logdir, "hints.txt")).read()
    assert "[self] collector procmon died mid-run and was restarted 1x" \
        in hints
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch", "report", "--logdir",
         logdir], capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "Complete!!" in r.stdout
    assert manifest(logdir)["sources"]["kineto"]["cache"] == "hit"
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch", "status", logdir],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0 and "restarted 1x" in r.stdout


def test_clean_removes_the_manifest_cache_and_quarantine(logdir):
    cfg = SofaConfig(logdir=logdir, enable_kineto=False,
                     enable_gpu_mon=False)
    assert sofa_record("true", cfg) == 0
    os.makedirs(cfg.path("_ingest_cache"))
    os.makedirs(cfg.path("_quarantine"))
    assert os.path.exists(cfg.path("sofa_self_trace.json"))
    sofa_clean(cfg)
    for name in ("run_manifest.json", "sofa_self_trace.json",
                 "_ingest_cache", "_quarantine"):
        assert not os.path.exists(cfg.path(name)), name
    assert os.path.exists(cfg.path("mpstat.txt"))
    assert os.path.exists(cfg.path("misc.txt"))


# --- analyze: cpu_profile over the region of interest ----------------------------

PERF = """\
python  4242 [000] 100.000000:   2000000 cycles:u:      7f0 main (/usr/bin/python3)
python  4242 [001] 100.500000:   3000000 cycles:u:      7f1 loop (/usr/bin/python3)
python  4242 [000] 101.000000:   1000000 cycles:u:      7f2 main (/usr/bin/python3)
python  4242 [001] 101.500000:   4000000 cycles:u:      7f3 step (/usr/bin/python3)
python  4242 [000] 102.000000:   5000000 cycles:u:      7f4 loop (/usr/bin/python3)
python  4242 [001] 102.500000:   2500000 cycles:u:      7f5 main (/usr/bin/python3)
"""


@pytest.mark.parametrize("roi", [(0.0, 0.0), (0.4, 1.6), (0.0, 0.9),
                                 (1.9, 2.6)])
def test_cpu_profile_clips_to_the_roi_as_the_jax_pass(tmp_path, roi):
    frames = {"cputrace": perf_script.parse_perf_script(
        PERF, time_base=100.0, mhz_at=lambda t: 1000.0)}
    assert len(frames["cputrace"]) == 6
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    cfg = SofaConfig(logdir=str(tmp_path / "port"), roi_begin=roi[0],
                     roi_end=roi[1])
    jcfg = JaxConfig(logdir=str(tmp_path / "jax"))
    jcfg.roi_begin, jcfg.roi_end = roi
    got, ref = Features(), JaxFeatures()
    host.cpu_profile(frames, cfg, got)
    jax_host.cpu_profile(frames, jcfg, ref)
    pd.testing.assert_frame_equal(got.to_frame(), ref.to_frame())
    assert (tmp_path / "port" / "cpu_top.csv").read_text() == \
        (tmp_path / "jax" / "cpu_top.csv").read_text()
    if roi == (0.4, 1.6):
        assert got.get("cpu_samples") == 3


def test_analyze_runs_cpu_profile_after_the_roi():
    from sofa_tpu_torch.analysis import device, registry

    registry.load_builtin_passes()
    specs = registry.registered()
    names = [s.name for s in specs]
    assert names[0] == "spotlight" and specs[0].fn is device.spotlight_roi
    assert "spotlight" in registry.get("cpu_profile").after
    waves = [[s.name for s in w] for w in registry.resolve_schedule(
        specs, strict=True)]
    wave_of = {n: i for i, w in enumerate(waves) for n in w}
    assert wave_of["spotlight"] < wave_of["cpu_profile"]
    # the host passes keep their order, right after the region of interest
    host_names = [s.name for s in specs if s.fn.__module__ == host.__name__]
    assert names[1:1 + len(host_names)] == host_names
