"""sofa_tpu_torch's fault injection and supervised collector runtime.

The fault-spec grammar against the JAX package's on the same specs; then
every record-side degradation path on demand, with a fake swarm (the time
base and one watchable background process) and a 0.05 s supervisor poll:
a death detected and restarted, a sticky death, stop and harvest wedges
cut off at their deadlines, a start failure, truncation at harvest
(inside an output directory too), a stall flagged once, and the disk
budgets.  Every manifest these runs write also passes the JAX package's
``tools/manifest_check.validate_manifest``.
"""

import importlib.util
import os
import subprocess
import time

import pytest

from sofa_tpu import faults as jax_faults
from sofa_tpu_torch import faults, telemetry
import sofa_tpu_torch.record as record_mod
from sofa_tpu_torch.cli import main as cli_main
from sofa_tpu_torch.collectors.base import ProcessCollector
from sofa_tpu_torch.collectors.timebase import TimebaseCollector
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.printing import SofaUserError
from sofa_tpu_torch.record import sofa_record
from sofa_tpu_torch.supervisor import CollectorSupervisor
from sofa_tpu_torch.tools.manifest_check import validate_manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_validator():
    spec = importlib.util.spec_from_file_location(
        "jax_manifest_check", os.path.join(REPO, "tools", "manifest_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_manifest


def manifest(logdir):
    """The run's manifest, held valid by both packages' validators."""
    doc = telemetry.load_manifest(logdir)
    assert doc is not None
    assert validate_manifest(doc) == []
    assert jax_validator()(doc) == []
    return doc


# --- the spec grammar --------------------------------------------------------

SPECS = [
    "procmon:die@2s,vmstat:wedge@stop,perf:fail@start,"
    "kineto:truncate@harvest,pcap:corrupt",
    "a:fail,b:wedge,c:die,d:truncate",
    "kineto:wedge@harvest,procmon:die@0.5",
    " mpstat:corrupt , , kineto:fail@harvest ",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_parse_as_the_jax_package_does(spec):
    ours = faults.parse(spec).specs
    theirs = jax_faults.parse(spec).specs
    assert [(s.target, s.kind, s.phase, s.delay_s) for s in ours] == \
        [(s.target, s.kind, s.phase, s.delay_s) for s in theirs]
    plan = faults.parse(spec)
    for s in ours:
        for phase in faults.PHASES:
            assert s.fires_at(phase) == \
                jax_faults.FaultSpec(s.target, s.kind, s.phase,
                                     s.delay_s).fires_at(phase)
        assert plan.find(s.target, s.kind) == s


@pytest.mark.parametrize("bad", [
    "procmon",                 # no kind
    "procmon:explode",         # unknown kind
    "procmon:die@stop",        # die takes a delay, not a phase
    "procmon:fail@2s",         # fail takes a phase, not a delay
    "procmon:wedge@start",     # start is unbounded by design
    "procmon:die@soon",        # unparseable delay
    ":die",                    # no target
])
def test_fault_specs_rejected_as_the_jax_package_does(bad):
    with pytest.raises(ValueError):
        jax_faults.parse(bad)
    with pytest.raises(ValueError):
        faults.parse(bad)


@pytest.mark.parametrize("spec", ["service:worker_die@2",
                                  "service:replica_stale",
                                  "service:slo_breach@1",
                                  "service:scrape_stall",
                                  "service:disk_full@3"])
def test_unported_fault_kinds_are_usage_errors_that_say_so(spec):
    jax_faults.parse(spec)                  # the JAX package takes them
    with pytest.raises(ValueError, match="fleet tier.*does not have yet"):
        faults.parse(spec)


@pytest.mark.parametrize("spec", ["service:conn_refused", "service:partial@0.5",
                                  "service:stall", "service:http_500",
                                  "service:conn_reset@always"])
def test_network_fault_kinds_parse_as_the_jax_package_does(spec):
    """The fleet client's kinds: the JAX package's spec, field for field."""
    (got,), (want,) = faults.parse(spec).specs, jax_faults.parse(spec).specs
    assert (got.target, got.kind, got.when, got.fraction) == \
        (want.target, want.kind, want.when, want.fraction)


def test_no_spec_means_no_plan(monkeypatch):
    monkeypatch.delenv("SOFA_FAULTS", raising=False)
    assert faults.install_from(SofaConfig()) is None
    assert faults.active() is None
    faults.maybe_inject("anything", "start")     # no plan: a no-op


def test_bad_spec_is_a_usage_error(logdir, monkeypatch):
    monkeypatch.setenv("SOFA_FAULTS", "procmon:explode")
    cfg = SofaConfig(logdir=logdir, enable_kineto=False)
    with pytest.raises(SofaUserError, match="explode"):
        sofa_record("true", cfg)
    assert faults.active() is None
    assert cli_main(["record", "--logdir", logdir, "--inject_faults",
                     "service:worker_die@1", "true"]) == 1


# --- collector faults on a fake swarm -----------------------------------------

class FakeProcCollector(ProcessCollector):
    """A watchable background collector with a controllable lifetime."""

    name = "fakeproc"

    def start(self):
        self.launch(["sleep", "60"], stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)

    def outputs(self):
        return [self.cfg.path("fakeproc.txt"), self.cfg.path("fakedir")]


@pytest.fixture
def fake_swarm(monkeypatch):
    monkeypatch.setattr(
        record_mod, "build_collectors",
        lambda cfg: [TimebaseCollector(cfg), FakeProcCollector(cfg)])
    monkeypatch.setenv("SOFA_SUPERVISOR_POLL_S", "0.05")


def test_die_mid_run_is_detected_and_restarted(logdir, fake_swarm,
                                               monkeypatch):
    monkeypatch.setenv("SOFA_FAULTS", "fakeproc:die@0.1s")
    cfg = SofaConfig(logdir=logdir, collector_restarts=1)
    assert sofa_record("sleep 1.5", cfg) == 0
    doc = manifest(logdir)
    ent = doc["collectors"]["fakeproc"]
    assert ent["died"] is True and ent["deaths"] == 1
    assert ent["restarts"] == 1
    assert ent["status"] == "stopped"      # the restart stopped normally
    assert cli_main(["status", logdir]) == 0
    assert any("restarted 1x" in w
               for w in telemetry.manifest_warnings(doc))


def test_die_without_restart_budget_is_sticky(logdir, fake_swarm,
                                              monkeypatch):
    monkeypatch.setenv("SOFA_FAULTS", "fakeproc:die@0.1s")
    cfg = SofaConfig(logdir=logdir, collector_restarts=0)
    assert sofa_record("sleep 0.8", cfg) == 0
    ent = manifest(logdir)["collectors"]["fakeproc"]
    assert ent["status"] == "died"          # the epilogue did not whitewash
    assert ent["died"] is True and "restarts" not in ent
    assert ent["exit_code"] == -9
    assert cli_main(["status", logdir]) == 1


@pytest.mark.parametrize("phase,flag", [
    ("stop", "collector_stop_timeout_s"),
    ("harvest", "collector_harvest_timeout_s")])
def test_wedge_hits_its_deadline(logdir, fake_swarm, monkeypatch, phase,
                                 flag):
    monkeypatch.setenv("SOFA_FAULTS", f"fakeproc:wedge@{phase}")
    cfg = SofaConfig(logdir=logdir, **{flag: 0.5})
    t0 = time.time()
    assert sofa_record("true", cfg) == 0
    assert time.time() - t0 < 10, "a wedge must not hang record"
    ent = manifest(logdir)["collectors"]["fakeproc"]
    assert ent["status"] == "timed_out"
    assert ent["timed_out"] is True and ent["phase"] == phase
    assert cli_main(["status", logdir]) == 1


def test_start_fail_on_a_real_collector(logdir, monkeypatch):
    monkeypatch.setenv("SOFA_FAULTS", "procmon:fail@start")
    cfg = SofaConfig(logdir=logdir, enable_kineto=False)
    assert sofa_record("true", cfg) == 0     # a degradation, not an abort
    doc = manifest(logdir)
    assert doc["collectors"]["procmon"]["status"] == "failed"
    assert "injected" in doc["collectors"]["procmon"]["error"]
    assert doc["collectors"]["timebase"]["status"] == "stopped"


def test_truncate_halves_files_and_directory_contents(logdir, fake_swarm,
                                                      monkeypatch):
    monkeypatch.setenv("SOFA_FAULTS", "fakeproc:truncate@harvest")
    orig_start = FakeProcCollector.start

    def start_and_write(self):
        orig_start(self)
        with open(self.cfg.path("fakeproc.txt"), "w") as f:
            f.write("x" * 100)
        os.makedirs(self.cfg.path("fakedir"), exist_ok=True)
        with open(self.cfg.path("fakedir", "trace_1.json"), "w") as f:
            f.write("y" * 64)

    monkeypatch.setattr(FakeProcCollector, "start", start_and_write)
    cfg = SofaConfig(logdir=logdir)
    assert sofa_record("true", cfg) == 0
    assert os.path.getsize(cfg.path("fakeproc.txt")) == 50
    assert os.path.getsize(cfg.path("fakedir", "trace_1.json")) == 32
    assert manifest(logdir)["collectors"]["fakeproc"]["bytes_captured"] \
        == 82


def test_stall_is_flagged_once(logdir, fake_swarm, capsys):
    orig_start = FakeProcCollector.start

    def start_and_write(self):
        orig_start(self)
        with open(self.cfg.path("fakeproc.txt"), "w") as f:
            f.write("once")

    FakeProcCollector.start = start_and_write
    try:
        assert sofa_record("sleep 2.5", SofaConfig(logdir=logdir)) == 0
    finally:
        FakeProcCollector.start = orig_start
    doc = manifest(logdir)
    assert doc["collectors"]["fakeproc"]["output_stalled"] is True
    assert capsys.readouterr().err.count("has not grown") == 1
    assert any("stopped producing output" in w
               for w in telemetry.manifest_warnings(doc))


# --- disk budgets ---------------------------------------------------------------

class _BudgetCollector:
    """alive() collector whose outputs are files the test controls."""

    name = "fake"

    def __init__(self, outdir):
        self.outdir = outdir
        self.killed = False

    def alive(self):
        return True

    def outputs(self):
        return [self.outdir]

    def run_kill(self):
        self.killed = True


def _write_output(outdir, name, nbytes, age_s):
    path = os.path.join(outdir, name)
    with open(path, "wb") as f:
        f.write(b"x" * nbytes)
    old = time.time() - age_s
    os.utime(path, (old, old))
    return path


def test_budget_rotates_oldest_files_first(tmp_path):
    outdir = str(tmp_path / "out")
    os.makedirs(outdir)
    oldest = _write_output(outdir, "seg0.txt", 600 * 1024, 30)
    middle = _write_output(outdir, "seg1.txt", 600 * 1024, 20)
    newest = _write_output(outdir, "seg2.txt", 300 * 1024, 1)
    col = _BudgetCollector(outdir)
    cfg = SofaConfig(logdir=str(tmp_path) + "/", collector_disk_budget_mb=1.0)
    tel = telemetry.begin("record")
    try:
        sup = CollectorSupervisor(cfg, [col])
        sup._check(col)
        assert not os.path.exists(oldest)
        assert os.path.exists(middle) and os.path.exists(newest)
        assert col.killed is False
        assert tel.collectors["fake"]["rotated_files"] == 1
        assert sup.budget_summary() == {
            "budget_mb": None, "collector_budget_mb": 1, "rotated_files": 1,
            "truncated": []}
    finally:
        telemetry.end(tel)


def test_budget_stops_a_single_growing_file(tmp_path):
    outdir = str(tmp_path / "out")
    os.makedirs(outdir)
    only = _write_output(outdir, "big.pcap", 2 * 1024 * 1024, 5)
    col = _BudgetCollector(outdir)
    cfg = SofaConfig(logdir=str(tmp_path) + "/", collector_disk_budget_mb=1.0)
    tel = telemetry.begin("record")
    try:
        sup = CollectorSupervisor(cfg, [col])
        sup._check(col)
        assert os.path.exists(only) and col.killed is True
        assert tel.collectors["fake"]["status"] == "truncated_by_budget"
        tel.collector_event("fake", "stopped")          # sticky
        assert tel.collectors["fake"]["status"] == "truncated_by_budget"
        assert sup.budget_summary()["truncated"] == ["fake"]
        sup._check(col)
        assert "died" not in tel.collectors["fake"]
    finally:
        telemetry.end(tel)


def test_total_budget_makes_the_biggest_producer_pay(tmp_path):
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(out_a)
    os.makedirs(out_b)
    _write_output(out_a, "a0.txt", 200 * 1024, 30)
    _write_output(out_a, "a1.txt", 200 * 1024, 1)
    big_old = _write_output(out_b, "b0.txt", 900 * 1024, 30)
    _write_output(out_b, "b1.txt", 200 * 1024, 1)
    col_a, col_b = _BudgetCollector(out_a), _BudgetCollector(out_b)
    col_a.name, col_b.name = "small", "large"
    cfg = SofaConfig(logdir=str(tmp_path) + "/", disk_budget_mb=1.0)
    tel = telemetry.begin("record")
    try:
        sup = CollectorSupervisor(cfg, [col_a, col_b])
        sup._check(col_a)
        sup._check(col_b)
        sup._enforce_total_budget()
        assert not os.path.exists(big_old)
        assert os.path.exists(os.path.join(out_a, "a0.txt"))
        assert sup.budget_summary()["rotated_files"] == 1
    finally:
        telemetry.end(tel)


def test_budget_lands_in_the_manifest_and_status(logdir, fake_swarm,
                                                 monkeypatch):
    orig_start = FakeProcCollector.start

    def start_and_write(self):
        orig_start(self)
        with open(self.cfg.path("fakeproc.txt"), "wb") as f:
            f.write(b"z" * (2 * 1024 * 1024))

    monkeypatch.setattr(FakeProcCollector, "start", start_and_write)
    cfg = SofaConfig(logdir=logdir, collector_disk_budget_mb=1.0)
    assert sofa_record("sleep 0.6", cfg) == 0
    doc = manifest(logdir)
    assert doc["collectors"]["fakeproc"]["status"] == "truncated_by_budget"
    assert doc["meta"]["disk_budget"]["truncated"] == ["fakeproc"]
    assert cli_main(["status", logdir]) == 1


def test_jittered_backoff_matches_the_jax_package():
    import random

    from sofa_tpu.concurrency import jittered_backoff as jax_backoff
    from sofa_tpu_torch.concurrency import jittered_backoff

    for attempt in range(8):
        a, b = random.Random(attempt), random.Random(attempt)
        assert jittered_backoff(attempt, rng=a) == jax_backoff(attempt, rng=b)
        assert 0.25 <= jittered_backoff(attempt) <= 30.0


def test_vmstat_that_exits_at_once_is_skipped_not_supervised(tmp_path,
                                                             monkeypatch):
    """A vmstat that cannot read its /proc files exits 1 before its first
    line; the probe runs one report, so the collector is skipped with the
    reason instead of dying under the supervisor."""
    from sofa_tpu_torch.collectors.base import Collector
    from sofa_tpu_torch.collectors.hostproc import VmstatCollector

    fake = tmp_path / "vmstat"
    fake.write_text("#!/bin/sh\necho 'vmstat: /proc/vmstat: denied' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(Collector, "which", staticmethod(lambda t: str(fake)))
    cfg = SofaConfig(logdir=str(tmp_path / "log") + "/", enable_kineto=False,
                     enable_gpu_mon=False)
    assert VmstatCollector(cfg).probe() == \
        "vmstat exits 1 here (vmstat: /proc/vmstat: denied)"
    monkeypatch.setattr(record_mod, "build_collectors",
                        lambda c: [TimebaseCollector(c), VmstatCollector(c)])
    assert sofa_record("true", cfg) == 0
    assert manifest(cfg.logdir)["collectors"]["vmstat"]["status"] == \
        "skipped"
