"""The port's native helper (``sofa_tpu_torch/native/sysmon.cc``) and its
build.

``sysmon`` compiles into a temporary build directory with the host's C++
compiler and writes the four files the thread sampler writes, and the
port's ``procfs`` parses both into the same columns and series; the
timebase collector, Python alone, gives three rows of four integers at
start and again at stop.  Without a compiler,
procmon warns once and runs its thread; a failed build is tried once per
process; procmon over ``sysmon`` survives the ``die`` fault and the
supervisor's restart inside a real ``record``.
"""

import os
import shutil
import subprocess
import time

import pytest

import sofa_tpu_torch.record as record_mod
from sofa_tpu_torch import telemetry
from sofa_tpu_torch.collectors import native_build, procmon
from sofa_tpu_torch.collectors.timebase import TimebaseCollector
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import procfs
from sofa_tpu_torch.record import sofa_record

needs_cxx = pytest.mark.skipif(native_build.find_compiler() is None,
                               reason="no C++ compiler on this host")
FILES = ("mpstat", "diskstat", "netstat", "cpuinfo")
PARSERS = {"mpstat": procfs.parse_mpstat, "diskstat": procfs.parse_diskstat,
           "netstat": procfs.parse_netstat, "cpuinfo": procfs.parse_cpuinfo}


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A fresh build directory and no remembered failures."""
    d = tmp_path / "torch_native"
    monkeypatch.setattr(native_build, "BUILD_DIR", str(d))
    monkeypatch.setattr(native_build, "_FAILED", set())
    monkeypatch.setattr(native_build, "BUILDS", {})
    return d


@needs_cxx
@pytest.mark.parametrize("tool", ["sysmon"])
def test_helper_builds_into_the_build_dir(build_dir, tool):
    before = sorted(os.listdir(native_build.NATIVE_DIR))
    path = native_build.ensure_built(tool)
    assert path == native_build.binary_path(tool)
    assert os.path.dirname(path) == str(build_dir)
    assert os.path.basename(path).startswith(f"{tool}-")
    assert os.access(path, os.X_OK)
    built = native_build.BUILDS[tool]
    assert built["path"] == path and built["seconds"] > 0
    assert os.path.basename(built["compiler"]) in native_build.COMPILERS
    # no temp file is left, and the source directory is never written into
    assert os.listdir(build_dir) == [os.path.basename(path)]
    assert sorted(os.listdir(native_build.NATIVE_DIR)) == before
    # a second call finds the binary: no build
    native_build.BUILDS.clear()
    assert native_build.ensure_built(tool) == path
    assert tool not in native_build.BUILDS


def _sample(cfg, seconds=0.3):
    col = procmon.ProcMonCollector(cfg)
    col.start()
    assert col.alive()
    time.sleep(seconds)
    col.stop()
    assert not col.alive()
    return col


@needs_cxx
def test_sysmon_writes_what_the_thread_sampler_writes(tmp_path, build_dir,
                                                      monkeypatch):
    native = SofaConfig(logdir=str(tmp_path / "native"), sys_mon_rate=50)
    os.makedirs(native.logdir)
    col = _sample(native)
    assert col.proc is not None and col._thread is None
    assert col.proc.returncode == 0           # stopped by TERM, cleanly
    monkeypatch.setattr(procmon, "ensure_built", lambda tool: None)
    thread = SofaConfig(logdir=str(tmp_path / "thread"), sys_mon_rate=50)
    os.makedirs(thread.logdir)
    col = _sample(thread)
    assert col.proc is None and col._thread is not None
    for name in FILES:
        got = procfs.load(native.path(f"{name}.txt"), PARSERS[name])
        ref = procfs.load(thread.path(f"{name}.txt"), PARSERS[name])
        assert list(got.columns) == list(ref.columns), name
        # the same rows: a timestamp with 6 decimals, then the same keys
        # (cpus, devices, interfaces) or as many cores' clocks
        keys = []
        for cfg in (native, thread):
            with open(cfg.path(f"{name}.txt")) as f:
                rows = [ln.split() for ln in f if ln.strip()]
            assert all(len(r[0].split(".")[1]) == 6 for r in rows), name
            keys.append({len(r) if name == "cpuinfo" else r[1]
                         for r in rows})
        assert keys[0] == keys[1], name
    # every cpu's counters parse into the same series
    got, ref = (procfs.load(cfg.path("mpstat.txt"), procfs.parse_mpstat)
                for cfg in (native, thread))
    assert not got.empty
    assert set(zip(got["deviceId"], got["name"])) == \
        set(zip(ref["deviceId"], ref["name"]))


def test_timebase_gives_three_rows_of_four_integers(build_dir, tmp_path):
    # three rows at start and three again at stop, from Python alone: the
    # collector builds nothing
    cfg = SofaConfig(logdir=str(tmp_path / "tb"))
    os.makedirs(cfg.logdir)
    col = TimebaseCollector(cfg)
    col.start()
    col.stop()
    with open(cfg.path("timebase.txt")) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    assert len(rows) == 6 and all(len(r) == 4 for r in rows)
    values = [[int(v) for v in r] for r in rows]
    assert all(v[0] > 10 ** 18 for v in values)     # realtime ns
    assert [v[1] for v in values] == sorted(v[1] for v in values)
    assert not os.path.exists(build_dir)


def test_no_compiler_warns_once_and_the_thread_samples(tmp_path, build_dir,
                                                       monkeypatch, capsys):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    cfg = SofaConfig(logdir=str(tmp_path / "log"), sys_mon_rate=50)
    os.makedirs(cfg.logdir)
    for _ in range(2):                         # a restart asks again
        col = _sample(cfg, 0.15)
        assert col.proc is None and col._thread is not None
    cap = capsys.readouterr()
    out = cap.out + cap.err
    assert out.count("native sysmon: no C++ compiler") == 1
    assert "using the Python fallback" in out
    assert not os.path.exists(build_dir)
    mp = procfs.load(cfg.path("mpstat.txt"), procfs.parse_mpstat)
    assert (mp["deviceId"] == -1).any()


def test_a_failed_build_is_tried_once_per_process(build_dir, monkeypatch,
                                                  capsys):
    calls = []

    def failing_compiler(argv, **kw):
        calls.append(argv)
        raise subprocess.CalledProcessError(1, argv, stderr=b"error")

    monkeypatch.setattr(native_build, "find_compiler", lambda: "/bin/g++")
    monkeypatch.setattr(native_build.subprocess, "run", failing_compiler)
    assert native_build.ensure_built("sysmon") is None
    assert native_build.ensure_built("sysmon") is None
    assert len(calls) == 1 and calls[0][0] == "/bin/g++"
    assert calls[0][-1] == native_build.source_path("sysmon")
    assert "sysmon" in native_build._FAILED
    cap = capsys.readouterr()
    assert (cap.out + cap.err).count("native sysmon: build failed") == 1


def _live_sysmons(pid):
    """The sysmon processes that ``pid`` parents."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        comm, rest = stat.split(" ", 1)[1], stat.rsplit(")", 1)[1].split()
        if comm.startswith("(sysmon-") and rest[0] != "Z" \
                and int(rest[1]) == pid:
            found.append(int(name))
    return found


@needs_cxx
def test_procmon_over_sysmon_survives_die_and_restart(logdir, build_dir,
                                                      monkeypatch):
    monkeypatch.setattr(
        record_mod, "build_collectors",
        lambda cfg: [TimebaseCollector(cfg), procmon.ProcMonCollector(cfg)])
    monkeypatch.setenv("SOFA_SUPERVISOR_POLL_S", "0.05")
    monkeypatch.setenv("SOFA_FAULTS", "procmon:die@0.3s")
    cfg = SofaConfig(logdir=logdir, collector_restarts=1, sys_mon_rate=50)
    assert sofa_record("sleep 2.5", cfg) == 0
    doc = telemetry.load_manifest(logdir)
    ent = doc["collectors"]["procmon"]
    assert ent["died"] is True and ent["deaths"] == 1
    assert ent["exit_code"] == 0               # the restarted daemon's TERM
    assert ent["restarts"] == 1 and ent["status"] == "stopped"
    with open(cfg.path("mpstat.txt")) as f:
        stamps = sorted({float(ln.split()[0]) for ln in f if ln.strip()})
    # samples every 0.02 s, then the gap of the death and the restart's
    # backoff (0.25-0.5 s), then samples again until the stop
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    cut = max(range(len(gaps)), key=gaps.__getitem__)
    assert gaps[cut] > 0.2 and cut >= 5 and len(gaps) - cut > 20, gaps
    assert not _live_sysmons(os.getpid())      # nothing left running
