"""The port's collector swarm on the CPU: each collector's probe, argv and
environment, the record orchestration (start order, command prefixes,
reverse stop, harvest, stale-file cleanup) and the CLI flags, beside the
JAX package's collectors where both exist."""

import os
import signal
import subprocess
import sys
import time

import pytest

from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu_torch import record
from sofa_tpu_torch.cli import build_parser, config_from_args
from sofa_tpu_torch.collectors import hostproc, perf, procmon
from sofa_tpu_torch.collectors.base import Collector, ProcessCollector
from sofa_tpu_torch.collectors.kineto import KinetoCollector
from sofa_tpu_torch.collectors.timebase import TimebaseCollector
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import procfs
from sofa_tpu_torch.ingest.timebase_align import converter


@pytest.fixture
def cfg(tmp_path):
    return SofaConfig(logdir=str(tmp_path / "log"))


def _no_tools(monkeypatch):
    monkeypatch.setattr(Collector, "which", staticmethod(lambda tool: None))


def _all_tools(monkeypatch):
    monkeypatch.setattr(Collector, "which",
                        staticmethod(lambda tool: f"/usr/bin/{tool}"))


# -- config and CLI ------------------------------------------------------------

@pytest.mark.parametrize("field", [
    "perf_events", "no_perf_events", "cpu_sample_rate", "perf_call_graph",
    "sys_mon_rate", "enable_strace", "strace_min_time", "enable_py_stacks",
    "py_stack_rate", "enable_tcpdump", "netstat_interface", "blkdev",
    "enable_vmstat"])
def test_host_collector_defaults_match_jax(field):
    assert getattr(SofaConfig(), field) == getattr(JaxConfig(), field)


def test_gpu_sampler_defaults_follow_the_tpu_ones():
    jax, port = JaxConfig(), SofaConfig()
    assert port.gpu_mon_rate == jax.tpu_mon_rate == 1
    assert port.enable_gpu_mon == jax.enable_tpu_mon
    assert port.enable_mem_prof == jax.enable_mem_prof


def test_cli_flags_reach_the_config():
    args = build_parser().parse_intermixed_args([
        "record", "sleep 1", "--logdir", "d", "--perf_events", "cycles",
        "--no-perf-events", "--cpu_sample_rate", "49", "--perf_call_graph",
        "fp", "--sys_mon_rate", "5", "--enable_strace", "--strace_min_time",
        "0.01", "--enable_py_stacks", "--enable_tcpdump",
        "--netstat_interface", "eth0", "--blkdev", "/dev/sda",
        "--gpu_mon_rate", "4", "--disable_gpu_mon", "--disable_memprof",
        "--disable_kineto"])
    cfg = config_from_args(args)
    assert cfg.logdir == "d/" and cfg.perf_events == "cycles"
    assert cfg.no_perf_events and cfg.cpu_sample_rate == 49
    assert cfg.perf_call_graph == "fp" and cfg.sys_mon_rate == 5
    assert cfg.enable_strace and cfg.strace_min_time == 0.01
    assert cfg.enable_py_stacks and cfg.enable_tcpdump
    assert cfg.netstat_interface == "eth0" and cfg.blkdev == "/dev/sda"
    assert cfg.gpu_mon_rate == 4
    assert not (cfg.enable_gpu_mon or cfg.enable_mem_prof
                or cfg.enable_kineto)
    assert config_from_args(build_parser().parse_intermixed_args(
        ["analyze"])) == SofaConfig()


# -- probes, argv, env ----------------------------------------------------------

@pytest.mark.parametrize("cls,flag,disabled,missing", [
    (hostproc.VmstatCollector, None, "disabled", "vmstat not installed"),
    (hostproc.TcpdumpCollector, "enable_tcpdump", "--enable_tcpdump",
     "tcpdump not installed"),
    (hostproc.BlktraceCollector, "blkdev", "--blkdev",
     "blktrace not installed"),
    (hostproc.StraceCollector, "enable_strace", "--enable_strace",
     "strace not installed"),
], ids=["vmstat", "tcpdump", "blktrace", "strace"])
def test_tool_collector_probes(cfg, monkeypatch, cls, flag, disabled,
                               missing):
    if flag is None:
        cfg.enable_vmstat = False
    assert disabled in cls(cfg).probe()
    if flag is None:
        cfg.enable_vmstat = True
    else:
        setattr(cfg, flag, "/dev/sda" if flag == "blkdev" else True)
    _no_tools(monkeypatch)
    assert cls(cfg).probe() == missing
    _all_tools(monkeypatch)
    assert cls(cfg).probe() is None


def test_tool_collector_argv(cfg):
    cfg.blkdev = "/dev/nvme0n1"
    assert hostproc.VmstatCollector(cfg).argv() == ["vmstat", "-w", "-t",
                                                    "1"]
    assert hostproc.TcpdumpCollector(cfg).argv() == [
        "tcpdump", "-i", "any", "-w", cfg.path("sofa.pcap"), "-s", "96"]
    assert hostproc.BlktraceCollector(cfg).argv() == [
        "blktrace", "--dev=/dev/nvme0n1", "-D", cfg.logdir, "-o",
        "blktrace"]
    assert hostproc.StraceCollector(cfg).command_prefix() == [
        "strace", "-q", "-T", "-tt", "-f", "-o", cfg.path("strace.txt")]


def test_perf_probe_modes_and_prefix(cfg, monkeypatch, capsys):
    _all_tools(monkeypatch)
    monkeypatch.setattr(perf, "_read_int", lambda path: 1)
    col = perf.PerfCollector(cfg)
    assert col.probe() is None and col.mode == "perf"
    assert col.command_prefix() == ["perf", "record", "-o",
                                    cfg.path("perf.data"), "-F", "99", "--"]
    cfg.perf_call_graph, cfg.perf_events = "dwarf", "cycles,instructions"
    assert col.command_prefix()[-5:] == ["--call-graph", "dwarf,16384", "-e",
                                         "cycles,instructions", "--"]
    # gated by perf_event_paranoid (unless root): the time -v fallback
    monkeypatch.setattr(perf, "_read_int", lambda path: 3)
    monkeypatch.setattr(os, "geteuid", lambda: 1000)
    monkeypatch.setattr(os.path, "isfile", lambda p: p == "/usr/bin/time")
    assert col.probe() is None and col.mode == "time"
    assert "perf_event_paranoid=3" in capsys.readouterr().err
    assert col.command_prefix() == ["/usr/bin/time", "-v", "-o",
                                    cfg.path("time.txt")]
    _no_tools(monkeypatch)
    assert col.probe() is None and col.mode == "time"
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    assert col.probe() == "neither perf nor /usr/bin/time available"
    cfg.no_perf_events = True
    monkeypatch.setattr(os.path, "isfile", lambda p: True)
    assert col.probe() is None and col.mode == "time"


def test_kineto_injection_env(cfg):
    cfg.enable_py_stacks = True
    env = KinetoCollector(cfg).child_env()
    inject = os.path.abspath(cfg.inject_dir)
    assert env["PYTHONPATH"].split(os.pathsep)[0] == inject
    assert env["SOFA_TORCH_GPUMON_HZ"] == "1"
    assert env["SOFA_TORCH_GPUMON_OUT"].endswith("/gpumon.txt")
    assert env["SOFA_TORCH_MEMPROF_OUT"].endswith("/memprof.pb.gz")
    assert env["SOFA_TORCH_PYSTACKS_HZ"] == "67"
    assert env["SOFA_TORCH_PYSTACKS_OUT"].endswith("/pystacks.txt")
    cfg.enable_mem_prof = False
    assert "SOFA_TORCH_MEMPROF_OUT" not in KinetoCollector(cfg).child_env()
    cfg.enable_gpu_mon, cfg.enable_mem_prof = False, True
    env = KinetoCollector(cfg).child_env()
    assert not any(k.startswith(("SOFA_TORCH_GPUMON", "SOFA_TORCH_MEMPROF"))
                   for k in env)
    # the injection is pointless only when all three are off
    cfg.enable_kineto = False
    assert KinetoCollector(cfg).probe() is None
    cfg.enable_py_stacks = False
    assert "disabled" in KinetoCollector(cfg).probe()


def test_kineto_start_writes_the_injected_modules(cfg):
    os.makedirs(cfg.logdir)
    KinetoCollector(cfg).start()
    assert sorted(os.listdir(cfg.inject_dir)) == [
        "sitecustomize.py", "sofa_torch_gpumon.py", "sofa_torch_kineto.py",
        "sofa_torch_pystacks.py"]
    for name in os.listdir(cfg.inject_dir):
        with open(os.path.join(cfg.inject_dir, name)) as f:
            compile(f.read(), name, "exec")


# -- the samplers run in the recording process -----------------------------------

def test_timebase_files(cfg):
    os.makedirs(cfg.logdir)
    col = TimebaseCollector(cfg)
    col.start()
    col.stop()
    with open(cfg.path("sofa_time.txt")) as f:
        assert abs(float(f.read()) - time.time()) < 60
    with open(cfg.path("timebase.txt")) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    assert len(rows) == 6 and all(len(r) == 4 for r in rows)
    to_unix = converter(cfg.path("timebase.txt"), "monotonic")
    assert abs(to_unix(time.monotonic()) - time.time()) < 1.0


def test_procmon_writes_what_procfs_parses(cfg):
    os.makedirs(cfg.logdir)
    cfg.sys_mon_rate = 50
    col = procmon.ProcMonCollector(cfg)
    assert col.probe() is None
    col.start()
    assert col.alive()
    time.sleep(0.3)
    col.stop()
    assert not col.alive()
    mp = procfs.load(cfg.path("mpstat.txt"), procfs.parse_mpstat)
    assert (mp["deviceId"] == -1).any() and (mp["deviceId"] >= 0).any()
    assert not procfs.load(cfg.path("cpuinfo.txt"),
                           procfs.parse_cpuinfo).empty
    assert sorted(os.path.basename(p) for p in col.outputs()) == [
        "cpuinfo.txt", "diskstat.txt", "mpstat.txt", "netstat.txt"]


def test_process_collector_stop_terms_then_kills(cfg):
    col = ProcessCollector(cfg)
    col.name = "stubborn"
    col.launch([sys.executable, "-c",
                "import signal, time; "
                "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                "print('up', flush=True); time.sleep(60)"],
               stdout=subprocess.PIPE)
    col.proc.stdout.readline()
    assert col.alive()
    t0 = time.time()
    col.stop(timeout=0.5)
    assert not col.alive() and col.proc.returncode == -signal.SIGKILL
    assert time.time() - t0 < 10
    col.stop()                       # idempotent


# -- record orchestration ---------------------------------------------------------

def test_build_collectors_in_the_jax_order(cfg):
    assert [c.name for c in record.build_collectors(cfg)] == [
        "timebase", "procmon", "vmstat", "tcpdump", "blktrace", "kineto",
        "strace", "perf"]


class _Spy(Collector):
    def __init__(self, cfg, name, log, prefix=(), reason=None, fail=False):
        super().__init__(cfg)
        self.name, self.log, self.prefix = name, log, list(prefix)
        self.reason, self.fail = reason, fail

    def probe(self):
        return self.reason

    def start(self):
        if self.fail:
            raise RuntimeError("no such device")
        self.log.append(("start", self.name))

    def stop(self):
        self.log.append(("stop", self.name))

    def harvest(self):
        self.log.append(("harvest", self.name))

    def command_prefix(self):
        return self.prefix

    def child_env(self):
        return {f"SPY_{self.name.upper()}": "1"}


def test_record_prefixes_env_and_epilogue_order(cfg, tmp_path, monkeypatch,
                                                capsys):
    log = []
    out = tmp_path / "argv.txt"
    monkeypatch.setattr(record, "build_collectors", lambda c: [
        _Spy(c, "a", log),
        _Spy(c, "skipped", log, reason="not here"),
        _Spy(c, "broken", log, fail=True),
        _Spy(c, "b", log, prefix=["env", "SPY_PREFIX=1"]),
        _Spy(c, "c", log, prefix=["nice", "-n", "0"]),
    ])
    rc = record.sofa_record(
        f'echo "$SPY_A $SPY_B $SPY_C $SPY_PREFIX $SPY_SKIPPED" > {out}; '
        "exit 5", cfg)
    assert rc == 5
    assert out.read_text().split() == ["1", "1", "1", "1"]
    assert log == [("start", "a"), ("start", "b"), ("start", "c"),
                   ("stop", "c"), ("stop", "b"), ("stop", "a"),
                   ("harvest", "a"), ("harvest", "b"), ("harvest", "c")]
    err = capsys.readouterr().err
    assert "skipped: not here" in err and "broken: start failed" in err


def test_clean_stale_drops_only_recording_files(cfg):
    os.makedirs(cfg.kineto_dir)
    os.makedirs(cfg.inject_dir)
    for name in ("gpumon.txt", "memprof.pb.gz", "mpstat.csv", "features.csv",
                 "kineto/trace_1.json", "blktrace.blktrace.0", "notes.md",
                 "_inject/sitecustomize.py"):
        with open(cfg.path(name), "w") as f:
            f.write("x")
    record._clean_stale(cfg)
    left = sorted(os.listdir(cfg.logdir))
    assert left == ["kineto", "notes.md"]
    assert not os.listdir(cfg.kineto_dir)
