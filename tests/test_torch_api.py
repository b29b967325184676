"""The in-process ``sofa_tpu_torch.api.profile()`` on the CPU: what it
records (the trace with its two timebase markers, misc.txt, the time base,
the /proc sampler), what it leaves alone (no gpumon.txt, CUDA never
initialized, a stale snapshot dropped), and that preprocess and analyze
run on its logdir as they do after ``record``."""

import glob
import json
import os
import subprocess
import sys

import torch

from sofa_tpu_torch import api
from sofa_tpu_torch.workloads import resnet
from sofa_tpu_torch.workloads.common import step_annotation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profiled_steps(logdir):
    model, x = resnet.create(2, 32, 10, stage_sizes=(1, 1, 1, 1),
                             device="cpu")
    labels = torch.zeros(2, dtype=torch.long)
    _, step = resnet.make_train_step(model)
    with api.profile(logdir) as cfg:
        for i in range(2):
            with step_annotation(i):
                step(x, labels)
    return cfg


def test_profile_records_the_run(tmp_path):
    logdir = tmp_path / "run"
    logdir.mkdir()
    for stale in ("memprof.pb.gz", "memprof.pb.gz.meta.json"):
        (logdir / stale).write_text("a previous run's snapshot")
    cfg = _profiled_steps(str(logdir))
    assert cfg.logdir == str(logdir) + "/"
    traces = glob.glob(str(logdir / "kineto" / "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert sum(n.startswith("sofa_timebase_marker:") for n in names) == 2
    assert "sofa_step_1" in names
    misc = (logdir / "misc.txt").read_text()
    assert "elapsed_time" in misc and "rc 0" in misc
    assert (logdir / "sofa_time.txt").exists()
    assert (logdir / "timebase.txt").exists()
    assert (logdir / "mpstat.txt").exists()
    assert not (logdir / "gpumon.txt").exists()
    assert not (logdir / "memprof.pb.gz").exists()
    assert not (logdir / "memprof.pb.gz.meta.json").exists()
    topo = json.loads((logdir / "gpu_topo.json").read_text())
    assert topo["devices"] == []
    # the allocation-stack recording is unwound after the block
    assert not getattr(torch.autograd.backward, "_sofa_torch_noted", False)


def test_profile_then_preprocess_and_analyze(tmp_path):
    logdir = str(tmp_path / "run")
    _profiled_steps(logdir)
    for verb in ("preprocess", "analyze"):
        r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", verb,
                            "--logdir", logdir], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
    assert "Complete!!" in r.stdout
    assert os.path.isfile(os.path.join(logdir, "hosttrace.csv"))


def test_profile_never_initializes_cuda(tmp_path):
    code = (
        "import torch, sofa_tpu_torch.api as sofa\n"
        f"with sofa.profile({str(tmp_path / 'run')!r}):\n"
        "    torch.ones(4).sum()\n"
        "print('initialized', torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert "initialized False" in r.stdout
    assert not (tmp_path / "run" / "gpumon.txt").exists()


def test_profile_elapsed_covers_the_stops(tmp_path, monkeypatch):
    """elapsed_time is taken after the trace stop, the sampler join and
    the collectors' stops, as the JAX package takes it: a stop made slow
    on purpose lands in it."""
    import time

    from sofa_tpu_torch.collectors import kineto
    from sofa_tpu_torch.collectors.procmon import ProcMonCollector

    slow_s = 0.6
    stop = ProcMonCollector.stop

    def slow_stop(self, *a, **kw):
        time.sleep(slow_s)
        return stop(self, *a, **kw)

    monkeypatch.setattr(ProcMonCollector, "stop", slow_stop)
    stop_trace = kineto.stop_trace
    trace_s = {}

    def timed_stop_trace(*a, **kw):
        t0 = time.perf_counter()
        out = stop_trace(*a, **kw)
        trace_s["s"] = time.perf_counter() - t0
        return out

    monkeypatch.setattr(kineto, "stop_trace", timed_stop_trace)
    logdir = tmp_path / "run"
    with api.profile(str(logdir)):
        t0 = time.perf_counter()
        torch.ones(8).sum()
        body_s = time.perf_counter() - t0
    misc = dict(line.split() for line in
                (logdir / "misc.txt").read_text().splitlines())
    assert float(misc["elapsed_time"]) >= body_s + slow_s + trace_s["s"]
