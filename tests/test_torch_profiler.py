"""sofa_tpu_torch's profiler path: Kineto ingest, GPU passes, record/stat.

The device-side fixture is SYNTHETIC: a hand-built Kineto (Chrome trace)
document with kernel, memcpy, memset, launch, gpu_user_annotation and
timebase marker rows in the shape torch.profiler writes them on a CUDA
machine.  The
end-to-end ``stat`` run is real, on the CPU, where the trace holds host
events only and the device frame is empty.
"""

import json
import os
import subprocess
import sys

import pandas as pd
import pytest
import torch

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.gpu import gpu_profile, serving_profile
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest.kineto import ingest_kineto_dir, ingest_trace
from sofa_tpu_torch.record import sofa_record
from sofa_tpu_torch.trace import CopyKind
from sofa_tpu_torch.workloads.common import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_NS = 1_700_000_000_000_000_000
LAG_NS = 5_000_000          # the synthetic trace clock runs 5 ms behind unix


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def synthetic_trace():
    """SYNTHETIC Kineto trace (hand-built, not captured)."""
    marker_unix = BASE_NS + 100_000 + LAG_NS
    ev = [
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0,
         "args": {"name": "python"}},
        _x("user_annotation", f"sofa_timebase_marker:{marker_unix}", 100.0,
           1.0, pid=100, tid=100),
        _x("user_annotation", "sofa_step_0", 150.0, 2000.0, pid=100, tid=100),
        _x("user_annotation", "sofa_step_1", 2200.0, 50.0, pid=100, tid=100),
        _x("user_annotation", "run_prefill", 200.0, 300.0, pid=100, tid=100),
        _x("user_annotation", "run_decode", 600.0, 300.0, pid=100, tid=100),
        _x("cpu_op", "aten::mm", 210.0, 20.0, pid=100, tid=100),
        # launches, matched to device events by correlation id: one from
        # autograd's device thread (tid 101) inside sofa_step_0's host range
        _x("cuda_runtime", "cudaLaunchKernel", 215.0, 5.0, pid=100, tid=100,
           correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1000.0, 5.0, pid=100,
           tid=101, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 700.0, 5.0, pid=100, tid=100,
           correlation=3),
        _x("cuda_driver", "cuLaunchKernel", 120.0, 5.0, pid=100, tid=100,
           correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 2300.0, 5.0, pid=100, tid=100,
           correlation=5),
        # Kineto's device-side spans follow only the opening thread's
        # launches: ingest does not use them
        _x("gpu_user_annotation", "sofa_step_0", 1000.0, 2000.0, device=0),
        _x("gpu_user_annotation", "run_prefill", 1100.0, 500.0, device=0),
        _x("gpu_user_annotation", "run_decode", 2500.0, 400.0, device=0),
        _x("kernel", "void sofa_flash_fwd_kernel<128>(bf16 const*)", 1200.0,
           100.0, device=0, stream=7, correlation=1),
        _x("kernel", "sm90_gemm_bf16", 1700.0, 200.0, device=0, stream=7,
           correlation=2),
        _x("kernel", "decode_gemv", 2600.0, 100.0, device=0, stream=7,
           correlation=3),
        _x("kernel", "other_device_kernel", 1200.0, 50.0, pid=1, device=1,
           stream=9, correlation=4),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3500.0, 10.0,
           device=0, stream=7, bytes=4096, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 3600.0, 8.0,
           device=0, stream=7, bytes=2048),
        _x("gpu_memset", "Memset (Device)", 3700.0, 2.0, device=0, stream=7,
           bytes=512),
    ]
    return {"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
            "traceEvents": ev}


def test_kineto_ingest_synthetic_trace():
    frames = ingest_trace(synthetic_trace(), time_base=BASE_NS / 1e9)
    gpu = frames["gputrace"].set_index("name")
    flash = gpu.loc["void sofa_flash_fwd_kernel<128>(bf16 const*)"]
    assert flash["deviceId"] == 0 and flash["copyKind"] == int(CopyKind.KERNEL)
    assert flash["module"] == "run_prefill"          # innermost range
    # launched from another thread while sofa_step_0 was open
    assert gpu.loc["sm90_gemm_bf16", "module"] == "sofa_step_0"
    assert gpu.loc["decode_gemv", "module"] == "run_decode"
    assert gpu.loc["other_device_kernel", "module"] == ""     # before it
    assert gpu.loc["Memcpy DtoH (Device -> Pageable)", "module"] == ""
    assert gpu.loc["other_device_kernel", "deviceId"] == 1
    kinds = gpu["copyKind"].to_dict()
    assert kinds["Memcpy HtoD (Pageable -> Device)"] == int(CopyKind.H2D)
    assert kinds["Memcpy DtoH (Device -> Pageable)"] == int(CopyKind.D2H)
    assert kinds["Memset (Device)"] == int(CopyKind.D2D)
    assert gpu.loc["Memcpy HtoD (Pageable -> Device)", "payload"] == 4096
    # ts 1200 us on the trace clock, which lags unix by 5 ms
    assert flash["timestamp"] == pytest.approx(1200e-6 + LAG_NS / 1e9,
                                               abs=1e-9)
    assert flash["duration"] == pytest.approx(100e-6)
    host = frames["hosttrace"]
    assert set(host["hlo_category"]) == {"cpu_op", "user_annotation",
                                         "cuda_runtime"}
    assert (host["deviceId"] == -1).all()
    steps = frames["gpusteps"].set_index("name")
    assert list(steps.index) == ["sofa_step_0", "sofa_step_1"]
    assert steps.loc["sofa_step_0", "deviceId"] == 0      # device span wins
    # the device work it launched: flash 1200 us to decode_gemv's end 2700
    assert steps.loc["sofa_step_0", "timestamp"] == pytest.approx(
        1200e-6 + LAG_NS / 1e9, abs=1e-9)
    assert steps.loc["sofa_step_0", "duration"] == pytest.approx(1500e-6)
    assert steps.loc["sofa_step_1", "deviceId"] == -1     # host-only step


def test_gpu_passes_on_synthetic_trace(tmp_path):
    cfg = SofaConfig(logdir=str(tmp_path))
    frames = ingest_trace(synthetic_trace(), time_base=BASE_NS / 1e9)
    feats = Features()
    gpu_profile(frames, cfg, feats)
    serving_profile(frames, cfg, feats)
    assert feats.get("gpu_devices") == 2
    assert feats.get("gpu_kernels") == 4
    assert feats.get("gpu0_kernel_time") == pytest.approx(400e-6)
    assert feats.get("gpu0_memcpy_time") == pytest.approx(20e-6)
    # device 0 busy 420 us of the 3602 us window (first host event at
    # ts 100 us to the memset's end at 3702 us)
    assert feats.get("gpu0_busy_pct") == pytest.approx(100 * 420 / 3602)
    assert feats.get("gpu_busy_pct") > 0
    # inside the steps' union [1200, 2700] us the device works 400 us
    assert feats.get("gpu_step_busy_pct") == pytest.approx(100 * 400 / 1500)
    assert feats.get("serving_prefill_time") == pytest.approx(100e-6)
    assert feats.get("serving_decode_time") == pytest.approx(100e-6)
    assert feats.get("serving_decode_calls") == 1
    # host dispatch of run_prefill (ts 200) to the end of the last prefill
    # kernel before decode (1300)
    assert feats.get("serving_ttft") == pytest.approx(1100e-6)
    top = pd.read_csv(tmp_path / "gpu_top_kernels.csv")
    assert top.iloc[0]["name"] == "sm90_gemm_bf16"


def test_ingest_dir_merges_files_and_tolerates_absence(tmp_path):
    assert all(df.empty for df in ingest_kineto_dir(
        str(tmp_path / "none"), 0.0).values())
    for pid in (1, 2):
        (tmp_path / f"trace_{pid}.json").write_text(
            json.dumps(synthetic_trace()))
    frames = ingest_kineto_dir(str(tmp_path), BASE_NS / 1e9)
    assert len(frames["gputrace"]) == 2 * 7
    assert frames["gputrace"]["timestamp"].is_monotonic_increasing


def test_stat_on_tiny_cpu_run(tmp_path):
    """The whole swarm on the CPU, with procmon and pystacks on: host
    frames and features, and an empty gpumon frame with its warning (the
    program never initializes CUDA, and neither do the samplers)."""
    logdir = str(tmp_path / "run")
    cmd = (f"{sys.executable} -m sofa_tpu_torch.workloads.inference "
           "--device cpu --n_layers 1 --d_model 32 --n_heads 2 "
           "--n_kv_heads 1 --d_ff 64 --vocab 64 --batch 2 --prompt 8 "
           "--new_tokens 3")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "stat",
                        "--logdir", logdir, "--enable_py_stacks",
                        "--sys_mon_rate", "20", cmd], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Complete!!" in r.stdout
    assert "gputrace is empty" in r.stderr
    assert "gpumon is empty" in r.stderr
    feats = pd.read_csv(os.path.join(logdir, "features.csv"))
    feats = dict(zip(feats["name"], feats["value"]))
    assert feats["gpu_devices"] == 0 and feats["elapsed_time"] > 0
    assert os.listdir(os.path.join(logdir, "kineto"))
    host = pd.read_csv(os.path.join(logdir, "hosttrace.csv"))
    names = set(host["name"])
    assert {"run_prefill", "run_decode"} <= names
    assert any(n.startswith("aten::") for n in names)
    assert 0 <= host["timestamp"].min() < feats["elapsed_time"]
    with open(os.path.join(logdir, "gpu_topo.json")) as f:
        assert json.load(f)["devices"] == []
    # host collectors: procmon's aggregate CPU rows and the passes over them
    mp = pd.read_csv(os.path.join(logdir, "mpstat.csv"))
    assert (mp["deviceId"] == -1).any() and (mp["deviceId"] >= 0).any()
    assert feats["num_cores"] >= 1 and 0 <= feats["cpu_util"] <= 1
    assert not pd.read_csv(os.path.join(logdir, "cpuinfo.csv")).empty
    with open(os.path.join(logdir, "timebase.txt")) as f:
        assert len(f.read().split()) == 4 * 6
    # the in-process Python stack sampler saw the workload
    py = pd.read_csv(os.path.join(logdir, "pystacks.csv"),
                     keep_default_na=False)
    assert feats["py_samples"] == len(py) > 0
    assert py["module"].str.contains(
        "sofa_tpu_torch.workloads.inference.").any()
    # no memory samples and no snapshot without CUDA
    assert pd.read_csv(os.path.join(logdir, "gpumon.csv")).empty
    assert not os.path.exists(os.path.join(logdir, "gpumon.txt"))
    assert not os.path.exists(os.path.join(logdir, "memprof.pb.gz"))
    assert not any(k.startswith(("gpumon_", "memprof_")) for k in feats)


def test_record_env_order_and_child_rc(tmp_path):
    cfg = SofaConfig(logdir=str(tmp_path / "rec"))
    out = tmp_path / "pp.txt"
    rc = sofa_record(f"echo \"$PYTHONPATH\" > {out}; exit 3", cfg)
    assert rc == 3
    parts = out.read_text().strip().split(os.pathsep)
    assert parts[0] == os.path.abspath(cfg.inject_dir)
    assert REPO in parts[1:]
    assert os.path.isfile(os.path.join(cfg.inject_dir, "sitecustomize.py"))
    misc = (tmp_path / "rec" / "misc.txt").read_text()
    assert "rc 3" in misc and "elapsed_time" in misc


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_record_needs_a_command():
    from sofa_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["stat"])
