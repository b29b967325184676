"""The port's single-device passes against the JAX package's, and the
flops, bytes, phase and op path ingest gives each kernel.

Parity: the same device work is built once as a JAX ``tputrace`` frame
(kernels at category 0, copies at category 2, the TPU trace's synchronous
and asynchronous lines) and once as the port's ``gputrace`` (copies told
apart by copyKind), with the same intervals, flops, bytes, phases, paths
and steps, two devices, and the same peaks (the port's from the card's name
in gpu_topo.json, the JAX side's through tpu_meta.json).  Each pair of
passes must give the same features under the renamed names, and the same
CSVs, to 1e-9; ``gpuutil`` must equal ``tpuutil``.

Ingest: a SYNTHETIC Kineto trace (hand-built in the shape torch.profiler
writes on a CUDA machine, with the operand shapes ``record_shapes``
records) carries a convolution whose op launched two kernels, a batch norm,
a flash forward launched through its cost range, and a backward on the
autograd engine's thread.
"""

import json

import numpy as np
import pandas as pd
import pytest

from sofa_tpu.analysis import sol as jax_sol
from sofa_tpu.analysis import tpu as jax_tpu
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.ingest.xplane import tpu_utilization
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu_torch import costs
from sofa_tpu_torch.analysis import device, gpu, sol
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest.kineto import gpu_utilization, ingest_trace
from sofa_tpu_torch.trace import CopyKind, make_frame

H100 = "NVIDIA H100 80GB HBM3"
PEAK_TFLOPS, PEAK_GBPS = sol.PEAKS[H100]
NAMES = ["conv_fprop", "gemm", "bn_fwd", "relu", "flash_fwd", "bn_bwd"]


def _ops(seed=0):
    """Rows of device work: sparse warm-up, 7 dense 100 ms steps with an
    H2D copy at each start, then a sparse tail; device 1 lighter."""
    rng = np.random.default_rng(seed)
    rows, steps = [], []

    def kernel(dev, t, d, step):
        name = NAMES[rng.integers(len(NAMES))]
        rows.append({
            "timestamp": t, "duration": d, "deviceId": dev,
            "copyKind": int(CopyKind.KERNEL), "name": name,
            "flops": float(rng.choice([0.0, rng.uniform(1e9, 4e11)])),
            "bytes_accessed": float(rng.uniform(1e6, 4e9)),
            "phase": ["fw", "bw"][rng.integers(2)],
            "hlo_category": f"aten::{name}",
            "op_path": "" if step is None else
            f"sofa_step_{step}/aten::{name}/aten::{name}_impl"})

    def copy(dev, t, d, kind):
        rows.append({"timestamp": t, "duration": d, "deviceId": dev,
                     "copyKind": int(kind), "name": f"Memcpy {kind.name}",
                     "payload": 4096})

    for dev, density in ((0, 0.9), (1, 0.5)):
        for t in np.arange(0.0, 0.3, 0.05):           # warm-up
            kernel(dev, float(t), 0.002, None)
        for s in range(7):
            t0 = 0.3 + 0.1 * s
            steps.append({"event": float(s), "timestamp": t0,
                          "duration": 0.1, "deviceId": dev,
                          "name": f"sofa_step_{s}"})
            copy(dev, t0, 0.006, CopyKind.H2D)
            t = t0 + 0.004
            while t < t0 + 0.095:
                d = float(rng.uniform(0.001, 0.005)) * density
                kernel(dev, t, d, s)
                t += d + float(rng.uniform(0.0, 0.0015)) / density
            copy(dev, t0 + 0.05, 0.003, CopyKind.D2D)
        copy(dev, 1.0, 0.004, CopyKind.D2H)
        for t in np.arange(1.0, 1.5, 0.1):            # tail
            kernel(dev, float(t), 0.001, None)
    return rows, steps


def _frames():
    rows, steps = _ops()
    port = {"gputrace": make_frame(rows), "gpusteps": make_frame(steps)}
    jax_rows = [dict(r, category=2 if r["copyKind"] != 0 else 0)
                for r in rows]
    ref = {"tputrace": jax_make_frame(jax_rows),
           "tpusteps": jax_make_frame(steps)}
    return port, ref


def _configs(tmp_path, **kw):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port" / "gpu_topo.json").write_text(json.dumps(
        {"cuda_available": True, "devices": [
            {"index": i, "name": H100} for i in (0, 1)]}))
    meta = {str(i): {"peak_teraflops_per_second": PEAK_TFLOPS,
                     "peak_hbm_bw_gigabytes_per_second": PEAK_GBPS}
            for i in (0, 1)}
    (tmp_path / "jax" / "tpu_meta.json").write_text(json.dumps(meta))
    return (SofaConfig(logdir=str(tmp_path / "port"), **kw),
            JaxConfig(logdir=str(tmp_path / "jax"), **kw), meta)


def _renamed(name):
    return (name.replace("tpu", "gpu").replace("tc_util", "kernel_util")
            .replace("mxu_util", "tensor_util"))


def _same_features(got, ref):
    want = ref.to_frame().assign(name=lambda d: d["name"].map(_renamed))
    pd.testing.assert_frame_equal(got.to_frame(), want, atol=1e-9, rtol=0)


def _same_csv(port_path, jax_path):
    a, b = pd.read_csv(port_path), pd.read_csv(jax_path)
    if "name" in b.columns:
        b["name"] = b["name"].astype(str)
    pd.testing.assert_frame_equal(a, b, atol=1e-9, rtol=0)


def test_gpuutil_matches_tpuutil(tmp_path):
    port, ref = _frames()
    cfg, _, meta = _configs(tmp_path)
    got = gpu_utilization(port["gputrace"], 0.1, sol.device_peaks(cfg))
    want = tpu_utilization(ref["tputrace"], 0.1, meta)
    assert set(got["name"]) == {"kernel_util", "tensor_util", "hbm_gbps"}
    want = want.assign(name=want["name"].map(_renamed), device_kind="gpu")
    pd.testing.assert_frame_equal(got, want, atol=1e-9, rtol=0)
    # no peak, no tensor_util
    bare = gpu_utilization(port["gputrace"], 0.1, {})
    assert "tensor_util" not in set(bare["name"])


PAIRS = [
    ("op_tree_profile", "op_tree_profile", "gpu_op_tree.csv",
     "tpu_op_tree.csv"),
    ("overlap_profile", "overlap_profile", None, None),
    ("input_pipeline_profile", "input_pipeline_profile",
     "gpu_input_pipeline.csv", "tpu_input_pipeline.csv"),
    ("roofline_profile", "roofline_profile", "roofline.csv", "roofline.csv"),
    ("gpuutil_profile", "tpuutil_profile", None, None),
]


@pytest.mark.parametrize("spotlight", [False, True],
                         ids=["whole_run", "spotlight_roi"])
@pytest.mark.parametrize("port_name,jax_name,port_csv,jax_csv", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_device_pass_matches_jax(tmp_path, port_name, jax_name, port_csv,
                                 jax_csv, spotlight):
    port, ref = _frames()
    cfg, jcfg, meta = _configs(tmp_path, spotlight=spotlight)
    port["gpuutil"] = gpu_utilization(port["gputrace"], 0.1,
                                      sol.device_peaks(cfg))
    ref["tpuutil"] = tpu_utilization(ref["tputrace"], 0.1, meta)
    got, want = Features(), JaxFeatures()
    device.spotlight_roi(port, cfg, got)
    jax_tpu.spotlight_roi(ref, jcfg, want)
    if spotlight:       # the region begins after the warm-up
        assert 0.2 < cfg.roi_begin < 0.4 and cfg.roi_end > 0.9
    assert (cfg.roi_begin, cfg.roi_end) == (jcfg.roi_begin, jcfg.roi_end)
    getattr(device, port_name)(port, cfg, got)
    getattr(jax_tpu, jax_name)(ref, jcfg, want)
    assert len(got.to_frame()) > 2 * spotlight
    _same_features(got, want)
    if port_csv:
        _same_csv(cfg.path(port_csv), jcfg.path(jax_csv))
    # an absent frame is a silent no-op
    empty = Features()
    getattr(device, port_name)({}, SofaConfig(logdir=str(tmp_path)), empty)
    assert empty.to_frame().empty


def test_sol_roofline_matches_jax(tmp_path):
    port, ref = _frames()
    cfg, jcfg, _ = _configs(tmp_path)
    got, want = Features(), JaxFeatures()
    sol.sol_roofline(port, cfg, got)
    jax_sol.sol_roofline(ref, jcfg, want)
    _same_features(got, want)
    _same_csv(cfg.path("sol_roofline.csv"), jcfg.path("sol_roofline.csv"))
    assert dict(got._info)["sol_peak_source"] == sol.PEAK_SOURCE


def test_unknown_card_gets_no_roofline(tmp_path, capsys):
    port, _ = _frames()
    (tmp_path / "gpu_topo.json").write_text(json.dumps(
        {"devices": [{"index": 0, "name": "Some Other GPU"}]}))
    cfg = SofaConfig(logdir=str(tmp_path))
    feats = Features()
    device.roofline_profile(port, cfg, feats)
    sol.sol_roofline(port, cfg, feats)
    assert feats.to_frame().empty
    assert not (tmp_path / "roofline.csv").exists()
    assert "no peak rates for 'Some Other GPU'" in capsys.readouterr().err


def test_gpu_profile_reports_what_tpu_profile_does(tmp_path):
    port, _ = _frames()
    cfg, _, _ = _configs(tmp_path)
    feats = Features()
    gpu.gpu_profile(port, cfg, feats)
    kern = port["gputrace"][port["gputrace"]["copyKind"] == 0]
    assert feats.get("gpu_total_flops") == pytest.approx(kern["flops"].sum())
    fw = kern.loc[kern["phase"] == "fw", "duration"].sum()
    bw = kern.loc[kern["phase"] == "bw", "duration"].sum()
    assert feats.get("gpu_fw_time") == pytest.approx(fw)
    assert feats.get("gpu_bw_fw_ratio") == pytest.approx(bw / fw)
    assert feats.get("gpu_op_time_aten::gemm") == pytest.approx(
        kern.loc[kern["name"] == "gemm", "duration"].sum())
    cats = pd.read_csv(cfg.path("gpu_categories.csv"))
    assert "Memcpy H2D" not in set(cats["cat"])          # not a category
    assert cats["duration"].sum() == pytest.approx(
        port["gputrace"]["duration"].sum())
    top = pd.read_csv(cfg.path("gpu_top_kernels.csv"))
    assert {"flops", "bytes_accessed"} <= set(top.columns)


# -- ingest: costs, the split rule, phase and op path ---------------------------

BASE_NS = 1_700_000_000_000_000_000
MAIN, ENGINE = 10, 11


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _op(name, ts, dur, dims, types, conc, tid=MAIN):
    return _x("cpu_op", name, ts, dur, tid=tid, **{
        "Input Dims": dims, "Input type": types, "Concrete Inputs": conc})


def _launch(ts, corr, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2.0, tid=tid,
              correlation=corr)


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": 7, "correlation": corr}}


BF16 = "c10::BFloat16"
FLASH = costs.cost_range_name("sofa_flash_fwd", 1, 128, 128, 4, 2, 64, True)
FLASH_BWD = costs.cost_range_name("sofa_flash_bwd_kv", 1, 128, 128, 4, 2, 64,
                                  True)


def kineto_trace():
    """SYNTHETIC Kineto trace (hand-built, not captured)."""
    ev = [
        _x("user_annotation", "sofa_timebase_marker:%d" % (BASE_NS + 50_000),
           50.0, 1.0),
        _x("user_annotation", "sofa_step_0", 100.0, 2000.0),
        # conv2d > ... > cudnn_convolution: x [2,8,16,16], w [16,8,3,3],
        # stride 2, pad 1 -> [2,16,8,8]; two kernels, 30 and 10 us
        _op("aten::conv2d", 110.0, 190.0, [[2, 8, 16, 16], [16, 8, 3, 3], [],
                                           [], [], [], []],
            [BF16, BF16, "", "ScalarList", "ScalarList", "ScalarList",
             "Scalar"], ["", "", "", "[2, 2]", "[1, 1]", "[1, 1]", "1"]),
        _op("aten::cudnn_convolution", 130.0, 150.0,
            [[2, 8, 16, 16], [16, 8, 3, 3], [], [], [], [], [], [], []],
            [BF16, BF16, "ScalarList", "ScalarList", "ScalarList", "Scalar",
             "Scalar", "Scalar", "Scalar"],
            ["", "", "[1, 1]", "[2, 2]", "[1, 1]", "1", "True", "False",
             "True"]),
        _launch(140.0, 1), _launch(200.0, 2),
        _op("aten::native_batch_norm", 310.0, 90.0,
            [[2, 16, 8, 8], [16], [16], [], [], [], [], []],
            [BF16, "float", "float", "", "", "Scalar", "Scalar", "Scalar"],
            ["", "", "", "", "", "True", "0.", "1e-05"]),
        _launch(320.0, 3),
        _x("user_annotation", FLASH, 410.0, 20.0),
        _launch(415.0, 4),
        # an op whose operands the trace does not record (a tensor list)
        _op("aten::_foreach_add_", 440.0, 20.0, [[], [], []],
            ["TensorList", "TensorList", "Scalar"], ["", "", "1"]),
        _launch(445.0, 8),
        # the backward, on the autograd engine's thread
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "ConvolutionBackward0", 500.0, 400.0, tid=ENGINE),
        _op("aten::convolution_backward", 520.0, 360.0,
            [[2, 16, 8, 8], [2, 8, 16, 16], [16, 8, 3, 3], [], [], [], [], [],
             [], [], []],
            [BF16, BF16, BF16, "ScalarList", "ScalarList", "ScalarList",
             "ScalarList", "Scalar", "ScalarList", "Scalar", "ScalarList"],
            ["", "", "", "[0]", "[2, 2]", "[1, 1]", "[1, 1]", "False",
             "[0, 0]", "1", "[True, True, False]"], tid=ENGINE),
        _launch(530.0, 5, tid=ENGINE), _launch(600.0, 6, tid=ENGINE),
        _x("user_annotation", FLASH_BWD, 910.0, 20.0, tid=ENGINE),
        _launch(915.0, 7, tid=ENGINE),
        _kernel("xmma_fprop", 1000.0, 30.0, 1),
        _kernel("nhwc_to_nchw", 1040.0, 10.0, 2),
        _kernel("bn_fwd", 1060.0, 5.0, 3),
        _kernel("sofa_flash_fwd_kernel", 1070.0, 8.0, 4),
        _kernel("multi_tensor_apply", 1080.0, 4.0, 8),
        _kernel("dgrad", 1100.0, 20.0, 5),
        _kernel("wgrad", 1130.0, 20.0, 6),
        _kernel("sofa_flash_bwd_kv_kernel", 1160.0, 10.0, 7),
    ]
    return {"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
            "traceEvents": ev}


def _gpu_rows():
    frames = ingest_trace(kineto_trace(), time_base=BASE_NS / 1e9)
    return frames["gputrace"].set_index("name")


def test_convolution_flops_split_over_its_kernels_by_time():
    gpu = _gpu_rows()
    out = 2 * 16 * 8 * 8                                  # N K P Q
    flops = 2.0 * out * 8 * 3 * 3
    nbytes = (2 * 8 * 16 * 16 + 16 * 8 * 9 + out) * 2
    assert gpu.loc["xmma_fprop", "flops"] == pytest.approx(0.75 * flops)
    assert gpu.loc["nhwc_to_nchw", "flops"] == pytest.approx(0.25 * flops)
    assert (gpu.loc["xmma_fprop", "bytes_accessed"]
            + gpu.loc["nhwc_to_nchw", "bytes_accessed"]) == \
        pytest.approx(nbytes)
    assert gpu.loc["xmma_fprop", "hlo_category"] == "aten::cudnn_convolution"
    assert gpu.loc["xmma_fprop", "op_path"] == (
        "sofa_step_0/aten::conv2d/aten::cudnn_convolution")
    assert gpu.loc["xmma_fprop", "phase"] == "fw"
    assert gpu.loc["xmma_fprop", "module"] == "sofa_step_0"


def test_elementwise_bytes_are_operands_plus_a_result_like_the_first():
    gpu = _gpu_rows()
    x = 2 * 16 * 8 * 8 * 2
    assert gpu.loc["bn_fwd", "flops"] == 0
    assert gpu.loc["bn_fwd", "bytes_accessed"] == x + 2 * 16 * 4 + x
    # no recorded operands: no cost, no owner
    assert gpu.loc["multi_tensor_apply", "bytes_accessed"] == 0
    assert gpu.loc["multi_tensor_apply", "hlo_category"] == "kernel"


def test_flash_kernels_carry_the_cost_estimate():
    gpu = _gpu_rows()
    b, t, h, kvh, d = 1, 128, 4, 2, 64
    fwd = gpu.loc["sofa_flash_fwd_kernel"]
    assert fwd["flops"] == 4 * b * h * t * t * d * 0.5
    assert fwd["bytes_accessed"] == (2 * b * t * h * d * 2
                                     + 2 * b * t * kvh * d * 2 + b * h * t * 4)
    assert fwd["hlo_category"] == "sofa_flash_fwd"
    assert fwd["module"] == "sofa_step_0"      # the cost range is not one
    assert fwd["op_path"] == f"sofa_step_0/{FLASH}"
    kv = gpu.loc["sofa_flash_bwd_kv_kernel"]
    assert kv["flops"] == 8 * b * h * t * t * d * 0.5
    assert kv["phase"] == "bw"


def test_backward_kernels_on_the_engine_thread():
    gpu = _gpu_rows()
    fwd_flops = 2.0 * (2 * 16 * 8 * 8) * 8 * 9
    for name in ("dgrad", "wgrad"):
        row = gpu.loc[name]
        assert row["phase"] == "bw"
        assert row["flops"] == pytest.approx(fwd_flops)      # 2x, halved
        assert row["op_path"] == (
            "sofa_step_0/autograd::engine::evaluate_function: "
            "ConvolutionBackward0/aten::convolution_backward")
        assert row["module"] == "sofa_step_0"


@pytest.mark.parametrize("name,args,flops", [
    # the stem convolution as the H100 trace records it (batch 32, 224^2)
    ("aten::cudnn_convolution", {
        "Input Dims": [[32, 3, 224, 224], [64, 3, 7, 7]] + [[]] * 7,
        "Input type": [BF16, BF16, "ScalarList", "ScalarList", "ScalarList",
                       "Scalar", "Scalar", "Scalar", "Scalar"],
        "Concrete Inputs": ["", "", "[3, 3]", "[2, 2]", "[1, 1]", "1", "True",
                            "False", "True"]},
     2.0 * 32 * 64 * 112 * 112 * 3 * 7 * 7),
    ("aten::addmm", {
        "Input Dims": [[1000], [32, 2048], [2048, 1000], [], []],
        "Input type": ["float"] * 3 + ["Scalar"] * 2,
        "Concrete Inputs": ["", "", "", "1", "1"]},
     2.0 * 32 * 2048 * 1000),
    ("aten::convolution_backward", {      # the stem: no input gradient
        "Input Dims": [[32, 64, 112, 112], [32, 3, 224, 224],
                       [64, 3, 7, 7]] + [[]] * 8,
        "Input type": [BF16] * 3 + ["ScalarList"] * 4 + ["Scalar",
                                                          "ScalarList",
                                                          "Scalar",
                                                          "ScalarList"],
        "Concrete Inputs": ["", "", "", "[0]", "[2, 2]", "[3, 3]", "[1, 1]",
                            "False", "[0, 0]", "1", "[False, True, False]"]},
     2.0 * 32 * 64 * 112 * 112 * 3 * 7 * 7),
])
def test_op_cost_formulas(name, args, flops):
    got, nbytes = costs.op_cost(name, args)
    assert got == flops and nbytes > 0


def test_cost_range_names_round_trip():
    name = costs.cost_range_name("sofa_flash_bwd_dq", 4, 2048, 2048, 32, 8,
                                 128, True)
    assert costs.is_cost_range(name) and not costs.is_cost_range("sofa_step_1")
    assert costs.range_cost(name) == costs.flash_cost(
        "sofa_flash_bwd_dq", 4, 2048, 2048, 32, 8, 128, True)
    assert costs.range_cost("aten::mm") is None
