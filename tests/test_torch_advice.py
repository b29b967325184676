"""The port's hints (sofa_tpu_torch/analysis/advice.py) against the JAX
package's rules on the same feature vector: the JAX one under its
``tpu<N>_`` names (``tpu<N>_op_time`` for the kernel time, ``mxu_util_mean``
for the tensor cores), the port's under ``gpu<N>_``.  For each ported rule
a vector that fires it and one that keeps it quiet; the same rules must
fire, on the same device, with the same numbers in the text.  The busiest
vector puts the worst device at 3, not 0, since the worst device drives
each rule."""

import os
import re

import pytest

from sofa_tpu.analysis.advice import generate_hints as jax_generate_hints
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu_torch.analysis.advice import generate_hints, hint_report
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig

# rule -> (JAX text prefix, port text prefix)
RULES = {
    "roofline": (r"ops on tpu\d+ run at", r"kernels on gpu\d+ run at"),
    "exposed": (r"exposed DMA latency on", r"exposed copy latency on"),
    "idle": (r"device idle inside steps on", r"device idle inside steps on"),
    "tensor": (r"MXU utilization is low", r"tensor-core utilization is low"),
    "iowait": (r"I/O-wait dominates", r"I/O-wait dominates"),
    "idle_wall": (r"\d+% of wall time is idle", r"\d+% of wall time is idle"),
    "cpu": (r"host CPU is saturated", r"host CPU is saturated"),
}

# port feature name -> JAX feature name
_JAX_NAME = [(r"^gpu(\d+)_kernel_time$", r"tpu\1_op_time"),
             (r"^gpu(\d+)_", r"tpu\1_"),
             (r"^tensor_util_mean$", "mxu_util_mean")]

# rule -> (firing features, quiet features), port names
CASES = {
    "roofline": (
        {"gpu0_roofline_efficiency": 0.62, "gpu3_roofline_efficiency": 0.213,
         "gpu3_memory_bound_time": 0.5, "gpu3_compute_bound_time": 0.2},
        {"gpu0_roofline_efficiency": 0.4, "gpu3_roofline_efficiency": 0.91}),
    "roofline_compute": (
        {"gpu1_roofline_efficiency": 0.35, "gpu1_memory_bound_time": 0.1,
         "gpu1_compute_bound_time": 0.9},
        {"gpu1_roofline_efficiency": 0.45, "gpu1_compute_bound_time": 0.9}),
    "exposed": (
        {"gpu0_async_hidden_pct": 40.0, "gpu0_async_time": 0.2,
         "gpu0_kernel_time": 1.0, "gpu2_async_hidden_pct": 12.4,
         "gpu2_async_time": 0.1, "gpu2_kernel_time": 1.0},
        {"gpu2_async_hidden_pct": 12.4, "gpu2_async_time": 0.04,
         "gpu2_kernel_time": 1.0, "gpu0_async_hidden_pct": 50.0,
         "gpu0_async_time": 0.5, "gpu0_kernel_time": 1.0}),
    "idle": (
        {"gpu0_step_gap_pct": 20.0, "gpu5_step_gap_pct": 86.12,
         "gpu5_step_h2d_pct": 3.0},
        {"gpu0_step_gap_pct": 15.0, "gpu5_step_gap_pct": 2.0}),
    "idle_h2d": (
        {"gpu1_step_gap_pct": 40.0, "gpu1_step_h2d_pct": 30.5},
        {"gpu1_step_gap_pct": 14.9, "gpu1_step_h2d_pct": 30.5}),
    "tensor": ({"tensor_util_mean": 9.39}, {"tensor_util_mean": 30.0}),
    "iowait": ({"elapsed_iow_ratio": 0.31}, {"elapsed_iow_ratio": 0.2}),
    "idle_wall": ({"elapsed_idl_ratio": 0.77}, {"elapsed_idl_ratio": 0.5}),
    "cpu": ({"cpu_util": 0.93, "num_cores": 8},
            {"cpu_util": 0.93, "num_cores": 0}),
}


def _vectors(feats):
    port, ref = Features(), JaxFeatures()
    for name, value in feats.items():
        port.add(name, value)
        jax_name = name
        for pat, rep in _JAX_NAME:
            jax_name, n = re.subn(pat, rep, jax_name)
            if n:
                break
        ref.add(jax_name, value)
    return port, ref


def _parse(hints, side):
    """{rule: (device, percentages, words)} of a package's hints (every
    number a rule takes from the features is a percentage)."""
    out = {}
    for h in hints:
        rule = next(r for r, prefixes in RULES.items()
                    if re.match(prefixes[side], h))
        dev = re.search(r"\b(?:tpu|gpu)(\d+)\b", h)
        rest = re.sub(r"\b(?:tpu|gpu)\d+\b", "", h)
        out[rule] = (dev.group(1) if dev else None,
                     re.findall(r"\d+(?:\.\d+)?%", rest),
                     [w for w in ("memory-bound", "compute-bound",
                                  "host->device") if w in h])
    return out


def _both(feats):
    port, ref = _vectors(feats)
    got = _parse(generate_hints(port, SofaConfig()), 1)
    want = _parse(jax_generate_hints(ref, JaxConfig()), 0)
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_fires_like_jax(case):
    got, want = _both(CASES[case][0])
    assert got == want
    assert len(got) == 1, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_stays_quiet_like_jax(case):
    got, want = _both(CASES[case][1])
    assert got == want == {}


def test_every_rule_at_once_worst_device_drives():
    feats = {}
    for case in ("roofline", "exposed", "idle", "tensor", "iowait",
                 "idle_wall", "cpu"):
        feats.update(CASES[case][0])
    got, want = _both(feats)
    assert got == want
    assert set(got) == set(RULES)
    assert got["roofline"][0] == "3" and got["exposed"][0] == "2"
    assert got["idle"][0] == "5"
    assert got["idle"][1] == ["14%"]         # 100 - 86.12, rounded
    assert got["roofline"][2] == ["memory-bound"]


def test_texts_speak_of_the_gpu():
    port, _ = _vectors({**CASES["roofline_compute"][0],
                        **CASES["idle"][0], **CASES["tensor"][0]})
    text = "\n".join(generate_hints(port, SofaConfig()))
    assert "tensor cores' tiles" in text and "gpu_input_pipeline.csv" in text
    assert not re.search(r"TPU|MXU|TensorCore|jax|XLA", text)


def test_hint_report_writes_hints_txt_only_when_one_fires(tmp_path, capsys):
    cfg = SofaConfig(logdir=str(tmp_path) + "/")
    port, _ = _vectors(CASES["idle"][0])
    hints = hint_report(port, cfg)
    assert len(hints) == 1
    assert open(cfg.path("hints.txt")).read() == hints[0] + "\n"
    assert "[HINT] device idle inside steps on gpu5" in capsys.readouterr().out
    quiet, _ = _vectors(CASES["idle"][1])
    assert hint_report(quiet, cfg) == []
    assert not os.path.exists(cfg.path("hints.txt"))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_by_regex_matches_jax():
    port, ref = _vectors({"gpu10_step_gap_pct": 1.0, "gpu2_step_gap_pct": 3.0,
                          "xgpu2_step_gap_pct": 9.0})
    port.add("gpu2_step_gap_pct", 4.0)
    ref.add("tpu2_step_gap_pct", 4.0)
    got = port.by_regex(r"gpu\d+_step_gap_pct")
    want = ref.by_regex(r"tpu\d+_step_gap_pct")
    assert [(n.replace("gpu", "tpu"), v) for n, v in got] == want
    assert got == [("gpu10_step_gap_pct", 1.0), ("gpu2_step_gap_pct", 4.0)]
