"""The port's mining layer (``sofa_tpu_torch/ml/``, ``analysis/mlpass.py``)
against the JAX package's ``sofa_tpu/ml/``: the same frames, built from a
numpy seed in the shared 13-column schema (the JAX ``tputrace`` and the
port's ``gputrace``), through both, with exact agreement: the suffix
automaton and the occurrence scans (hypothesis-drawn sequences too),
``detect_iterations``, the ``sofa_aisi`` tables in every mode both
packages have, the swarms, and the three diff tables.  Then what the port
alone does: ``--iterations_from module`` is a usage error, the mining
passes run through the registry and the CLI, and ``diff`` refreshes the
digests of every logdir it writes into."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.ml import aisi as jax_aisi
from sofa_tpu.ml import diff as jax_diff
from sofa_tpu.ml import hsg as jax_hsg
from sofa_tpu.ml import suffix as jax_suffix
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu.trace import write_csv as jax_write_csv
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import MODULE_REFUSAL, SofaConfig
from sofa_tpu_torch.ml import aisi, diff, hsg, suffix
from sofa_tpu_torch.trace import CopyKind, make_frame, write_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TO_JAX = {"gputrace": "tputrace", "gpusteps": "tpusteps"}


# --- suffix ---------------------------------------------------------------------

SEQUENCES = {
    "periodic": list("abcabcabcabc"),
    "warmup": list("xy") + list("abcd") * 7 + list("z"),
    "symbols": [("op", i % 5) for i in range(40)],
    "noisy": list("abcabcabdabcabcabcaxc"),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_suffix_automaton_matches_jax(name):
    seq = SEQUENCES[name]
    ours, ref = suffix.SuffixAutomaton(seq), jax_suffix.SuffixAutomaton(seq)
    assert ours.occurrence_counts() == ref.occurrence_counts()
    for target in (2, 3, 7):
        for prefer in (None, len(seq) / target):
            assert ours.repeat_candidates(target, 1, prefer_len=prefer) == \
                ref.repeat_candidates(target, 1, prefer_len=prefer)
        assert ours.best_repeat(target, 1) == ref.best_repeat(target, 1)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_occurrence_scans_match_jax(name):
    seq = SEQUENCES[name]
    for pattern in (seq[:3], seq[2:6], seq[:1], []):
        assert suffix.find_occurrences(seq, pattern) == \
            jax_suffix.find_occurrences(seq, pattern)
        assert suffix.fuzzy_occurrences(seq, pattern, 0.7) == \
            jax_suffix.fuzzy_occurrences(seq, pattern, 0.7)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 4), min_size=0, max_size=80),
       st.integers(1, 6), st.integers(0, 2))
def test_suffix_and_scans_match_jax_on_drawn_sequences(seq, target, tol):
    ours, ref = suffix.SuffixAutomaton(seq), jax_suffix.SuffixAutomaton(seq)
    assert ours.repeat_candidates(target, tol, prefer_len=3.0) == \
        ref.repeat_candidates(target, tol, prefer_len=3.0)
    pattern = seq[1:4]
    assert suffix.find_occurrences(seq, pattern) == \
        jax_suffix.find_occurrences(seq, pattern)
    assert suffix.fuzzy_occurrences(seq, pattern, 0.6) == \
        jax_suffix.fuzzy_occurrences(seq, pattern, 0.6)
    names = [f"k{v}" for v in seq]
    assert aisi.detect_iterations(names, target) == \
        jax_aisi.detect_iterations(names, target)


def test_fuzzy_cap_warns_in_the_port(capsys):
    seq = list("ab" * 200)
    got = suffix.fuzzy_occurrences(seq, list("ab"), 0.5, max_full_checks=3)
    assert got == jax_suffix.fuzzy_occurrences(seq, list("ab"), 0.5,
                                               max_full_checks=3)
    assert "capped after 3" in capsys.readouterr().err


# --- aisi -------------------------------------------------------------------------

KERNELS = ["gemm_fw", "softmax_fw", "sofa_flash_fwd_kernel", "gemm_bw",
           "sofa_flash_bwd_kv_kernel", "sofa_flash_bwd_dq_kernel"]


def training_frames(seed=0, n_steps=12, warmup=2):
    """A seeded training trace in the port's names: warm-up kernels, then
    ``n_steps`` steps of six kernels, an all-reduce and an H2D copy, each
    step's sofa_step range opened on the host 2 ms before the device runs
    it, syscalls, Python samples; gpusteps at each step's device span."""
    rng = np.random.default_rng(seed)
    gpu, steps, host, strace, py = [], [], [], [], []
    t = 0.0
    for i in range(warmup):
        gpu.append({"timestamp": t, "duration": 0.004, "deviceId": 0,
                    "copyKind": 0, "category": 0, "name": f"warm_{i}",
                    "device_kind": "gpu", "hlo_category": "kernel"})
        t += 0.005
    for s in range(n_steps):
        t0 = t
        host.append({"timestamp": t0 - 0.002, "duration": 0.001 + 0.001 *
                     rng.random(), "pid": 7, "tid": 1,
                     "name": f"sofa_step_{s}", "device_kind": "cpu",
                     "hlo_category": "user_annotation"})
        gpu.append({"timestamp": t, "duration": 0.0005, "deviceId": 0,
                    "copyKind": int(CopyKind.H2D), "category": 2,
                    "payload": 4096, "name": "Memcpy HtoD",
                    "device_kind": "gpu", "hlo_category": "gpu_memcpy"})
        for j, k in enumerate(KERNELS):
            d = float(0.001 + 0.002 * rng.random())
            gpu.append({"timestamp": t, "duration": d, "deviceId": 0,
                        "copyKind": 0, "category": 0, "name": k,
                        "flops": float(rng.integers(1, 10)) * 1e9,
                        "bytes_accessed": float(rng.integers(1, 10)) * 1e6,
                        "phase": "fw" if j < 3 else "bw",
                        "device_kind": "gpu", "hlo_category": "aten::mm",
                        "module": f"sofa_step_{s}"})
            t += d + 1e-5
        d = float(0.0005 + 0.001 * rng.random())
        gpu.append({"timestamp": t, "duration": d, "deviceId": 0,
                    "copyKind": int(CopyKind.ALL_REDUCE), "category": 0,
                    "payload": 1 << 20, "phase": "bw",
                    "name": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL",
                    "device_kind": "gpu", "hlo_category": "nccl:all_reduce"})
        t += d
        steps.append({"timestamp": t0, "duration": t - t0, "deviceId": 0,
                      "event": float(s), "name": f"sofa_step_{s}",
                      "device_kind": "gpu"})
        strace.append({"timestamp": t0 + 0.001, "duration": 0.0005, "pid": 7,
                       "name": "read"})
        t += float(0.001 + 0.002 * rng.random())
    for k in range(int(t / 0.001)):
        py.append({"timestamp": 0.001 * k, "tid": 1, "name": "train",
                   "event": 3.0})
    return {"gputrace": make_frame(gpu), "gpusteps": make_frame(steps),
            "hosttrace": make_frame(host), "strace": make_frame(strace),
            "pystacks": make_frame(py)}


def to_jax(frames, modules=False):
    """The same frames under the JAX names; with ``modules`` the XLA
    module launches the JAX marker anchoring reads, one a step at its
    device span (what the port anchors through gpusteps)."""
    out = {PORT_TO_JAX.get(k, k): jax_make_frame(v.to_dict("records"))
           for k, v in frames.items()}
    if modules:
        out["tpumodules"] = jax_make_frame([
            {"timestamp": r.timestamp, "duration": r.duration,
             "deviceId": r.deviceId, "name": "jit_train_step",
             "device_kind": "tpu"}
            for r in frames["gpusteps"].itertuples(index=False)])
    return out


def _both_aisi(tmp_path, frames, jax_frames, **cfg_kw):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir(exist_ok=True)
    jax_dir.mkdir(exist_ok=True)
    f_port, f_jax = Features(), JaxFeatures()
    got = aisi.sofa_aisi(frames, SofaConfig(logdir=str(port_dir), **cfg_kw),
                         f_port)
    want = jax_aisi.sofa_aisi(jax_frames,
                              JaxConfig(logdir=str(jax_dir), **cfg_kw),
                              f_jax)
    return got, want, f_port, f_jax, port_dir, jax_dir


@pytest.mark.parametrize("mode", ["auto", "steps", "marker", "op"])
def test_sofa_aisi_tables_equal_jax(tmp_path, mode):
    frames = training_frames()
    got, want, f_port, f_jax, pd_, jd = _both_aisi(
        tmp_path, frames, to_jax(frames, modules=True), num_iterations=12,
        iterations_from=mode)
    assert got is not None and len(got) == 12
    pd.testing.assert_frame_equal(got, want)
    assert f_port.to_frame().equals(f_jax.to_frame())
    assert (pd_ / "iterations.csv").read_bytes() == \
        (jd / "iterations.csv").read_bytes()


def test_marker_mode_without_device_anchor_equals_jax(tmp_path):
    """No device step spans: the host markers stand, the last padded to a
    median period, in both packages."""
    frames = training_frames(seed=3)
    frames["gpusteps"] = make_frame([])
    got, want, *_ = _both_aisi(tmp_path, frames, to_jax(frames),
                               num_iterations=12, iterations_from="marker")
    assert got is not None and len(got) == 12
    pd.testing.assert_frame_equal(got, want)
    assert got["begin"].iloc[0] == frames["hosttrace"]["timestamp"].iloc[0]


def test_marker_anchors_at_the_device_step(tmp_path):
    frames = training_frames(seed=1)
    got, *_ = _both_aisi(tmp_path, frames, to_jax(frames, modules=True),
                         num_iterations=12, iterations_from="marker")
    steps = frames["gpusteps"]
    assert list(got["begin"]) == list(steps["timestamp"])
    assert got["end"].iloc[-1] == pytest.approx(
        steps["timestamp"].iloc[-1] + steps["duration"].iloc[-1])


def test_op_mining_finds_the_steps_past_warmup(tmp_path):
    frames = training_frames(seed=2, n_steps=20, warmup=3)
    names = list(aisi._op_sequence(frames["gputrace"])["name"])
    assert aisi.detect_iterations(names, 20) == \
        jax_aisi.detect_iterations(names, 20)
    got, want, f_port, *_ = _both_aisi(
        tmp_path, frames, to_jax(frames), num_iterations=20,
        iterations_from="op")
    assert len(got) == 20
    pd.testing.assert_frame_equal(got, want)
    # the all-reduce is 1 of 9 device rows a step: a compute-bound verdict
    assert f_port.get("aisi_comm_ratio") < aisi.COMM_BOUND_RATIO


@pytest.mark.parametrize("mode", ["steps", "marker"])
def test_a_required_source_that_is_missing_gives_none(tmp_path, mode):
    frames = training_frames()
    frames.pop("gpusteps")
    frames.pop("hosttrace")
    got, want, *_ = _both_aisi(tmp_path, frames, to_jax(frames),
                               num_iterations=12, iterations_from=mode)
    assert got is None and want is None


def test_module_source_is_a_usage_error(tmp_path, capsys):
    with pytest.raises(ValueError, match="XLA module launches"):
        SofaConfig(iterations_from="module")
    cfg = SofaConfig(logdir=str(tmp_path))
    cfg.iterations_from = "module"      # set past the config's check
    with pytest.raises(ValueError, match="XLA module launches"):
        aisi.sofa_aisi(training_frames(), cfg, Features())
    from sofa_tpu_torch.cli import main

    assert main(["analyze", "--logdir", str(tmp_path), "--enable_aisi",
                 "--iterations_from", "module"]) == 2
    assert MODULE_REFUSAL in capsys.readouterr().err


def test_iteration_series_names_the_gpu():
    table = pd.DataFrame({"iteration": [0, 1], "begin": [0.0, 1.0],
                          "step_time": [1.0, 1.5]})
    ours = aisi.iteration_series(table)
    ref = jax_aisi.iteration_series(table)
    assert ours.to_columnar() == ref.to_columnar()
    assert set(ours.data["device_kind"]) == {"gpu"}


# --- hsg --------------------------------------------------------------------------

def sample_frame(seed=0, n=400, groups=4):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n)
    return make_frame({"timestamp": np.arange(n) * 1e-3,
                       "event": g * 10.0 + rng.normal(0, 0.3, n),
                       "duration": rng.uniform(1e-5, 1e-3, n),
                       "name": [f"func_{v}" for v in g],
                       "device_kind": ["cpu"] * n})


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 3), (2, 10), (3, 1)])
def test_hsg_cluster_assignment_equals_jax(seed, k):
    df = sample_frame(seed)
    ours = hsg.hsg_cluster(df, k)
    ref = jax_hsg.hsg_cluster(jax_make_frame(df.to_dict("records")), k)
    assert ours["cluster_ID"].tolist() == ref["cluster_ID"].tolist()


@pytest.mark.parametrize("source", ["cputrace", "hosttrace"])
def test_sofa_hsg_artifacts_equal_jax(tmp_path, source):
    df = sample_frame(5)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    f_port, f_jax = Features(), JaxFeatures()
    hsg.sofa_hsg({source: df}, SofaConfig(logdir=str(tmp_path / "p"),
                                          num_swarms=4), f_port)
    jax_hsg.sofa_hsg({source: jax_make_frame(df.to_dict("records"))},
                     JaxConfig(logdir=str(tmp_path / "j"), num_swarms=4),
                     f_jax)
    for name in ("auto_caption.csv", "swarms_report.csv",
                 "swarms_report.txt"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert f_port.get("hsg_swarms") == f_jax.get("hsg_swarms") == 4


def test_swarm_series_equal_jax():
    clustered = hsg.hsg_cluster(sample_frame(6), 3)
    ours = hsg.swarm_series(clustered, 3)
    ref = jax_hsg.swarm_series(jax_hsg.hsg_cluster(
        jax_make_frame(sample_frame(6).to_dict("records")), 3), 3)
    assert [(s.name, s.title, s.color) for s in ours] == \
        [(s.name, s.title, s.color) for s in ref]


# --- diff -------------------------------------------------------------------------

def _run_dirs(tmp_path, side, frames, seed):
    """One run's logdir for each package: the kernel frame under its own
    name, a memprof snapshot, and its swarms' auto_caption.csv."""
    from sofa_tpu_torch.collectors import gpumon

    rng = np.random.default_rng(seed)
    samples = [([(f"site_{i}", "train.py", 10 + i)], "cuda:0", "buffer",
                int(rng.integers(1, 4)), int(rng.integers(1, 9)) << 20)
               for i in range(5)]
    import gzip

    blob = gzip.compress(gpumon._ns["_pprof_encode"](samples))
    out = {}
    for pkg in ("port", "jax"):
        d = tmp_path / f"{side}_{pkg}"
        d.mkdir()
        if pkg == "port":
            write_csv(frames["gputrace"], str(d / "gputrace.csv"))
            hsg.sofa_hsg({"cputrace": sample_frame(seed)},
                         SofaConfig(logdir=str(d), num_swarms=4), Features())
        else:
            jax_write_csv(jax_make_frame(frames["gputrace"].to_dict(
                "records")), str(d / "tputrace.csv"))
            jax_hsg.sofa_hsg({"cputrace": jax_make_frame(sample_frame(
                seed).to_dict("records"))}, JaxConfig(logdir=str(d),
                                                      num_swarms=4),
                JaxFeatures())
        (d / "memprof.pb.gz").write_bytes(blob)
        out[pkg] = str(d) + "/"
    return out


def test_the_three_diff_tables_equal_jax(tmp_path):
    base = _run_dirs(tmp_path, "base", training_frames(seed=7), 7)
    match = _run_dirs(tmp_path, "match", training_frames(seed=8), 8)
    port_cfg = SofaConfig(logdir=str(tmp_path / "out_p"),
                          base_logdir=base["port"],
                          match_logdir=match["port"])
    jax_cfg = JaxConfig(logdir=str(tmp_path / "out_j"),
                        base_logdir=base["jax"], match_logdir=match["jax"])
    got = diff.sofa_gpu_diff(port_cfg)
    want = jax_diff.sofa_tpu_diff(jax_cfg)
    pd.testing.assert_frame_equal(got, want)
    assert (tmp_path / "out_p" / "gpu_diff.csv").read_bytes() == \
        (tmp_path / "out_j" / "tpu_diff.csv").read_bytes()
    for ours, ref, name in ((diff.sofa_mem_diff, jax_diff.sofa_mem_diff,
                             "mem_diff.csv"),
                            (diff.sofa_swarm_diff, jax_diff.sofa_swarm_diff,
                             "swarm_diff.csv")):
        pd.testing.assert_frame_equal(ours(port_cfg), ref(jax_cfg))
        assert (tmp_path / "out_p" / name).read_bytes() == \
            (tmp_path / "out_j" / name).read_bytes(), name


def test_delta_conventions_match_jax(tmp_path):
    base = pd.DataFrame({"time": [0.01, 0.005, 0.002, 0.0]},
                        index=pd.Index(["a", "b", "gone", "zero"],
                                       name="name"))
    match = pd.DataFrame({"time": [0.02, 0.005, 0.001, 0.0]},
                         index=pd.Index(["a", "b", "new", "zero"],
                                        name="name"))
    ours = diff._delta_table(base, match, "time", str(tmp_path / "p.csv"))
    ref = jax_diff._delta_table(base, match, "time", str(tmp_path / "j.csv"))
    pd.testing.assert_frame_equal(ours, ref)
    by = ours.set_index("name")
    assert np.isinf(by.loc["new", "ratio"]) and by.loc["gone", "ratio"] == 0
    assert by.loc["zero", "ratio"] == 1.0


def test_match_swarms_equal_jax():
    a = diff._cluster_signatures(hsg.hsg_cluster(sample_frame(9), 4))
    b = diff._cluster_signatures(hsg.hsg_cluster(sample_frame(10), 4))
    assert diff.match_swarms(a, b) == jax_diff.match_swarms(a, b)


def test_swarm_diff_of_a_side_without_clusters_is_a_warning(tmp_path,
                                                            capsys):
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    (tmp_path / "a" / "auto_caption.csv").write_text("x,y\n1,2\n")
    (tmp_path / "b" / "auto_caption.csv").write_text("x,y\n1,2\n")
    cfg = SofaConfig(logdir=str(tmp_path / "o"),
                     base_logdir=str(tmp_path / "a"),
                     match_logdir=str(tmp_path / "b"))
    assert diff.sofa_swarm_diff(cfg) is None
    assert "missing column(s)" in capsys.readouterr().err


# --- the passes and the verb, end to end ----------------------------------------

@pytest.fixture(scope="module")
def sink_dir(tmp_path_factory):
    from test_torch_board import write_sink_logdir

    d = str(tmp_path_factory.mktemp("ml_sink")) + "/run/"
    write_sink_logdir(d, n_steps=6)
    r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "report",
                        "--logdir", d], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return d


def _copy(src, tmp_path, name):
    dst = str(tmp_path / name) + "/"
    shutil.copytree(src, dst)
    return dst


def test_analyze_runs_aisi_and_hsg_through_the_registry(sink_dir, tmp_path):
    from sofa_tpu_torch import telemetry
    from sofa_tpu_torch.trace import read_report_js_doc

    d = _copy(sink_dir, tmp_path, "a")
    r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "analyze",
                        "--logdir", d, "--enable_aisi", "--enable_hsg",
                        "--num_swarms", "3"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "Complete!!" in r.stdout, r.stderr
    ledger = telemetry.load_manifest(d)["meta"]["passes"]["passes"]
    assert ledger["aisi"]["status"] == ledger["hsg"]["status"] == "ok"
    it = pd.read_csv(d + "iterations.csv")
    assert len(it) == 6
    feats = pd.read_csv(d + "features.csv").set_index("name")["value"]
    assert feats["aisi_iterations"] == 6 and feats["hsg_swarms"] <= 3
    names = {s["name"] for s in read_report_js_doc(d + "report.js")
             ["series"]}
    assert "iterations" in names and any(n.startswith("swarm_")
                                         for n in names)
    assert "gputrace" in names      # preprocess's series stay


def test_diff_verb_refreshes_every_digest(sink_dir, tmp_path):
    from sofa_tpu_torch.cli import main
    from sofa_tpu_torch.durability import fsck_scan, fsck_problem_counts

    a = _copy(sink_dir, tmp_path, "a")
    b = _copy(sink_dir, tmp_path, "b")
    out = str(tmp_path / "d") + "/"
    assert main(["diff", "--base_logdir", a, "--match_logdir", b,
                 "--logdir", out]) == 0
    for name in ("gpu_diff.csv", "mem_diff.csv", "swarm_diff.csv",
                 "diff-report.html"):
        assert os.path.isfile(out + name), name
    gd = pd.read_csv(out + "gpu_diff.csv")
    assert (gd["delta"] == 0).all() and len(gd) > 0
    for d in (a, b, out):
        rep = fsck_scan(d)
        assert rep is not None and not any(
            fsck_problem_counts(rep).values()), (d, rep)


def test_diff_verb_exits_1_with_nothing_to_compare(tmp_path, capsys):
    from sofa_tpu_torch.cli import main

    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    assert main(["diff", "--base_logdir", str(tmp_path / "a"),
                 "--match_logdir", str(tmp_path / "b"), "--logdir",
                 str(tmp_path / "o")]) == 1
    assert main(["diff", "--logdir", str(tmp_path / "o")]) == 2
    assert "needs --base_logdir" in capsys.readouterr().err
