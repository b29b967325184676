"""The multi-rank profile: NCCL ingest, the per-rank topology, and the
device communication passes held against the JAX package's.

Ingest: a SYNTHETIC two-rank Kineto capture, hand-built in the shape
torch.profiler writes on a CUDA machine: each rank's trace names its rank
in ``distributedInfo``, its NCCL kernels launch under the
``record_param_comms`` op torch's process group records (the argument
keys are torch's: ``Collective name``, ``dtype``, ``In msg nelems``,
``Out msg nelems``, ``Process Group Ranks``), and the kernel names follow
NCCL's (``ncclDevKernel_AllReduce_Sum_bf16_RING_LL``,
``ncclDevKernel_SendRecv``, and the older
``ncclKernel_AllReduce_RING_LL_Sum_float``).  copyKind, payload, groups,
category and the per-rank deviceId must come out exact.

Passes: ``comm_profile``, ``comm_scatter``, ``step_skew_profile`` and
``mesh_advice`` run over the same rows as the JAX package's (the port's
``gputrace`` from the fixture, the JAX side's ``tputrace`` built from the
same rows), with the name map of ``analysis/comm.py`` (``ici`` -> ``link``,
``tpu`` -> ``gpu``): comm.csv, the link matrix, commtrace.csv and the
skew CSV exact, features atol 1e-12, and the three hint rules that wait
for them (communication ratio, straggler skew, input-bound) fire rule for
rule.  Then the tracer on two spawned gloo ranks (CPU): each trace names
its rank, each rank writes its topology record, and preprocess merges
them.
"""

import json
import os
import re
import time

import numpy as np
import pandas as pd
import pytest

from sofa_tpu.analysis import advice as jax_advice
from sofa_tpu.analysis import comm as jax_comm
from sofa_tpu.analysis import tpu as jax_tpu
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu_torch.analysis import advice, comm, device
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.collectors import kineto as kineto_collector
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest.kineto import ingest_kineto_dir
from sofa_tpu_torch.trace import CopyKind, make_frame
from sofa_tpu_torch.workloads.common import spawn_ranks

BASE_NS = 1_700_000_000_000_000_000
MAIN = 11


def _comms_args(name, dtype, n_in, n_out, ranks):
    """The arguments torch records on ``record_param_comms``."""
    return {"External id": 7, "Collective name": name, "dtype": dtype,
            "In msg nelems": n_in, "Out msg nelems": n_out,
            "In split size": "[]", "Out split size": "[]",
            "Global rank start": 0, "Global rank stride": 1,
            "Group size": len(ranks), "Process Group Name": "0",
            "Process Group Description": "default_pg",
            "Process Group Ranks": json.dumps(ranks), "Rank": 0}


def rank_trace(rank, skew_us=0.0):
    """One rank's capture: three steps, each with a compute kernel, an
    all-reduce of the gradients (its op also launching a torch kernel,
    which stays compute), an all-gather, a reduce-scatter, an
    all-to-all (NCCL's grouped SendRecv), a broadcast and a ring's P2P
    hop launched outside any comms op, an H2D memcpy, and one old-style
    all-reduce kernel with no context."""
    ev = [{"ph": "X", "cat": "user_annotation", "pid": 100 + rank,
           "tid": MAIN, "ts": 1.0, "dur": 1.0,
           "name": f"sofa_timebase_marker:{BASE_NS + 1000}"}]
    corr = [0]

    def launch(t, name, args=None, cat="kernel", nbytes=0):
        corr[0] += 1
        c = corr[0]
        ev.append({"ph": "X", "cat": "cuda_runtime", "pid": 100 + rank,
                   "tid": MAIN, "ts": t, "dur": 2.0,
                   "name": "cudaLaunchKernel" if cat == "kernel"
                   else "cudaMemcpyAsync", "args": {"correlation": c}})
        dev_args = {"device": 0, "stream": 7, "correlation": c}
        if nbytes:
            dev_args["bytes"] = nbytes
        ev.append({"ph": "X", "cat": cat, "pid": 0, "tid": 7, "ts": t + 5,
                   "dur": 20.0 + rank, "name": name, "args": dev_args})

    def comms(t, name, kernel, dtype, n_in, n_out, ranks=(0, 1), also=None):
        ev.append({"ph": "X", "cat": "cpu_op", "pid": 100 + rank,
                   "tid": MAIN, "ts": t, "dur": 10.0,
                   "name": "record_param_comms",
                   "args": _comms_args(name, dtype, n_in, n_out,
                                       list(ranks))})
        if also:                # a torch kernel the process group launches
            launch(t + 1, also)
        launch(t + 2, kernel)

    for step in range(3):
        t0 = 1000.0 * (step + 1) + skew_us * (step + 1)
        ev.append({"ph": "X", "cat": "user_annotation", "pid": 100 + rank,
                   "tid": MAIN, "ts": t0, "dur": 900.0,
                   "name": f"sofa_step_{step}"})
        launch(t0 + 10, "Memcpy HtoD (Pageable -> Device)", cat="gpu_memcpy",
               nbytes=4096)
        launch(t0 + 40, "sm90_xmma_gemm_bf16bf16_bf16f32")
        comms(t0 + 100, "allreduce",
              "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgs"
              "Storage<4096ul>)", "BFloat16", 1000, 1000,
              also="CatArrayBatchedCopy_contig<OpaqueType<2u>, unsigned int>")
        comms(t0 + 200, "_allgather_base",
              "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage"
              "<4096ul>)", "Float", 1000, 2000)
        comms(t0 + 300, "_reduce_scatter_base",
              "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernel"
              "ArgsStorage<4096ul>)", "Float", 2000, 1000)
        comms(t0 + 400, "all_to_all",
              "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
              "BFloat16", 512, 512)
        comms(t0 + 500, "broadcast",
              "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage"
              "<4096ul>)", "Half", 300, 300)
        launch(t0 + 600, "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage"
               "<4096ul>)")
        launch(t0 + 700, "ncclKernel_AllReduce_RING_LL_Sum_float(ncclWork*)")
    return {"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
            "distributedInfo": {"backend": "nccl", "rank": rank,
                                "world_size": 2},
            "traceEvents": ev}


def write_capture(d, skew_us=40.0):
    """Two ranks' traces under ``d/kineto`` and their topology records
    (two ranks sharing one card), merged."""
    os.makedirs(os.path.join(d, "kineto"), exist_ok=True)
    os.makedirs(os.path.join(d, "gpu_topo"), exist_ok=True)
    for rank in (0, 1):
        with open(os.path.join(d, "kineto", f"trace_{200 + rank}.json"),
                  "w") as f:
            json.dump(rank_trace(rank, skew_us * rank), f)
        with open(os.path.join(d, "gpu_topo", f"rank_{rank}.json"),
                  "w") as f:
            json.dump({"cuda_available": True, "rank": rank,
                       "world_size": 2, "backend": "nccl", "host": "node0",
                       "pid": 200 + rank, "cuda_ordinal": 0,
                       "peer_access": [],
                       "devices": [{"index": 0, "uuid": "GPU-abc",
                                    "name": "NVIDIA H100 80GB HBM3"}]}, f)
    assert kineto_collector.merge_rank_topology(d)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks")) + "/"
    write_capture(d)
    frames = ingest_kineto_dir(d + "kineto", BASE_NS / 1e9)
    return d, frames


def _kernel(frames, rank, needle, nth=0):
    gpu = frames["gputrace"]
    rows = gpu[(gpu["deviceId"] == rank)
               & gpu["name"].str.contains(needle, regex=False)]
    return rows.iloc[nth]


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("needle,kind,payload,groups", [
    ("AllReduce_Sum_bf16", CopyKind.ALL_REDUCE, 2000, "[[0, 1]]"),
    ("AllGather", CopyKind.ALL_GATHER, 8000, "[[0, 1]]"),
    ("ReduceScatter", CopyKind.REDUCE_SCATTER, 8000, "[[0, 1]]"),
    ("Broadcast", CopyKind.COLLECTIVE_BROADCAST, 600, "[[0, 1]]"),
    ("ncclKernel_AllReduce", CopyKind.ALL_REDUCE, 0, ""),
    ("sm90_xmma_gemm", CopyKind.KERNEL, 0, ""),
    ("CatArrayBatchedCopy", CopyKind.KERNEL, 0, ""),
    ("Memcpy HtoD", CopyKind.H2D, 4096, ""),
], ids=["all_reduce", "all_gather", "reduce_scatter", "broadcast",
        "old_name_no_context", "compute", "torch_kernel_under_the_op",
        "memcpy"])
def test_nccl_kernels_take_their_collective(capture, rank, needle, kind,
                                            payload, groups):
    row = _kernel(capture[1], rank, needle)
    assert row["copyKind"] == int(kind)
    assert row["payload"] == payload
    assert row["groups"] == groups
    assert row["category"] == (2 if kind == CopyKind.H2D else 0)


@pytest.mark.parametrize("rank", [0, 1])
def test_a_sendrecv_is_all_to_all_only_under_its_op(capture, rank):
    """NCCL's grouped SendRecv serves all_to_all (its context says so) and
    a ring's P2P hop (none does): the name alone means P2P."""
    under_op = _kernel(capture[1], rank, "SendRecv", 0)
    bare = _kernel(capture[1], rank, "SendRecv", 1)
    assert under_op["copyKind"] == int(CopyKind.ALL_TO_ALL)
    assert under_op["payload"] == 1024 and under_op["groups"] == "[[0, 1]]"
    assert bare["copyKind"] == int(CopyKind.P2P) and bare["payload"] == 0


def test_each_rank_is_a_device(capture):
    """Both traces say device 0 (one card); their ranks make them two."""
    frames = capture[1]
    assert sorted(frames["gputrace"]["deviceId"].unique()) == [0, 1]
    steps = frames["gpusteps"]
    assert sorted(steps["deviceId"].unique()) == [0, 1]
    assert len(steps) == 6


def test_merged_topology_names_two_ranks_on_one_card(capture):
    topo = comm.load_topology(SofaConfig(logdir=capture[0]))
    devices = topo["devices"]
    assert [d["id"] for d in devices] == [0, 1]
    assert {(d["host"], d["cuda_ordinal"], d["uuid"]) for d in devices} == {
        ("node0", 0, "GPU-abc")}
    assert topo["world_size"] == 2 and len(topo["ranks"]) == 2
    assert all(d["name"] == "NVIDIA H100 80GB HBM3" for d in devices)


def test_no_rank_records_leave_the_topology_alone(tmp_path):
    (tmp_path / "gpu_topo.json").write_text('{"devices": []}')
    assert not kineto_collector.merge_rank_topology(str(tmp_path))
    assert (tmp_path / "gpu_topo.json").read_text() == '{"devices": []}'


def test_rank_gpumon_files_are_the_ranks_devices(tmp_path):
    from sofa_tpu_torch.ingest.gpumon_parse import gpumon_files, ingest_gpumon

    for name, used in (("gpumon.txt", 1), ("gpumon.rank1.txt", 2)):
        (tmp_path / name).write_text(
            f"{BASE_NS} -1 0 0 0\n{BASE_NS} 0 {used * 10 ** 9} "
            f"{80 * 10 ** 9} {used * 10 ** 9}\n")
    assert [os.path.basename(p) for p in gpumon_files(str(tmp_path))] == \
        ["gpumon.txt", "gpumon.rank1.txt"]
    df = ingest_gpumon(str(tmp_path), BASE_NS / 1e9)
    used = df[df["name"] == "hbm_used_gb"].set_index("deviceId")["event"]
    assert used.to_dict() == {0: 1.0, 1: 2.0}


def test_sampler_names_follow_the_group(monkeypatch):
    """A plain process writes the plain names; a torchrun worker (RANK in
    its environment) its pid's until it joins a group, then its rank's
    (the plain ones in a group of one); the rank sticks once noted."""
    from sofa_tpu_torch.collectors import gpumon

    ns = gpumon._ns
    monkeypatch.setitem(ns, "_group_rank", lambda: None)
    monkeypatch.delenv("RANK", raising=False)
    plain = ns["_Names"](out="/l/gpumon.txt", memprof="/l/memprof.pb.gz")
    assert plain.get("out") == "/l/gpumon.txt"
    assert plain.get("memprof") == "/l/memprof.pb.gz"
    monkeypatch.setenv("RANK", "3")     # says only: may become a rank
    pid = os.getpid()
    for world, out, memprof in ((4, "/l/gpumon.rank1.txt",
                                 "/l/memprof.rank1.pb.gz"),
                                (1, "/l/gpumon.txt", "/l/memprof.pb.gz")):
        names = ns["_Names"](out="/l/gpumon.txt", memprof="/l/memprof.pb.gz")
        assert names.get("out") == f"/l/gpumon.pid{pid}.txt"
        assert names.get("memprof") == f"/l/memprof.pid{pid}.pb.gz"
        names.update()                  # no group yet
        assert names.get("out") == f"/l/gpumon.pid{pid}.txt"
        monkeypatch.setitem(ns, "_group_rank", lambda w=world: (1, w))
        names.update()
        assert (names.get("out"), names.get("memprof")) == (out, memprof)
        monkeypatch.setitem(ns, "_group_rank", lambda: None)   # torn down
        names.update()
        assert names.get("out") == out
    assert ns["_Names"](out="/l/gpumon.txt").get("memprof") is None


def _sampled_rank(rank, store, logdir):
    """One spawned rank (no RANK in its environment) under the memory
    sampler, with a stand-in for an initialized card (device 0, the same
    for both ranks, as two ranks sharing one card): it samples under its
    pid's name, joins the group, and its file moves to its rank's name."""
    import threading
    import types

    from sofa_tpu_torch.collectors import gpumon
    from sofa_tpu_torch.workloads.common import init_distributed

    assert "RANK" not in os.environ
    used = (rank + 1) * 10 ** 9
    card = types.SimpleNamespace(cuda=types.SimpleNamespace(
        memory_stats=lambda d: {"allocated_bytes.all.current": used,
                                "allocated_bytes.all.peak": used},
        get_device_properties=lambda d: types.SimpleNamespace(
            total_memory=80 * 10 ** 9)))
    gpumon._ns["_cuda_ready"] = lambda: card
    gpumon._ns["_live_devices"] = lambda torch: [0]

    def wait_for(path):
        deadline = time.monotonic() + 30
        while not (os.path.exists(path) and os.path.getsize(path)):
            assert time.monotonic() < deadline, path
            time.sleep(0.01)

    stop = threading.Event()
    t = gpumon.start_sampler(100.0, os.path.join(logdir, "gpumon.txt"),
                             stop)
    wait_for(os.path.join(logdir, f"gpumon.pid{os.getpid()}.txt"))
    init_distributed(device="cpu", store_path=store, rank=rank,
                     world_size=2)
    wait_for(os.path.join(logdir, f"gpumon.rank{rank}.txt"))
    stop.set()
    t.join(5)
    assert t.names.get("out").endswith(f"gpumon.rank{rank}.txt")
    import torch.distributed as dist

    dist.destroy_process_group()


def test_rank_files_do_not_collide(tmp_path):
    """Two ranks spawned by torch.multiprocessing (no RANK in their
    environment) sharing one card: two gpumon files, named by the ranks
    the process group gives them, ingested as devices 0 and 1."""
    from sofa_tpu_torch.ingest.gpumon_parse import ingest_gpumon

    logdir = tmp_path / "run"
    logdir.mkdir()
    spawn_ranks(2, _sampled_rank, str(tmp_path / "store"), str(logdir),
                timeout=120.0)
    # each with its cards' names beside it, moved to the rank's name too
    assert sorted(os.listdir(logdir)) == [
        "gpumon.rank0.txt", "gpumon.rank0.txt.meta.json",
        "gpumon.rank1.txt", "gpumon.rank1.txt.meta.json"]
    df = ingest_gpumon(str(logdir))
    used = df[df["name"] == "hbm_used_gb"].groupby("deviceId")["event"]
    assert used.unique().apply(list).to_dict() == {0: [1.0], 1: [2.0]}


def test_a_rank_on_several_cards_keeps_their_ordinals(tmp_path, capsys):
    """A rank whose rows name two cards is not folded into one device."""
    from sofa_tpu_torch.ingest.gpumon_parse import ingest_gpumon

    (tmp_path / "gpumon.rank1.txt").write_text(
        f"{BASE_NS} 0 {10 ** 9} {80 * 10 ** 9} 0\n"
        f"{BASE_NS} 1 {10 ** 9} {80 * 10 ** 9} 0\n")
    df = ingest_gpumon(str(tmp_path), BASE_NS / 1e9)
    assert sorted(df["deviceId"].unique()) == [0, 1]
    assert "rank 1 sampled cards [0, 1]" in capsys.readouterr().err


def test_a_rank_trace_on_several_cards_keeps_their_ordinals(capsys):
    from sofa_tpu_torch.ingest.kineto import ingest_trace

    doc = rank_trace(1)
    kernels = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"]
    kernels[0]["args"]["device"] = 1
    gpu = ingest_trace(doc, BASE_NS / 1e9)["gputrace"]
    assert sorted(gpu["deviceId"].unique()) == [0, 1]
    assert "rank 1 drives cards [0, 1]" in capsys.readouterr().err


# --- the passes against the JAX package's -----------------------------------

def _jax_frame(df):
    """The port's rows as the JAX package's tputrace (same columns), with
    the NCCL P2P kernels on the asynchronous line (category 2), where the
    JAX pass counts P2P next to the copies: the port counts them always
    (analysis/comm.py's one deliberate difference)."""
    cols = {c: df[c].to_numpy().copy() for c in (
        "timestamp", "duration", "deviceId", "category", "copyKind",
        "payload", "groups", "name")}
    p2p = (cols["category"] == 0) & (cols["copyKind"] == int(CopyKind.P2P))
    cols["category"][p2p] = 2
    return jax_make_frame(cols)


def _net():
    rng = np.random.default_rng(4)
    n = 40
    return dict(timestamp=np.sort(rng.uniform(0, 0.004, n)),
                duration=rng.uniform(1e-6, 1e-5, n),
                payload=rng.integers(60, 1500, n),
                pkt_src=rng.choice([0x0A000001, 0x0A000002], n),
                pkt_dst=rng.choice([0x0A000003, 0x0A000004], n))


def _topologies(port_dir, jax_dir, n=2):
    with open(os.path.join(jax_dir, "tpu_topo.json"), "w") as f:
        json.dump({"devices": [{"id": i, "process_index": 0}
                               for i in range(n)]}, f)
    if not os.path.isfile(os.path.join(port_dir, "gpu_topo.json")):
        with open(os.path.join(port_dir, "gpu_topo.json"), "w") as f:
            json.dump({"devices": [{"id": i, "index": i}
                                   for i in range(n)]}, f)


LINK_MAP = [(r"ici", "link"), (r"tpu(\d)", r"gpu\1")]


def _to_port(text):
    for pat, rep in LINK_MAP:
        text = re.sub(pat, rep, text)
    return text


@pytest.fixture
def both(capture, tmp_path):
    d, frames = capture
    port_dir, jax_dir = str(tmp_path / "port") + "/", str(tmp_path / "jax")
    os.makedirs(port_dir)
    os.makedirs(jax_dir)
    with open(os.path.join(d, "gpu_topo.json")) as f:
        topo = f.read()
    with open(port_dir + "gpu_topo.json", "w") as f:
        f.write(topo)
    _topologies(port_dir, jax_dir)
    port_cfg = SofaConfig(logdir=port_dir)
    jax_cfg = JaxConfig(logdir=jax_dir + "/")
    port_frames = {"gputrace": frames["gputrace"],
                   "nettrace": make_frame(_net()),
                   "gpusteps": frames["gpusteps"]}
    jax_frames = {"tputrace": _jax_frame(frames["gputrace"]),
                  "nettrace": jax_make_frame(_net()),
                  "tpusteps": jax_make_frame(
                      {c: frames["gpusteps"][c].to_numpy() for c in
                       ("timestamp", "duration", "deviceId", "event",
                        "name")})}
    return port_cfg, port_frames, jax_cfg, jax_frames


def _features_equal(port, ref):
    got = dict(port.items()) if hasattr(port, "items") else port
    want = {_to_port(k): v for k, v in ref.items()}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, abs=1e-12), k


def _feats(f):
    return {name: value for name, value in f.to_frame().itertuples(
        index=False, name=None)}


def test_comm_profile_matches_jax(both):
    port_cfg, port_frames, jax_cfg, jax_frames = both
    pf, jf = Features(), JaxFeatures()
    comm.comm_profile(port_frames, port_cfg, pf)
    jax_comm.comm_profile(jax_frames, jax_cfg, jf)
    got, want = _feats(pf), _feats(jf)
    # comm_ratio's denominator holds every kernel, the P2P hops too
    gpu = port_frames["gputrace"]
    kernels = float(gpu.loc[gpu["category"] == 0, "duration"].sum())
    assert got.pop("comm_ratio") == pytest.approx(
        got["comm_time"] / kernels, abs=1e-12)
    want.pop("comm_ratio")
    _features_equal(got, want)
    assert got["comm_p2p_time"] > 0 and pf.get("link_est_bytes") > 0
    got = pd.read_csv(port_cfg.path("comm.csv"))
    want = pd.read_csv(os.path.join(jax_cfg.logdir, "comm.csv"))
    want.columns = [_to_port(c) for c in want.columns]
    pd.testing.assert_frame_equal(got, want)
    assert set(got["kind"]) == {"H2D", "P2P", "ALL_REDUCE", "ALL_GATHER",
                                "REDUCE_SCATTER", "ALL_TO_ALL",
                                "COLLECTIVE_BROADCAST"}
    got = pd.read_csv(port_cfg.path("link_matrix.csv"), index_col=0)
    want = pd.read_csv(os.path.join(jax_cfg.logdir, "ici_matrix.csv"),
                       index_col=0)
    want.index = [_to_port(x) for x in want.index]
    want.columns = [_to_port(x) for x in want.columns]
    pd.testing.assert_frame_equal(got, want)
    assert list(got.index) == ["gpu0", "gpu1"]


def test_comm_scatter_matches_jax(both):
    port_cfg, port_frames, jax_cfg, jax_frames = both
    comm.comm_scatter(port_frames, port_cfg, Features())
    jax_comm.comm_scatter(jax_frames, jax_cfg, JaxFeatures())
    got = pd.read_csv(port_cfg.path("commtrace.csv"))
    want = pd.read_csv(os.path.join(jax_cfg.logdir, "commtrace.csv"))
    want["cls"] = want["cls"].map(_to_port)
    want["peer"] = want["peer"].map(_to_port)
    pd.testing.assert_frame_equal(got, want)
    assert set(got["cls"]) == {"link", "dcn"}


def test_step_skew_matches_jax(both):
    port_cfg, port_frames, jax_cfg, jax_frames = both
    pf, jf = Features(), JaxFeatures()
    device.step_skew_profile(port_frames, port_cfg, pf)
    jax_tpu.step_skew_profile(jax_frames, jax_cfg, jf)
    _features_equal(_feats(pf), _feats(jf))
    got = pd.read_csv(port_cfg.path("gpu_step_skew.csv"))
    want = pd.read_csv(os.path.join(jax_cfg.logdir, "tpu_step_skew.csv"))
    pd.testing.assert_frame_equal(got, want)
    # rank 1 starts each step 40 us later than the one before
    assert list(got["count"]) == [2, 2, 2]
    assert pf.get("step_skew_max") > pf.get("step_skew_mean") > 0


def test_one_device_has_no_skew(both):
    port_cfg, port_frames, _, _ = both
    steps = port_frames["gpusteps"]
    f = Features()
    device.step_skew_profile({"gpusteps": steps[steps["deviceId"] == 0]},
                             port_cfg, f)
    assert f.get("step_time_mean") > 0 and f.get("step_skew_mean") is None
    assert not os.path.exists(port_cfg.path("gpu_step_skew.csv"))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_advice_matches_jax_without_links(tmp_path, n):
    port_dir, jax_dir = str(tmp_path / "p") + "/", str(tmp_path / "j")
    os.makedirs(port_dir)
    os.makedirs(jax_dir)
    _topologies(port_dir, jax_dir, n)
    pf, jf = Features(), JaxFeatures()
    advice.mesh_advice({}, SofaConfig(logdir=port_dir), pf)
    jax_advice.mesh_advice({}, JaxConfig(logdir=jax_dir + "/"), jf)
    got = open(port_dir + "sofa_hints/mesh_advice.txt").read()
    want = open(jax_dir + "/sofa_hints/mesh_advice.txt").read()
    ring = re.compile(r"^(\w+ = \d+|\w+ = \[[\d, ]*\])")
    assert [ring.match(x).group(1).split(" = ")[1] for x in
            got.splitlines()[1:3]] == \
        [ring.match(x).group(1).split(" = ")[1] for x in
         want.splitlines()[1:3]]                     # the count, the ring
    pairs = re.findall(r"\((\d+), (\d+)", want)
    assert re.findall(r"\((\d+), (\d+), 1\)", got) == pairs
    info = dict(pf._info)
    assert info["mesh_advice"].endswith("sofa_hints/mesh_advice.txt")
    assert info["mesh_advice"][len(port_dir):] == \
        dict(jf._info)["mesh_advice"][len(jax_dir) + 1:]


def test_mesh_advice_rings_along_peer_access(tmp_path):
    """Cards 0-2 and 1-3 reach each other; 0-1 do not: the ring goes
    0, 2, then 1, 3; two ranks on one card are linked."""
    d = str(tmp_path) + "/"
    topo = {"devices": [{"id": i, "host": "h", "cuda_ordinal": i}
                        for i in range(4)],
            "peer_access": {"h": [[0, 2], [2, 0], [1, 3], [3, 1]]}}
    with open(d + "gpu_topo.json", "w") as f:
        json.dump(topo, f)
    advice.mesh_advice({}, SofaConfig(logdir=d), Features())
    text = open(d + "sofa_hints/mesh_advice.txt").read()
    assert "link_ring_order = [0, 2, 1, 3]" in text
    assert '("data", "seq", "model"), (2, 2, 1)' in text
    shared = {"devices": [{"id": i, "host": "h", "cuda_ordinal": 0}
                          for i in range(2)]}
    assert advice.link_ring(shared) == ([0, 1], True)


HINTS = {  # rule: (port prefix, JAX prefix)
    "communication": ("communication-bound", "communication-bound"),
    "compute": ("compute-bound", "compute-bound"),
    "skew": ("straggler skew", "straggler skew"),
    "input": ("input-bound", "input-bound"),
}
HINT_CASES = {
    "communication": ({"comm_ratio": 0.4, "gpu_kernels": 10},
                      {"comm_ratio": 0.1499}),
    "compute": ({"comm_ratio": 0.05, "gpu_kernels": 10},
                {"comm_ratio": 0.05}),
    "skew": ({"step_skew_mean": 0.0051, "step_time_mean": 0.1},
             {"step_skew_mean": 0.005, "step_time_mean": 0.1}),
    "input": ({"comm_h2d_time": 0.21, "gpu0_kernel_time": 1.0},
              {"comm_h2d_time": 0.2, "gpu0_kernel_time": 1.0}),
}


def _fired(feats):
    port, ref = Features(), JaxFeatures()
    for name, value in feats.items():
        port.add(name, value)
        ref.add({"gpu_kernels": "tpu_ops",
                 "gpu0_kernel_time": "tpu0_op_time"}.get(name, name), value)

    def rules(hints, side):
        return sorted(r for r, p in HINTS.items()
                      for h in hints if h.startswith(p[side]))

    got = rules(advice.generate_hints(port, SofaConfig()), 0)
    want = rules(jax_advice.generate_hints(ref, JaxConfig()), 1)
    return got, want, advice.generate_hints(port, SofaConfig())


@pytest.mark.parametrize("case", sorted(HINT_CASES))
def test_held_back_hint_rules_fire_like_jax(case):
    fires, quiet = HINT_CASES[case]
    got, want, text = _fired(fires)
    assert got == want == [case], text
    got, want, _ = _fired(quiet)
    assert got == want and case not in got
    assert not re.search(r"TPU|MXU|TensorCore|jax|XLA|ICI",
                         "\n".join(text))


# --- the tracer on two spawned gloo ranks ------------------------------------

def _traced_rank(rank, store, logdir):
    """One rank: joins the group INSIDE api.profile (the trace starts
    before the group exists), all-reduces, leaves the group, stops; the
    profile watches init_process_group only while it runs."""
    import torch
    import torch.distributed as dist

    from sofa_tpu_torch import api
    from sofa_tpu_torch.workloads.common import init_distributed

    orig = dist.init_process_group
    with api.profile(logdir):
        assert dist.init_process_group is not orig      # watched
        init_distributed(device="cpu", store_path=store, rank=rank,
                         world_size=2)
        x = torch.ones(8)
        dist.all_reduce(x)
        dist.destroy_process_group()
    # the watch is undone with the trace
    assert dist.init_process_group is orig
    assert dist.distributed_c10d.init_process_group is orig


def test_traced_ranks_name_their_rank_and_topology(tmp_path):
    logdir = str(tmp_path / "run") + "/"
    spawn_ranks(2, _traced_rank, str(tmp_path / "store"), logdir,
                timeout=240.0)
    traces = sorted(os.listdir(logdir + "kineto"))
    assert len(traces) == 2
    ranks = set()
    for name in traces:
        with open(logdir + "kineto/" + name) as f:
            info = json.load(f)["distributedInfo"]
        ranks.add(info["rank"])
        assert info["world_size"] == 2 and info["backend"] == "gloo"
    assert ranks == {0, 1}
    assert sorted(os.listdir(logdir + "gpu_topo")) == ["rank_0.json",
                                                       "rank_1.json"]
    assert not os.path.exists(logdir + "gpu_topo.json")
    assert kineto_collector.merge_rank_topology(logdir)
    topo = comm.load_topology(SofaConfig(logdir=logdir))
    assert [d["id"] for d in topo["devices"]] == [0, 1]
    assert topo["backend"] == "gloo" and topo["world_size"] == 2


def test_copies_under_a_gloo_collective_range_take_its_group():
    """gloo records no ``record_param_comms``: the tracer's
    ``sofa_comms:<collective>:<ranks>`` range names the group, and the
    device work launched inside it (gloo's copy of a CUDA tensor to the
    host) takes the collective's copyKind and the ranks as ``groups``; a
    copy outside any such range (the copy back, from gloo's thread) keeps
    its own kind and has none.  link_matrix.csv then books each
    collective within its own group."""
    from sofa_tpu_torch.ingest.kineto import ingest_trace

    def copy(t, corr, name):
        return [{"ph": "X", "cat": "cuda_runtime", "pid": 100, "tid": MAIN,
                 "ts": t, "dur": 2.0, "name": "cudaMemcpyAsync",
                 "args": {"correlation": corr}},
                {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
                 "ts": t + 5, "dur": 20.0, "name": name,
                 "args": {"device": 0, "stream": 7, "correlation": corr,
                          "bytes": 4096}}]

    ev = [{"ph": "X", "cat": "user_annotation", "pid": 100, "tid": MAIN,
           "ts": 100.0, "dur": 50.0, "name": "sofa_comms:all_reduce:0,2"},
          *copy(110.0, 1, "Memcpy DtoH (Device -> Pinned)"),
          {"ph": "X", "cat": "user_annotation", "pid": 100, "tid": MAIN,
           "ts": 200.0, "dur": 50.0,
           "name": "sofa_comms:all_to_all_single:0,1,2,3"},
          *copy(210.0, 2, "Memcpy DtoH (Device -> Pinned)"),
          *copy(300.0, 3, "Memcpy HtoD (Pinned -> Device)")]
    gpu = ingest_trace({"traceEvents": ev}, 0.0)["gputrace"]
    assert list(gpu["groups"]) == ["[[0, 2]]", "[[0, 1, 2, 3]]", ""]
    assert list(gpu["copyKind"]) == [int(CopyKind.ALL_REDUCE),
                                     int(CopyKind.ALL_TO_ALL),
                                     int(CopyKind.H2D)]
    assert list(gpu["payload"]) == [4096] * 3
    matrix = comm.link_traffic_matrix(gpu[gpu["copyKind"] >= 20], {
        "devices": [{"id": i} for i in range(4)]})
    assert matrix.loc["gpu0", "gpu2"] > 0 and matrix.loc["gpu0", "gpu1"] > 0
    assert matrix.loc["gpu0", "gpu3"] > 0       # the all-to-all's fourth


def _grouped_rank(rank, store, logdir):
    """One of four ranks, traced: all-reduces in its "model" pair
    ([0, 1] or [2, 3]) and in its "data" pair ([0, 2] or [1, 3])."""
    import torch
    import torch.distributed as dist

    from sofa_tpu_torch import api
    from sofa_tpu_torch.workloads.common import init_distributed

    orig = dist.all_reduce
    with api.profile(logdir):
        init_distributed(device="cpu", store_path=store, rank=rank,
                         world_size=4)
        pairs = [dist.new_group(r) for r in ([0, 1], [2, 3], [0, 2],
                                             [1, 3])]
        x = torch.ones(8)
        dist.all_reduce(x, group=pairs[rank // 2])
        dist.all_reduce(x, group=pairs[2 + rank % 2])
        dist.destroy_process_group()
    assert dist.all_reduce is orig          # unwrapped with the trace


def test_traced_gloo_collectives_name_their_process_groups(tmp_path):
    logdir = str(tmp_path / "run") + "/"
    spawn_ranks(4, _grouped_rank, str(tmp_path / "store"), logdir,
                timeout=240.0)
    for name in os.listdir(logdir + "kineto"):
        with open(logdir + "kineto/" + name) as f:
            doc = json.load(f)
        rank = doc["distributedInfo"]["rank"]
        ranges = sorted(e["name"] for e in doc["traceEvents"]
                        if str(e.get("name", "")).startswith("sofa_comms:"))
        model = "0,1" if rank < 2 else "2,3"
        data = "0,2" if rank % 2 == 0 else "1,3"
        assert ranges == sorted([f"sofa_comms:all_reduce:{model}",
                                 f"sofa_comms:all_reduce:{data}"])
