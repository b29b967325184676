"""The port's exporters against the JAX package's: the same seeded frames
(the JAX ``tputrace``/``tpuutil``/``tpumon`` are the port's
``gputrace``/``gpuutil``/``gpumon``) give byte-identical folded stacks and
the same Trace Event list apart from the device tracks' names; the native
Perfetto writer's file decompresses to the Python path's bytes; the static
export draws a PDF of at least two pages and a PNG without matplotlib;
``load_cluster_frames`` puts every host on the clock and ordinals of the
JAX merge.  Then the ``export`` verb."""

import gzip
import json
import os
import re
import shutil
import struct
import zlib

import numpy as np
import pandas as pd
import pytest

from sofa_tpu import export_folded as jax_folded
from sofa_tpu import export_perfetto as jax_perfetto
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu.trace import write_csv as jax_write_csv
from sofa_tpu_torch import charts, export_folded, export_perfetto
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.export_static import export_static
from sofa_tpu_torch.trace import make_frame, write_csv

PORT_TO_JAX = {"gputrace": "tputrace", "gpusteps": "tpusteps",
               "gpuutil": "tpuutil", "gpumon": "tpumon"}


def frames(seed=0, n=60):
    """Kernels and copies (with the analysis columns), steps, host events
    on two threads, utilization and memory counters, mpstat and network
    samples, perf samples and Python stacks."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(1e-5, 2e-3, n))
    gpu = make_frame({
        "timestamp": t, "duration": rng.uniform(1e-6, 1e-3, n),
        "deviceId": rng.integers(0, 2, n),
        "category": rng.choice([0, 0, 0, 2], n),
        "copyKind": rng.choice([0, 0, 1, 20], n),
        "payload": rng.choice([0, 4096], n),
        "name": [f"kernel_{i % 7}" for i in range(n)],
        "hlo_category": rng.choice(["aten::mm", "sofa_flash_fwd", ""], n),
        "module": rng.choice(["sofa_step_0", "sofa_step_1", ""], n),
        "phase": rng.choice(["fw", "bw", ""], n),
        "op_path": rng.choice(["sofa_step_0/aten::mm", ""], n),
        "flops": rng.choice([0.0, 1e9, 3.5e10], n),
        "bytes_accessed": rng.choice([0.0, 1e6], n),
        "groups": rng.choice(["", "[[0, 1]]"], n),
        "device_kind": ["gpu"] * n})
    steps = make_frame([{"timestamp": 0.01 * s, "duration": 0.009,
                         "deviceId": d, "event": float(s),
                         "name": f"sofa_step_{s}", "device_kind": "gpu"}
                        for d in (0, 1) for s in range(3)])
    host = make_frame({"timestamp": t[:20], "duration": [1e-4] * 20,
                       "deviceId": [-1] * 20, "pid": [7] * 20,
                       "tid": [1, 2] * 10,
                       "name": [f"aten::op{i % 3}" for i in range(20)],
                       "module": ["", "worker"] * 10,
                       "device_kind": ["cpu"] * 20})
    util = make_frame([{"timestamp": 0.1 * i, "event": float(v),
                        "deviceId": d, "name": nm, "device_kind": "gpu"}
                       for i in range(4) for d in (0, 1)
                       for nm, v in (("kernel_util", 40 + i),
                                     ("tensor_util", 10 + i),
                                     ("hbm_gbps", 900 + i))])
    mon = make_frame([{"timestamp": 0.5 * i, "event": e, "deviceId": d,
                       "name": nm, "device_kind": "gpu"}
                      for i in range(3) for d, nm, e in (
                          (-1, "alive", 1.0), (0, "hbm_used_gb", 1.5 + i),
                          (0, "hbm_occupancy", 10.0 + i))])
    mp = make_frame([{"timestamp": 0.1 * i, "event": float(5 + i + c),
                      "deviceId": c, "name": nm, "payload": 3,
                      "device_kind": "cpu"}
                     for i in range(3) for c in (-1, 0, 1)
                     for nm in ("usr", "sys", "iow", "idl")])
    net = make_frame([{"timestamp": 0.1 * i, "event": 1e6 * (i + 1),
                       "deviceId": 0, "name": nm, "device_kind": "cpu"}
                      for i in range(3) for nm in ("eth0:rx", "eth0:tx")])
    cpu = make_frame({"timestamp": t[:12], "duration": [1e-3] * 12,
                      "name": ["leaf<-mid<-root @ libfoo.so", "f<-g",
                               "solo", "", "leaf<-mid<-root @ libfoo.so",
                               "h"] * 2, "device_kind": ["cpu"] * 12})
    py = make_frame({"timestamp": t[:9], "tid": [1] * 9,
                     "name": ["c"] * 9,
                     "module": ["main;a;c", "main;b", "main;a;c"] * 3,
                     "device_kind": ["cpu"] * 9})
    return {"gputrace": gpu, "gpusteps": steps, "hosttrace": host,
            "gpuutil": util, "gpumon": mon, "mpstat": mp,
            "netbandwidth": net, "cputrace": cpu, "pystacks": py}


def jax_frames(fr):
    return {PORT_TO_JAX.get(k, k): jax_make_frame(v.to_dict("records"))
            for k, v in fr.items()}


def memprof_file(d):
    from sofa_tpu_torch.collectors import gpumon

    samples = [([("alloc", "model.py", 10), ("main", "run.py", 3)],
                "cuda:0", "buffer", 2, 1 << 30),
               ([("load", "input.py", 9)], "cuda:0", "buffer", 1, 1 << 20),
               ([("ws", "x.py", 1)], "cuda:0", "workspace", 1, 4096)]
    with open(os.path.join(d, "memprof.pb.gz"), "wb") as f:
        f.write(gzip.compress(gpumon._ns["_pprof_encode"](samples)))


@pytest.fixture
def dirs(tmp_path):
    out = {}
    for side in ("port", "jax"):
        d = str(tmp_path / side) + "/"
        os.makedirs(d)
        memprof_file(d)
        with open(d + "sofa_self_trace.json", "w") as f:
            json.dump({"traceEvents": [
                {"name": "preprocess", "ph": "X", "ts": 5.0, "dur": 2.0,
                 "pid": 1, "tid": 2, "cat": "stage"},
                {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2,
                 "args": {"name": "sofa preprocess"}}, {"bad": 1}]}, f)
        out[side] = d
    return out


# --- folded ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_folded_files_are_byte_identical_to_jax(dirs, seed):
    fr = frames(seed)
    got = export_folded.export_folded(SofaConfig(logdir=dirs["port"]), fr)
    want = jax_folded.export_folded(JaxConfig(logdir=dirs["jax"]),
                                    jax_frames(fr))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        ["pystacks.folded", "cputrace.folded", "memprof.folded"]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def test_folded_without_samples_writes_nothing(tmp_path, capsys):
    cfg = SofaConfig(logdir=str(tmp_path))
    assert export_folded.export_folded(cfg, {}) == []
    assert "no sampled stacks" in capsys.readouterr().err


# --- perfetto -------------------------------------------------------------------

def _events(path):
    with gzip.open(path, "rb") as f:
        raw = f.read()
    return raw, json.loads(raw)


def _normalized_jax(doc):
    """The JAX document in the port's device-track terms: processes
    tpu<N> -> gpu<N>, their lanes' thread names, the kernels' category,
    and the kernels' ts/dur at the %.3f both port writers print."""
    from sofa_tpu_torch.export_perfetto import DEVICE_THREADS

    out = []
    for e in doc["traceEvents"]:
        e = dict(e)
        if e.get("name") == "process_name" and \
                re.fullmatch(r"tpu\d+", e["args"]["name"]):
            e["args"] = {"name": "g" + e["args"]["name"][1:]}
        if e.get("name") == "thread_name" and e["pid"] < 1_000_000:
            if e["tid"] not in DEVICE_THREADS:
                continue            # the XLA module lane: none on a GPU
            e["args"] = {"name": DEVICE_THREADS[e["tid"]]}
        if e.get("cat") == "tpu_op":
            e["cat"] = "gpu_op"
            e["ts"] = float(f"{e['ts']:.3f}")
            e["dur"] = float(f"{e['dur']:.3f}")
        out.append(e)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_perfetto_events_equal_jax_but_the_device_track_names(dirs, seed,
                                                              monkeypatch):
    monkeypatch.setenv("SOFA_NATIVE_PERFETTO", "0")
    fr = frames(seed)
    p = export_perfetto.export_perfetto(SofaConfig(logdir=dirs["port"]), fr)
    j = jax_perfetto.export_perfetto(JaxConfig(logdir=dirs["jax"]),
                                     jax_frames(fr))
    _, got = _events(p)
    _, want = _events(j)
    assert got["traceEvents"] == _normalized_jax(want)
    assert got["otherData"]["producer"] == "sofa_tpu_torch"
    names = {e["args"]["name"] for e in got["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"gpu0", "gpu1", "host"} <= names and not any(
        n.startswith("tpu") for n in names)


def test_native_writer_matches_the_python_path(dirs, monkeypatch, capsys):
    from sofa_tpu_torch.collectors import native_build

    fr = frames(5, n=500)
    cfg = SofaConfig(logdir=dirs["port"])
    monkeypatch.setenv("SOFA_NATIVE_PERFETTO", "0")
    export_perfetto.export_perfetto(cfg, fr, out_name="py.json.gz")
    assert "(Python writer;" in capsys.readouterr().out
    monkeypatch.setenv("SOFA_NATIVE_PERFETTO", "1")
    assert native_build.find_compiler() is not None    # g++ is here
    export_perfetto.export_perfetto(cfg, fr, out_name="native.json.gz")
    assert "(native writer;" in capsys.readouterr().out
    py_raw, _ = _events(cfg.path("py.json.gz"))
    nat_raw, doc = _events(cfg.path("native.json.gz"))
    assert py_raw == nat_raw
    assert sum(e.get("cat") == "gpu_op" for e in doc["traceEvents"]) == 500
    assert not [n for n in os.listdir(dirs["port"])
                if ".native." in n or n.endswith(".bin")]


def test_nonfinite_times_are_clamped_in_both_writers(dirs, monkeypatch):
    fr = frames(1)
    gpu = fr["gputrace"].copy()
    gpu.loc[0, "timestamp"] = np.inf
    gpu.loc[1, "duration"] = np.nan
    cfg = SofaConfig(logdir=dirs["port"])
    for flag, name in (("0", "a.json.gz"), ("1", "b.json.gz")):
        monkeypatch.setenv("SOFA_NATIVE_PERFETTO", flag)
        export_perfetto.export_perfetto(cfg, {"gputrace": gpu},
                                        out_name=name)
    a, doc = _events(cfg.path("a.json.gz"))
    assert a == _events(cfg.path("b.json.gz"))[0]
    assert b"inf" not in a and b"NaN" not in a
    assert doc["traceEvents"][0]["ts"] == 1e15


def test_perfetto_with_nothing_to_export(tmp_path, capsys):
    assert export_perfetto.export_perfetto(SofaConfig(logdir=str(tmp_path)),
                                           {}) is None
    assert "no trace frames" in capsys.readouterr().err


# --- static ----------------------------------------------------------------------

def _pdf_objects(raw):
    """Each xref entry points at its ``N 0 obj``; returns the page
    count."""
    xref = int(re.search(rb"startxref\n(\d+)", raw).group(1))
    assert raw[xref:xref + 4] == b"xref"
    head = raw[xref:].split(b"\n")
    n = int(head[1].split()[1])
    for i in range(1, n):
        off = int(head[2 + i][:10])
        assert raw[off:].startswith(f"{i} 0 obj".encode()), i
    return max(int(c) for c in re.findall(rb"/Count (\d+)", raw))


def test_static_export_draws_a_multipage_pdf_and_a_png(tmp_path):
    d = str(tmp_path / "run") + "/"
    os.makedirs(d)
    fr = frames(2)
    pd.DataFrame([[0, 5e8], [7e8, 0]], index=["0", "1"],
                 columns=["0", "1"]).to_csv(d + "link_matrix.csv")
    written = export_static(SofaConfig(logdir=d), fr)
    assert written == [d + "sofa_report.pdf", d + "overview.png"]
    raw = open(d + "sofa_report.pdf", "rb").read()
    assert raw.startswith(b"%PDF-1.4") and raw.rstrip().endswith(b"%%EOF")
    # overview, network, link, top kernels (no blktrace in the frames)
    assert _pdf_objects(raw) == 4
    streams = [zlib.decompress(m) for m in re.findall(
        rb"stream\n(.*?)\nendstream", raw, re.S)]
    text = b"".join(streams)
    for title in (b"GPU utilization", b"Top kernels by total device time",
                  b"Estimated NCCL traffic", b"Network bandwidth"):
        assert title in text, title
    png = open(d + "overview.png", "rb").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", png[16:24])
    assert (w, h) == (int(charts.PAGE_W * 2), int(charts.PAGE_H * 2))


def test_static_export_of_top_kernels_alone(tmp_path):
    d = str(tmp_path) + "/"
    fr = {"gputrace": frames(0)["gputrace"]}
    written = export_static(SofaConfig(logdir=d), fr)
    assert written == [d + "sofa_report.pdf"]
    assert _pdf_objects(open(written[0], "rb").read()) == 1


def test_static_export_without_data(tmp_path, capsys):
    d = str(tmp_path) + "/"
    assert export_static(SofaConfig(logdir=d), {}) == []
    assert not os.path.exists(d + "sofa_report.pdf")
    assert "no data to chart" in capsys.readouterr().err


def test_chart_primitives():
    assert charts.nice_ticks(0, 1) == [0, 0.2, 0.4, 0.6, 0.8, 1.0]
    assert charts.nice_ticks(3, 3) == [3]
    c = charts.Canvas()
    ax = charts.Axes(c, 10, 10, 110, 60)
    ax.plot([0, 1, 2], [0, 10, 5], "#2a78d6", "x")
    ax.finish("t", "s", "%")
    img = charts.rasterize(c, scale=1)
    blue = np.all(img == [0x2a, 0x78, 0xd6], axis=-1)
    assert blue.sum() > 50          # the line and its legend swatch
    assert charts.ramp(["#000000", "#ffffff"])(0.5) == "#808080"


# --- the cluster merge -------------------------------------------------------------

def _host_dirs(tmp_path):
    base = str(tmp_path / "clog")
    fr = frames(4)
    for i, (host, tb) in enumerate((("ha", 1000.0), ("hb", 1002.5))):
        d = base + f"-{host}/"
        os.makedirs(d)
        with open(d + "sofa_time.txt", "w") as f:
            f.write(f"{tb}\n")
        for name in ("gputrace", "mpstat", "hosttrace", "cputrace"):
            write_csv(fr[name], d + f"{name}.csv")
            jax_write_csv(jax_make_frame(fr[name].to_dict("records")),
                          d + f"{PORT_TO_JAX.get(name, name)}.csv")
    return base, fr


def test_cluster_frames_align_as_the_jax_merge(tmp_path):
    from sofa_tpu.analyze import load_cluster_frames as jax_load
    from sofa_tpu_torch.analyze import load_cluster_frames

    base, fr = _host_dirs(tmp_path)
    cfg = SofaConfig(logdir=base + "/", cluster_hosts=["ha", "hb"])
    got = load_cluster_frames(cfg, only=["gputrace", "mpstat", "cputrace",
                                         "hosttrace"])
    want = jax_load(JaxConfig(logdir=base + "/", cluster_hosts=["ha", "hb"]),
                    only=["tputrace", "mpstat", "cputrace", "hosttrace"])
    for ours, ref in (("gputrace", "tputrace"), ("mpstat", "mpstat"),
                      ("cputrace", "cputrace")):
        pd.testing.assert_frame_equal(got[ours], want[ref], check_dtype=False)
    g = got["gputrace"]
    assert sorted(set(g["deviceId"])) == [0, 1, 256, 257]
    shifted = g[g["host"] == 1]["timestamp"].to_numpy()
    assert np.allclose(shifted - fr["gputrace"]["timestamp"].to_numpy(), 2.5,
                       rtol=0, atol=1e-9)
    # a CUDA trace's host events carry deviceId -1: each host's take its
    # base, so that each is a process of its own
    h = got["hosttrace"]
    assert sorted(set(h["deviceId"])) == [0, 256]


def test_cluster_export_gives_every_host_its_tracks(tmp_path, monkeypatch):
    from sofa_tpu_torch.cli import main

    base, _ = _host_dirs(tmp_path)
    monkeypatch.setenv("SOFA_NATIVE_PERFETTO", "0")
    assert main(["export", "--cluster_hosts", "ha,hb", "--logdir", base,
                 "--perfetto"]) == 0
    _, doc = _events(base + "/trace.json.gz")
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"gpu0", "gpu1", "gpu256", "gpu257", "host0", "host1"} <= procs
    assert os.path.isfile(base + "/sofa_report.pdf")


# --- the verb ---------------------------------------------------------------------

def test_export_verb_writes_everything_and_refreshes_digests(tmp_path):
    from sofa_tpu_torch.cli import main
    from sofa_tpu_torch.durability import (fsck_problem_counts, fsck_scan,
                                           write_digests)
    from test_torch_board import write_sink_logdir

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    assert main(["report", "--logdir", d]) == 0
    write_digests(d)
    assert main(["export", "--logdir", d, "--perfetto", "--folded"]) == 0
    for name in ("sofa_report.pdf", "overview.png", "trace.json.gz",
                 "pystacks.folded", "memprof.folded"):
        assert os.path.getsize(d + name) > 0, name
    rep = fsck_scan(d)
    assert not any(fsck_problem_counts(rep).values()), rep
    # clean treats the exports as derived
    from sofa_tpu_torch.record import sofa_clean

    sofa_clean(SofaConfig(logdir=d))
    assert not [n for n in ("sofa_report.pdf", "overview.png",
                            "trace.json.gz", "pystacks.folded")
                if os.path.exists(d + n)]


def test_export_verb_fails_when_nothing_can_be_written(tmp_path):
    from sofa_tpu_torch.cli import main

    d = str(tmp_path / "empty")
    os.makedirs(d)
    assert main(["export", "--logdir", d]) == 1
    assert main(["export", "--logdir", d, "--perfetto"]) == 1
    shutil.rmtree(d)
