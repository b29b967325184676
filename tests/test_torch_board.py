"""The port's board against the JAX package's: the timeline series and
report.js, the board's data contract, and the host-only verbs.

Series parity: one synthetic capture, made with numpy from a seed, as a
host set (cputrace, hosttrace, pystacks, strace, mpstat, vmstat, diskstat,
netbandwidth, nettrace, blktrace) and a device set, goes through the JAX
package's ``build_series`` with the device frames under its names
(``tputrace``, ``tpuutil``, ``tpumon``, ``tpusteps``) and through the port's
with the same frames under the port's (``gputrace``, ...).  Every series'
columnar data (``x``, ``y``, ``d``, ``names``, ``ni``), kind and colour must
be equal under the name map, the fw/bw phase series and one keyword filter
(set the same in both packages) too; the device frame is larger than
``viz_downsample_to``, so the overview is downsampled.

Board contract (as ``tests/test_board_contract.py`` holds the JAX pages): a
kitchen-sink logdir, a SYNTHETIC Kineto capture (hand-built in the shape
torch.profiler writes on a CUDA machine: steps, forward and backward
kernels, flops from recorded shapes and the flash cost ranges, H2D copies,
serving ranges) with a memprof snapshot and Python stacks, through the
port's real preprocess and analyze; then every column the port's pages read
by name must be in the header the port writes.

Verbs: ``report`` over a real CPU ``stat`` logdir, ``report
--skip_preprocess``, ``clean``.
"""

import glob
import gzip
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from sofa_tpu.config import Filter as JaxFilter
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.preprocess import build_series as jax_build_series
from sofa_tpu.trace import downsample as jax_downsample
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu.trace import series_to_report_js as jax_series_to_report_js
from sofa_tpu_torch import costs
from sofa_tpu_torch.analyze import BOARD_DIR, board_pages, sofa_analyze
from sofa_tpu_torch.config import Filter, SofaConfig
from sofa_tpu_torch.preprocess import build_series, sofa_preprocess
from sofa_tpu_torch.trace import (CopyKind, downsample, make_frame,
                                  read_report_js_doc, series_to_report_js)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_NAMES = {"gputrace": "tputrace", "gpuutil": "tpuutil",
                "gpumon": "tpumon", "gpusteps": "tpusteps"}
N_DEVICE = 25000            # > viz_downsample_to (10000)
KERNELS = ["sofa_flash_fwd_kernel", "sofa_flash_bwd_kv_kernel",
           "sm90_gemm_bf16", "elementwise_kernel", "reduce_kernel"]


def _capture(seed=0):
    """Column dicts of a synthetic capture: frame name (port's) -> cols."""
    rng = np.random.default_rng(seed)

    def host(n, names, **extra):
        return dict(timestamp=np.sort(rng.uniform(0, 10, n)),
                    event=rng.normal(5, 2, n), duration=rng.exponential(
                        1e-3, n), deviceId=np.full(n, -1),
                    name=[names[i] for i in rng.integers(len(names), size=n)],
                    **extra)

    n = N_DEVICE
    kind = rng.choice([0, 0, 0, 0, 1, 2, 8], size=n)
    gpu = dict(
        timestamp=np.sort(rng.uniform(0, 10, n)),
        event=rng.integers(0, 2, n).astype(float),
        duration=rng.exponential(1e-4, n), deviceId=rng.integers(0, 2, n),
        copyKind=kind,
        name=[KERNELS[i] if k == 0 else
              {1: "Memcpy HtoD (Pageable -> Device)",
               2: "Memcpy DtoH (Device -> Pageable)",
               8: "Memcpy DtoD (Device -> Device)"}[k]
              for i, k in zip(rng.integers(len(KERNELS), size=n), kind)],
        hlo_category=[["aten::mm", "aten::add", "", "fusion"][i]
                      for i in rng.integers(4, size=n)],
        phase=[["fw", "bw", ""][i] for i in rng.integers(3, size=n)])
    # NaN and Inf must come out as 0 in the JSON
    gpu["duration"][:3] = [np.nan, np.inf, -np.inf]
    t = np.arange(0, 10, 0.1)
    util = dict(timestamp=np.repeat(t, 3), event=rng.uniform(0, 100, 3 *
                len(t)), deviceId=np.zeros(3 * len(t), dtype=int),
                name=["kernel_util", "tensor_util", "hbm_gbps"] * len(t))
    mp = dict(timestamp=np.repeat(t, 6), event=rng.uniform(0, 100, 6 * len(t)),
              deviceId=np.tile([-1, -1, -1, 0, 0, 1], len(t)),
              name=["usr", "sys", "idl", "usr", "sys", "usr"] * len(t))
    steps = dict(timestamp=np.arange(5) * 2.0, duration=np.full(5, 1.5),
                 deviceId=np.zeros(5, dtype=int),
                 name=[f"sofa_step_{i}" for i in range(5)])
    return {
        "cputrace": host(3000, ["python", "swapper idle", "cpu_idle",
                                "libtorch"], pid=np.full(3000, 7)),
        "hosttrace": host(2000, ["aten::mm", "cudaLaunchKernel"]),
        "pystacks": host(500, ["main", "step"]),
        "strace": host(300, ["read", "futex"]),
        "mpstat": mp,
        "vmstat": host(100, ["cs", "in", "bi"]),
        "diskstat": host(100, ["sda.r_bw", "sda.w_bw"]),
        "netbandwidth": host(100, ["eth0.tx", "eth0.rx"]),
        "nettrace": host(400, ["tcp"]),
        "blktrace": host(50, ["R", "W"]),
        "gputrace": gpu,
        "gpuutil": util,
        "gpumon": host(60, ["hbm_used", "alive"]),
        "gpusteps": steps,
    }


def _both_series(**cfg_kw):
    cols = _capture()
    port_cfg = SofaConfig(gpu_filters=[Filter("sofa_flash", "darkviolet")],
                          **cfg_kw)
    jax_cfg = JaxConfig(tpu_filters=[JaxFilter("sofa_flash", "darkviolet")],
                        **cfg_kw)
    port = build_series(port_cfg, {k: make_frame(v) for k, v in cols.items()})
    ref = jax_build_series(jax_cfg, {DEVICE_NAMES.get(k, k): jax_make_frame(v)
                                     for k, v in cols.items()})
    return port_cfg, port, ref


def _jax_name(name):
    if name in DEVICE_NAMES:
        return DEVICE_NAMES[name]
    return re.sub(r"^gpu_", "tpu_", name)


PORT_SERIES = ["cputrace", "hosttrace", "pystacks", "strace", "mpstat",
               "vmstat", "diskstat", "netbandwidth", "nettrace", "gputrace",
               "gpuutil", "gpumon", "gpusteps", "blktrace", "cpu_idle",
               "gpu_phase_fw", "gpu_phase_bw", "gpu_sofa_flash"]


@pytest.fixture(scope="module")
def series_pair():
    return _both_series()


def test_series_names_and_order(series_pair):
    _cfg, port, ref = series_pair
    assert [s.name for s in port] == PORT_SERIES
    assert [_jax_name(s.name) for s in port] == [s.name for s in ref]


@pytest.mark.parametrize("name", PORT_SERIES)
def test_series_matches_jax(series_pair, name):
    cfg, port, ref = series_pair
    got = {s.name: s for s in port}[name]
    want = {s.name: s for s in ref}[_jax_name(name)]
    assert (got.kind, got.color) == (want.kind, want.color)
    a = got.to_columnar(cfg.viz_downsample_to)
    b = want.to_columnar(cfg.viz_downsample_to)
    assert a == b
    assert len(a["x"]) == min(len(got.data), len(a["x"]))
    if len(got.data) > cfg.viz_downsample_to:
        assert len(a["x"]) < len(got.data)


def test_report_js_matches_jax(tmp_path, series_pair):
    """The whole report.js payload, under the name map, with the same
    meta; no NaN token in the JSON."""
    cfg, port, ref = series_pair
    series_to_report_js(port, str(tmp_path / "port.js"), 10000, {"k": 1})
    jax_series_to_report_js(ref, str(tmp_path / "jax.js"), 10000, {"k": 1})
    got = read_report_js_doc(str(tmp_path / "port.js"))
    want = read_report_js_doc(str(tmp_path / "jax.js"))
    assert got["meta"] == want["meta"]
    for g, w in zip(got["series"], want["series"], strict=True):
        assert _jax_name(g["name"]) == w["name"]
        assert (g["kind"], g["color"], g["data"]) == \
            (w["kind"], w["color"], w["data"])
    text = (tmp_path / "port.js").read_text()
    assert "NaN" not in text and "Infinity" not in text
    gputrace = next(s for s in got["series"] if s["name"] == "gputrace")
    assert gputrace["data"]["d"][0] == 0.0        # the NaN row, stride 0


def test_small_overview_matches_jax():
    """A smaller viz_downsample_to downsamples every series, alike."""
    cfg, port, ref = _both_series(viz_downsample_to=64)
    for g, w in zip(port, ref, strict=True):
        a, b = g.to_columnar(64), w.to_columnar(64)
        assert a == b
        assert len(a["x"]) <= 64 + 64 // 10 + 1


@pytest.mark.parametrize("max_points", [0, 10, 333, 2999, 3000, 5000])
def test_downsample_matches_jax(max_points):
    cols = _capture()["cputrace"]
    got = downsample(make_frame(cols), max_points)
    want = jax_downsample(jax_make_frame(cols), max_points)
    assert list(got.index) == list(want.index)


def test_filters_match_name_or_category():
    """A filter keyword matches a substring of name or of hlo_category,
    case-insensitively; the default GPU filters catch the copies and the
    flash kernels."""
    cols = _capture()
    frames = {k: make_frame(v) for k, v in cols.items()}
    cfg = SofaConfig(gpu_filters=[Filter("FUSION", "red")])
    sel = {s.name: s for s in build_series(cfg, frames)}["gpu_FUSION"].data
    assert (sel["hlo_category"] == "fusion").all() and len(sel) > 0
    names = {s.name: s for s in build_series(SofaConfig(), frames)}
    for kw in ("HtoD", "DtoH", "DtoD", "sofa_flash"):
        data = names[f"gpu_{kw}"].data
        assert data["name"].str.contains(kw).all()
    flash = set(names["gpu_sofa_flash"].data["name"])
    assert flash == {"sofa_flash_fwd_kernel", "sofa_flash_bwd_kv_kernel"}
    assert "gpu_AllReduce" not in names          # no NCCL kernel here


# -- the board's data contract ---------------------------------------------------

BASE_NS = 1_700_000_000_000_000_000
MAIN, ENGINE = 10, 11
F32 = "float"
FWD = costs.cost_range_name("sofa_flash_fwd", 1, 256, 256, 4, 2, 64, True)
BWD_KV = costs.cost_range_name("sofa_flash_bwd_kv", 1, 256, 256, 4, 2, 64,
                               True)
BWD_DQ = costs.cost_range_name("sofa_flash_bwd_dq", 1, 256, 256, 4, 2, 64,
                               True)


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def sink_trace(n_steps=6):
    """SYNTHETIC Kineto trace (hand-built, not captured): ``n_steps``
    sofa_step_N ranges, each an H2D copy, a forward matmul and flash
    forward, and the backward (matmul, both flash backward kernels) from
    the autograd engine's thread, with gaps between; then serving ranges."""
    ev = [_x("user_annotation", "sofa_timebase_marker:%d" % (BASE_NS + 50_000),
             50.0, 1.0)]
    corr = [0]

    def launch(ts, tid, kernel, kts, kdur, cat="kernel", **kargs):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel" if cat == "kernel"
                     else "cudaMemcpyAsync", ts, 2.0, tid=tid,
                     correlation=corr[0]))
        ev.append({"ph": "X", "cat": cat, "name": kernel, "pid": 0, "tid": 7,
                   "ts": kts, "dur": kdur,
                   "args": {"device": 0, "stream": 7,
                            "correlation": corr[0], **kargs}})

    def mm(ts, tid, kernel, kts):
        ev.append(_x("cpu_op", "aten::mm", ts, 20.0, tid=tid, **{
            "Input Dims": [[256, 512], [512, 512]],
            "Input type": [F32, F32], "Concrete Inputs": ["", ""]}))
        launch(ts + 5, tid, kernel, kts, 300.0)

    for s in range(n_steps):
        t0 = 1000.0 + s * 5000.0
        ev.append(_x("user_annotation", f"sofa_step_{s}", t0, 4000.0))
        launch(t0 + 10, MAIN, "Memcpy HtoD (Pageable -> Device)", t0 + 100,
               200.0, cat="gpu_memcpy", bytes=1 << 20)
        mm(t0 + 50, MAIN, "sm90_gemm_fw", t0 + 400)
        ev.append(_x("user_annotation", FWD, t0 + 100, 20.0))
        launch(t0 + 105, MAIN, "sofa_flash_fwd_kernel", t0 + 800, 150.0)
        ev.append(_x("cpu_op", "autograd::engine::evaluate_function: "
                     "MmBackward0", t0 + 200, 400.0, tid=ENGINE))
        mm(t0 + 210, ENGINE, "sm90_gemm_bw", t0 + 1200)
        ev.append(_x("user_annotation", BWD_KV, t0 + 300, 20.0, tid=ENGINE))
        launch(t0 + 305, ENGINE, "sofa_flash_bwd_kv_kernel", t0 + 1600, 250.0)
        ev.append(_x("user_annotation", BWD_DQ, t0 + 330, 20.0, tid=ENGINE))
        launch(t0 + 335, ENGINE, "sofa_flash_bwd_dq_kernel", t0 + 1900, 200.0)
    t0 = 1000.0 + n_steps * 5000.0
    ev.append(_x("user_annotation", "run_prefill", t0, 500.0))
    mm(t0 + 10, MAIN, "prefill_gemm", t0 + 100)
    ev.append(_x("user_annotation", "run_decode", t0 + 600, 500.0))
    mm(t0 + 610, MAIN, "decode_gemv", t0 + 700)
    return {"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
            "traceEvents": ev}


def write_sink_logdir(d, n_steps=6):
    """The raw files of a kitchen-sink recording in ``d``."""
    from sofa_tpu_torch.collectors import gpumon

    os.makedirs(os.path.join(d, "kineto"), exist_ok=True)
    with open(os.path.join(d, "kineto", "trace_100.json"), "w") as f:
        json.dump(sink_trace(n_steps), f)
    with open(os.path.join(d, "sofa_time.txt"), "w") as f:
        f.write(f"{BASE_NS / 1e9:.6f}\n")
    with open(os.path.join(d, "misc.txt"), "w") as f:
        f.write("elapsed_time 0.05\ncores 8\npid 100\nrc 0\n")
    with open(os.path.join(d, "gpu_topo.json"), "w") as f:
        json.dump({"cuda_available": True, "devices": [
            {"index": 0, "name": "NVIDIA H100 80GB HBM3"}]}, f)
    samples = [([("train_step", "train.py", 40)], "cuda:0", "buffer", 2,
                1 << 30),
               ([("load_batch", "input.py", 9), ("main", "run.py", 3)],
                "cuda:0", "buffer", 1, 1 << 20)]
    with open(os.path.join(d, "memprof.pb.gz"), "wb") as f:
        f.write(gzip.compress(gpumon._ns["_pprof_encode"](samples)))
    with open(os.path.join(d, "memprof.pb.gz.meta.json"), "w") as f:
        json.dump({"trigger": "peak", "total_bytes": (2 << 30) + (1 << 20)},
                  f)
    with open(os.path.join(d, "pystacks.txt"), "w") as f:
        f.write("".join(f"{BASE_NS / 1e9 + i * 1e-3:.6f} 100 "
                        f"main;train;step_{i % 3}\n" for i in range(40)))
    # the allocator sampler: ns, device (-1: alive), used, limit, peak
    with open(os.path.join(d, "gpumon.txt"), "w") as f:
        for i in range(1, 4):
            f.write(f"{BASE_NS + i * 10_000_000} -1 0 0 0\n"
                    f"{BASE_NS + i * 10_000_000} 0 {i * 10 ** 9} "
                    f"{80 * 10 ** 9} {3 * 10 ** 9}\n")


@pytest.fixture(scope="module")
def sink(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sink")) + "/"
    write_sink_logdir(d)
    # a small overview, so the capture's device series get a pyramid
    cfg = SofaConfig(logdir=d, viz_downsample_to=20)
    sofa_analyze(cfg, sofa_preprocess(cfg))
    # the diff page's tables: the run against itself, into its own logdir
    from sofa_tpu_torch.ml.diff import sofa_diff

    assert sofa_diff(SofaConfig(logdir=d, base_logdir=d, match_logdir=d,
                                viz_downsample_to=20)) == 0
    return cfg


# csv -> the columns the port's pages read by name (indexOf, col(), the
# explorer's dims keys, csvColumn).
CONTRACT = {
    "mpstat.csv": ["timestamp", "event", "deviceId", "name"],
    "cputrace.csv": ["timestamp", "event", "duration", "deviceId", "pid",
                     "tid"],
    "gputrace.csv": ["timestamp", "duration", "flops", "bytes_accessed",
                     "copyKind", "deviceId"],
    "gpuutil.csv": ["timestamp", "event", "name"],
    "gpu_categories.csv": ["duration"],
    "roofline.csv": ["deviceId", "name", "efficiency"],
    "gpu_input_pipeline.csv": ["deviceId", "step", "busy_pct"],
    "gpu_memprof.csv": ["site", "bytes"],
    "netbandwidth.csv": ["timestamp", "event", "name"],
    "diskstat.csv": ["timestamp", "event", "name"],
    "pystacks.csv": ["module"],
    "gpu_op_tree.csv": ["path", "depth", "time", "time_pct", "count",
                        "flops"],
    "features.csv": ["name", "value"],
    "commtrace.csv": ["timestamp", "duration", "payload", "peer", "dst",
                      "kind", "cls"],
    "gpu_diff.csv": ["name", "delta"],
    "mem_diff.csv": ["site", "delta"],
}
# fetched but only shown whole by renderTable (any header will do)
TABLE_ONLY = {"cpu_top.csv", "pystacks_top.csv", "strace_top.csv",
              "disk_summary.csv", "gpu_top_kernels.csv",
              "gpu_modules_summary.csv", "performance.csv", "comm.csv",
              "link_matrix.csv", "netrank.csv", "swarm_diff.csv"}


def _board_sources():
    files = sorted(glob.glob(os.path.join(BOARD_DIR, "*.html")))
    return files + [os.path.join(BOARD_DIR, "sofa_board.js")]


def test_board_csv_contract(sink):
    missing = [c for c in CONTRACT if not os.path.isfile(sink.path(c))]
    assert not missing, f"the sink did not write {missing}"
    for csvname, cols in CONTRACT.items():
        header = list(pd.read_csv(sink.path(csvname), nrows=0).columns)
        lacking = [c for c in cols if c not in header]
        assert not lacking, (csvname, lacking, header)
    # the page's data, not only its header
    for csvname in ("roofline.csv", "gpu_input_pipeline.csv",
                    "gpu_memprof.csv", "gpu_op_tree.csv",
                    "gpu_categories.csv", "gpu_top_kernels.csv"):
        assert len(pd.read_csv(sink.path(csvname))) > 0, csvname


def test_board_static_references_covered():
    """Every fetchCSV target is contracted or table-only, and every literal
    column reference of the pages is contracted."""
    fetched, cols = set(), set()
    for f in _board_sources():
        src = open(f).read()
        # every CSV a page names (fetchCSV, the explorer, the table loops)
        fetched |= set(re.findall(r'"([\w.]+\.csv)"', src))
        cols |= set(re.findall(r'\.indexOf\("(\w+)"\)', src))
        cols |= set(re.findall(r'col\(r, "(\w+)"\)', src))
        cols |= set(re.findall(r'col\("(\w+)"\)', src))
        cols |= set(re.findall(r'key: "(\w+)"', src))
        cols |= set(re.findall(r'csvColumn\(\w+, "(\w+)"\)', src))
    unknown = fetched - set(CONTRACT) - TABLE_ONLY
    assert not unknown, f"pages fetch uncontracted CSVs: {sorted(unknown)}"
    missing = cols - set().union(*CONTRACT.values())
    assert not missing, f"pages read uncontracted columns: {sorted(missing)}"
    assert not (set(CONTRACT) & TABLE_ONLY)
    assert set(CONTRACT) | TABLE_ONLY <= fetched, "contract names a CSV no " \
        "page reads"


STAGED = ["index.html", "gpu-report.html", "op-tree.html", "flame.html",
          "cpu-report.html", "comm-report.html", "disk.html", "net.html",
          "serving.html", "diff-report.html", "archive-diff.html",
          "fleet.html", "tier.html", "whatif.html", "run-report.html"]


@pytest.mark.parametrize("page", STAGED)
def test_nav_links_every_staged_page_and_no_other(page):
    src = open(os.path.join(BOARD_DIR, page)).read()
    nav = re.search(r"<nav>(.*?)</nav>", src, re.S).group(1)
    links = re.findall(r'href="([\w-]+\.html)"', nav)
    assert links == STAGED
    assert re.findall(r'class="active" href="([\w-]+\.html)"', nav) == [page]
    # a page names no JAX-package term in what it shows
    assert not re.search(r"\b(TPU|XLA|jit|tpu_\w+\.csv)\b", src), page


def test_staged_pages_are_the_port_copies(sink):
    assert sorted(STAGED + ["sofa_board.js", "style.css"]) == board_pages()
    for name in board_pages():
        with open(sink.path(name), "rb") as a, \
                open(os.path.join(BOARD_DIR, name), "rb") as b:
            assert a.read() == b.read()


def test_board_js_decodes_tiles_and_columnar():
    js = open(os.path.join(BOARD_DIR, "sofa_board.js")).read()
    index = open(os.path.join(BOARD_DIR, "index.html")).read()
    for needed in ("function pointsFromColumnar", "function pointsFromTile",
                   "class TileLoader", "DecompressionStream"):
        assert needed in js
    assert "TileLoader" in index and "onViewChange" in index


def test_serving_feature_names_contract(sink):
    names = set(pd.read_csv(sink.path("features.csv"))["name"])
    for needed in ("serving_prefill_time", "serving_decode_time"):
        assert needed in names
    page = open(os.path.join(BOARD_DIR, "serving.html")).read()
    assert set(re.findall(r'get\("(serving_\w+)"\)', page)) == {
        "serving_prefill_time", "serving_decode_time"}


def test_report_js_columnar_and_tiles_contract(sink):
    doc = read_report_js_doc(sink.path("report.js"))
    names = [s["name"] for s in doc["series"]]
    for want in ("gputrace", "gpu_phase_fw", "gpu_phase_bw", "gpuutil",
                 "gpusteps", "gpumon", "hosttrace", "pystacks", "gpu_HtoD",
                 "gpu_sofa_flash"):
        assert want in names
    for s in doc["series"]:
        assert {"name", "title", "color", "kind", "data"} <= set(s)
        data = s["data"]
        assert len(data["x"]) == len(data["y"]) == len(data["d"]) \
            == len(data["ni"])
        assert all(0 <= i < len(data["names"]) for i in data["ni"])
    flash = next(s for s in doc["series"] if s["name"] == "gpu_sofa_flash")
    assert set(flash["data"]["names"]) == {
        "sofa_flash_fwd_kernel", "sofa_flash_bwd_kv_kernel",
        "sofa_flash_bwd_dq_kernel"}
    meta = doc["meta"]
    assert meta["gpu_meta"]["devices"][0]["name"] == "NVIDIA H100 80GB HBM3"
    assert meta["elapsed_time"] == 0.05 and meta["logdir"] == sink.logdir
    tiles = meta["tiles"]
    assert tiles["dir"] == "_tiles" and "gputrace" in tiles["series"]
    for ent in tiles["series"].values():
        assert ent["levels"] >= 1 and ent["x1"] >= ent["x0"]
        assert os.path.isdir(sink.path("_tiles", ent["path"]))


def test_sink_hints_and_features(sink):
    """The sink's steps are mostly idle: analyze names it in hints.txt."""
    hints = open(sink.path("hints.txt")).read()
    assert "device idle inside steps on gpu0" in hints


def test_num_cores_from_misc_like_jax(tmp_path):
    """A logdir without mpstat (an api.profile() capture) takes num_cores
    from misc.txt, as the JAX package's analyze does."""
    from sofa_tpu.analyze import sofa_analyze as jax_sofa_analyze

    feats = {}
    for side, analyze, config in (("port", sofa_analyze, SofaConfig),
                                  ("jax", jax_sofa_analyze, JaxConfig)):
        d = tmp_path / side
        d.mkdir()
        (d / "misc.txt").write_text("elapsed_time 1.5\ncores 12\n")
        f = analyze(config(logdir=str(d) + "/"))
        feats[side] = (f.get("elapsed_time"), f.get("num_cores"))
    assert feats["port"] == feats["jax"] == (1.5, 12.0)


# -- the verbs on the CPU ----------------------------------------------------------

def _cli(*argv, cwd=REPO):
    """``python -m sofa_tpu_torch`` in a fresh process; then whether it
    imported torch and initialized CUDA."""
    code = ("import sys; from sofa_tpu_torch.cli import main; "
            f"rc = main({list(argv)!r}); "
            "t = sys.modules.get('torch'); "
            "print('CUDA_INIT', bool(t and t.cuda.is_initialized())); "
            "sys.exit(rc)")
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def cpu_logdir(tmp_path_factory):
    """A real CPU ``stat`` logdir (the command the verify notes give)."""
    d = str(tmp_path_factory.mktemp("stat") / "run")
    cmd = (f"{sys.executable} -m sofa_tpu_torch.workloads.inference --device "
           "cpu --n_layers 1 --d_model 64 --n_heads 4 --n_kv_heads 2 "
           "--d_ff 128 --vocab 256 --prompt 16 --new_tokens 4")
    r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "stat",
                        "--logdir", d, "--enable_py_stacks", cmd], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "Complete!!" in r.stdout, r.stderr[-2000:]
    return d


def _copy(src, tmp_path):
    dst = str(tmp_path / "copy")
    shutil.copytree(src, dst)
    return dst + "/"


def test_report_on_a_cpu_stat_logdir(cpu_logdir, tmp_path):
    d = _copy(cpu_logdir, tmp_path)
    r = _cli("report", "--logdir", d)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Complete!!" in r.stdout and "CUDA_INIT False" in r.stdout
    for page in STAGED:
        assert os.path.isfile(d + page)
    doc = read_report_js_doc(d + "report.js")
    assert {"hosttrace", "pystacks", "mpstat"} <= \
        {s["name"] for s in doc["series"]}
    assert "board data:" in r.stdout


def test_report_skip_preprocess_reads_the_csvs(cpu_logdir, tmp_path):
    d = _copy(cpu_logdir, tmp_path)
    before = os.stat(d + "report.js").st_mtime_ns
    os.rename(d + "kineto", d + "kineto.away")     # nothing to re-ingest
    r = _cli("report", "--skip_preprocess", "--logdir", d)
    assert r.returncode == 0 and "Complete!!" in r.stdout
    assert "CUDA_INIT False" in r.stdout
    feats = pd.read_csv(d + "features.csv")
    assert feats.loc[feats["name"] == "py_samples", "value"].iloc[0] > 0
    assert os.stat(d + "report.js").st_mtime_ns == before
    assert os.path.isfile(d + "index.html")


def test_clean_removes_derived_keeps_raw(tmp_path):
    d = str(tmp_path / "sink") + "/"
    write_sink_logdir(d)
    cfg = SofaConfig(logdir=d, viz_downsample_to=20)
    sofa_analyze(cfg, sofa_preprocess(cfg))
    raw = {"sofa_time.txt", "misc.txt", "gpu_topo.json", "memprof.pb.gz",
           "memprof.pb.gz.meta.json", "pystacks.txt", "gpumon.txt", "kineto"}
    assert os.path.isdir(d + "_tiles") and os.path.isfile(d + "hints.txt")
    with open(d + "user_notes.md", "w") as f:
        f.write("mine")
    os.makedirs(d + "_tiles/gputrace/0", exist_ok=True)
    with open(d + "_tiles/gputrace/0/stray.json.gz.tmp", "w") as f:
        f.write("x")
    with open(d + "kineto/torn.json.tmp", "w") as f:
        f.write("x")
    r = _cli("clean", "--logdir", d)
    assert r.returncode == 0 and "CUDA_INIT False" in r.stdout
    assert set(os.listdir(d)) == raw | {"user_notes.md"}
    assert os.listdir(d + "kineto") == ["trace_100.json"]
    # and the logdir reports again
    r = _cli("report", "--logdir", d)
    assert r.returncode == 0 and "Complete!!" in r.stdout
    assert os.path.isfile(d + "report.js")
