"""The options of the port's verbs against the JAX package's: the config
file (``SofaConfig.from_toml`` / ``from_dict`` and ``--config``, with the
same errors for unknown keys and mistyped values, and flags overriding the
file), each new flag at a value other than its default on the same raw
input through both packages (``--tile_levels``, the two clock offsets, the
timeline filters, ``--viz_downsample_to``), and the Kineto trace's detail
levels and window: real CPU captures of ``api.profile()`` and ``stat``,
and a synthetic CUDA capture recorded at each level, through ingest and
the passes (which columns are present, which absent, and the warnings).
The concurrency breakdown's ``--is_idle_threshold`` is held in
``test_torch_net_passes.py``."""

import copy
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pandas as pd
import pytest

from sofa_tpu import tiles as jax_tiles
from sofa_tpu.cli import build_parser as jax_parser
from sofa_tpu.cli import config_from_args as jax_config_from_args
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.preprocess import build_series as jax_build_series
from sofa_tpu.preprocess import sofa_preprocess as jax_preprocess
from sofa_tpu.trace import SofaSeries as JaxSeries
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu.trace import read_csv as jax_read_csv
from sofa_tpu.trace import series_to_report_js as jax_series_to_report_js
from sofa_tpu_torch import api, tiles
from sofa_tpu_torch.cli import build_parser, config_from_args, main
from sofa_tpu_torch.config import Filter, SofaConfig
from sofa_tpu_torch.ingest.kineto import ingest_trace
from sofa_tpu_torch.preprocess import build_series, sofa_preprocess
from sofa_tpu_torch.trace import SofaSeries, make_frame, read_csv
from sofa_tpu_torch.trace import series_to_report_js
from sofa_tpu_torch.workloads.common import step_annotation
from test_torch_board import (BASE_NS, DEVICE_NAMES, _capture, sink_trace,
                              write_sink_logdir)
import test_torch_host_ingest as host_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The port's field names for the JAX package's.
PORT_NAMES = {"tpu_time_offset_ms": "gpu_time_offset_ms",
              "tpu_filters": "gpu_filters",
              "xprof_delay_s": "kineto_delay_s",
              "xprof_duration_s": "kineto_duration_s",
              "xprof_host_tracer_level": "kineto_host_tracer_level",
              "xprof_python_tracer": "kineto_python_tracer"}


def _port_dict(jax_dict):
    return {PORT_NAMES.get(k, k): v for k, v in jax_dict.items()}


# --- the config file ----------------------------------------------------------

BAD = {
    "unknown_key": {"nope": 1},
    "str_field_int": {"logdir": 123},
    "bool_field_int": {"verbose": 1},
    "int_field_str": {"sys_mon_rate": "many"},
    "int_field_float": {"viz_port": 80.5},
    "float_field_bool": {"is_idle_threshold": True},
    "int_field_bool": {"tile_levels": False},
    "str_field_list": {"profile_region": ["1", "2"]},
    "port_float_str": {"tpu_time_offset_ms": "5"},
    "port_int_str": {"xprof_host_tracer_level": "high"},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_from_dict_rejects_like_jax(case):
    data = BAD[case]
    with pytest.raises(ValueError) as want:
        JaxConfig.from_dict(data)
    with pytest.raises(ValueError) as got:
        SofaConfig.from_dict(_port_dict(data))
    names = {v: k for k, v in PORT_NAMES.items()}
    msg = str(got.value)
    for port, jax in names.items():
        msg = msg.replace(port, jax)
    assert msg == str(want.value)


GOOD = {
    "int_for_float": {"tpu_time_offset_ms": 5, "is_idle_threshold": 1},
    "optional_and_list": {"hint_server": "h:1", "plugins": ["a", "b:c"],
                          "cluster_hosts": ["x"]},
    "knobs": {"xprof_delay_s": 2.5, "xprof_duration_s": 4,
              "xprof_host_tracer_level": 0, "xprof_python_tracer": True,
              "tile_levels": 3, "cpu_time_offset_ms": -7,
              "viz_downsample_to": 500},
}


@pytest.mark.parametrize("case", sorted(GOOD))
def test_from_dict_accepts_like_jax(case):
    data = GOOD[case]
    want = JaxConfig.from_dict(data)
    got = SofaConfig.from_dict(_port_dict(data))
    for key, value in data.items():
        assert getattr(got, PORT_NAMES.get(key, key)) == \
            getattr(want, key) == value


def test_from_toml_filters_like_jax(tmp_path):
    text = ('logdir = "run1/"\nsys_mon_rate = 25\n'
            'cpu_filters = ["idle:black", "memcpy"]\n'
            '{key} = [{{keyword = "flash", color = "violet"}}, "gemm:red"]\n')
    (tmp_path / "jax.toml").write_text(text.format(key="tpu_filters"))
    (tmp_path / "port.toml").write_text(text.format(key="gpu_filters"))
    want = JaxConfig.from_toml(str(tmp_path / "jax.toml"))
    got = SofaConfig.from_toml(str(tmp_path / "port.toml"))
    assert (got.logdir, got.sys_mon_rate) == ("run1/", 25)
    assert [(f.keyword, f.color) for f in got.cpu_filters] == \
        [(f.keyword, f.color) for f in want.cpu_filters] == \
        [("idle", "black"), ("memcpy", "orange")]
    assert [(f.keyword, f.color) for f in got.gpu_filters] == \
        [(f.keyword, f.color) for f in want.tpu_filters] == \
        [("flash", "violet"), ("gemm", "red")]


def test_flags_override_the_config_file(tmp_path):
    cfg_file = tmp_path / "sofa.toml"
    cfg_file.write_text('logdir = "from_file/"\nsys_mon_rate = 25\n'
                        'kineto_delay_s = 3.0\nspotlight = true\n'
                        'is_idle_threshold = 0.2\n')
    args = build_parser().parse_intermixed_args(
        ["analyze", "--config", str(cfg_file), "--sys_mon_rate", "50",
         "--is_idle_threshold", "0.05"])
    cfg = config_from_args(args)
    assert (cfg.logdir, cfg.sys_mon_rate, cfg.kineto_delay_s,
            cfg.spotlight, cfg.is_idle_threshold) == \
        ("from_file/", 50, 3.0, True, 0.05)
    jax_file = tmp_path / "jax.toml"
    jax_file.write_text(cfg_file.read_text().replace("kineto_delay_s",
                                                     "xprof_delay_s"))
    jcfg = jax_config_from_args(jax_parser().parse_args(
        ["analyze", "--config", str(jax_file), "--sys_mon_rate", "50",
         "--is_idle_threshold", "0.05"]))
    assert (jcfg.logdir, jcfg.sys_mon_rate, jcfg.xprof_delay_s,
            jcfg.spotlight, jcfg.is_idle_threshold) == \
        (cfg.logdir, cfg.sys_mon_rate, cfg.kineto_delay_s, cfg.spotlight,
         cfg.is_idle_threshold)


def test_a_bad_config_file_is_exit_2(tmp_path, capsys):
    bad = tmp_path / "bad.toml"
    bad.write_text("logdir = 123\n")
    assert main(["analyze", "--config", str(bad)]) == 2
    assert "bad configuration: config key 'logdir': expected str" in \
        capsys.readouterr().err
    assert main(["analyze", "--config", str(tmp_path / "missing.toml")]) == 2


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == "sofa_tpu_torch 0.1.0"


# (port flag argv, port field, value, JAX argv or None)
FLAGS = [
    (["--cpu_filters", "python:red,libtorch"], "cpu_filters",
     [Filter("python", "red"), Filter("libtorch", "orange")],
     ["--cpu_filters", "python:red,libtorch"]),
    (["--gpu_filters", "gemm:blue"], "gpu_filters", [Filter("gemm", "blue")],
     ["--tpu_filters", "gemm:blue"]),
    (["--viz_downsample_to", "777"], "viz_downsample_to", 777,
     ["--viz_downsample_to", "777"]),
    (["--tile_levels", "3"], "tile_levels", 3, ["--tile_levels", "3"]),
    (["--cpu_time_offset_ms", "250"], "cpu_time_offset_ms", 250,
     ["--cpu_time_offset_ms", "250"]),
    (["--gpu_time_offset_ms", "-12.5"], "gpu_time_offset_ms", -12.5,
     ["--tpu_time_offset_ms", "-12.5"]),
    (["--is_idle_threshold", "0.05"], "is_idle_threshold", 0.05,
     ["--is_idle_threshold", "0.05"]),
    (["--kineto_delay_s", "2"], "kineto_delay_s", 2.0,
     ["--xprof_delay_s", "2"]),
    (["--kineto_duration_s", "1.5"], "kineto_duration_s", 1.5,
     ["--xprof_duration_s", "1.5"]),
    (["--kineto_host_tracer_level", "1"], "kineto_host_tracer_level", 1,
     ["--xprof_host_tracer_level", "1"]),
    (["--kineto_python_tracer"], "kineto_python_tracer", True,
     ["--xprof_python_tracer"]),
    (["--plugin", "a", "--plugin", "b:c"], "plugins", ["a", "b:c"],
     ["--plugin", "a", "--plugin", "b:c"]),
    (["--hint_server", "h:5"], "hint_server", "h:5", ["--hint_server", "h:5"]),
]


@pytest.mark.parametrize("argv,field,value,jax_argv", FLAGS,
                         ids=[f[1] for f in FLAGS])
def test_each_new_flag_sets_its_field_like_jax(argv, field, value, jax_argv,
                                               monkeypatch):
    cfg = config_from_args(build_parser().parse_intermixed_args(
        ["report", *argv]))
    assert getattr(cfg, field) == value
    assert getattr(SofaConfig(), field) != value
    jcfg = jax_config_from_args(jax_parser().parse_args(
        ["report", *jax_argv]))
    jfield = {v: k for k, v in PORT_NAMES.items()}.get(field, field)
    want = getattr(jcfg, jfield)
    if field.endswith("_filters"):
        want = [Filter(f.keyword, f.color) for f in want]
    assert want == value
    # nothing else moved
    for other in ("sys_mon_rate", "logdir", "spotlight", "jobs"):
        assert getattr(cfg, other) == getattr(SofaConfig(), other)


def test_the_trace_level_flag_takes_only_the_four_levels():
    with pytest.raises(SystemExit):
        build_parser().parse_intermixed_args(
            ["record", "true", "--kineto_host_tracer_level", "4"])


# --- each flag on the same input through both packages ------------------------

def _tile_cols(n, seed):
    rng = np.random.default_rng(seed)
    return {"timestamp": np.sort(rng.uniform(0, 50, n)),
            "duration": rng.exponential(1e-3, n),
            "event": rng.uniform(0, 1, n),
            "name": [f"kernel_{i % 50}" for i in range(n)]}


def _tree(root):
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("levels", [1, 3])
def test_tile_levels_match_jax(tmp_path, levels):
    cols = _tile_cols(60000, 4)
    pcfg = SofaConfig(logdir=str(tmp_path / "port"), tile_levels=levels)
    jcfg = JaxConfig(logdir=str(tmp_path / "jax"), tile_levels=levels)
    got = tiles.build_tiles(pcfg, [SofaSeries("gputrace", "t", "c",
                                              make_frame(cols))], jobs=2)
    want = jax_tiles.build_tiles(jcfg, [JaxSeries("gputrace", "t", "c",
                                                  jax_make_frame(cols))],
                                 jobs=2)
    assert got == want
    assert got["series"]["gputrace"]["levels"] == levels
    assert _tree(pcfg.path(tiles.TILES_DIR_NAME)) == \
        _tree(jcfg.path(jax_tiles.TILES_DIR_NAME))
    auto = tiles.build_tiles(SofaConfig(logdir=str(tmp_path / "auto")), [
        SofaSeries("gputrace", "t", "c", make_frame(cols))], jobs=2)
    assert auto["series"]["gputrace"]["levels"] > levels


def _host_raw(d):
    os.makedirs(d, exist_ok=True)
    for name, text in (("mpstat.txt", host_raw.MPSTAT),
                       ("diskstat.txt", host_raw.DISKSTAT),
                       ("netstat.txt", host_raw.NETSTAT),
                       ("pystacks.txt", host_raw.PYSTACKS),
                       ("strace.txt", host_raw.STRACE)):
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    with open(os.path.join(d, "sofa_time.txt"), "w") as f:
        f.write(f"{host_raw.T0:.6f}\n")


HOST_FRAMES = ("mpstat", "diskstat", "netbandwidth", "pystacks", "strace")


def test_cpu_time_offset_matches_jax(tmp_path):
    """The same raw host files through both packages' preprocess with
    --cpu_time_offset_ms 250: the same frames, exactly."""
    for side in ("port", "jax"):
        _host_raw(str(tmp_path / side))
    sofa_preprocess(SofaConfig(logdir=str(tmp_path / "port"),
                               cpu_time_offset_ms=250))
    jax_preprocess(JaxConfig(logdir=str(tmp_path / "jax"),
                             cpu_time_offset_ms=250, trace_format="csv"))
    _host_raw(str(tmp_path / "zero"))
    sofa_preprocess(SofaConfig(logdir=str(tmp_path / "zero")))
    for name in HOST_FRAMES:
        got = read_csv(str(tmp_path / "port" / f"{name}.csv"))
        want = jax_read_csv(str(tmp_path / "jax" / f"{name}.csv"))
        assert len(got) > 0
        pd.testing.assert_frame_equal(got, want, check_exact=True,
                                      check_dtype=False)
        zero = read_csv(str(tmp_path / "zero" / f"{name}.csv"))
        assert (got["timestamp"] == zero["timestamp"] + 0.25).all()


def test_gpu_time_offset_shifts_the_kineto_frames_after_the_cache(
        tmp_path, monkeypatch):
    """--gpu_time_offset_ms moves every Kineto frame and no other, by
    t + offset as the JAX package moves its device frames; a warm run
    (the frames from the ingest cache) takes a changed offset too."""
    from sofa_tpu_torch import telemetry

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    base = sofa_preprocess(SofaConfig(logdir=d))
    for off in (-12.5, 40.0):
        got = sofa_preprocess(SofaConfig(logdir=d, gpu_time_offset_ms=off))
        assert telemetry.load_manifest(d)["sources"]["kineto"]["cache"] \
            == "hit"
        for name, df in got.items():
            if df.empty:
                continue
            shift = off / 1e3 if name in ("gputrace", "gpusteps",
                                          "hosttrace", "gpuutil") else 0.0
            ts = df["timestamp"].to_numpy()
            assert (ts == base[name]["timestamp"].to_numpy() + shift).all()
            on_disk = read_csv(os.path.join(d, f"{name}.csv"))
            np.testing.assert_allclose(on_disk["timestamp"].to_numpy(), ts,
                                       rtol=0, atol=1e-12)


def _filter_series(port_argv, jax_argv):
    cols = _capture()
    pcfg = config_from_args(build_parser().parse_intermixed_args(
        ["report", *port_argv]))
    jcfg = jax_config_from_args(jax_parser().parse_args(
        ["report", *jax_argv]))
    port = build_series(pcfg, {k: make_frame(v) for k, v in cols.items()})
    ref = jax_build_series(jcfg, {DEVICE_NAMES.get(k, k): jax_make_frame(v)
                                  for k, v in cols.items()})
    return pcfg, jcfg, port, ref


def test_filters_match_jax():
    pcfg, jcfg, port, ref = _filter_series(
        ["--cpu_filters", "python:red,libtorch", "--gpu_filters",
         "gemm:blue,add"],
        ["--cpu_filters", "python:red,libtorch", "--tpu_filters",
         "gemm:blue,add"])
    names = [s.name for s in port]
    for kw in ("cpu_python", "cpu_libtorch", "gpu_gemm", "gpu_add"):
        assert kw in names
    by_name = {s.name: s for s in port}
    jax_by = {s.name: s for s in ref}
    for kw in ("python", "libtorch"):
        a = by_name[f"cpu_{kw}"].to_columnar(pcfg.viz_downsample_to)
        b = jax_by[f"cpu_{kw}"].to_columnar(jcfg.viz_downsample_to)
        assert a == b and len(a["x"]) > 0
    for kw in ("gemm", "add"):
        a = by_name[f"gpu_{kw}"].to_columnar(pcfg.viz_downsample_to)
        b = jax_by[f"tpu_{kw}"].to_columnar(jcfg.viz_downsample_to)
        assert a == b and len(a["x"]) > 0
    assert by_name["gpu_gemm"].color == jax_by["tpu_gemm"].color == "blue"


def test_viz_downsample_to_report_js_matches_jax(tmp_path):
    pcfg, jcfg, port, ref = _filter_series(
        ["--viz_downsample_to", "777", "--gpu_filters", "flash"],
        ["--viz_downsample_to", "777", "--tpu_filters", "flash"])
    series_to_report_js(port, str(tmp_path / "port.js"),
                        pcfg.viz_downsample_to)
    jax_series_to_report_js(ref, str(tmp_path / "jax.js"),
                            jcfg.viz_downsample_to)
    from sofa_tpu_torch.trace import read_report_js_doc

    got = read_report_js_doc(str(tmp_path / "port.js"))
    want = read_report_js_doc(str(tmp_path / "jax.js"))
    assert len(got["series"]) == len(want["series"])
    for g, w in zip(got["series"], want["series"]):
        assert g["data"] == w["data"]
        assert len(g["data"]["x"]) <= 777 + 777 // 10 + 1
    assert max(len(s["data"]["x"]) for s in got["series"]) > 700


# --- the trace's detail and window: real CPU captures -------------------------

def _train_steps(n, sleep_s=0.0):
    import time

    import torch

    x = torch.randn(32, 32, requires_grad=True)
    for i in range(n):
        with step_annotation(i):
            (x @ x).relu().sum().backward()
            if sleep_s:
                time.sleep(sleep_s)


def _capture_doc(logdir):
    paths = glob.glob(os.path.join(logdir, "kineto", "*.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        return json.load(f)


def _cats(doc):
    out = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            out[e.get("cat")] = out.get(e.get("cat"), 0) + 1
    return out


@pytest.mark.parametrize("level,python_tracer", [(0, False), (1, False),
                                                 (1, True), (2, False),
                                                 (3, False)])
def test_detail_levels_record_what_they_say(tmp_path, level, python_tracer):
    logdir = str(tmp_path / "run")
    with api.profile(logdir, cfg=SofaConfig(
            kineto_host_tracer_level=level,
            kineto_python_tracer=python_tracer)):
        _train_steps(3)
    doc = _capture_doc(logdir)
    cats = _cats(doc)
    names = [e.get("name", "") for e in doc["traceEvents"]]
    detail = doc["sofa_trace_detail"]
    assert (detail["host_tracer_level"], detail["python_tracer"]) == \
        (level, python_tracer)
    # the record_function ranges stay at every level: both clock markers
    # and the steps
    assert sum(n.startswith("sofa_timebase_marker:") for n in names) == 2
    assert sum(n.startswith("sofa_step_") for n in names) == 3
    assert (cats.get("cpu_op", 0) > 0) == (level >= 1)
    shapes = sum("Input Dims" in (e.get("args") or {})
                 for e in doc["traceEvents"])
    assert (shapes > 0) == (level >= 2)
    assert (cats.get("python_function", 0) > 0) == \
        (level >= 3 or python_tracer)


def test_window_records_only_inside_it_on_the_programs_thread(tmp_path):
    """A delayed start and an early stop, each on the thread that
    profiles: a capture of the steps inside the window only, its CPU ops
    on that thread."""
    logdir = str(tmp_path / "run")
    with api.profile(logdir, cfg=SofaConfig(kineto_delay_s=0.3,
                                            kineto_duration_s=0.3)):
        _train_steps(60, sleep_s=0.02)
    doc = _capture_doc(logdir)
    steps = sorted(int(e["name"].rpartition("_")[2])
                   for e in doc["traceEvents"]
                   if str(e.get("name", "")).startswith("sofa_step_"))
    assert 3 <= len(steps) < 60 and steps[0] > 0 and steps[-1] < 59
    assert steps == list(range(steps[0], steps[-1] + 1))
    tids = {e.get("tid") for e in doc["traceEvents"]
            if e.get("cat") == "cpu_op"}
    assert tids == {threading.get_native_id()}
    detail = doc["sofa_trace_detail"]
    assert 0.25 <= detail["stop_unix"] - detail["start_unix"] < 0.6


PROGRAM = """
import time, torch
from sofa_tpu_torch.workloads.common import step_annotation
x = torch.randn(32, 32, requires_grad=True)
for i in range({n}):
    with step_annotation(i):
        (x @ x).relu().sum().backward()
        time.sleep(0.02)
print("done", flush=True)
"""


@pytest.mark.parametrize("window", [("0.5", "0.4"), ("30", "0")],
                         ids=["inside_the_run", "past_the_run"])
def test_stat_window_exports_once(tmp_path, window):
    """Under ``stat``: the early stop exports the trace from the
    program's thread, the at-exit stop exports nothing more; a delay
    longer than the run leaves no trace, a warning, and the topology."""
    prog = tmp_path / "prog.py"
    prog.write_text(PROGRAM.format(n=60))
    logdir = str(tmp_path / "run")
    delay, duration = window
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch", "record", "--logdir",
         logdir, "--kineto_delay_s", delay, "--kineto_duration_s", duration,
         "--disable_gpu_mon", f"{sys.executable} {prog}"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done" in r.stdout
    traces = glob.glob(os.path.join(logdir, "kineto", "*.json"))
    assert os.path.isfile(os.path.join(logdir, "gpu_topo.json"))
    if delay == "30":
        assert traces == []
        assert "the trace never started" in r.stderr
        return
    assert len(traces) == 1 and not glob.glob(os.path.join(
        logdir, "kineto", "*.tmp"))
    doc = _capture_doc(logdir)
    steps = [e["name"] for e in doc["traceEvents"]
             if str(e.get("name", "")).startswith("sofa_step_")]
    assert 3 <= len(steps) < 60
    frames = sofa_preprocess(SofaConfig(logdir=logdir))
    assert 3 <= len(frames["gpusteps"]) < 60


# --- the detail levels through ingest and the passes: a synthetic capture ----

def _at_level(level):
    """sink_trace() as the collector would record it at ``level``: no
    operand shapes below 2, no aten op or autograd range at 0."""
    doc = copy.deepcopy(sink_trace())
    doc["sofa_trace_detail"] = {"host_tracer_level": level}
    events = []
    for e in doc["traceEvents"]:
        if e.get("cat") == "cpu_op":
            if level == 0:
                continue
            if level == 1:
                e["args"] = {k: v for k, v in e["args"].items()
                             if k not in ("Input Dims", "Input type",
                                          "Concrete Inputs")}
        events.append(e)
    doc["traceEvents"] = events
    return doc


@pytest.mark.parametrize("level", [0, 1, 2])
def test_ingest_reports_what_the_level_cannot_see_as_absent(level):
    frames = ingest_trace(_at_level(level), BASE_NS / 1e9)
    kern = frames["gputrace"][frames["gputrace"]["copyKind"] == 0]
    flash = kern["name"].str.startswith("sofa_flash")
    # the flash kernels' cost ranges are record_function ranges: kept
    assert (kern.loc[flash, "flops"] > 0).all()
    if level == 2:
        assert (kern["flops"] > 0).all() and not kern["flops"].isna().any()
    else:
        assert kern.loc[~flash, ["flops", "bytes_accessed"]].isna().all() \
            .all()
    phases = set(kern["phase"])
    assert phases == ({""} if level == 0 else {"fw", "bw"})
    paths = kern.loc[~flash, "op_path"]
    assert paths.str.contains("aten::mm").any() == (level >= 1)
    assert paths.str.startswith("sofa_step_").any()


@pytest.mark.parametrize("level", [0, 1])
def test_passes_below_level_2_warn_and_write_no_roofline(tmp_path, level,
                                                         capsys):
    from sofa_tpu_torch.analyze import sofa_analyze

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    with open(os.path.join(d, "kineto", "trace_100.json"), "w") as f:
        json.dump(_at_level(level), f)
    cfg = SofaConfig(logdir=d)
    features = sofa_analyze(cfg, sofa_preprocess(cfg))
    err = capsys.readouterr().err
    for name in ("roofline_profile", "sol_roofline"):
        assert re.search(f"{name}: \\d+ of \\d+ kernels carry no flops or "
                         "bytes .*--kineto_host_tracer_level below 2", err)
    assert not os.path.exists(cfg.path("roofline.csv"))
    assert not os.path.exists(cfg.path("sol_roofline.csv"))
    for absent in ("gpu_total_flops", "gpu_total_bytes_accessed",
                   "gpu0_roofline_efficiency", "gpu0_sol_distance",
                   "tensor_util_mean", "hbm_gbps_mean"):
        assert features.get(absent) is None, absent
    assert features.get("gpu_kernels") == 32
    assert features.get("kernel_util_mean") is not None
    top = pd.read_csv(cfg.path("gpu_top_kernels.csv"))
    flash = top["name"].str.startswith("sofa_flash")
    assert (top.loc[flash, "flops"] > 0).all()
    assert top.loc[~flash, "flops"].isna().all()
    assert (features.get("gpu_fw_time") is None) == (level == 0)
