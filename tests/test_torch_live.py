"""sofa_tpu_torch's ``live`` verb against the JAX package's on the same raw
bytes (the JAX ``tpumon.txt`` and the port's ``gpumon.txt`` share their
line format): the chunked tail of each tailed source, the offset ledger and
the chunk store, the live tile pyramid, the incremental pass window, the
stream faults and the growth watermark, the gpumon files' rename and
renumbering, a Kineto capture landing between epochs, a SIGKILL inside an
epoch then ``resume`` and ``live --drain`` against batch, the write
sentinel, the CLI, ``clean``, ``status``, both validators and the board.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest

from sofa_tpu import faults as jax_faults
from sofa_tpu import live as jax_live
from sofa_tpu import supervisor as jax_supervisor
from sofa_tpu import tiles as jax_tiles
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.ingest.cache import IngestCache as JaxCache
from sofa_tpu.trace import SofaSeries as JaxSeries
from sofa_tpu_torch import faults, live, tiles, telemetry
from sofa_tpu_torch.analysis import registry
from sofa_tpu_torch.cli import main as cli_main
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest.cache import CACHE_DIR_NAME, IngestCache
from sofa_tpu_torch.preprocess import KINETO_FRAMES, _ingest_tasks
from sofa_tpu_torch.supervisor import GrowthWatermark
from sofa_tpu_torch.tools.manifest_check import (validate_live_offsets,
                                                 validate_manifest)
from sofa_tpu_torch.trace import SofaSeries, _conform, read_frame

from test_torch_board import BASE_NS, sink_trace
from test_torch_faults import jax_validator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TB = BASE_NS / 1e9
# the columns both packages' frames carry
SHARED = ["timestamp", "event", "duration", "deviceId", "name", "payload"]


def jax_manifest_check():
    spec = importlib.util.spec_from_file_location(
        "jax_manifest_check", os.path.join(REPO, "tools", "manifest_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- raw bytes ---------------------------------------------------------------

def seed_logdir(path, name="log") -> str:
    log = os.path.join(str(path), name) + "/"
    os.makedirs(log, exist_ok=True)
    with open(log + "sofa_time.txt", "w") as f:
        f.write(f"{TB}\n")
    with open(log + "misc.txt", "w") as f:
        f.write("elapsed_time 2.5\ncores 8\npid 1\nrc 0\n")
    return log


def mon_lines(t0: int, t1: int, devs=(0,)) -> str:
    """Sampler lines, the port's gpumon and the JAX package's tpumon."""
    rows = []
    for t in range(t0, t1):
        ns = int((TB + t * 0.001) * 1e9)
        rows.append(f"{ns} -1 0 0 0\n")
        rows += [f"{ns} {d} {2500000000 + t * 1000} 8000000000 "
                 f"{2600000000 + t}\n" for d in devs]
    return "".join(rows)


def pystacks_lines(t0: int, t1: int) -> str:
    return "".join(f"{TB + i * 0.001:.6f} {1 + i % 4} "
                   f"main;train;step_{i % 50};kernel\n" for i in range(t0, t1))


def strace_lines(t0: int, t1: int) -> str:
    import datetime as _dt

    day = _dt.datetime.fromtimestamp(TB)
    origin = _dt.datetime(day.year, day.month, day.day).timestamp()
    rows = []
    for i in range(t0, t1):
        hh, rem = divmod(TB - origin + i * 0.001, 3600)
        mm, ss = divmod(rem, 60)
        rows.append(f"{100 + i % 4} {int(hh):02d}:{int(mm):02d}:{ss:09.6f} "
                    f"read(3, \"buf\", 4096) = 4096 <0.0001{i % 90:02d}>\n")
    return "".join(rows)


def cpuinfo_lines(t0: int, t1: int) -> str:
    return "".join(f"{TB + t * 0.1:.2f} " + " ".join(["2000.0"] * 4) + "\n"
                   for t in range(t0, t1))


# source -> (port raw, JAX source, JAX raw, writer)
SOURCES = {
    "gpumon": ("gpumon.txt", "tpumon", "tpumon.txt", mon_lines),
    "pystacks": ("pystacks.txt", "pystacks", "pystacks.txt", pystacks_lines),
    "strace": ("strace.txt", "strace", "strace.txt", strace_lines),
    "cpuinfo": ("cpuinfo.txt", "cpuinfo", "cpuinfo.txt", cpuinfo_lines),
}


def append(log, name, text, mode="a"):
    with open(log + name, mode) as f:
        f.write(text)


def live_cfg(log, **kw) -> SofaConfig:
    kw.setdefault("live_interval_s", 0.0)
    return SofaConfig(logdir=log, **kw)


def meta_live(log) -> dict:
    return (telemetry.load_manifest(log) or {}).get("meta", {}).get("live", {})


def ledger(log) -> dict:
    with open(log + live.OFFSETS_NAME) as f:
        return json.load(f)


# --- the ledger ---------------------------------------------------------------

def test_whole_records_as_the_jax_package():
    for buf in (b"a 1\nb 2\nc 3", b"a 1\nb 2\n", b"half", b"", b"\n",
                b"x\n\ny"):
        assert live.whole_records(buf) == jax_live.whole_records(buf)


def test_offset_ledger_round_trips_and_the_jax_package_reads_it(tmp_path):
    log = seed_logdir(tmp_path)
    led = live.OffsetLedger.load(log)
    assert led.doc["epoch"] == 0
    ent = led.source("gpumon")
    ent["offset"], ent["chunks"] = 120, [[0, 120, 5]]
    led.doc["epoch"] = 3
    led.commit()
    again = live.OffsetLedger.load(log)
    assert again.doc["epoch"] == 3
    assert again.source("gpumon") == {"offset": 120, "chunks": [[0, 120, 5]],
                                      "head_sha": None, "events": 0}
    theirs = jax_live.OffsetLedger.load(log)
    assert theirs.doc == again.doc
    assert validate_live_offsets(ledger(log)) == []
    assert jax_manifest_check().validate_live_offsets(ledger(log)) == []


@pytest.mark.parametrize("text", ['{"schema": "other/ledger", "version": 1, '
                                  '"epoch": 9}', '{"schema": "sofa_tpu/live_'])
def test_a_foreign_or_torn_ledger_starts_from_byte_0(tmp_path, text):
    log = seed_logdir(tmp_path)
    append(log, live.OFFSETS_NAME, text, "w")
    assert live.OffsetLedger.load(log).doc["epoch"] == 0
    assert jax_live.OffsetLedger.load(log).doc["epoch"] == 0
    append(log, "gpumon.txt", mon_lines(0, 20))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    assert ledger(log)["sources"]["gpumon"]["chunks"][0][0] == 0
    assert ledger(log)["epoch"] == 1


# --- chunked tailing ------------------------------------------------------------

def _tailers(tmp_path, source):
    """The port's and the JAX package's tailer of one source, each over a
    logdir of its own: a function of the epoch -> (port frame, JAX frame,
    port outcome)."""
    raw, jsrc, jraw, _gen = SOURCES[source]
    ours = seed_logdir(tmp_path, "ours")
    theirs = seed_logdir(tmp_path, "theirs")
    cfg, jcfg = live_cfg(ours), JaxConfig(logdir=theirs)
    led, jled = live.OffsetLedger(ours), jax_live.OffsetLedger(theirs)
    chunks = IngestCache(ours + CACHE_DIR_NAME).chunks()
    jchunks = JaxCache(theirs + CACHE_DIR_NAME).chunks()
    parser = {s: p for s, _r, p in live._tail_sources(cfg)}[source]
    jparser = {s: p for s, _r, p in jax_live._tail_parsers(jcfg)}[jsrc]
    wm, jwm = GrowthWatermark(30), jax_supervisor.GrowthWatermark(30)

    def epoch(n):
        o = live._tail_source(led, chunks, source, ours + raw, parser, TB, n,
                              wm)
        j = jax_live._tail_source(jcfg, jled, jchunks, jsrc, jraw, jparser,
                                  TB, n, jwm)
        return o, j

    return ours, theirs, epoch


def _shared(df):
    return _conform(df.copy())[SHARED].reset_index(drop=True)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_chunked_tail_equals_batch_and_the_jax_live_frame(tmp_path, source):
    raw, _jsrc, jraw, gen = SOURCES[source]
    ours, theirs, epoch = _tailers(tmp_path, source)
    first, second = gen(0, 40), gen(40, 80)
    torn = second[:-9]                      # cut inside the last record
    cuts = [first, torn, second[len(torn):]]
    offsets = []
    for n, part in enumerate(cuts, 1):
        append(ours, raw, part)
        append(theirs, jraw, part)
        o, j = epoch(n)
        offsets.append(o.info["offset"])
        assert o.info["offset"] == j.info["offset"]
        assert o.info["chunks_parsed"] == j.info["chunks_parsed"] == 1
        pd.testing.assert_frame_equal(_shared(o.frame), _shared(j.frame))
    whole = (first + second).encode()
    assert offsets == [len(first.encode()),
                       len(first.encode()) + len(torn[:torn.rfind("\n") + 1]
                                                 .encode()),
                       len(whole)]
    # the chunks concatenated are the batch parse of the whole file
    task = next(t for t in _ingest_tasks(live_cfg(ours), TB)
                if t.name == source)
    batch = task.fn(*task.args, **task.kwargs)
    pd.testing.assert_frame_equal(_conform(o.frame), _conform(batch.copy()),
                                  check_dtype=False)


def test_live_frames_equal_the_batch_frames(tmp_path):
    """Epochs over growing files write the frames batch would write over
    the final files, value for value."""
    log = seed_logdir(tmp_path)
    for lo, hi in ((0, 30), (30, 70), (70, 100)):
        for src, (raw, _j, _jr, gen) in SOURCES.items():
            append(log, raw, gen(lo, hi))
        assert live.sofa_live(live_cfg(log), epochs=1) == 0
    cfg = live_cfg(log)
    for src in SOURCES:
        task = next(t for t in _ingest_tasks(cfg, TB) if t.name == src)
        want = _conform(task.fn(*task.args, **task.kwargs).copy())
        got = read_frame(log + src)
        pd.testing.assert_frame_equal(got, want, check_dtype=False)


# --- the chunk store: no reparse -----------------------------------------------

def test_committed_chunks_never_reparse(tmp_path, monkeypatch):
    from sofa_tpu_torch.ingest import strace_parse

    calls = {"pystacks": 0}
    orig = strace_parse.parse_pystacks

    def counted(*a, **kw):
        calls["pystacks"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(strace_parse, "parse_pystacks", counted)
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 100))
    append(log, "pystacks.txt", pystacks_lines(0, 100))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    assert meta_live(log)["chunks_parsed"] == 2 and calls["pystacks"] == 1
    append(log, "gpumon.txt", mon_lines(100, 200))     # only gpumon grows
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    ml = meta_live(log)
    assert calls["pystacks"] == 1
    assert ml["chunks_parsed"] == 1 and ml["chunks_loaded"] == 3
    assert ml["sources"]["pystacks"] == {**ml["sources"]["pystacks"],
                                         "chunks_parsed": 0,
                                         "chunks_loaded": 1, "status": "idle"}
    assert ml["sources"]["gpumon"]["status"] == "streaming"
    assert ml["dirty"] == ["gpumon"]


def test_compaction_only_loads_and_stores(tmp_path, monkeypatch):
    from sofa_tpu_torch.ingest import gpumon_parse

    calls = [0]
    orig = gpumon_parse.parse_gpumon

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(gpumon_parse, "parse_gpumon", counted)
    monkeypatch.setattr(live, "CHUNK_COMPACT_COUNT", 3)
    log = seed_logdir(tmp_path)
    for i in range(5):
        append(log, "gpumon.txt", mon_lines(i * 50, (i + 1) * 50))
        assert live.sofa_live(live_cfg(log), epochs=1) == 0
    ent = ledger(log)["sources"]["gpumon"]
    assert calls[0] == 5                 # one parse per appended chunk
    assert len(ent["chunks"]) <= 4
    assert ent["events"] == 250 * 3      # heartbeat + 2 metric rows a tick
    assert validate_live_offsets(ledger(log)) == []


# --- live tiles ---------------------------------------------------------------

def _series_pair(df):
    return ([SofaSeries("pystacks", "Python stacks", "goldenrod", df)],
            [JaxSeries("pystacks", "Python stacks", "goldenrod", df)])


def _tile_files(root):
    out = {}
    for base, _d, names in os.walk(root):
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                out[os.path.relpath(os.path.join(base, n), root)] = f.read()
    return out


def test_live_tiles_match_the_jax_package(tmp_path):
    from sofa_tpu.ingest.strace_parse import parse_pystacks

    full = parse_pystacks(pystacks_lines(0, 13000), time_base=TB)
    ours, theirs = str(tmp_path / "o") + "/", str(tmp_path / "t") + "/"
    cfg = SofaConfig(logdir=ours, viz_downsample_to=800)
    jcfg = JaxConfig(logdir=theirs, viz_downsample_to=800)
    stats = []
    for df in (full.iloc[:12000], full, full):
        s, js = _series_pair(df)
        m, st = tiles.build_tiles_live(cfg, s, jobs=2)
        jm, jst = jax_tiles.build_tiles_live(jcfg, js, jobs=2)
        assert m == jm and st == jst
        assert _tile_files(ours + "_tiles") == _tile_files(theirs + "_tiles")
        stats.append(st)
    assert stats[0]["full_rebuilds"] == 1
    assert stats[1]["full_rebuilds"] == 0
    assert 0 < stats[1]["rebuilt"] < stats[1]["rebuilt"] + stats[1]["kept"]
    assert stats[2] == {"series": 1, "rebuilt": 0, "kept": stats[2]["kept"],
                        "unchanged_series": 1, "full_rebuilds": 0}
    index = json.load(open(ours + "_tiles/pystacks/tile_index.json"))
    assert "key" not in index and index["live"]["rows"] == 13000


def test_live_tiles_re_anchor_past_the_horizon(tmp_path):
    from sofa_tpu.ingest.strace_parse import parse_pystacks

    df = parse_pystacks(pystacks_lines(0, 12000), time_base=TB)
    later = df.copy()
    later["timestamp"] += 100.0          # far past the 32 s horizon
    grown = pd.concat([df, later], ignore_index=True)
    ours, theirs = str(tmp_path / "o") + "/", str(tmp_path / "t") + "/"
    cfg = SofaConfig(logdir=ours, viz_downsample_to=800)
    jcfg = JaxConfig(logdir=theirs, viz_downsample_to=800)
    for frame_ in (df, grown):
        s, js = _series_pair(frame_)
        m, st = tiles.build_tiles_live(cfg, s)
        jm, jst = jax_tiles.build_tiles_live(jcfg, js)
        assert (m, st) == (jm, jst) and st["full_rebuilds"] == 1
    assert _tile_files(ours + "_tiles") == _tile_files(theirs + "_tiles")
    index = json.load(open(ours + "_tiles/pystacks/tile_index.json"))
    assert index["live"]["width"] >= 2 * 112


def test_batch_tiles_unchanged_by_the_anchor_arguments(tmp_path):
    xs = np.sort(np.random.default_rng(0).uniform(0, 9, 20000))
    for cap in (3, 12):
        assert tiles._levels_for(xs, cap) == jax_tiles._levels_for(xs, cap)
        assert tiles._levels_for(xs, cap, 0.0, 32.0) == \
            jax_tiles._levels_for(xs, cap, 0.0, 32.0)


# --- the incremental pass window -------------------------------------------------

def _closure(specs, dirty):
    """The window from the contracts alone: passes reading a dirty frame,
    then every pass reading a feature they provide or running after them,
    until nothing is added."""
    chosen = {s.name for s in specs if set(s.reads_frames) & set(dirty)}
    while True:
        more = {c.name for c in specs if c.name not in chosen and any(
            p.name in chosen and (p.name in c.after or any(
                registry.patterns_overlap(r, q) for r in c.reads_features
                if not registry.covered(r, registry.AMBIENT_FEATURES)
                for q in p.provides_features))
            for p in specs if p.name != c.name)}
        if not more:
            return chosen
        chosen |= more


@pytest.mark.parametrize("dirty", [{"gpumon"}, {"pystacks", "strace"},
                                   {"mpstat"}, set(KINETO_FRAMES), set()])
def test_select_for_dirty_is_the_contracts_closure(dirty):
    registry.load_builtin_passes()
    cfg = SofaConfig()
    specs = [s for s in registry.registered() if s.enabled(cfg)]
    got = registry.select_for_dirty(cfg, dirty)
    assert got == _closure(specs, dirty)
    assert bool(got) == bool(dirty)


def test_incremental_window_keeps_the_clean_passes_features(tmp_path):
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 200))
    append(log, "pystacks.txt", pystacks_lines(0, 200))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    f0 = pd.read_csv(log + "features.csv").set_index("name")["value"]
    append(log, "gpumon.txt", mon_lines(200, 400))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    passes = telemetry.load_manifest(log)["meta"]["passes"]["passes"]
    clean = {n for n, e in passes.items()
             if e.get("skip_reason") == "inputs unchanged (live incremental)"}
    ran = {n for n, e in passes.items() if e.get("status") == "ok"}
    assert clean and ran
    assert ran == registry.select_for_dirty(live_cfg(log), {"gpumon"})
    f1 = pd.read_csv(log + "features.csv").set_index("name")["value"]
    assert f1["py_samples"] == f0["py_samples"]             # carried
    assert f1["gpumon_samples"] == 2 * f0["gpumon_samples"]  # recomputed
    assert meta_live(log)["passes"] == {"ran": len(ran),
                                        "skipped_clean": len(clean)}


# --- stream faults and the watermark ---------------------------------------------

@pytest.mark.parametrize("spec", [
    "gpumon:tail_torn@2,strace:rotate,pystacks:stall@always",
    "cpuinfo:tail_truncate@3,pcap:tail_torn", "mpstat:stall",
    "gpumon:rotate@1,procmon:die@2s,kineto:wedge@harvest"])
def test_stream_specs_parse_as_the_jax_package_does(spec):
    ours, theirs = faults.parse(spec), jax_faults.parse(spec)
    assert [(s.target, s.kind, s.phase, s.delay_s, s.when, s.epoch)
            for s in ours.specs] == \
        [(s.target, s.kind, s.phase, s.delay_s, s.when, s.epoch)
         for s in theirs.specs]
    for s in ours.specs:
        for n in range(1, 5):
            got, want = ours.stream_fault(s.target, n), \
                theirs.stream_fault(s.target, n)
            assert (got and got.kind) == (want and want.kind)


@pytest.mark.parametrize("bad", ["gpumon:tail_torn@0", "x:tail_torn@bogus",
                                 "x:rotate@-1"])
def test_stream_specs_rejected_as_the_jax_package_does(bad):
    with pytest.raises(ValueError):
        jax_faults.parse(bad)
    with pytest.raises(ValueError):
        faults.parse(bad)


def test_growth_watermark_as_the_jax_package():
    seq = [("a", 10, 0.0), ("b", 5, 0.0), ("a", 10, 1.0), ("a", 10, 3.5),
           ("b", 6, 3.6), ("a", 12, 4.0), ("a", 12, 6.1), ("b", 6, 9.0)]
    ours, theirs = GrowthWatermark(2.0), jax_supervisor.GrowthWatermark(2.0)
    for i, (k, n, t) in enumerate(seq):
        assert ours.update(k, n, t) == theirs.update(k, n, t)
        if i == 3:
            doc = ours.to_doc()
            assert doc == theirs.to_doc()
            ours = GrowthWatermark.from_doc(2.0, doc)
            theirs = jax_supervisor.GrowthWatermark.from_doc(2.0, doc)


@pytest.mark.parametrize("kind", ["tail_torn", "tail_truncate"])
def test_torn_and_truncated_reads_back_off(tmp_path, kind):
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 100))
    size = os.path.getsize(log + "gpumon.txt")
    assert live.sofa_live(live_cfg(log, inject_faults=f"gpumon:{kind}@1"),
                          epochs=1) == 0
    off = ledger(log)["sources"]["gpumon"]["offset"]
    assert 0 < off < size and (kind == "tail_torn" or off <= size // 2)
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    assert ledger(log)["sources"]["gpumon"]["offset"] == size


@pytest.mark.parametrize("how", ["fault", "replaced", "shrunk"])
def test_rotation_reads_from_byte_0(tmp_path, how):
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 200))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    spec = ""
    if how == "fault":
        spec = "gpumon:rotate@2"
    elif how == "replaced":     # same size class, other bytes at the head
        append(log, "gpumon.txt", mon_lines(500, 700), "w")
    else:
        append(log, "gpumon.txt", mon_lines(900, 950), "w")
    assert live.sofa_live(live_cfg(log, inject_faults=spec), epochs=1) == 0
    ml = meta_live(log)
    ent = ledger(log)["sources"]["gpumon"]
    assert ml["sources"]["gpumon"]["status"] == "rotated"
    assert ent["chunks"][0][0] == 0
    assert ent["offset"] == os.path.getsize(log + "gpumon.txt")
    rows = {"fault": 200, "replaced": 200, "shrunk": 50}[how]
    assert ml["sources"]["gpumon"]["events"] == rows * 3


def test_a_file_younger_than_its_head_signature_is_not_rotated(tmp_path):
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 1))           # < 256 bytes
    assert os.path.getsize(log + "gpumon.txt") < 256
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    append(log, "gpumon.txt", mon_lines(1, 50))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    assert meta_live(log)["sources"]["gpumon"]["status"] == "streaming"
    assert meta_live(log)["sources"]["gpumon"]["chunks"] == 2


def test_stalled_while_siblings_stream_idle_when_all_quiet(tmp_path):
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 100))
    append(log, "pystacks.txt", pystacks_lines(0, 100))
    cfg = live_cfg(log, live_stall_s=0.01,
                   inject_faults="pystacks:stall@always")
    assert live.sofa_live(cfg, epochs=1) == 0
    time.sleep(0.05)
    append(log, "gpumon.txt", mon_lines(100, 200))
    append(log, "pystacks.txt", pystacks_lines(100, 200))
    assert live.sofa_live(cfg, epochs=1) == 1
    ml = meta_live(log)
    assert ml["sources"]["pystacks"]["status"] == "stalled"
    assert ml["sources"]["gpumon"]["status"] == "streaming"
    doc = telemetry.load_manifest(log)
    for check in (validate_manifest, jax_manifest_check().validate_manifest):
        assert check(doc) == []
        assert any("stalled" in p for p in check(doc, require_healthy=True))
    assert any("live source pystacks stalled" in w
               for w in telemetry.manifest_warnings(doc))
    lines, rc = telemetry.render_status(doc, log)
    assert rc == 1 and any("1 STALLED" in ln for ln in lines)
    # without the fault pystacks catches up; then nothing grows: quiet
    # everywhere is idle, not stalled
    live.sofa_live(live_cfg(log, live_stall_s=0.01), epochs=1)
    time.sleep(0.05)
    assert live.sofa_live(live_cfg(log, live_stall_s=0.01), epochs=1) == 0
    assert {s["status"] for s in meta_live(log)["sources"].values()} <= \
        {"idle", "absent"}


# --- gpumon: several files, renamed while written ----------------------------------

def test_pid_file_renamed_to_its_rank_counts_each_row_once(tmp_path):
    from sofa_tpu_torch.ingest.gpumon_parse import ingest_gpumon

    log = seed_logdir(tmp_path)
    append(log, "gpumon.pid41.txt", mon_lines(0, 60, devs=(3,)))
    append(log, "gpumon.pid42.txt", mon_lines(0, 60, devs=(4,)))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    # the sampler joins its group: the pid files move to the ranks' names
    os.replace(log + "gpumon.pid41.txt", log + "gpumon.rank0.txt")
    os.replace(log + "gpumon.pid42.txt", log + "gpumon.rank1.txt")
    append(log, "gpumon.rank0.txt", mon_lines(60, 100, devs=(3,)))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    led = ledger(log)["sources"]
    assert sorted(n for n in led if n.startswith("gpumon.")) == \
        ["gpumon.rank0", "gpumon.rank1"]
    got = read_frame(log + "gpumon")
    want = _conform(ingest_gpumon(log, TB))
    assert len(got) == (100 + 60) * 3
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    assert sorted(got.loc[got["deviceId"] >= 0, "deviceId"].unique()) == [0, 1]
    ml = meta_live(log)
    assert ml["sources"]["gpumon.rank1"]["chunks_parsed"] == 0
    # a file that vanishes with no heir takes its rows with it
    os.unlink(log + "gpumon.rank1.txt")
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    pd.testing.assert_frame_equal(read_frame(log + "gpumon"),
                                  _conform(ingest_gpumon(log, TB)),
                                  check_dtype=False)


def test_a_rank_file_of_two_cards_keeps_its_ordinals_as_batch(tmp_path):
    from sofa_tpu_torch.ingest.gpumon_parse import ingest_gpumon

    log = seed_logdir(tmp_path)
    append(log, "gpumon.rank1.txt", mon_lines(0, 30, devs=(0,)))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    append(log, "gpumon.rank1.txt", mon_lines(30, 60, devs=(0, 1)))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    got = read_frame(log + "gpumon")
    pd.testing.assert_frame_equal(got, _conform(ingest_gpumon(log, TB)),
                                  check_dtype=False)
    assert sorted(got.loc[got["deviceId"] >= 0, "deviceId"].unique()) == [0, 1]


# --- a Kineto capture landing between epochs -----------------------------------

def test_a_kineto_capture_between_epochs_marks_its_frames(tmp_path):
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 50))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    os.makedirs(log + "kineto")
    with open(log + "kineto/trace_100.json", "w") as f:
        json.dump(sink_trace(4), f)
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    ml = meta_live(log)
    assert set(KINETO_FRAMES) <= set(ml["dirty"])
    assert "gpumon" not in ml["dirty"]
    gpu = read_frame(log + "gputrace")
    assert gpu["name"].astype(str).str.contains("sofa_flash_fwd").sum() == 4
    passes = telemetry.load_manifest(log)["meta"]["passes"]["passes"]
    ran = {n for n, e in passes.items() if e.get("status") == "ok"}
    assert ran == registry.select_for_dirty(live_cfg(log), ml["dirty"])
    assert "gpumon_profile" not in ran
    assert ml["passes"]["skipped_clean"] > 0
    # the next epoch finds the capture in the cache: nothing is dirty
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    assert meta_live(log)["dirty"] == []


# --- crash, resume, drain ----------------------------------------------------------

KILL_CHILD = """
import os, signal, sys
from sofa_tpu_torch import tiles
orig, count = tiles._write_tile, [0]
def hook(*a, **kw):
    count[0] += 1
    if count[0] >= 2:
        os.kill(os.getpid(), signal.SIGKILL)
    return orig(*a, **kw)
tiles._write_tile = hook
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.live import sofa_live
sofa_live(SofaConfig(logdir=sys.argv[1], live_interval_s=0.0,
                     viz_downsample_to=800, inject_faults=sys.argv[2]),
          epochs=1)
"""


def _outputs(log):
    out = {}
    for rel in ("report.js", "features.csv", "hints.txt"):
        if os.path.isfile(log + rel):
            with open(log + rel, "rb") as f:
                out[rel] = f.read()
    out.update({"_tiles/" + k: v
                for k, v in _tile_files(log + "_tiles").items()})
    return out


def test_sigkill_mid_epoch_then_resume_and_drain_equal_batch(tmp_path):
    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.durability import sofa_resume
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.record import sofa_clean

    log = seed_logdir(tmp_path)
    data = pystacks_lines(0, 12000).encode()
    cut = data[:len(data) // 2]
    cut = cut[:cut.rfind(b"\n") + 1]
    append(log, "pystacks.txt", cut.decode(), "w")
    append(log, "gpumon.txt", mon_lines(0, 300))
    assert live.sofa_live(live_cfg(log, viz_downsample_to=800),
                          epochs=1) == 0
    append(log, "pystacks.txt", data[len(cut):].decode())
    append(log, "gpumon.txt", mon_lines(300, 400))
    r = subprocess.run([sys.executable, "-c", KILL_CHILD, log,
                        "gpumon:tail_torn@2"], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == -signal.SIGKILL, r.stderr[-500:]
    assert meta_live(log)["epoch"] == 1
    assert sofa_resume(SofaConfig(logdir=log, viz_downsample_to=800)) == 0
    assert meta_live(log)["epoch"] == 2
    assert live.sofa_live(SofaConfig(logdir=log, viz_downsample_to=800),
                          epochs=0, drain=True) == 0
    got = _outputs(log)
    ml = meta_live(log)
    assert ml["active"] is False and ml["drained"] is True
    doc = telemetry.load_manifest(log)
    assert validate_manifest(doc, require_healthy=True) == []
    assert jax_validator()(doc) == []
    sofa_clean(SofaConfig(logdir=log))
    assert not os.path.exists(log + live.OFFSETS_NAME)
    assert not os.path.exists(log + CACHE_DIR_NAME)
    ctrl = SofaConfig(logdir=log, viz_downsample_to=800)
    sofa_analyze(ctrl, sofa_preprocess(ctrl))
    want = _outputs(log)
    assert got.keys() == want.keys() and any(k.startswith("_tiles/")
                                             for k in got)
    assert [k for k in got if got[k] != want[k]] == []


@pytest.mark.parametrize("committed", [False, True])
def test_resume_replays_only_an_uncommitted_epoch(tmp_path, committed):
    from sofa_tpu_torch.durability import JOURNAL_NAME, sofa_resume

    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 100))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    if not committed:           # killed one instruction before the commit
        with open(log + JOURNAL_NAME) as f:
            kept = [ln for ln in f.read().splitlines()
                    if not ('"commit"' in ln and '"live"' in ln)]
        append(log, JOURNAL_NAME, "\n".join(kept) + "\n", "w")
    append(log, "gpumon.txt", mon_lines(100, 120))   # the job goes on
    assert sofa_resume(SofaConfig(logdir=log)) == 0
    assert meta_live(log)["epoch"] == (1 if committed else 2)


def test_no_write_sentinel_during_epochs(tmp_path, monkeypatch):
    from sofa_tpu_torch.trace import WRITING_SENTINEL

    log = seed_logdir(tmp_path)
    append(log, "pystacks.txt", pystacks_lines(0, 3000))
    seen = []
    orig = tiles._write_tile

    def spy(path, doc):
        seen.append(os.path.exists(log + WRITING_SENTINEL))
        return orig(path, doc)

    monkeypatch.setattr(tiles, "_write_tile", spy)
    for lo, hi in ((3000, 3500), (3500, 4000)):
        assert live.sofa_live(live_cfg(log, viz_downsample_to=500),
                              epochs=1) == 0
        append(log, "pystacks.txt", pystacks_lines(lo, hi))
    assert seen and not any(seen)
    assert not os.path.exists(log + WRITING_SENTINEL)


# --- the CLI, clean, status, the validators, viz and the board --------------------

def test_cli_exit_codes_clean_and_status(tmp_path, capsys):
    assert cli_main(["live", str(tmp_path / "nope")]) == 2
    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 50))
    assert cli_main(["live", log, "--live_epochs", "1",
                     "--live_interval_s", "0"]) == 0
    assert cli_main(["status", log]) == 0
    assert "live: epoch 1 active, 1 source(s) streaming" in \
        capsys.readouterr().out
    doc = telemetry.load_manifest(log)
    assert validate_manifest(doc) == [] and jax_validator()(doc) == []
    for check in (validate_live_offsets,
                  jax_manifest_check().validate_live_offsets):
        assert check(ledger(log)) == []
    time.sleep(0.05)
    append(log, "gpumon.txt", mon_lines(50, 60))
    assert cli_main(["live", log, "--live_epochs", "2", "--live_interval_s",
                     "0", "--live_stall_s", "0.01", "--inject_faults",
                     "gpumon:stall@3"]) == 0     # no sibling streams: idle
    assert cli_main(["fsck", log]) == 0        # the epochs' digests hold
    assert cli_main(["live", log, "--drain"]) == 0
    assert meta_live(log)["active"] is False
    assert cli_main(["status", log]) == 0
    assert "live: epoch 3 drained" in capsys.readouterr().out
    assert cli_main(["clean", "--logdir", log]) == 0
    assert not os.path.exists(log + live.OFFSETS_NAME)
    assert not os.path.exists(log + CACHE_DIR_NAME)
    assert os.path.isfile(log + "gpumon.txt")


def test_manifest_check_live_vocabulary_as_the_jax_package(tmp_path):
    from sofa_tpu_torch.tools.manifest_check import main as check_main

    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 50))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    doc = telemetry.load_manifest(log)
    theirs = jax_manifest_check().validate_manifest
    for edit, word in ((("sources", "gpumon", "status"), "status"),
                       (("epoch",), "epoch"), (("chunks_parsed",), "chunks")):
        bad = json.loads(json.dumps(doc))
        node = bad["meta"]["live"]
        for k in edit[:-1]:
            node = node[k]
        node[edit[-1]] = "vibing" if word == "status" else 0 \
            if word == "epoch" else -1
        assert any(word in p for p in validate_manifest(bad))
        assert any(word in p for p in theirs(bad))
    stale = json.loads(json.dumps(doc))
    stale["meta"]["live"]["updated_unix"] = time.time() - 3600
    assert any("stale" in p or "old" in p
               for p in validate_manifest(stale, require_healthy=True))
    stale["meta"]["live"]["active"] = False
    assert validate_manifest(stale, require_healthy=True) == []
    assert check_main([log, "--require-healthy"]) == 0
    led = ledger(log)
    led["sources"]["gpumon"]["offset"] += 1
    append(log, live.OFFSETS_NAME, json.dumps(led), "w")
    assert check_main([log]) == 1
    assert validate_live_offsets(led) and \
        jax_manifest_check().validate_live_offsets(led)


def test_viz_names_the_stream_and_the_board_polls_it(tmp_path, capsys):
    from sofa_tpu_torch.analyze import BOARD_DIR
    from sofa_tpu_torch.viz import sofa_viz

    log = seed_logdir(tmp_path)
    append(log, "gpumon.txt", mon_lines(0, 20))
    assert live.sofa_live(live_cfg(log), epochs=1) == 0
    httpd = sofa_viz(SofaConfig(logdir=log, viz_port=8931),
                     serve_forever=False)
    assert httpd is not None
    httpd.server_close()
    assert "live stream:" in capsys.readouterr().out
    js = open(os.path.join(BOARD_DIR, "sofa_board.js")).read()
    html = open(os.path.join(BOARD_DIR, "index.html")).read()
    assert "function initLivePoll" in js and "function liveStatusText" in js
    assert "run_manifest.json" in js
    assert "initLivePoll(" in html and "liveStatusText(" in html
    # the staged board is the port's
    with open(log + "sofa_board.js") as f:
        assert f.read() == js
