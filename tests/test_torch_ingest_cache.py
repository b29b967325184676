"""sofa_tpu_torch's ingest cache, worker pools and quarantine.

``make_key`` is stable and reacts to size, mtime and presence (the JAX
package's key on the same files); a warm run loads instead of
reparsing; a parser-version bump or a changed file misses;
``--no_ingest_cache`` bypasses.  Over a SYNTHETIC Kineto capture (built
here, in the shape torch.profiler writes) and host files: cold and warm
``report``, and ``--jobs 1`` against ``--jobs 4`` (and the process pool),
give byte-identical CSVs, report.js, tiles and features.csv, with the
pickle fallback too.  A Kineto JSON cut in half is quarantined by the real
decoder, recorded, purged from the cache and never recached; an injected
``kineto:corrupt`` bypasses a warm cache.
"""

import glob
import json
import os
import time

import pandas as pd
import pytest

from sofa_tpu.ingest import cache as jax_cache
from sofa_tpu_torch import telemetry
from sofa_tpu_torch.analyze import sofa_analyze
from sofa_tpu_torch.cli import main as cli_main
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import CorruptRawError, cache, procfs
from sofa_tpu_torch.ingest.kineto import ingest_kineto_dir
from sofa_tpu_torch.pool import process_context, resolve_jobs, thread_map
from sofa_tpu_torch.preprocess import QUARANTINE_DIR_NAME, sofa_preprocess

from test_torch_faults import manifest

T0 = 1_700_000_000.0
BASE_NS = int(T0 * 1e9)

MPSTAT = "".join(
    f"{T0 + 0.1 * i:.6f} {cpu} {100 + 7 * i} 0 {50 + 3 * i} "
    f"{800 + 11 * i} 1 0 0 0\n"
    for i in range(40) for cpu in ("cpuall", "cpu0", "cpu1"))


def _x(cat, name, ts, dur, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def big_trace(n_kernels: int) -> dict:
    """SYNTHETIC Kineto trace: a timebase marker, steps, and n_kernels
    kernels, each launched under an aten::mm."""
    ev = [_x("user_annotation", f"sofa_timebase_marker:{BASE_NS + 50_000}",
             50.0, 1.0)]
    for step in range(4):
        ev.append(_x("user_annotation", f"sofa_step_{step}",
                     100.0 + step * n_kernels * 10.0, n_kernels * 10.0 - 1))
    for i in range(n_kernels):
        t = 100.0 + i * 10.0
        ev.append(_x("cpu_op", "aten::mm", t, 6.0,
                     **{"Input Dims": [[64, 64], [64, 64]],
                        "Input type": ["float", "float"]}))
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", t + 1, 2.0,
                     correlation=i + 1))
        name = ("void sofa_flash_fwd_kernel<128>()" if i % 7 == 0
                else f"gemm_{i % 5}")
        ev.append(_x("kernel", name, t + 4, 3.0 + i % 3, device=0, stream=7,
                     correlation=i + 1))
    return {"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
            "traceEvents": ev}


def make_logdir(tmp_path, name="log", n_kernels=600):
    d = str(tmp_path / name) + "/"
    os.makedirs(d + "kineto")
    with open(d + "sofa_time.txt", "w") as f:
        f.write(f"{T0}\n")
    with open(d + "misc.txt", "w") as f:
        f.write("elapsed_time 1.0\ncores 2\npid 100\nrc 0\n")
    with open(d + "mpstat.txt", "w") as f:
        f.write(MPSTAT)
    with open(d + "gpu_topo.json", "w") as f:
        json.dump({"cuda_available": True, "devices": [
            {"index": 0, "name": "NVIDIA H100 80GB HBM3",
             "total_memory": 85e9, "multi_processor_count": 132,
             "capability": "9.0"}]}, f)
    with open(d + "kineto/trace_100.json", "w") as f:
        json.dump(big_trace(n_kernels), f)
    return d


def cfg_for(d, **kw):
    return SofaConfig(logdir=d, viz_downsample_to=100, **kw)


def derived_bytes(d) -> dict:
    """Every derived file's bytes (CSVs, report.js, tiles), by path."""
    out = {}
    for path in sorted(glob.glob(d + "*.csv") + [d + "report.js"]
                       + glob.glob(d + "_tiles/**/*", recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, d)] = f.read()
    return out


def report(d, **kw):
    cfg = cfg_for(d, **kw)
    frames = sofa_preprocess(cfg)
    sofa_analyze(cfg, frames)
    return frames


# --- keys ----------------------------------------------------------------------

def test_make_key_is_stable_and_matches_the_jax_key(tmp_path):
    p = tmp_path / "mpstat.txt"
    p.write_text(MPSTAT)
    params = {"time_base": T0}
    k1 = cache.make_key("mpstat", [str(p)], params)
    assert k1 == cache.make_key("mpstat", [str(p)], params)
    assert k1 == jax_cache.make_key("mpstat", [str(p)], params)
    assert json.loads(json.dumps(k1)) == k1
    assert cache.raw_files_present(k1)


def test_make_key_reacts_to_size_mtime_and_presence(tmp_path):
    p = tmp_path / "gpumon.txt"
    missing = str(tmp_path / "absent.txt")
    p.write_text("1 -1 0 0 0\n")
    k0 = cache.make_key("gpumon", [str(p), missing])
    os.utime(p, ns=(1, 1))
    k1 = cache.make_key("gpumon", [str(p), missing])
    assert k1 != k0                                  # mtime
    p.write_text("1 -1 0 0 0\n2 -1 0 0 0\n")
    os.utime(p, ns=(1, 1))
    k2 = cache.make_key("gpumon", [str(p), missing])
    assert k2 != k1                                  # size
    open(missing, "w").close()
    assert cache.make_key("gpumon", [str(p), missing]) != k2   # presence
    assert not cache.raw_files_present(cache.make_key("x", [str(tmp_path
                                                                / "no")]))
    assert cache.make_key("kineto", [], {"time_base": 1.0}) != \
        cache.make_key("kineto", [], {"time_base": 2.0})


# --- hits and misses ----------------------------------------------------------------

def _count_parser(monkeypatch, name="parse_mpstat"):
    real = getattr(procfs, name)
    calls = []

    def counting(text, time_base=0.0, **kw):
        calls.append(1)
        return real(text, time_base=time_base, **kw)

    monkeypatch.setattr(procfs, name, counting)
    return calls


def test_warm_run_loads_and_changes_miss(tmp_path, monkeypatch):
    d = make_logdir(tmp_path, n_kernels=20)
    calls = _count_parser(monkeypatch)
    cold = sofa_preprocess(cfg_for(d))
    assert len(calls) == 1
    warm = sofa_preprocess(cfg_for(d))
    assert len(calls) == 1                            # no reparse
    doc = manifest(d)
    assert doc["sources"]["mpstat"] == {
        **doc["sources"]["mpstat"], "status": "cached", "cache": "hit"}
    assert doc["sources"]["kineto"]["cache"] == "hit"
    assert "kineto" in doc["meta"]["ingest_cache"]["hits"]
    for name in cold:
        pd.testing.assert_frame_equal(cold[name], warm[name])
    with open(d + "mpstat.txt", "a") as f:
        f.write(f"{T0 + 9:.6f} cpu0 900 0 90 900 1 0 0 0\n")
    sofa_preprocess(cfg_for(d))
    assert len(calls) == 2                            # a changed file
    monkeypatch.setitem(cache.PARSER_VERSIONS, "mpstat", 99)
    sofa_preprocess(cfg_for(d))
    assert len(calls) == 3                            # a parser bump
    assert manifest(d)["sources"]["mpstat"]["cache"] == "miss"


def test_no_ingest_cache_bypasses(tmp_path, monkeypatch):
    d = make_logdir(tmp_path, n_kernels=20)
    calls = _count_parser(monkeypatch)
    assert cli_main(["preprocess", "--logdir", d, "--no_ingest_cache"]) == 0
    assert cli_main(["preprocess", "--logdir", d, "--no_ingest_cache"]) == 0
    assert len(calls) == 2
    assert not os.path.exists(d + cache.CACHE_DIR_NAME)
    doc = manifest(d)
    assert doc["sources"]["mpstat"]["cache"] == "bypass"
    assert doc["meta"]["ingest_cache"]["enabled"] is False


# --- byte-identical outputs --------------------------------------------------------

def test_cold_and_warm_report_are_byte_identical(tmp_path):
    d = make_logdir(tmp_path)
    cold_frames = report(d)
    assert len(cold_frames["gputrace"]) == 600
    cold = derived_bytes(d)
    assert any(k.startswith("_tiles") for k in cold), "no tiles were built"
    feats_cold = open(d + "features.csv", "rb").read()
    assert manifest(d)["sources"]["kineto"]["cache"] == "miss"
    warm_frames = report(d)
    assert manifest(d)["sources"]["kineto"]["status"] == "cached"
    for name in cold_frames:
        pd.testing.assert_frame_equal(cold_frames[name], warm_frames[name])
    assert derived_bytes(d) == cold
    assert open(d + "features.csv", "rb").read() == feats_cold


def test_pickle_fallback_is_byte_identical(tmp_path, monkeypatch):
    d = make_logdir(tmp_path)

    def no_parquet(self, *a, **kw):
        raise ImportError("pyarrow is missing")

    monkeypatch.setattr(pd.DataFrame, "to_parquet", no_parquet)
    report(d)
    cold = derived_bytes(d)
    assert manifest(d)["meta"]["ingest_cache"]["formats"]["kineto"] == \
        "pickle"
    assert glob.glob(d + "_ingest_cache/kineto__*.pkl")
    report(d)
    doc = manifest(d)
    assert doc["sources"]["kineto"]["cache"] == "hit"
    assert doc["meta"]["ingest_cache"]["formats"]["kineto"] == "pickle"
    assert derived_bytes(d) == cold


@pytest.mark.parametrize("pool", ["auto", "always"])
def test_jobs_1_and_4_are_byte_identical(tmp_path, monkeypatch, pool):
    from sofa_tpu_torch.record import sofa_clean

    monkeypatch.setenv("SOFA_PREPROCESS_POOL", pool)
    d = make_logdir(tmp_path)
    # a host source of the process pool's kind beside the Kineto one
    with open(d + "perf.script", "w") as f:
        f.write("python  4242 [000] 1700000000.500000:   2000000 "
                "cycles:u:      7f0 main (/usr/bin/python3)\n")
    outs = []
    for jobs in (1, 4):
        sofa_clean(cfg_for(d))
        report(d, jobs=jobs, ingest_cache=False)
        assert manifest(d)["meta"]["pool"]["jobs"] == jobs
        assert manifest(d)["sources"]["cputrace"]["events"] == 1
        outs.append(derived_bytes(d))
    assert outs[0] == outs[1]


def test_pool_policy():
    assert resolve_jobs(3) == 3
    assert 1 <= resolve_jobs(0) <= 32
    assert thread_map(lambda x: x * x, range(9), 4) == [x * x for x in
                                                        range(9)]
    assert process_context().get_start_method() in ("forkserver", "spawn")


def test_resolve_jobs_reads_sofa_jobs(monkeypatch):
    monkeypatch.setenv("SOFA_JOBS", "3")
    assert resolve_jobs(0) == 3
    monkeypatch.setenv("SOFA_JOBS", "x")
    assert resolve_jobs(0) >= 1


# --- quarantine ------------------------------------------------------------------------

def _halve(path):
    os.truncate(path, os.path.getsize(path) // 2)


def test_truncated_kineto_json_is_corrupt(tmp_path):
    d = make_logdir(tmp_path, n_kernels=20)
    _halve(d + "kineto/trace_100.json")
    with pytest.raises(CorruptRawError) as e:
        ingest_kineto_dir(d + "kineto", T0)
    assert e.value.path.endswith("trace_100.json")
    with open(d + "kineto/trace_100.json", "w") as f:
        json.dump({"schemaVersion": 1}, f)
    with pytest.raises(CorruptRawError, match="traceEvents"):
        ingest_kineto_dir(d + "kineto", T0)


def test_truncated_capture_is_quarantined_and_never_recached(tmp_path):
    d = make_logdir(tmp_path, n_kernels=50)
    report(d)                                         # warms the cache
    assert glob.glob(d + "_ingest_cache/kineto__*")
    _halve(d + "kineto/trace_100.json")
    frames = report(d)                                # no fault spec
    assert frames["gputrace"].empty
    doc = manifest(d)
    ent = doc["sources"]["kineto"]
    qfile = os.path.join(d, QUARANTINE_DIR_NAME, "trace_100.json")
    assert ent["status"] == "quarantined" and ent["cache"] == "miss"
    assert ent["quarantined_file"] == qfile and os.path.isfile(qfile)
    assert "not a JSON document" in ent["error"]
    assert not os.path.exists(d + "kineto/trace_100.json")
    assert not glob.glob(d + "_ingest_cache/kineto__*")
    hints = open(d + "hints.txt").read()
    assert "[self] ingest source kineto had corrupt raw input" in hints
    assert cli_main(["status", d]) == 0      # a degraded source, not a
    report(d)                                # dead collector
    ent = manifest(d)["sources"]["kineto"]
    assert ent["cache"] != "hit" and ent["status"] == "empty"
    assert not glob.glob(d + "_ingest_cache/kineto__*")


def test_injected_corruption_bypasses_a_warm_cache(tmp_path, monkeypatch):
    d = make_logdir(tmp_path, n_kernels=20)
    sofa_preprocess(cfg_for(d))
    assert manifest(d)["sources"]["kineto"]["status"] == "parsed"
    sofa_preprocess(cfg_for(d, inject_faults="kineto:corrupt"))
    ent = manifest(d)["sources"]["kineto"]
    assert ent["status"] == "quarantined"
    assert "injected" in ent["error"]
    assert os.path.isfile(os.path.join(d, QUARANTINE_DIR_NAME,
                                       "trace_100.json"))
    assert not glob.glob(d + "_ingest_cache/kineto__*")
    from sofa_tpu_torch import faults

    assert faults.active() is None


def test_a_failing_parser_is_degraded_not_quarantined(tmp_path, monkeypatch):
    d = make_logdir(tmp_path, n_kernels=20)

    def broken(text, time_base=0.0, **kw):
        raise RuntimeError("parser bug")

    monkeypatch.setattr(procfs, "parse_mpstat", broken)
    frames = sofa_preprocess(cfg_for(d))
    assert frames["mpstat"].empty and not frames["gputrace"].empty
    ent = manifest(d)["sources"]["mpstat"]
    assert ent["status"] == "degraded" and "parser bug" in ent["error"]
    assert os.path.exists(d + "mpstat.txt")
    assert not os.path.exists(d + QUARANTINE_DIR_NAME)


def test_a_failing_perf_script_is_failed_not_degraded(tmp_path, monkeypatch):
    d = make_logdir(tmp_path, n_kernels=20)
    with open(d + "perf.data", "wb") as f:
        f.write(b"PERFILE2" + b"\0" * 64)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "perf").write_text("#!/bin/sh\necho 'no samples' >&2\n"
                                 "exit 3\n")
    (bindir / "perf").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    frames = sofa_preprocess(cfg_for(d))
    assert frames["cputrace"].empty and not frames["gputrace"].empty
    ent = manifest(d)["sources"]["cputrace"]
    assert ent["status"] == "failed" and "rc=3" in ent["error"]
    assert os.path.exists(d + "perf.data")
    assert not os.path.exists(d + "perf.script")
    assert not os.path.exists(d + QUARANTINE_DIR_NAME)


def test_preprocess_writes_the_self_trace_stages(tmp_path):
    d = make_logdir(tmp_path, n_kernels=20)
    sofa_preprocess(cfg_for(d))
    doc = manifest(d)
    names = [s["name"] for s in doc["stages"] if s["verb"] == "preprocess"]
    assert names[:2] == ["ingest", "write_frames"]
    assert {"tiles", "report_js"} <= set(names)
    trace = telemetry.load_self_trace(d)
    lanes = {e["tid"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert lanes == {2}
    assert telemetry.preprocess_summary(doc).startswith(
        "preprocess timing: ingest ")
    t_before = doc["generated_unix"]
    time.sleep(0.01)
    sofa_analyze(cfg_for(d))
    doc = manifest(d)
    assert set(doc["runs"]) == {"preprocess", "analyze"}
    assert doc["generated_unix"] >= t_before
