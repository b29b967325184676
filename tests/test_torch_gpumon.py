"""The GPU memory sampler and allocation-site snapshots, on the CPU.

Parity with the JAX package: ``parse_gpumon`` against ``parse_tpumon`` on
the same lines, the port's hand-written pprof decoder against the JAX
package's protobuf one on blobs from the JAX encoder, from protobuf itself
and from the port's encoder, and ``gpumon_profile`` / ``memprof_profile``
against ``tpumon_profile`` / ``memprof_profile`` under the tpu -> gpu
feature-name map.  The sampler's loop, growth gate, snapshot aggregation,
history arming and at-exit fallback run against a stand-in for ``torch``
(the CPU build cannot initialize CUDA); tests/test_torch_cuda.py drives
them on the card.
"""

import gzip
import json
import os
import subprocess
import sys
import threading
import time
import types

import pandas as pd
import pytest
import torch

from sofa_tpu.analysis import tpu as jax_tpu
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.collectors import tpumon as jax_tpumon
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.ingest import memprof as jax_memprof
from sofa_tpu.ingest.tpumon_parse import parse_tpumon
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.gpu import gpumon_profile, memprof_profile
from sofa_tpu_torch.collectors import gpumon
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import memprof
from sofa_tpu_torch.ingest.gpumon_parse import ingest_gpumon, parse_gpumon

NS = gpumon._ns
MON_FIXTURE = """\
1700000001000000000 -1 0 0 0
1700000001000000000 0 8000000000 16000000000 9000000000
1700000001000000000 1 4000000000 16000000000 4000000000
1700000002000000000 -1 0 0 0
1700000002000000000 0 12000000000 16000000000 12500000000
1700000002000000000 1 1000 0 1000
garbage
1700000002000000000 9 1 2
"""
TORCH_FILE = os.path.join(os.path.dirname(torch.__file__), "optim",
                          "adamw.py")
USER_FILE = "/work/sofa_tpu_torch/workloads/transformer.py"


def _gpu_names(feats):
    """The JAX features under the tpu -> gpu name map."""
    df = feats.to_frame()
    df["name"] = (df["name"].str.replace("tpumon_", "gpumon_", regex=False)
                  .str.replace(r"^tpu(\d+)_", r"gpu\1_", regex=True))
    return df


# -- gpumon.txt ---------------------------------------------------------------

def test_parse_gpumon_matches_parse_tpumon():
    got = parse_gpumon(MON_FIXTURE, time_base=1700000000.0)
    ref = parse_tpumon(MON_FIXTURE, time_base=1700000000.0)
    assert set(got["device_kind"]) == {"gpu"}
    pd.testing.assert_frame_equal(got, ref.assign(device_kind="gpu"))
    assert len(got[got["name"] == "alive"]) == 2
    occ = got[(got["name"] == "hbm_occupancy") & (got["deviceId"] == 0)]
    assert list(occ["event"]) == [50.0, 75.0]
    assert occ["payload"].iloc[-1] == 12500000000


def test_ingest_gpumon_reads_the_logdir(tmp_path):
    assert ingest_gpumon(str(tmp_path)).empty
    (tmp_path / "gpumon.txt").write_text(MON_FIXTURE)
    assert len(ingest_gpumon(str(tmp_path), 1700000000.0)) == 2 + 4 + 3


def test_gpumon_profile_matches_tpumon_profile(tmp_path):
    got, ref = Features(), JaxFeatures()
    gpumon_profile({"gpumon": parse_gpumon(MON_FIXTURE, 1700000000.0)},
                   SofaConfig(logdir=str(tmp_path)), got)
    jax_tpu.tpumon_profile({"tpumon": parse_tpumon(MON_FIXTURE,
                                                   1700000000.0)},
                           JaxConfig(logdir=str(tmp_path)), ref)
    pd.testing.assert_frame_equal(got.to_frame(), _gpu_names(ref))
    assert got.get("gpu0_hbm_peak_gb") == pytest.approx(12.5)
    assert got.get("gpumon_samples") == 2 and got.get("gpumon_span") == 1.0


def test_gpumon_profile_warns_on_an_empty_frame(tmp_path, capsys):
    feats = Features()
    gpumon_profile({"gpumon": parse_gpumon("")},
                   SofaConfig(logdir=str(tmp_path)), feats)
    assert feats.to_frame().empty
    assert "gpumon is empty" in capsys.readouterr().err


# -- pprof: the two decoders --------------------------------------------------

def _protobuf_profile():
    """A two-device profile built with protobuf (packed repeateds)."""
    from sofa_tpu.ingest import memprof_pb2

    p = memprof_pb2.Profile()
    strings = [""]

    def intern(s):
        if s not in strings:
            strings.append(s)
        return strings.index(s)

    for t, u in (("allocations", "count"), ("space", "bytes")):
        vt = p.sample_type.add()
        vt.type, vt.unit = intern(t), intern(u)
    for fid, (name, fname) in enumerate(
            [("train_step", "train.py"), ("load_batch", "input.py"),
             ("zeros_like", TORCH_FILE)], start=1):
        fn = p.function.add()
        fn.id, fn.name, fn.filename = fid, intern(name), intern(fname)
        loc = p.location.add()
        loc.id = fid
        ln = loc.line.add()
        ln.function_id, ln.line = fid, 10 * fid

    def add_sample(stack, count, nbytes, device, labels=True):
        s = p.sample.add()
        s.location_id.extend(stack)
        s.value.extend([count, nbytes])
        if labels:
            for key, val in (("kind", "buffer"), ("device", device)):
                lb = s.label.add()
                lb.key, lb.str = intern(key), intern(val)

    add_sample([1], 2, 6 * 2**20, "cuda:0")
    add_sample([1], 1, 2 * 2**20, "cuda:1")
    add_sample([2, 1], 4, 1 * 2**20, "cuda:0")
    add_sample([], 1, 5, "cuda:0", labels=False)
    p.string_table.extend(strings)
    return p.SerializeToString()


_SAMPLES = [
    ([("train_step", "train.py", 40)], "cuda:0", "buffer", 2, 107),
    ([("train_step", "train.py", 40)], "cuda:1", "buffer", 1, 50),
    ([("load_batch", "input.py", 9), ("main", "run.py", 3)], "cuda:0",
     "buffer", 1, 1000),
    ([("(stackless buffer)", "", 0)], "cuda:0", "buffer", 1, 3),
]
BLOBS = {
    "jax_encoder": lambda: jax_tpumon._ns["_pprof_encode"](_SAMPLES),
    "port_encoder": lambda: NS["_pprof_encode"](_SAMPLES),
    "protobuf_packed": _protobuf_profile,
}


@pytest.mark.parametrize("gz", [True, False], ids=["gzip", "raw"])
@pytest.mark.parametrize("source", sorted(BLOBS))
def test_hand_decoder_matches_protobuf_decoder(tmp_path, source, gz):
    blob = BLOBS[source]()
    path = tmp_path / "memprof.pb.gz"
    path.write_bytes(gzip.compress(blob) if gz else blob)
    got = memprof.parse_memprof(str(path))
    ref = jax_memprof.parse_memprof(str(path))
    assert len(got) == len(ref) > 0
    pd.testing.assert_frame_equal(got, ref)


def test_both_encoders_write_the_same_bytes():
    assert BLOBS["port_encoder"]() == BLOBS["jax_encoder"]()


def test_site_skips_frames_inside_torch(tmp_path):
    samples = [([("zeros_like", TORCH_FILE, 10), ("step", USER_FILE, 317)],
                "cuda:0", "buffer", 2, 4096),
               ([("empty", TORCH_FILE, 5)], "cuda:0", "buffer", 1, 8)]
    path = tmp_path / "memprof.pb.gz"
    path.write_bytes(gzip.compress(NS["_pprof_encode"](samples)))
    got = memprof.parse_memprof(str(path))
    ref = jax_memprof.parse_memprof(str(path))
    cols = ["device", "kind", "count", "bytes", "stack"]
    pd.testing.assert_frame_equal(got[cols], ref[cols])
    assert list(got["site"]) == ["step", "empty"]   # torch-only: the leaf
    assert got["stack"].iloc[0] == "zeros_like;step"


def test_decoder_fuzz_random_bytes(tmp_path):
    """Arbitrary bytes parse to a frame or raise promptly, never hang."""
    import random

    rng = random.Random(0)
    base = _protobuf_profile()
    path = tmp_path / "fuzz.bin"
    decoded = 0
    for trial in range(90):
        if trial % 3 == 0:
            blob = bytes(rng.randbytes(rng.randrange(0, 400)))
        elif trial % 3 == 1:
            cut = base[:rng.randrange(0, len(base))]
            blob = gzip.compress(cut) if trial % 2 else cut
        else:
            b = bytearray(base)
            for _ in range(rng.randrange(1, 6)):
                b[rng.randrange(len(b))] = rng.randrange(256)
            blob = bytes(b)
        path.write_bytes(blob)
        try:
            df = memprof.parse_memprof(str(path))
        except (ValueError, UnicodeDecodeError):
            continue
        decoded += 1
        assert list(df.columns) == ["device", "kind", "count", "bytes",
                                    "site", "stack"]
    assert decoded > 0


def test_memprof_profile_matches_jax(tmp_path):
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        (d / "memprof.pb.gz").write_bytes(gzip.compress(
            NS["_pprof_encode"](_SAMPLES)))
        (d / "memprof.pb.gz.meta.json").write_text(json.dumps(
            {"trigger": "peak", "total_bytes": 1160}))
    got, ref = Features(), JaxFeatures()
    memprof_profile({}, SofaConfig(logdir=str(tmp_path / "port")), got)
    jax_tpu.memprof_profile({}, JaxConfig(logdir=str(tmp_path / "jax")), ref)
    pd.testing.assert_frame_equal(got.to_frame(), _gpu_names(ref))
    assert got._info == ref._info
    assert (tmp_path / "port" / "gpu_memprof.csv").read_text() == \
        (tmp_path / "jax" / "tpu_memprof.csv").read_text()
    assert got.get("memprof_held_gb") == pytest.approx(1160 / 1e9)
    assert dict(got._info)["memprof_top_site"].startswith("load_batch")
    # absent snapshot: a silent no-op
    memprof_profile({}, SofaConfig(logdir=str(tmp_path / "none")),
                    Features())


# -- the sampler, against a stand-in for torch --------------------------------

def _snapshot(blocks_by_device):
    return {"segments": [
        {"device": dev, "blocks": blocks}
        for dev, blocks in blocks_by_device.items()]}


def _block(addr, size, frames, state="active_allocated"):
    return {"address": addr, "size": size + 64, "requested_size": size,
            "state": state, "frames": [{"filename": f, "line": ln, "name": n}
                                       for n, f, ln in frames]}


STEP = [("zeros_like", TORCH_FILE, 10), ("step", USER_FILE, 317)]
SNAPSHOT = _snapshot({
    0: [_block(10, 4096, STEP), _block(11, 4096, STEP), _block(12, 512, []),
        _block(13, 1 << 20, STEP, state="inactive")],
    1: [_block(14, 2048, [("init", USER_FILE, 99)])],
})


class _StubTorch(types.SimpleNamespace):
    """Stands in for ``torch`` in the sampler: ``used`` bytes in use on
    device 0 (a context on device 0 only), a fixed snapshot."""

    def __init__(self, used=1000, snapshot=SNAPSHOT, initialized=True):
        stats = self

        class _Props:
            total_memory = 80 * 2**30

        def memory_stats(d):
            return {"allocated_bytes.all.current": stats.used,
                    "allocated_bytes.all.peak": stats.used + 7}

        def _snap():
            stats.snapshots += 1
            return stats.snapshot

        super().__init__(
            used=used, snapshot=snapshot, snapshots=0, queued=[],
            history=[],
            _C=types.SimpleNamespace(_cuda_hasPrimaryContext=lambda d: d == 0),
            autograd=types.SimpleNamespace(
                backward=lambda loss: ("backward", loss),
                grad=lambda out, inputs: ("grad", out, inputs)),
            cuda=types.SimpleNamespace(
                is_initialized=lambda: initialized,
                device_count=lambda: 2,
                current_device=lambda: 0,
                memory_stats=memory_stats,
                get_device_properties=lambda d: _Props(),
                _lazy_call=lambda fn: stats.queued.append(fn),
                memory=types.SimpleNamespace(
                    _snapshot=_snap,
                    _record_memory_history=lambda **kw:
                        stats.history.append(kw))))


def test_snapshot_aggregates_active_blocks_by_stack_and_device(tmp_path):
    samples = NS["_snapshot_samples"](SNAPSHOT)
    by_dev = {(s[1], s[0][0][0]): s for s in samples}
    step = by_dev[("cuda:0", "zeros_like (%s:10)" % TORCH_FILE)]
    assert step[3:] == (2, 8192)                       # count, bytes
    assert step[0][1] == ("step (%s:317)" % USER_FILE, USER_FILE, 317)
    assert by_dev[("cuda:0", "(stackless buffer)")][3:] == (1, 512)
    assert by_dev[("cuda:1", "init (%s:99)" % USER_FILE)][3:] == (1, 2048)
    assert len(samples) == 3                           # inactive: skipped
    path = str(tmp_path / "memprof.pb.gz")
    stub = _StubTorch()
    assert NS["snapshot_memprof"](stub, path, "peak", 10752)
    df = memprof.parse_memprof(path)
    assert int(df["bytes"].sum()) == 8192 + 512 + 2048
    assert set(df["site"]) == {"step (%s:317)" % USER_FILE,
                               "(stackless buffer)",
                               "init (%s:99)" % USER_FILE}
    meta = json.loads(open(path + ".meta.json").read())
    assert meta["trigger"] == "peak" and meta["total_bytes"] == 10752
    assert meta["encoder"] == "memory_snapshot" and meta["snapshot_s"] >= 0
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]


def test_snapshot_failure_warns_and_returns_false(tmp_path, capsys):
    broken = _StubTorch()
    broken.cuda.memory._snapshot = lambda: 1 / 0
    assert not NS["snapshot_memprof"](broken, str(tmp_path / "x.pb.gz"),
                                      "final", 0)
    assert "memprof snapshot failed" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_peak_trigger_growth_gate(tmp_path, monkeypatch):
    """The JAX package's gate, unchanged: >2 % over the last snapshot, at
    most one every 2 s, the baseline never raised by a deferred tick."""
    stub = _StubTorch()
    path = str(tmp_path / "memprof.pb.gz")
    monkeypatch.setitem(NS["_MEMPROF"], "snap", 0)
    monkeypatch.setitem(NS["_MEMPROF"], "last", 0.0)
    gate = NS["_maybe_memprof"]
    gate(stub, path, 100 * 2**20)
    assert stub.snapshots == 1 and os.path.isfile(path)
    NS["_MEMPROF"]["last"] = 0.0
    gate(stub, path, 101 * 2**20)                      # < 2 %: held
    assert stub.snapshots == 1
    NS["_MEMPROF"]["last"] = time.time()
    gate(stub, path, 200 * 2**20)                      # rate-limited
    assert stub.snapshots == 1 and NS["_MEMPROF"]["snap"] == 100 * 2**20
    NS["_MEMPROF"]["last"] = 0.0
    gate(stub, path, 200 * 2**20)                      # deferred growth
    assert stub.snapshots == 2 and NS["_MEMPROF"]["snap"] == 200 * 2**20
    NS["_MEMPROF"]["last"] = 0.0
    for total in (202, 204, 206):                      # +3 % in sum
        gate(stub, path, total * 2**20)
    assert stub.snapshots == 3
    gate(stub, None, 400 * 2**20)
    gate(stub, path, 0)
    assert stub.snapshots == 3


def test_snapshot_never_imports_a_lazy_module():
    """torch's symbolizer probes ``hasattr(torch, "_inductor")``, which
    torch's lazy module ``__getattr__`` turns into an import: inside the
    sampler's snapshot the probe reads "absent", everywhere else it still
    imports, and the frames are named all the same."""
    imported = []
    fake = types.ModuleType("fake_torch")

    def lazy(name):
        if name in ("_dynamo", "_inductor", "_export", "onnx"):
            imported.append(name)
            return types.SimpleNamespace()
        raise AttributeError(name)

    fake.__getattr__ = lazy

    def _symbolizing_snapshot():
        return {"probe": hasattr(fake, "_inductor"),
                "segments": SNAPSHOT["segments"]}

    fake.cuda = types.SimpleNamespace(memory=types.SimpleNamespace(
        _snapshot=_symbolizing_snapshot))
    snap = NS["_snapshot"](fake)
    assert snap["probe"] is False and imported == []
    assert NS["_snapshot_samples"](snap)            # frames still named
    # the guard is installed once and leaves other callers alone
    guard = fake.__dict__["__getattr__"]
    NS["_snapshot"](fake)
    assert fake.__dict__["__getattr__"] is guard and imported == []
    assert hasattr(fake, "_inductor") and imported == ["_inductor"]
    with pytest.raises(AttributeError):
        fake.not_a_module                           # noqa: B018


def test_snapshot_of_a_torch_without_lazy_modules(tmp_path):
    """A stand-in with no module ``__getattr__`` (or a torch that imports
    everything eagerly) is snapshotted as it is."""
    stub = _StubTorch()
    assert NS["_snapshot"](stub) is SNAPSHOT and stub.snapshots == 1
    assert "__getattr__" not in vars(stub)


def test_sampler_writes_the_tpumon_format_once_cuda_is_up(tmp_path,
                                                          monkeypatch):
    stub = _StubTorch(initialized=False)
    ready = {"torch": None}
    monkeypatch.setitem(NS, "_cuda_ready", lambda: ready["torch"])
    out = tmp_path / "gpumon.txt"
    stop = threading.Event()
    t = NS["start_sampler"](50.0, str(out), stop)
    time.sleep(0.3)
    assert not out.exists()          # nothing before the program's CUDA init
    ready["torch"] = stub
    deadline = time.time() + 10
    while time.time() < deadline and (
            not out.exists() or out.read_text().count("\n") < 4):
        time.sleep(0.05)
    stop.set()
    t.join(2.0)
    assert not t.is_alive()
    lines = [ln.split() for ln in out.read_text().splitlines()]
    beats = [ln for ln in lines if ln[1] == "-1"]
    rows = [ln for ln in lines if ln[1] != "-1"]
    assert beats and rows
    assert all(ln[2:] == ["0", "0", "0"] for ln in beats)
    # device 1 has no context: never sampled
    assert {ln[1] for ln in rows} == {"0"}
    assert rows[0][2:] == ["1000", str(80 * 2**30), "1007"]
    df = ingest_gpumon(str(tmp_path))
    assert set(df["name"]) == {"alive", "hbm_used_gb", "hbm_occupancy"}


def test_sampler_writes_nothing_before_cuda_init(tmp_path):
    """With the tests' own torch, where CUDA is never initialized, the
    sampler waits and writes nothing, then stops on request."""
    out = tmp_path / "gpumon.txt"
    stop = threading.Event()
    t = gpumon.start_sampler(50.0, str(out), stop)
    time.sleep(0.3)
    stop.set()
    t.join(2.0)
    assert not t.is_alive() and not out.exists()
    assert not torch.cuda.is_initialized()


def test_arm_history_queues_into_cuda_init(capsys):
    stub = _StubTorch(initialized=False)
    NS["arm_history"](stub)
    assert len(stub.queued) == 1 and not stub.history   # not yet run
    stub.queued[0]()
    assert stub.history == [{"enabled": "all", "context": "alloc",
                             "stacks": "python",
                             "max_entries": NS["MAX_ENTRIES"]}]
    # the backward entry points, wrapped to note their calls, unchanged
    NS["_BACKWARDS"].clear()
    assert stub.autograd.backward(3) == ("backward", 3)
    assert stub.autograd.grad(1, inputs=2) == ("grad", 1, 2)
    assert [c[1] is not None for c in NS["_BACKWARDS"]] == [True, True]
    NS["_BACKWARDS"].clear()

    def boom(**kw):
        raise RuntimeError("no allocator")

    stub.cuda.memory._record_memory_history = boom
    stub.queued[0]()                 # a failure warns, never raises
    assert "allocation stacks not recorded" in capsys.readouterr().err


def test_final_snapshot_and_breadcrumb_at_exit(tmp_path):
    """A program whose peak never cleared the gate leaves a final snapshot
    and the atexit_stop.json breadcrumb (stub torch, real atexit)."""
    (tmp_path / "_inject").mkdir()
    gpumon.write_sampler_module(str(tmp_path / "_inject"))
    code = f"""
import sys, types
snap = {{"segments": [{{"device": 0, "blocks": [{{"address": 1, "size": 64,
    "state": "active_allocated", "frames": [{{"filename": "/w/app.py",
    "line": 7, "name": "main"}}]}}]}}]}}
torch = types.SimpleNamespace(cuda=types.SimpleNamespace(
    is_initialized=lambda: True,
    memory=types.SimpleNamespace(_snapshot=lambda: snap)))
sys.modules["torch"] = torch
from sofa_torch_gpumon import start_sampler
start_sampler(0.001, {str(tmp_path / 'gpumon.txt')!r},
              memprof_path={str(tmp_path / 'memprof.pb.gz')!r})
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60,
                       env=dict(os.environ,
                                PYTHONPATH=str(tmp_path / "_inject")))
    assert r.returncode == 0, r.stderr
    df, meta = memprof.load_memprof(str(tmp_path))
    assert meta["trigger"] == "final" and list(df["site"]) == [
        "main (/w/app.py:7)"]
    crumb = json.loads((tmp_path / "_inject" / "atexit_stop.json")
                       .read_text())
    assert crumb["done"] and crumb["ok"]


# -- blocks of the autograd engine's device thread -----------------------------

def test_engine_blocks_take_the_backward_callers_line(tmp_path):
    """A block with no frames allocated while a backward call ran carries
    that call's stack under (autograd engine); its site is the caller's
    line.  Outside any call it stays (stackless buffer)."""
    NS["_BACKWARDS"].clear()
    seen = {}

    def engine(loss):                   # stands in for torch.autograd.backward
        seen["t"] = time.time_ns() // 1000
        return loss

    backward = NS["_noting_backward"](engine, torch)
    assert backward(5) == 5; line = sys._getframe().f_lineno  # noqa: E702
    trace = [dict(_alloc(20, 64, []), time_us=seen["t"]),
             dict(_alloc(21, 32, []), time_us=seen["t"] + 10**9)]
    snap = {"segments": [{"device": 0, "blocks": [
        _block(20, 64, []), _block(21, 32, [])]}], "device_traces": [trace]}
    path = str(tmp_path / "memprof.pb.gz")
    assert NS["snapshot_memprof"](_StubTorch(snapshot=snap), path, "peak", 96)
    df = memprof.parse_memprof(path).set_index("bytes")
    assert df.loc[64, "stack"].startswith("(autograd engine);")
    assert df.loc[64, "site"].startswith(
        "test_engine_blocks_take_the_backward_callers_line (")
    assert df.loc[64, "site"].endswith(":%d)" % line)
    assert df.loc[32, "site"] == "(stackless buffer)"
    NS["_BACKWARDS"].clear()


def test_noted_backward_on_real_autograd():
    """The wrapped torch.autograd.backward computes the same gradient and
    notes one finished call from this test's line."""
    NS["_BACKWARDS"].clear()
    backward = NS["_noting_backward"](torch.autograd.backward, torch)
    assert NS["_noting_backward"](backward, torch) is backward   # once
    x = torch.ones(3, requires_grad=True)
    backward((x * 2).sum())
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    (start, end, frames), = NS["_BACKWARDS"]
    assert start <= end
    assert frames[0]["name"] == "test_noted_backward_on_real_autograd"
    NS["_BACKWARDS"].clear()


# -- the at-exit replay to the highest point of the trace ---------------------

def _alloc(addr, size, frames):
    return {"action": "alloc", "addr": addr, "size": size,
            "frames": [{"filename": f, "line": ln, "name": n}
                       for n, f, ln in frames]}


def _free(addr, size, frames=(), action="free_requested"):
    return dict(_alloc(addr, size, frames), action=action)


PARAMS = [("init", USER_FILE, 99)]
ACTS = [("forward", USER_FILE, 263)]
TRACE = [
    _alloc(1, 100, PARAMS),
    _alloc(2, 50, STEP),
    _alloc(3, 400, ACTS),                 # the peak: 100 + 50 + 400 + 30
    _alloc(4, 30, []),
    _free(3, 400, ACTS), _free(3, 400, ACTS, "free_completed"),
    _alloc(5, 20, ACTS),
    {"action": "segment_alloc", "addr": 0, "size": 1 << 21},
]
# the blocks live at the end of TRACE (device 0), and of a device-1 trace
END = {0: [_block(1, 100, PARAMS), _block(2, 50, STEP), _block(4, 30, []),
           _block(5, 20, ACTS), _block(6, 1 << 20, ACTS, state="inactive")],
       1: [_block(9, 3, ACTS)]}
TRACE1 = [_alloc(9, 7, PARAMS), _free(9, 7, PARAMS), _alloc(9, 3, ACTS)]


def test_replay_finds_the_blocks_live_at_the_high_water_mark():
    snap = {**_snapshot(END), "device_traces": [TRACE, TRACE1]}
    samples, peak, lengths = NS["_replay_peak"](snap)
    assert peak == 580 + 7 and lengths == [8, 3]
    got = {(dev, fr[0][0]): (c, b) for fr, dev, k, c, b in samples}
    assert got == {
        ("cuda:0", "init (%s:99)" % USER_FILE): (1, 100),
        ("cuda:0", "zeros_like (%s:10)" % TORCH_FILE): (1, 50),
        ("cuda:0", "forward (%s:263)" % USER_FILE): (1, 400),
        ("cuda:0", "(stackless buffer)"): (1, 30),
        ("cuda:1", "init (%s:99)" % USER_FILE): (1, 7),
    }


def test_replay_walks_a_ring_that_lost_its_start():
    """Armed late, or wrapped: blocks allocated before the ring's first
    entry are live throughout, and the peak is the highest point the ring
    reaches."""
    ring = TRACE[2:]                      # lost the allocs of blocks 1 and 2
    snap = {**_snapshot({0: END[0]}), "device_traces": [ring]}
    samples, peak, lengths = NS["_replay_peak"](snap)
    assert peak == 580 and lengths == [6]
    assert sum(b for *_, b in samples) == 580


@pytest.mark.parametrize("trace", [
    TRACE + [_alloc(7, 10, [])],                  # alloc of a block not live
    TRACE + [_free(1, 100, PARAMS)] + [_free(1, 100, PARAMS)],  # freed twice
], ids=["lost_alloc", "double_free"])
def test_replay_refuses_a_trace_that_contradicts_the_live_blocks(trace):
    assert NS["_replay_peak"]({**_snapshot(END),
                               "device_traces": [trace]}) is None


def _exit_snapshot(tmp_path, monkeypatch, snap_bytes, trace, existing=False):
    stub = _StubTorch(snapshot={**_snapshot({0: END[0]}),
                                "device_traces": [trace]})
    path = tmp_path / "memprof.pb.gz"
    if existing:
        assert NS["snapshot_memprof"](stub, str(path), "peak", snap_bytes)
    monkeypatch.setitem(NS["_MEMPROF"], "snap", snap_bytes)
    assert NS["final_memprof"](stub, str(path))
    return memprof.load_memprof(str(tmp_path))


def test_exit_replays_a_peak_the_gate_missed(tmp_path, monkeypatch):
    df, meta = _exit_snapshot(tmp_path, monkeypatch, 200, TRACE,
                              existing=True)
    assert meta["trigger"] == "peak" and meta["replayed"]
    assert meta["total_bytes"] == 580 == int(df["bytes"].sum())
    assert meta["trace_entries"] == [8] and not meta["wrapped"]
    assert meta["gate_bytes"] == 200
    assert meta["allocator_peak_bytes"] == 1007        # the stub's counter
    top = memprof.aggregate_sites(df).iloc[0]
    assert top["site"] == "forward (%s:263)" % USER_FILE


def test_exit_keeps_a_gate_snapshot_near_the_peak(tmp_path, monkeypatch):
    df, meta = _exit_snapshot(tmp_path, monkeypatch, 570, TRACE,
                              existing=True)
    assert meta["trigger"] == "peak" and "replayed" not in meta
    assert int(df["bytes"].sum()) == 100 + 50 + 30 + 20    # END[0]


def test_exit_without_a_trace_falls_back_to_the_final_state(tmp_path,
                                                            monkeypatch):
    df, meta = _exit_snapshot(tmp_path, monkeypatch, 0, [])
    assert meta["trigger"] == "final"
    assert int(df["bytes"].sum()) == 100 + 50 + 30 + 20
