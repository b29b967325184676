"""The port's chunked columnar frame store (``sofa_tpu_torch/frames.py``)
and its projection through the pass registry, held against the JAX
package's ``sofa_tpu/frames.py`` in one process.

The same frame, made from a seed with numpy, goes through both packages'
``write_frame_chunks``: the frame_index.json documents are equal (chunk
shas, rows, t_min/t_max), and each package's ``open_frame`` reads the
other's store.  Projection and time-range reads, append and shrink, a kill
before the index commit and the chunk re-hash agree with the JAX store.
Then every registered port pass sees the same features and writes the same
artifacts from its projected slice as from the full load, and a pass that
reads a frame or a column it did not declare fails loudly.
"""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from sofa_tpu import frames as jax_frames
from sofa_tpu_torch import frames, telemetry, trace
from sofa_tpu_torch.analysis import registry
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.trace import COLUMNS, make_frame

STEP = 64           # chunk rows: a few chunks at a test's size


def _frame(n=300, seed=0, nan_chunk=False) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    df = make_frame({
        "timestamp": np.sort(rng.uniform(0.0, 10.0, n)),
        "event": rng.normal(size=n),
        "duration": rng.uniform(0, 1e-3, n),
        "deviceId": rng.integers(-1, 2, n),
        "copyKind": rng.choice([0, 1, 2, 8], n),
        "payload": rng.integers(0, 1 << 20, n),
        "name": [f"kernel_{i % 7}" for i in rng.integers(0, 100, n)],
        "flops": rng.uniform(0, 1e9, n),
        "phase": rng.choice(["fw", "bw", ""], n),
        "op_path": [f"step/{i % 5}/mm" for i in range(n)],
    })
    if nan_chunk:       # one chunk signs no time range
        df.loc[STEP:2 * STEP - 1, "timestamp"] = np.nan
    return df


def _partial(n=200, seed=1) -> pd.DataFrame:
    """Only a few columns: each package's _conform fills the rest."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"timestamp": np.sort(rng.uniform(0, 5, n)),
                         "duration": rng.uniform(0, 1e-3, n),
                         "name": [f"n{i}" for i in rng.integers(0, 9, n)],
                         "deviceId": rng.integers(0, 3, n)})


def _index(logdir, name="gputrace"):
    with open(os.path.join(logdir, "_frames", name,
                           "frame_index.json")) as f:
        return json.load(f)


def _both(tmp_path, df, name="gputrace", chunk_rows=STEP):
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    got = frames.write_frame_chunks(df, port, name, chunk_rows=chunk_rows)
    want = jax_frames.write_frame_chunks(df, jax, name,
                                         chunk_rows=chunk_rows)
    return port, jax, got, want


@pytest.mark.parametrize("make", [_frame, _partial,
                                  lambda: _frame(nan_chunk=True)],
                         ids=["schema", "partial", "nan_chunk"])
def test_same_frame_index_as_jax(tmp_path, make):
    port, jax, got, want = _both(tmp_path, make())
    assert _index(port) == _index(jax)
    assert got["_stats"] == {**want["_stats"], "bytes": got["_stats"]["bytes"]}
    doc = _index(port)
    assert doc["columns"] == COLUMNS and doc["chunk_rows"] == STEP
    assert sum(c["rows"] for c in doc["chunks"]) == doc["rows"]


def test_nan_chunk_signs_null_bounds(tmp_path):
    port, _, _, _ = _both(tmp_path, _frame(nan_chunk=True))
    chunk = _index(port)["chunks"][1]
    assert chunk["t_min"] is None and chunk["t_max"] is None


def test_each_package_reads_the_others_store(tmp_path):
    port, jax, _, _ = _both(tmp_path, _frame())
    mine = frames.open_frame(port, "gputrace").read()
    pd.testing.assert_frame_equal(jax_frames.open_frame(port, "gputrace")
                                  .read(), mine)
    pd.testing.assert_frame_equal(frames.open_frame(jax, "gputrace").read(),
                                  mine)
    # and the read is the frame that went in
    pd.testing.assert_frame_equal(mine, trace._conform(_frame().copy()),
                                  check_dtype=False)


READS = [
    (None, None),
    (["name", "duration"], None),
    (["duration", "timestamp", "no_such_column"], None),
    (None, (2.0, 4.0)),
    (["name"], (2.0, 4.0)),
    (["flops", "deviceId"], (9.5, 100.0)),
    (["name"], (20.0, 30.0)),           # no chunk overlaps
]


@pytest.mark.parametrize("columns,time_range", READS)
@pytest.mark.parametrize("nan_chunk", [False, True])
def test_projection_and_time_range_match_jax(tmp_path, columns, time_range,
                                             nan_chunk):
    port, jax, _, _ = _both(tmp_path, _frame(nan_chunk=nan_chunk))
    mine = frames.open_frame(port, "gputrace")
    ref = jax_frames.open_frame(jax, "gputrace")
    got = mine.read(columns=columns, time_range=time_range)
    want = ref.read(columns=columns, time_range=time_range)
    pd.testing.assert_frame_equal(got, want)
    assert mine.chunks_read == ref.chunks_read
    if columns is not None:
        assert list(got.columns) == [c for c in columns if c in COLUMNS]
    if time_range is not None and len(got) and "timestamp" in got:
        assert got["timestamp"].between(*time_range).all()


def test_chunk_and_table_reads_match_jax(tmp_path):
    port, jax, _, _ = _both(tmp_path, _frame())
    mine = frames.open_chunk_store(os.path.join(port, "_frames",
                                                "gputrace"))
    ref = jax_frames.open_chunk_store(os.path.join(jax, "_frames",
                                                   "gputrace"))
    for i in range(len(mine.index["chunks"])):
        pd.testing.assert_frame_equal(mine.read_chunk(i, ["name", "flops"]),
                                      ref.read_chunk(i, ["name", "flops"]))
    assert mine.read_table(["duration"]).equals(ref.read_table(["duration"]))
    assert mine.read_table().num_rows == 300
    assert frames.open_chunk_store(str(tmp_path / "none")) is None


def test_time_range_skips_chunks(tmp_path):
    port, _, _, _ = _both(tmp_path, _frame(n=640))
    handle = frames.open_frame(port, "gputrace")
    handle.read(columns=["name"], time_range=(0.0, 0.5))
    assert 0 < handle.chunks_read < len(handle.index["chunks"])


def test_append_equals_batch_and_matches_jax(tmp_path):
    full = _frame(n=300)
    stats = {}
    for pkg, root in ((frames, tmp_path / "port"), (jax_frames,
                                                    tmp_path / "jax")):
        pkg.write_frame_chunks(full.iloc[:150], str(root / "a"), "f",
                               chunk_rows=STEP)
        stats[pkg] = pkg.write_frame_chunks(full, str(root / "a"), "f",
                                            chunk_rows=STEP)["_stats"]
        pkg.write_frame_chunks(full, str(root / "b"), "f", chunk_rows=STEP)
        assert _index(str(root / "a"), "f") == _index(str(root / "b"), "f")
    # the two full chunks of the first write are reused, the tail rewritten
    assert stats[frames]["reused"] == 150 // STEP == stats[jax_frames][
        "reused"]
    assert stats[frames]["wrote"] == stats[jax_frames]["wrote"]
    assert _index(str(tmp_path / "port" / "a"), "f") == \
        _index(str(tmp_path / "jax" / "a"), "f")
    again = frames.write_frame_chunks(full, str(tmp_path / "port" / "a"),
                                      "f", chunk_rows=STEP)["_stats"]
    assert again["wrote"] == 0 and again["reused"] == 5


def test_shrink_drops_stale_chunks_like_jax(tmp_path):
    full = _frame(n=300)
    for pkg, root in ((frames, tmp_path / "port"), (jax_frames,
                                                    tmp_path / "jax")):
        pkg.write_frame_chunks(full, str(root), "f", chunk_rows=STEP)
        pkg.write_frame_chunks(full.iloc[:100], str(root), "f",
                               chunk_rows=STEP)
    assert _index(str(tmp_path / "port"), "f") == \
        _index(str(tmp_path / "jax"), "f")
    sdir = tmp_path / "port" / "_frames" / "f"
    assert sorted(os.listdir(sdir)) == ["000000.arrow", "000001.arrow",
                                        "frame_index.json"]
    assert len(frames.open_frame(str(tmp_path / "port"), "f").read()) == 100


class _Killed(BaseException):
    """Stands for a SIGKILL at the index commit: nothing after it runs."""


def test_kill_before_the_index_commit_keeps_the_previous_generation(
        tmp_path, monkeypatch):
    full = _frame(n=300)
    logdir = str(tmp_path)
    frames.write_frame_chunks(full.iloc[:100], logdir, "f", chunk_rows=STEP)
    before = frames.open_frame(logdir, "f").read()
    real = trace.atomic_write

    def dying(path, *a, **kw):
        if path.endswith(frames.FRAME_INDEX_NAME):
            raise _Killed()
        return real(path, *a, **kw)

    monkeypatch.setattr(trace, "atomic_write", dying)
    with pytest.raises(_Killed):
        frames.write_frame_chunks(full, logdir, "f", chunk_rows=STEP)
    monkeypatch.setattr(trace, "atomic_write", real)
    # the new chunks are on disk, the index still signs the old rows
    assert len(os.listdir(os.path.join(logdir, "_frames", "f"))) > 3
    for reader in (frames, jax_frames):
        pd.testing.assert_frame_equal(reader.open_frame(logdir, "f").read(),
                                      before)
    assert frames.verify_frame_store(logdir, "f") == [] == \
        jax_frames.verify_frame_store(logdir, "f")
    frames.write_frame_chunks(full, logdir, "f", chunk_rows=STEP)
    pd.testing.assert_frame_equal(frames.open_frame(logdir, "f").read(),
                                  frames.open_frame(logdir, "f").read())
    assert len(frames.open_frame(logdir, "f").read()) == 300


def test_verify_flags_a_flipped_chunk_byte_like_jax(tmp_path):
    port, _, _, _ = _both(tmp_path, _frame())
    assert frames.verify_frame_store(port, "gputrace") == []
    path = os.path.join(port, "_frames", "gputrace", "000002.arrow")
    data = bytearray(open(path, "rb").read())
    # a byte inside the first column's values (not the IPC framing)
    data[len(data) // 3] ^= 0xFF
    open(path, "wb").write(bytes(data))
    bad = ["_frames/gputrace/000002.arrow"]
    assert frames.verify_frame_store(port, "gputrace") == bad
    assert jax_frames.verify_frame_store(port, "gputrace") == bad


def test_write_frame_modes_delete_each_other(tmp_path):
    base = str(tmp_path / "gputrace")
    df = _frame(n=50)
    _, stats = trace.write_frame(df, base, "columnar")
    assert frames.frame_store_names(str(tmp_path)) == ["gputrace"]
    assert stats["wrote"] == 1 and stats["reused"] == 0
    assert trace.write_frame(df, base, "parquet") == (base + ".parquet",
                                                      None)
    assert frames.frame_store_names(str(tmp_path)) == []
    trace.write_frame(df, base, "csv")
    assert not os.path.exists(base + ".parquet")
    pd.testing.assert_frame_equal(trace.read_frame(base, ["name"]),
                                  df[["name"]], check_dtype=False)
    trace.write_frame(df, base, "columnar")
    # the chunk store wins over the csv beside it
    assert trace.read_frame(base) is not None
    assert len(frames.open_frame(str(tmp_path), "gputrace").read()) == 50


def test_a_frame_arrow_refuses_falls_back_to_csv(tmp_path, capsys):
    df = _frame(n=20)
    df["name"] = [object()] * 20            # no Arrow type for this
    path, stats = trace.write_frame(df, str(tmp_path / "odd"), "columnar")
    assert path.endswith("odd.csv") and os.path.isfile(path)
    assert stats is None
    assert frames.frame_store_names(str(tmp_path)) == []
    assert "writing odd.csv instead" in capsys.readouterr().err


def test_resolve_trace_format(monkeypatch, capsys):
    monkeypatch.delenv("SOFA_TRACE_FORMAT", raising=False)
    assert trace.resolve_trace_format(SofaConfig()) == "columnar"
    monkeypatch.setenv("SOFA_TRACE_FORMAT", "parquet")
    assert trace.resolve_trace_format(SofaConfig()) == "parquet"
    assert trace.resolve_trace_format(SofaConfig(trace_format="csv")) == \
        "csv"
    assert trace.resolve_trace_format(SofaConfig(trace_format="xml")) == \
        "columnar"
    monkeypatch.setattr(frames, "columnar_available", lambda: False)
    assert trace.resolve_trace_format(SofaConfig(trace_format="columnar")) \
        == "csv"
    assert "falling back to csv" in capsys.readouterr().err


def test_preprocess_without_pyarrow_writes_csv(tmp_path, monkeypatch):
    """The reference's fallback: no pyarrow, the frames go to CSV with a
    warning, and meta.frames.format says csv."""
    from test_torch_board import write_sink_logdir

    from sofa_tpu_torch.preprocess import sofa_preprocess

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    monkeypatch.setattr(frames, "columnar_available", lambda: False)
    sofa_preprocess(SofaConfig(logdir=d, jobs=1))
    meta = telemetry.load_manifest(d)["meta"]["frames"]
    assert meta["format"] == "csv" and meta["chunks"] == 0
    assert not os.path.isdir(d + "_frames")
    assert len(trace.read_csv(d + "gputrace.csv")) > 0


# --- projection through the registry -----------------------------------------

def _host_logdir(d):
    """The sink capture with network raws, preprocessed, then the host
    parsers' frames written over its (empty) host frames."""
    from test_torch_board import write_sink_logdir
    from test_torch_host_ingest import _host_frames
    from test_torch_net_passes import _mpstat, _netstat, _packets, _pcap

    write_sink_logdir(d)
    with open(d + "sofa.pcap", "wb") as f:
        f.write(_pcap(_packets()))
    with open(d + "netstat.txt", "w") as f:
        f.write(_netstat())
    with open(d + "mpstat.txt", "w") as f:
        f.write(_mpstat())
    _preprocess(d)
    for name, df in _host_frames().items():
        if name != "mpstat":
            trace.write_frame(df, d + name, "columnar")


def _comm_logdir(d):
    from test_torch_comm import BASE_NS, write_capture

    write_capture(d)
    with open(d + "sofa_time.txt", "w") as f:
        f.write(f"{BASE_NS / 1e9}\n")
    _preprocess(d)


def _preprocess(d):
    from sofa_tpu_torch.preprocess import sofa_preprocess

    sofa_preprocess(SofaConfig(logdir=d, jobs=1, trace_format="columnar"))


def _run_each(logdir, lazy):
    """Every registered pass in canonical order on one Features: the
    rows each added and the error each raised, by name."""
    from sofa_tpu_torch.analyze import open_frames
    from sofa_tpu_torch.frames import ProjectionPool
    from sofa_tpu_torch.preprocess import load_frames, read_misc

    cfg = SofaConfig(logdir=logdir, jobs=1)
    if lazy:
        pool = ProjectionPool(open_frames(cfg))
        assert pool.lazy
    else:
        full = load_frames(cfg)
    feats = Features()
    feats.add("elapsed_time",
              float(read_misc(cfg).get("elapsed_time", 0) or 0))
    out = {}
    for spec in registry.registered():
        n = len(feats._rows)
        given = (pool.for_pass(spec.reads_frames, spec.reads_columns)
                 if lazy else full)
        try:
            spec.fn(given, cfg, feats)
            err = None
        except Exception as e:  # noqa: BLE001 - recorded, asserted on
            err = f"{type(e).__name__}: {e}"
        rows = [(k, v) for k, v in feats._rows[n:]
                if not str(v).startswith(logdir)]
        out[spec.name] = (rows, err)
    return out


def _artifacts(logdir, spec):
    found = {}
    for name in spec.provides_artifacts:
        path = os.path.join(logdir, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                found[name] = f.read()
    return found


@pytest.fixture(scope="module")
def projected_runs(tmp_path_factory):
    """(logdir kind -> (full run, projected run, full dir, lazy dir))."""
    registry.load_builtin_passes()
    runs = {}
    for kind, build in (("host", _host_logdir), ("comm", _comm_logdir)):
        base = str(tmp_path_factory.mktemp(f"proj_{kind}"))
        full_dir, lazy_dir = base + "/full/", base + "/lazy/"
        build(full_dir)
        shutil.copytree(full_dir, lazy_dir)
        runs[kind] = (_run_each(full_dir, False), _run_each(lazy_dir, True),
                      full_dir, lazy_dir)
    return runs


def _builtin_names():
    registry.load_builtin_passes()
    return [s.name for s in registry.registered()]


@pytest.mark.parametrize("name", _builtin_names())
def test_projected_input_equals_the_full_load(projected_runs, name):
    spec = registry.get(name)
    ran = False
    for kind, (full, lazy, full_dir, lazy_dir) in projected_runs.items():
        assert full[name][1] is None, (kind, full[name][1])
        assert lazy[name] == full[name], kind
        assert _artifacts(lazy_dir, spec) == _artifacts(full_dir, spec), kind
        ran = ran or bool(full[name][0])
    # spotlight adds its region only under --spotlight
    if spec.reads_frames and spec.provides_features \
            and spec.enabled(SofaConfig()) and name != "spotlight":
        assert ran, f"{name} added no feature on any logdir"


def _lazy_frames(tmp_path):
    from sofa_tpu_torch.analyze import open_frames

    d = str(tmp_path / "run") + "/"
    from test_torch_board import write_sink_logdir

    write_sink_logdir(d)
    _preprocess(d)
    return d, open_frames(SofaConfig(logdir=d))


@pytest.mark.parametrize("declared,reads,why", [
    (dict(reads_frames=("gputrace",), reads_columns=("name",)),
     ("hosttrace", "name"), "FrameHandle"),
    (dict(reads_frames=("gputrace",), reads_columns=("name",)),
     ("gputrace", "duration"), "KeyError"),
])
def test_an_undeclared_read_fails_loudly(tmp_path, declared, reads, why):
    from sofa_tpu_torch.analysis.registry import run_passes

    d, lazy = _lazy_frames(tmp_path)

    def sneaky(frames_, cfg, features):
        frame, column = reads
        features.add("sneaky_sum", float(frames_[frame][column].sum()))

    with registry.scoped():
        registry.clear()
        registry.register_pass(sneaky, name="sneaky", **declared)
        ledger, _ = run_passes(lazy, SofaConfig(logdir=d), Features(),
                               jobs=1)
    ent = ledger["passes"]["sneaky"]
    assert ent["status"] == "failed" and why in ent["error"]


def test_analyze_hands_each_pass_its_slice(tmp_path, monkeypatch):
    """analyze over a columnar logdir gives a pass exactly its declared
    columns of its declared frames."""
    from sofa_tpu_torch.analyze import sofa_analyze

    d, _ = _lazy_frames(tmp_path)
    seen = {}

    def probe(frames_, cfg, features):
        seen.update({k: (type(v).__name__, list(getattr(v, "columns", [])))
                     for k, v in frames_.items()})

    with registry.scoped():
        registry.register_pass(probe, name="probe",
                               reads_frames=("gputrace",),
                               reads_columns=("name", "duration"))
        sofa_analyze(SofaConfig(logdir=d, jobs=1))
    assert seen["gputrace"] == ("DataFrame", ["name", "duration"])
    assert seen["hosttrace"][0] == "FrameHandle"
