"""The port's durability layer (``sofa_tpu_torch/durability.py``: the run
journal, the digests, ``fsck`` and ``resume``) held against the JAX
package's ``sofa_tpu/durability.py`` in one process.

The journal's state after a torn tail and after compaction equals the JAX
reading of the same file; both packages' ``fsck_scan`` give the same
verdicts on the same damaged port logdir (a missing tile, a flipped byte in
a derived CSV, a rewritten raw capture, a ``.tmp`` and a flipped chunk
byte); the port's manifest with ``digests``, ``meta.frames`` and
``meta.fsck`` passes the JAX validator; ``fsck --repair`` returns 0 and
``resume`` is a no-op once every stage committed.  A preprocess SIGKILLed
at the JAX chaos matrix's three kill points (``tools/chaos_matrix.py:73-
103``: a frame CSV write, a tile write, a chunk hash) resumes to the bytes
of an uninterrupted run.  csv and columnar frames give byte-identical
features.csv, hints.txt and report.js at ``--jobs`` 1 and 4.
"""

import json
import os
import subprocess
import sys

import pytest

from sofa_tpu import durability as jax_durability
from sofa_tpu_torch import durability, frames, telemetry
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.tools.manifest_check import (check_frame_indexes,
                                                 validate_manifest)
from test_torch_board import write_sink_logdir
from test_torch_faults import jax_validator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# report.js keeps 8 points a series, so the sink's series get tile pyramids
VIZ = 8


def _cfg(logdir, **kw):
    return SofaConfig(logdir=logdir, viz_downsample_to=VIZ, **kw)


def _report(cfg):
    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.preprocess import sofa_preprocess

    sofa_analyze(cfg, sofa_preprocess(cfg))


def _cli(*argv):
    return subprocess.run([sys.executable, "-m", "sofa_tpu_torch", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


# --- the journal --------------------------------------------------------------

JOURNAL = [
    {"ev": "begin", "stage": "record", "t": 1.0},
    {"ev": "commit", "stage": "record", "rc": 0, "key": "r1", "t": 2.0},
    {"ev": "begin", "stage": "preprocess", "key": "k0", "t": 3.0},
    {"ev": "commit", "stage": "preprocess", "key": "k1", "t": 4.0},
    {"ev": "begin", "stage": "analyze", "key": "k1", "t": 5.0},
    {"ev": "begin", "stage": "preprocess", "key": "k1", "t": 6.0},
    {"stage": 7, "ev": "begin"},
    {"ev": "commit", "stage": "analyze", "key": "k1", "t": 7.0},
]


@pytest.mark.parametrize("tail", ["", '{"ev": "commit", "stage": "prep',
                                  "not json\n"])
def test_journal_state_matches_jax(tmp_path, tail):
    text = "".join(json.dumps(e) + "\n" for e in JOURNAL) + "\n" + tail
    (tmp_path / durability.JOURNAL_NAME).write_text(text)
    got = durability.read_journal(str(tmp_path))
    assert got == jax_durability.read_journal(str(tmp_path))
    assert len(got) == len(JOURNAL)
    state = durability.journal_state(got)
    assert state == jax_durability.journal_state(got)
    assert not state["preprocess"]["committed"] and \
        state["analyze"]["committed"] and state["record"]["rc"] == 0


def test_journal_compaction_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(durability, "JOURNAL_COMPACT_LINES", 6)
    monkeypatch.setattr(jax_durability, "JOURNAL_COMPACT_LINES", 6)
    docs = {}
    for pkg, d in ((durability, tmp_path / "port"),
                   (jax_durability, tmp_path / "jax")):
        d.mkdir()
        j = pkg.Journal(str(d))
        for i in range(5):
            for stage in ("preprocess", "analyze"):
                j.begin(stage, key=f"k{i}")
                j.commit(stage, key=f"k{i}")
        j.begin("preprocess", key="k9")
        entries = pkg.read_journal(str(d))
        # lines whose millisecond stamps tie keep an order that depends on
        # the timing: compare them as a set, in time order
        assert [e["t"] for e in entries] == sorted(e["t"] for e in entries)
        docs[pkg] = sorted((e["stage"], e["ev"], e.get("key"))
                           for e in entries)
        state = pkg.journal_state(entries)
        assert not state["preprocess"]["committed"]
        assert state["analyze"] == {"committed": True, "key": "k4",
                                    "rc": None, "begin_key": "k4",
                                    "begin_t": state["analyze"]["begin_t"]}
    assert docs[durability] == docs[jax_durability]
    assert len(docs[durability]) <= 6
    strip = [{k: v for k, v in e.items() if k not in ("t", "pid")}
             for e in durability.read_journal(str(tmp_path / "port"))]
    assert durability.journal_state(strip) == jax_durability.journal_state(
        strip)


def test_the_verbs_journal_begin_and_commit(tmp_path):
    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    _report(_cfg(d))
    state = durability.journal_state(durability.read_journal(d))
    assert state["preprocess"]["committed"] and state["analyze"]["committed"]
    assert state["preprocess"]["key"] == durability.logdir_raw_key(d)
    begins = [e for e in durability.read_journal(d) if e["ev"] == "begin"
              and e["stage"] == "preprocess"]
    assert begins[-1]["trace_format"] == "columnar"


def test_record_journals_and_digests_its_harvest(tmp_path):
    d = str(tmp_path / "rec")
    r = _cli("record", "--logdir", d, "--disable_kineto", "--no-perf-events",
             "true")
    assert r.returncode == 0, r.stderr[-2000:]
    state = durability.journal_state(durability.read_journal(d))
    assert state["record"]["committed"] and state["record"]["rc"] == 0
    digests = durability.load_digests(d)
    assert digests["files"]["misc.txt"]["kind"] == "raw"
    assert telemetry.load_manifest(d)["digests"]["files"] == \
        digests["files"]


# --- fsck ---------------------------------------------------------------------

def _flip(path, at=None):
    data = bytearray(open(path, "rb").read())
    i = len(data) // 2 if at is None else at
    data[i] ^= 0x01
    st = os.stat(path)
    open(path, "wb").write(bytes(data))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))   # silent rot


def _damage(d):
    """One artifact of each verdict kind; returns {verdict: [file]}."""
    tile = sorted(os.path.join(r, n) for r, _, ns in
                  os.walk(d + "_tiles") for n in ns if n.endswith(".gz"))[0]
    os.unlink(tile)
    _flip(d + "gputrace.csv")
    trace = sorted(os.listdir(d + "kineto"))[0]
    with open(d + "kineto/" + trace, "a") as f:
        f.write("\n")
    with open(d + "features.csv.tmp", "w") as f:
        f.write("half")
    chunk = d + "_frames/hosttrace/000000.arrow"
    _flip(chunk, at=os.path.getsize(chunk) // 3)
    return {"missing": [os.path.relpath(tile, d)],
            "corrupt": ["_frames/hosttrace/000000.arrow", "gputrace.csv"],
            "stale": ["kineto/" + trace],
            "orphaned": ["features.csv.tmp"]}


@pytest.fixture
def damaged(tmp_path):
    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    _report(_cfg(d))
    return d, _damage(d)


def test_fsck_verdicts_match_jax(damaged):
    d, want = damaged
    got = durability.fsck_scan(d)
    assert got == jax_durability.fsck_scan(d)
    for verdict, files in want.items():
        assert sorted(got[verdict]) == sorted(files), verdict
    assert got["checked"] == len(durability.load_digests(d)["files"]) + len(
        frames.frame_store_names(d))
    raw = {r for r, e in durability.load_digests(d)["files"].items()
           if e["kind"] == "raw"}
    assert {"sofa_time.txt", "misc.txt"} <= raw
    assert any(r.startswith("kineto/") for r in raw)


def test_fsck_repair_status_and_manifest(damaged):
    d, want = damaged
    r = _cli("fsck", d, "--viz_downsample_to", str(VIZ))
    assert r.returncode == 1
    for verdict, files in want.items():
        for rel in files:
            assert f"{verdict:<9} {rel}" in r.stdout
    st = _cli("status", d)
    assert st.returncode == 1 and "last fsck: 5 problem(s)" in st.stdout
    assert "found damaged artifacts" in st.stdout
    r = _cli("fsck", d, "--repair", "--viz_downsample_to", str(VIZ))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert _cli("fsck", d).returncode == 0
    doc = telemetry.load_manifest(d)
    assert doc["meta"]["fsck"]["ok"] and doc["meta"]["fsck"]["repaired"] \
        is False
    assert validate_manifest(doc) == [] and jax_validator()(doc) == []
    assert check_frame_indexes(d) == []
    st = _cli("status", d)
    assert st.returncode == 0 and "last fsck: healthy" in st.stdout
    assert "integrity:" in st.stdout
    r = _cli("resume", d)
    assert r.returncode == 0 and "nothing to replay" in r.stdout


def test_fsck_without_digests_and_on_an_archive_root(tmp_path):
    d = tmp_path / "bare"
    d.mkdir()
    assert _cli("fsck", str(d)).returncode == 2
    # an archive root is checked as a store (an empty one is healthy)...
    (d / durability.ARCHIVE_MARKER_NAME).write_text("{}")
    r = _cli("fsck", str(d))
    assert r.returncode == 0 and "all healthy" in r.stderr + r.stdout
    # ... and a fleet root as its tenants' stores (none yet: healthy)
    f = tmp_path / "fleet"
    f.mkdir()
    (f / durability.FLEET_MARKER_NAME).write_text("{}")
    r = _cli("fsck", str(f))
    assert r.returncode == 0 and "no tenants yet" in r.stderr + r.stdout


def test_frame_indexes_pass_the_jax_validator(tmp_path):
    import importlib.util

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    _report(_cfg(d))
    spec = importlib.util.spec_from_file_location(
        "jax_manifest_check", os.path.join(REPO, "tools",
                                           "manifest_check.py"))
    jax_mc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_mc)
    assert jax_mc._check_frame_indexes(d) == [] == check_frame_indexes(d)
    doc = telemetry.load_manifest(d)
    assert doc["meta"]["frames"]["format"] == "columnar"
    assert doc["meta"]["frames"]["chunks"] > 0
    assert validate_manifest(doc) == [] and jax_mc.validate_manifest(doc) \
        == []


# --- resume -------------------------------------------------------------------

_KILL_CHILD = """
import os, signal, sys
logdir, point, n, viz = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
from sofa_tpu_torch import frames as framestore, tiles, trace
count = [0]
def arm(orig):
    def hook(*a, **kw):
        count[0] += 1
        if count[0] >= n:
            os.kill(os.getpid(), signal.SIGKILL)
        return orig(*a, **kw)
    return hook
if point == "tiles":
    tiles._write_tile = arm(tiles._write_tile)
elif point == "frame_chunks":
    framestore._chunk_sha = arm(framestore._chunk_sha)
else:
    trace.write_csv = arm(trace.write_csv)
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.preprocess import sofa_preprocess
sofa_preprocess(SofaConfig(logdir=logdir, viz_downsample_to=int(viz)))
"""


def _derived(d):
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            rel = os.path.relpath(os.path.join(root, n), d)
            if rel == "report.js" or rel.startswith("_tiles/") or \
                    rel.endswith("frame_index.json"):
                with open(os.path.join(root, n), "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("point", ["frames", "tiles", "frame_chunks"])
def test_resume_after_a_sigkill_matches_an_uninterrupted_run(tmp_path,
                                                             point):
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.record import sofa_clean
    from sofa_tpu_torch.trace import WRITING_SENTINEL

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    cfg = _cfg(d)
    sofa_preprocess(cfg)
    want = _derived(d)
    assert "report.js" in want and any(k.startswith("_tiles/") for k in want)
    sofa_clean(cfg)
    r = subprocess.run([sys.executable, "-c", _KILL_CHILD, d, point, "3",
                        str(VIZ)], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == -9, r.stderr[-2000:]
    assert os.path.exists(d + WRITING_SENTINEL)
    state = durability.journal_state(durability.read_journal(d))
    assert not state["preprocess"]["committed"]
    assert durability.sofa_resume(_cfg(d)) == 0
    assert not os.path.exists(d + WRITING_SENTINEL)
    assert _derived(d) == want
    assert durability.sofa_fsck(_cfg(d)) == 0
    doc = telemetry.load_manifest(d)
    assert validate_manifest(doc) == [] and jax_validator()(doc) == []
    assert durability.sofa_resume(_cfg(d)) == 0     # nothing left


def test_resume_replays_a_preprocess_whose_raw_files_changed(tmp_path,
                                                             capsys):
    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    _report(_cfg(d))
    trace = sorted(os.listdir(d + "kineto"))[0]
    with open(d + "kineto/" + trace, "a") as f:
        f.write("\n")
    assert durability.sofa_resume(_cfg(d)) == 0
    out = capsys.readouterr()
    assert "raw files changed" in out.err and "replaying analyze" in out.out
    state = durability.journal_state(durability.read_journal(d))
    assert state["preprocess"]["key"] == durability.logdir_raw_key(d)


def test_resume_without_a_journal_is_a_usage_error(tmp_path):
    r = _cli("resume", str(tmp_path))
    assert r.returncode == 1 and "journal" in r.stderr


# --- csv and columnar ------------------------------------------------------------

def test_csv_and_columnar_write_the_same_bytes(tmp_path):
    """preprocess then a standalone analyze (which reads the frames back:
    the CSVs, or the chunk store through each pass's projection), on one
    logdir path (report.js names it), in both formats at --jobs 1 and 4."""
    from sofa_tpu_torch.analyze import sofa_analyze
    from sofa_tpu_torch.preprocess import sofa_preprocess
    from sofa_tpu_torch.record import sofa_clean

    d = str(tmp_path / "run") + "/"
    write_sink_logdir(d)
    outs = {}
    for fmt in ("csv", "columnar"):
        for jobs in (1, 4):
            cfg = _cfg(d, trace_format=fmt, jobs=jobs)
            sofa_clean(cfg)
            sofa_preprocess(cfg)
            sofa_analyze(cfg)
            got = {}
            for name in ("features.csv", "hints.txt", "report.js"):
                with open(d + name, "rb") as f:
                    got[name] = f.read()
            assert telemetry.load_manifest(d)["meta"]["frames"]["format"] \
                == fmt
            assert os.path.isdir(d + "_frames") == (fmt == "columnar")
            outs[fmt, jobs] = got
    first = outs["csv", 1]
    assert first["hints.txt"].strip()
    for key, got in outs.items():
        assert got == first, key
