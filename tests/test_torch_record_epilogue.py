"""sofa_tpu_torch's bounded record epilogue and ``--pid`` attach.

The epilogue math (``_epilogue_deadline``, ``_marker_authoritative``)
against the JAX package's on the same breadcrumbs and processes; a child
that writes a ``done, not ok`` breadcrumb and sleeps is killed past
``--epilogue_deadline_s``; a breadcrumb from a grandchild or an exited
writer kills nothing; the two writers of the breadcrumb (the memory
sampler's final snapshot, then the Kineto stop) never turn a failure into
a success; ``record --pid`` waits for a running process and names it in
misc.txt.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.record import _epilogue_deadline as jax_deadline
from sofa_tpu.record import _marker_authoritative as jax_authoritative
from sofa_tpu_torch.cli import main as cli_main
from sofa_tpu_torch.collectors import gpumon, kineto
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.record import (_epilogue_deadline,
                                   _marker_authoritative, sofa_record)

from test_torch_faults import manifest

MARKERS = [
    {"t": 100.0, "done": True, "ok": True},
    {"t": 100.0, "done": True, "ok": False, "grace_s": 20},
    {"t": 100.0, "done": True, "ok": False},
    {"t": 100.0, "timeout_s": 30, "grace_s": 20},
    {"t": 100.0, "timeout_s": 300.0, "grace_s": 0},
    {"t": 50.0},
    {"pid": 7, "t": 100.0, "done": False, "ok": True, "timeout_s": 5},
]


@pytest.mark.parametrize("override", [None, 5.0, 0.0])
@pytest.mark.parametrize("i", range(len(MARKERS)))
def test_epilogue_deadline_matches_the_jax_package(i, override):
    cfg = SofaConfig(logdir="/tmp/x/", epilogue_deadline_s=override)
    jcfg = JaxConfig(logdir="/tmp/x/", epilogue_deadline_s=override)
    assert _epilogue_deadline(cfg, MARKERS[i]) == \
        jax_deadline(jcfg, MARKERS[i])


def test_marker_authoritative_matches_the_jax_package():
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import subprocess, sys, time\n"
         "p = subprocess.Popen([sys.executable, '-c',"
         " 'import time; time.sleep(30)'])\n"
         "print(p.pid, flush=True)\n"
         "time.sleep(30)\n"],
        stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        grandchild = int(child.stdout.readline())
        done = subprocess.Popen([sys.executable, "-c", "pass"])
        done.wait()
        cases = [({"pid": child.pid}, True), ({"pid": grandchild}, True),
                 ({"pid": 0}, False), ({"pid": "x"}, False), ({}, False),
                 ({"pid": os.getpid()}, False), ({"pid": done.pid}, False)]
        for m, want in cases:
            assert _marker_authoritative(child, m) == want, m
            assert jax_authoritative(child, m) == want, m
    finally:
        os.killpg(child.pid, signal.SIGKILL)
        child.wait()


WEDGED = """\
import json, os, sys, time
inject = os.path.join(json.loads(os.environ["SOFA_TORCH_KINETO_OPTS"])
                      ["logdir"], "_inject")
with open(os.path.join(inject, "atexit_stop.json"), "w") as f:
    json.dump({"pid": os.getpid(), "t": time.time(), "timeout_s": 0,
               "grace_s": 0, "done": True, "ok": False}, f)
print("wedging", flush=True)
time.sleep(600)
"""


def test_a_child_wedged_at_exit_is_killed_past_the_deadline(tmp_path,
                                                            capsys):
    prog = tmp_path / "wedged.py"
    prog.write_text(WEDGED)
    d = str(tmp_path / "log") + "/"
    cfg = SofaConfig(logdir=d, enable_gpu_mon=False, epilogue_deadline_s=1.0)
    t0 = time.time()
    rc = sofa_record(f"{sys.executable} {prog}", cfg)
    assert time.time() - t0 < 30, "the epilogue deadline did not fire"
    assert rc == 143                        # SIGTERM, the shell convention
    err = capsys.readouterr().err
    assert "wedged in its at-exit trace stop" in err
    assert "the device trace may be partial" in err
    misc = dict(line.split(None, 1)
                for line in open(cfg.path("misc.txt")).read().splitlines())
    time.sleep(0.3)
    assert not os.path.exists(f"/proc/{int(misc['pid'])}"), "orphan"
    assert manifest(d)["runs"]["record"]["rc"] == 143


GRANDCHILD = """\
import json, os, subprocess, sys, time
inject = os.path.join(json.loads(os.environ["SOFA_TORCH_KINETO_OPTS"])
                      ["logdir"], "_inject")
code = ("import json, os, time; "
        "json.dump({'pid': os.getpid(), 't': time.time() - 100, "
        "'done': True, 'ok': False}, "
        "open(os.path.join(%r, 'atexit_stop.json'), 'w')); time.sleep(%s)")
# a descendant of the workload that stays alive (a grandchild of sh)...
helper = subprocess.Popen([sys.executable, "-c", code % (inject, 4)])
time.sleep(1.5)
# ...then one that exits at once: a leftover breadcrumb
subprocess.run([sys.executable, "-c", code % (inject, 0)])
time.sleep(2.0)
helper.kill()
"""


def test_a_breadcrumb_of_another_writer_kills_nothing(tmp_path):
    prog = tmp_path / "helpers.py"
    prog.write_text(GRANDCHILD)
    d = str(tmp_path / "log") + "/"
    cfg = SofaConfig(logdir=d, enable_gpu_mon=False, epilogue_deadline_s=0.1)
    t0 = time.time()
    rc = sofa_record(f"{sys.executable} {prog}; exit 0", cfg)
    assert rc == 0 and time.time() - t0 >= 3.5


def test_breadcrumb_writers_keep_a_failure(tmp_path):
    inject = tmp_path / "_inject"
    inject.mkdir()
    marker = inject / "atexit_stop.json"
    pid = os.getpid()
    # the memory sampler's final snapshot gave up...
    gpumon._ns["_mark"](str(tmp_path / "memprof.pb.gz"),
                        {"pid": pid, "t": 1.0, "timeout_s": 30,
                         "grace_s": 0, "done": True, "ok": False})
    # ...then the Kineto stop begins and finishes in time
    kineto._ns["write_marker"](str(tmp_path), {"pid": pid, "t": 2.0,
                                               "timeout_s": 300,
                                               "grace_s": 0})
    m = json.loads(marker.read_text())
    assert m["ok"] is False and not m.get("done")
    kineto._ns["write_marker"](str(tmp_path), {
        "pid": pid, "t": 3.0, "timeout_s": 300, "grace_s": 0, "done": True,
        "ok": True})
    m = json.loads(marker.read_text())
    assert m == {"pid": pid, "t": 3.0, "timeout_s": 300, "grace_s": 0,
                 "done": True, "ok": False}
    # another process's write starts afresh
    kineto._ns["write_marker"](str(tmp_path), {"pid": pid + 1, "t": 4.0,
                                               "done": True, "ok": True})
    assert json.loads(marker.read_text())["ok"] is True
    # no injection directory (api.profile()): nothing is written
    kineto._ns["write_marker"](str(tmp_path / "elsewhere"), {"pid": pid})
    assert not (tmp_path / "elsewhere").exists()


def test_kineto_stop_writes_the_breadcrumb_under_record(tmp_path):
    """A real CPU ``record`` of a torch program: the Kineto stop's
    breadcrumb ends done and ok, from the program's own pid."""
    d = str(tmp_path / "log") + "/"
    cfg = SofaConfig(logdir=d, enable_gpu_mon=False)
    rc = sofa_record(f"{sys.executable} -c 'import torch, os; "
                     "print(os.getpid(), flush=True)'", cfg)
    assert rc == 0
    m = json.load(open(os.path.join(cfg.inject_dir, "atexit_stop.json")))
    assert m["done"] is True and m["ok"] is True
    assert m["timeout_s"] == kineto._ns["STOP_TIMEOUT_S"]
    assert os.listdir(cfg.kineto_dir)


def test_record_attaches_to_a_running_pid(tmp_path):
    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(1.5)"])
    d = str(tmp_path / "log") + "/"
    try:
        t0 = time.time()
        rc = cli_main(["record", "--logdir", d, "--pid", str(sleeper.pid),
                       "--disable_kineto", "--disable_gpu_mon"])
        assert rc == 0 and time.time() - t0 >= 1.0
    finally:
        sleeper.kill()
        sleeper.wait()
    misc = dict(line.split(None, 1)
                for line in open(d + "misc.txt").read().splitlines())
    assert int(misc["pid"]) == sleeper.pid and misc["rc"] == "0"
    doc = manifest(d)
    assert any(s["name"] == "attach" for s in doc["stages"])
    assert doc["collectors"]["procmon"]["status"] == "stopped"
    assert os.path.getsize(d + "mpstat.txt") > 0
