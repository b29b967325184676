"""``top`` (``sofa_tpu_torch/top.py``) over fixture sampler files: the
memory sampler's ``gpumon`` files (one a process, ``gpumon.rank<r>.txt``
for a rank) with the cards' names beside them, the allocation-site
snapshot, and procmon's mpstat, netstat and diskstat.  The host lines are
the JAX package's, character for character, over the same files; the GPU
lines name the card and read the allocator's bytes; a cluster frame
stacks its hosts; the verb's exit codes."""

import gzip
import json
import os
import time

import pytest

from sofa_tpu import top as jax_top
from sofa_tpu_torch import top
from sofa_tpu_torch.config import SofaConfig

CARD = "NVIDIA H100 80GB HBM3"
LIMIT = 85_000_000_000


def seed_logdir(d, now, rank=None, frozen=False, name=True, age=0.5):
    """A logdir mid-recording: two sampler ticks (the newest ``age`` s
    old), two mpstat, netstat and diskstat samples a second apart."""
    os.makedirs(d, exist_ok=True)
    mon = "gpumon.txt" if rank is None else f"gpumon.rank{rank}.txt"
    t1 = int((now - age) * 1e9)
    with open(os.path.join(d, mon), "w") as f:
        f.write(f"{t1 - 1_000_000_000} -1 0 0 0\n"
                f"{t1 - 1_000_000_000} 0 4000000000 {LIMIT} 5000000000\n"
                f"{t1} -1 0 0 0\n"
                f"{t1} 0 41040000000 {LIMIT} 41510000000\n"
                f"{t1} 0 12")                      # a torn last line
    if name:
        with open(os.path.join(d, mon + ".meta.json"), "w") as f:
            json.dump({"devices": {"0": CARD}}, f)
    with open(os.path.join(d, "mpstat.txt"), "w") as f:
        if frozen:
            f.write(f"{now - 1} cpuall 0 0 0 0 0 0 0 0\n"
                    f"{now} cpuall 0 0 0 0 0 0 0 0\n")
        else:
            f.write(f"{now - 1} cpu0 100 0 50 800 10 0 0 0\n"
                    f"{now} cpu0 160 0 70 820 12 0 0 0\n"
                    f"{now - 1} cpu1 10 0 5 900 0 0 0 0\n"
                    f"{now} cpu1 30 0 9 950 0 0 0 0\n")
    with open(os.path.join(d, "netstat.txt"), "w") as f:
        f.write(f"{now - 1} eth0 1000000 2000000 10 20\n"
                f"{now} eth0 5000000 4000000 40 50\n"
                f"{now - 1} ib0 0 0 0 0\n{now} ib0 2048 1024 2 1\n")
    with open(os.path.join(d, "diskstat.txt"), "w") as f:
        f.write(f"{now - 1} sda 10 2048 5 20 4096 9 0\n"
                f"{now} sda 30 6144 9 40 12288 15 0\n")


@pytest.mark.parametrize("maker", ["_cpu_line", "_net_line", "_disk_line"])
def test_host_lines_equal_jax(tmp_path, maker):
    d = str(tmp_path / "run")
    seed_logdir(d, time.time())
    got = getattr(top, maker)(d)
    assert got is not None and got == getattr(jax_top, maker)(d)


def test_gpu_line_names_the_card_and_reads_the_sampler(tmp_path):
    d = str(tmp_path / "run")
    now = time.time()
    seed_logdir(d, now)
    frame = top.render_frame(d, now=now)
    lines = frame.splitlines()
    gpu = next(ln for ln in lines if ln.startswith("gpu0 "))
    assert CARD in gpu and "41.04/85.00 GB" in gpu and "48.3%" in gpu
    assert "peak 41.51 GB" in gpu
    beat = next(ln for ln in lines if "sample" in ln)
    assert "0.5s ago" in beat and beat.endswith("live")
    assert "cpu    [" in frame and "net    eth0" in frame
    assert "disk   read 2.0 MiB/s" in frame
    assert "mem@" not in frame          # no snapshot yet


def test_a_stale_sample_says_so(tmp_path):
    d = str(tmp_path / "run")
    now = time.time()
    seed_logdir(d, now, age=12.0)
    frame = top.render_frame(d, now=now)
    assert "STALE (12s)" in frame and top.LIVE_S == 5.0


def test_ranks_get_a_line_each_and_the_topology_names_a_finished_run(
        tmp_path):
    d = str(tmp_path / "run")
    now = time.time()
    seed_logdir(d, now, rank=0, name=False)
    seed_logdir(d, now, rank=1, name=False)
    assert not os.path.exists(os.path.join(d, "gpumon.txt"))
    with open(os.path.join(d, "gpu_topo.json"), "w") as f:
        json.dump({"devices": [{"index": 0, "name": CARD}]}, f)
    frame = top.render_frame(d, now=now)
    assert f"rank0 gpu0 {CARD}" in frame and f"rank1 gpu0 {CARD}" in frame
    assert frame.count("sample") == 2


def test_without_a_sampler_file(tmp_path):
    d = str(tmp_path / "run")
    os.makedirs(d)
    assert "no gpumon file" in top.render_frame(d)


def test_frozen_proc_stat_is_not_measured(tmp_path):
    d = str(tmp_path / "run")
    seed_logdir(d, time.time(), frozen=True)
    assert top._cpu_line(d).startswith("cpu    not measured")


def test_memory_pane_from_the_sampler_snapshot(tmp_path):
    from sofa_tpu_torch.collectors import gpumon

    d = str(tmp_path / "run")
    seed_logdir(d, time.time())
    samples = [([("loss.backward", "train.py", 40)], "cuda:0", "buffer", 3,
                30 * 2 ** 30),
               ([("load", "data.py", 9)], "cuda:0", "buffer", 1, 2 ** 30)]
    for name in ("memprof.pb.gz", "memprof.rank1.pb.gz"):
        with open(os.path.join(d, name), "wb") as f:
            f.write(gzip.compress(gpumon._ns["_pprof_encode"](samples)))
        with open(os.path.join(d, name + ".meta.json"), "w") as f:
            json.dump({"trigger": "peak"}, f)
    frame = top.render_frame(d)
    assert "mem@peak  top sites:" in frame
    assert "mem@peak.rank1  top sites:" in frame
    assert "32.21 GB" in frame and "loss.backward" in frame
    # decoded once: the next frame reads the pane from the cache
    assert os.path.join(d, "memprof.pb.gz") in top._MEM_CACHE
    assert top._mem_lines(d) == [ln for ln in frame.splitlines()
                                 if ln.startswith(("mem@", "       "))]


def test_cluster_frame_stacks_the_hosts(tmp_path):
    base = str(tmp_path / "c")
    now = time.time()
    seed_logdir(base + "-ha", now)
    cfg = SofaConfig(logdir=base, cluster_hosts=["ha", "hb"])
    frame = top.render_cluster_frame(cfg, now=now)
    assert "sofa top — ha" in frame and "sofa top — hb   (no logdir yet)" \
        in frame
    from sofa_tpu_torch.printing import SofaUserError

    with pytest.raises(SofaUserError, match="no host logdirs"):
        top.render_cluster_frame(SofaConfig(logdir=str(tmp_path / "x"),
                                            cluster_hosts=["a"]))


def test_the_verb(tmp_path, capsys):
    from sofa_tpu_torch.cli import main

    d = str(tmp_path / "run")
    seed_logdir(d, time.time())
    assert main(["top", "--logdir", d, "--once"]) == 0
    assert CARD in capsys.readouterr().out
    assert main(["top", "--logdir", str(tmp_path / "none"), "--once"]) == 1
    assert main(["top", "--cluster_hosts", "zz", "--logdir",
                 str(tmp_path / "none"), "--once"]) == 1
