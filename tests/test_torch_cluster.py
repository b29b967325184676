"""``record`` and ``report`` over several hosts (``--cluster_hosts``), held
against the JAX package's.

``_record_flags`` round-trips every record field of the port's config
through the port's CLI parser (a config field that is neither forwarded
nor listed here as not a record field fails the test).  Two ``localhost``
hosts record at once (the JAX rendezvous test); a host's failure folds
into the exit code; the remote leg runs ``python3 -m sofa_tpu_torch
record`` through ssh/scp PATH stubs and never probes for a ``sofa``
console script.  ``cluster_analyze`` over two hosts whose clocks differ by
5 s: the shift is 5.0, and the merged host series (``mpstat``,
``netbandwidth``) equal the JAX ``cluster_analyze``'s over the same raw
files, key by key, as ``cluster_summary.csv`` does in its shared columns.
"""

import dataclasses
import json
import os
import re
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

from sofa_tpu.analyze import cluster_analyze as jax_cluster_analyze
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.preprocess import sofa_preprocess as jax_preprocess
from sofa_tpu_torch.analyze import (cluster_analyze, cluster_clock_shifts,
                                    cluster_host_cfgs)
from sofa_tpu_torch.cli import build_parser, config_from_args
from sofa_tpu_torch.cli import main as cli_main
from sofa_tpu_torch.config import Filter, SofaConfig
from sofa_tpu_torch.preprocess import sofa_preprocess
from sofa_tpu_torch.record import _record_flags, cluster_record
from sofa_tpu_torch.trace import read_report_js_doc

# Fields of SofaConfig that are not forwarded to the per-host records,
# and why.  Every other field is a record field and must round-trip.
NOT_FORWARDED = {
    "logdir": "each host records into <logdir>-<host>/",
    "pid": "an attach names a process of one host",
    "cluster_hosts": "each host records alone",
    "py_stack_rate": "no CLI flag, as in the JAX package",
    "enable_vmstat": "no CLI flag, as in the JAX package",
    "jobs": "preprocess's pools", "ingest_cache": "preprocess's cache",
    "profile_region": "analyze", "spotlight": "analyze",
    "roi_begin": "analyze", "roi_end": "analyze",
    "viz_downsample_to": "the board", "enable_tiles": "the board",
    "viz_port": "the board", "viz_bind": "the board",
    "cpu_filters": "the board", "gpu_filters": "the board",
    "tile_levels": "the board",
    "cpu_time_offset_ms": "preprocess", "gpu_time_offset_ms": "preprocess",
    "trace_format": "preprocess",
    "is_idle_threshold": "analyze", "hint_server": "analyze",
    "plugins": "loaded by the verb itself, before it runs",
    "num_iterations": "analyze", "num_swarms": "analyze",
    "enable_aisi": "analyze", "enable_hsg": "analyze",
    "enable_swarms": "analyze", "iterations_from": "analyze",
    "base_logdir": "diff", "match_logdir": "diff", "whatif_apply": "whatif",
    "live_interval_s": "live", "live_epochs": "live", "live_stall_s": "live",
    "archive_root": "archive", "archive_label": "archive",
    "archive_keep": "archive", "archive_keep_days": "archive",
    "archive_limit": "archive", "archive_since": "archive",
    "archive_host": "archive", "regress_rolling": "regress",
    "regress_pct": "regress", "regress_threshold": "regress",
}
# Values the type alone does not give (a choice, a spec).
VALUES = {"perf_call_graph": "fp", "inject_faults": "procmon:die@2s",
          "netstat_interface": "eth9", "blkdev": "/dev/sdz",
          "perf_events": "cycles,instructions",
          "epilogue_deadline_s": 7.5, "kineto_host_tracer_level": 0}


def _record_fields():
    return [f for f in dataclasses.fields(SofaConfig)
            if f.name not in NOT_FORWARDED]


def _changed(field):
    base = getattr(SofaConfig(), field.name)
    if field.name in VALUES:
        return VALUES[field.name]
    if isinstance(base, bool):
        return not base
    if isinstance(base, int):
        return base + 3
    if isinstance(base, float):
        return base + 2.5
    raise AssertionError(f"no test value for the new field {field.name}: "
                         "forward it in _record_flags or list it in "
                         "NOT_FORWARDED")


def _roundtrip(cfg):
    args = build_parser().parse_intermixed_args(
        ["record", "true", "--logdir", "/x/"] + _record_flags(cfg))
    return config_from_args(args)


@pytest.mark.parametrize("field", [f.name for f in _record_fields()])
def test_record_flags_round_trip_each_record_field(field):
    f = next(f for f in _record_fields() if f.name == field)
    cfg = SofaConfig()
    setattr(cfg, field, _changed(f))
    flags = _record_flags(cfg)
    assert flags, f"{field} is not forwarded"
    back = _roundtrip(cfg)
    assert getattr(back, field) == getattr(cfg, field)
    # nothing else moved
    for other in dataclasses.fields(SofaConfig):
        if other.name not in (field, "logdir"):
            assert getattr(back, other.name) == \
                getattr(SofaConfig(), other.name), other.name


def test_record_flags_round_trip_all_at_once_and_defaults_give_none():
    assert _record_flags(SofaConfig()) == []
    cfg = SofaConfig()
    for f in _record_fields():
        setattr(cfg, f.name, _changed(f))
    back = _roundtrip(cfg)
    for f in _record_fields():
        assert getattr(back, f.name) == getattr(cfg, f.name), f.name
    # NOT_FORWARDED names fields that exist
    names = {f.name for f in dataclasses.fields(SofaConfig)}
    assert set(NOT_FORWARDED) <= names
    assert isinstance(SofaConfig().cpu_filters[0], Filter)


def test_cluster_hosts_flag_parses_a_comma_list():
    args = build_parser().parse_intermixed_args(
        ["report", "--cluster_hosts", "a,b,,127.0.0.1"])
    assert config_from_args(args).cluster_hosts == ["a", "b", "127.0.0.1"]
    cfg = SofaConfig(logdir="/r/run/", cluster_hosts=["h1", "h2"])
    assert [(i, h, c.logdir) for i, h, c in cluster_host_cfgs(cfg)] == [
        (0, "h1", "/r/run-h1/"), (1, "h2", "/r/run-h2/")]
    assert cluster_clock_shifts({"a": 10.0, "b": 15.5, "c": 0.0}) == \
        (10.0, {"a": 0.0, "b": 5.5, "c": 0.0})


def test_cluster_record_two_localhost_hosts_meet(tmp_path):
    """Both hosts' children must see each other: serial launches would
    time the first one out with rc 7.  Each child dumps its environment,
    so that the forwarded flags show in its collectors' injection."""
    base = str(tmp_path / "clog") + "/"
    sync = tmp_path / "sync"
    sync.mkdir()
    cfg = SofaConfig(logdir=base, cluster_hosts=["localhost", "127.0.0.1"],
                     enable_kineto=False, gpu_mon_rate=7, sys_mon_rate=20)
    command = (f"env > {sync}/env.$$; touch {sync}/$$.here; n=0; "
               f"while [ $(find {sync} -name '*.here' | wc -l) -lt 2 ]; do "
               f"n=$((n+1)); [ $n -gt 300 ] && exit 7; sleep 0.1; done")
    assert cluster_record(command, cfg) == 0
    assert len([f for f in os.listdir(sync) if f.endswith(".here")]) == 2
    envs = [open(sync / f).read() for f in os.listdir(sync)
            if f.startswith("env.")]
    assert len(envs) == 2
    for env in envs:
        assert '"enable": false' in env
        assert "SOFA_TORCH_GPUMON_HZ=7" in env
    for host in ("localhost", "127.0.0.1"):
        hdir = base.rstrip("/") + f"-{host}/"
        for name in ("sofa_time.txt", "mpstat.txt", "run_manifest.json"):
            assert os.path.isfile(os.path.join(hdir, name)), (host, name)
        misc = dict(line.split()
                    for line in open(os.path.join(hdir, "misc.txt")))
        assert misc["rc"] == "0"
    assert not os.path.exists(base)         # the hosts' logdirs only


def test_cluster_record_folds_a_host_failure_into_the_exit_code(tmp_path):
    cfg = SofaConfig(logdir=str(tmp_path / "c") + "/",
                     cluster_hosts=["localhost"], enable_kineto=False)
    assert cluster_record("exit 3", cfg) == 3
    # through the CLI too, which dispatches record to cluster_record
    assert cli_main(["record", "--cluster_hosts", "localhost", "--logdir",
                     str(tmp_path / "d"), "--disable_kineto",
                     "exit 4"]) == 4
    assert os.path.isfile(tmp_path / "d-localhost" / "misc.txt")


def _ssh_stubs(tmp_path):
    """PATH stubs for a remote host (this host has no sshd): ``ssh`` runs
    the remote command string through a shell, whose ``$TMPDIR`` is
    ``remote_tmp`` under ``tmp_path``, ``scp`` copies the "remote" logdir
    back, ``python3`` is a wrapper that execs this interpreter (a symlink
    to a venv's interpreter would lose its site-packages), and a ``sofa``
    that fails loudly, which the port must never call."""
    stubs = tmp_path / "stubs"
    stubs.mkdir()
    remote_tmp = tmp_path / "remote_tmp"
    remote_tmp.mkdir()
    seen = tmp_path / "ssh_calls.txt"
    (stubs / "ssh").write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import os, subprocess, sys
        host, remote = sys.argv[-2], sys.argv[-1]
        with open({str(seen)!r}, "a") as f:
            f.write(host + " :: " + remote + chr(10))
        if remote.startswith("rm -rf"):
            target = remote[len("rm -rf"):].strip()
            assert target.startswith({str(remote_tmp) + "/"!r}), target
        env = dict(os.environ, TMPDIR={str(remote_tmp)!r})
        sys.exit(subprocess.call(remote, shell=True, env=env))
        """))
    (stubs / "scp").write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import subprocess, sys
        src, dst = sys.argv[-2], sys.argv[-1]
        host, path = src.split(":", 1)
        sys.exit(subprocess.call(["cp", "-r", path, dst]))
        """))
    (stubs / "python3").write_text(
        f'#!/bin/sh\nexec {sys.executable} "$@"\n')
    (stubs / "sofa").write_text("#!/bin/sh\necho JAX-SOFA-CALLED; exit 99\n")
    for s in stubs.iterdir():
        os.chmod(s, os.stat(s).st_mode | stat.S_IEXEC)
    return stubs, seen, remote_tmp


def test_cluster_record_remote_leg_runs_the_port_module(tmp_path,
                                                        monkeypatch):
    stubs, seen, remote_tmp = _ssh_stubs(tmp_path)
    monkeypatch.setenv("PATH", f"{stubs}:{os.environ['PATH']}")
    base = str(tmp_path / "clog") + "/"
    cfg = SofaConfig(logdir=base, cluster_hosts=["gpu-host-9"],
                     enable_kineto=False, sys_mon_rate=25)
    assert cluster_record("sleep 0.1", cfg) == 0
    calls = open(seen).read().splitlines()
    assert len(calls) == 3
    # the host makes its own logdir under its $TMPDIR, records into it,
    # and removes it once fetched
    assert calls[0].startswith("gpu-host-9 :: mktemp -d ")
    launch = calls[1]
    m = re.match(r"gpu-host-9 :: python3 -m sofa_tpu_torch record "
                 r"'sleep 0\.1' --logdir (\S+) ", launch)
    assert m, launch
    remote_dir = m.group(1)
    assert remote_dir.startswith(f"{remote_tmp}/sofa_tpu_torch_record_")
    assert "--sys_mon_rate 25" in launch and "--disable_kineto" in launch
    assert "command -v" not in launch and "sofa record" not in launch
    assert calls[2] == f"gpu-host-9 :: rm -rf {remote_dir}"
    assert not os.path.exists(remote_dir)
    assert os.listdir(remote_tmp) == []
    # the real record's files, fetched into the host's logdir
    hdir = base.rstrip("/") + "-gpu-host-9/"
    for name in ("sofa_time.txt", "misc.txt", "mpstat.txt"):
        assert os.path.isfile(os.path.join(hdir, name)), name
    assert float(open(os.path.join(hdir, "sofa_time.txt")).read()) > 1e9


# --- cluster_analyze against the JAX package's ---------------------------------

T0 = 1_700_000_000.0
SKEWS = {"hostA": 0.0, "hostB": 5.0}


def _raw_host(d, skew, seed):
    """mpstat.txt, netstat.txt, sofa_time.txt and misc.txt of a 2 s run at
    10 Hz on a 2-core host with one NIC, made from ``seed``; the
    timestamps are the host's clock (its run starts at T0 + skew)."""
    rng = np.random.default_rng(seed)
    os.makedirs(d)
    tb = T0 + skew
    with open(os.path.join(d, "sofa_time.txt"), "w") as f:
        f.write(f"{tb:.9f}\n")
    with open(os.path.join(d, "misc.txt"), "w") as f:
        f.write("elapsed_time 2.000000\ncores 2\npid 1\nrc 0\n")
    cpus = {c: np.zeros(8, dtype=np.int64) for c in ("cpu0", "cpu1")}
    rx = tx = rxp = txp = 0
    mp, nt = [], []
    for i in range(21):
        ts = tb + 0.05 + 0.1 * i
        for c in cpus:
            cpus[c] += rng.integers(0, 6, 8)
        total = sum(cpus.values())
        for name, vals in [("cpuall", total)] + list(cpus.items()):
            mp.append(f"{ts:.6f} {name} " + " ".join(str(v) for v in vals))
        rx += int(rng.integers(0, 10 ** 6))
        tx += int(rng.integers(0, 10 ** 6))
        rxp += 10
        txp += 12
        nt.append(f"{ts:.6f} eth0 {rx} {tx} {rxp} {txp}")
    with open(os.path.join(d, "mpstat.txt"), "w") as f:
        f.write("\n".join(mp) + "\n")
    with open(os.path.join(d, "netstat.txt"), "w") as f:
        f.write("\n".join(nt) + "\n")


def _merged(report_js):
    with open(report_js) as f:
        text = f.read()
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The same raw files under a port and a JAX cluster, each preprocessed
    and cluster-analyzed by its own package."""
    root = tmp_path_factory.mktemp("cluster")
    out = {}
    for side in ("port", "jax"):
        base = str(root / side / "run")
        for i, (host, skew) in enumerate(SKEWS.items()):
            _raw_host(f"{base}-{host}", skew, seed=i)
        if side == "port":
            cfg = SofaConfig(logdir=base + "/", cluster_hosts=list(SKEWS))
            pre = {h: sofa_preprocess(c) for _i, h, c in
                   cluster_host_cfgs(cfg)}
            feats = cluster_analyze(cfg, preloaded=pre)
        else:
            cfg = JaxConfig(logdir=base + "/", cluster_hosts=list(SKEWS))
            for host in SKEWS:
                jax_preprocess(JaxConfig(logdir=f"{base}-{host}/"))
            feats = jax_cluster_analyze(cfg)
        out[side] = (cfg, feats)
    return out


def test_cluster_report_shifts_the_late_host_by_five_seconds(clusters):
    from sofa_tpu_torch.preprocess import read_time_base

    cfg, feats = clusters["port"]
    assert set(feats) == set(SKEWS)
    bases = {h: read_time_base(c) for _i, h, c in cluster_host_cfgs(cfg)}
    assert cluster_clock_shifts(bases) == (T0, {"hostA": 0.0, "hostB": 5.0})
    doc = read_report_js_doc(cfg.path("report.js"))
    assert doc["meta"]["cluster_hosts"] == list(SKEWS)
    assert doc["meta"]["time_base"] == T0
    by_name = {s["name"]: s for s in doc["series"]}
    for series in ("mpstat", "netbandwidth"):
        xa = np.array(by_name[f"hostA_{series}"]["data"]["x"])
        xb = np.array(by_name[f"hostB_{series}"]["data"]["x"])
        assert len(xa) == len(xb) > 0
        assert np.allclose(xb - xa, 5.0, rtol=0, atol=1e-6)
        assert by_name[f"hostB_{series}"]["title"].startswith("[hostB] ")
    assert os.path.isfile(cfg.path("index.html"))  # the board is staged
    with open(cfg.path("report.js")) as f:
        assert f.read().startswith("sofa_traces = ")


@pytest.mark.parametrize("series", ["hostA_mpstat", "hostA_netbandwidth",
                                    "hostB_mpstat", "hostB_netbandwidth"])
def test_merged_host_series_equal_jax(clusters, series):
    port = {s["name"]: s for s in
            _merged(clusters["port"][0].path("report.js"))["series"]}
    jax = {s["name"]: s for s in
           _merged(clusters["jax"][0].path("report.js"))["series"]}
    assert series in port and series in jax
    for key in ("name", "title", "color", "kind"):
        assert port[series].get(key) == jax[series].get(key), key
    assert set(port[series]["data"]) == set(jax[series]["data"])
    for key, values in jax[series]["data"].items():
        assert port[series]["data"][key] == values, key


def test_cluster_summary_matches_jax_in_shared_columns(clusters):
    port = pd.read_csv(clusters["port"][0].path("cluster_summary.csv"))
    jax = pd.read_csv(clusters["jax"][0].path("cluster_summary.csv"))
    assert list(port["host"]) == list(jax["host"]) == list(SKEWS)
    shared = [c for c in port.columns if c in jax.columns]
    assert {"host", "elapsed_time", "cpu_util", "net_tx_total_bytes",
            "net_rx_total_bytes"} <= set(shared)
    pd.testing.assert_frame_equal(port[shared], jax[shared], rtol=0,
                                  atol=1e-12)
    # the columns the device names: neither side has a device trace
    assert not {"gpu0_kernel_time", "kernel_util_mean"} & set(port.columns)
    assert (port["elapsed_time"] == 2.0).all()


def test_report_cli_preprocesses_each_host_and_merges(tmp_path):
    base = str(tmp_path / "run")
    for i, (host, skew) in enumerate(SKEWS.items()):
        _raw_host(f"{base}-{host}", skew, seed=i)
    r = subprocess.run(
        [sys.executable, "-m", "sofa_tpu_torch", "report", "--logdir", base,
         "--cluster_hosts", ",".join(SKEWS), "--no_tiles"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("Complete!!") == 2
    for host in SKEWS:
        assert os.path.isfile(f"{base}-{host}/mpstat.csv")
        assert os.path.isfile(f"{base}-{host}/performance.csv")
    summary = pd.read_csv(os.path.join(base, "cluster_summary.csv"))
    assert len(summary) == 2
    doc = read_report_js_doc(os.path.join(base, "report.js"))
    assert doc["meta"]["cluster_hosts"] == list(SKEWS)
