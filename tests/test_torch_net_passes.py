"""The port's network and concurrency passes against the JAX package's.

One pcap of IPv4 and IPv6 packets goes through both packages' pcap
ingest, one netstat.txt and one mpstat.txt through both ``procfs``
parsers; the device's activity is JAX ``tputrace`` category-0 rows and
port ``gputrace`` KERNEL rows of equal times (each with copy rows the
passes must ignore), its utilization JAX ``tpuutil`` ``tc_util`` and port
``gpuutil`` ``kernel_util`` rows of equal values.  ``netbandwidth_profile``,
``net_profile``, ``dcn_step_correlation`` and ``_busy_bins`` give the JAX
features (atol 1e-12) and a byte-identical ``netrank.csv``;
``concurrency_breakdown`` the same class per window and the same
``performance.csv``, ``elapsed_*_ratio`` and ``corr_*``, under the name
map tpu -> gpu (``elapsed_tpu_ratio`` -> ``elapsed_gpu_ratio``,
``corr_tpu_*`` -> ``corr_gpu_*``, the column ``tpu_util`` -> ``gpu_util``,
the class ``tpu`` -> ``gpu``).  Then the iowait and idle-wall hints fire
from frames through the pass.
"""

import ipaddress
import struct

import numpy as np
import pandas as pd
import pytest

from sofa_tpu.analysis import comm as jax_comm
from sofa_tpu.analysis import concurrency as jax_conc
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.ingest import pcap as jax_pcap
from sofa_tpu.ingest import procfs as jax_procfs
from sofa_tpu.trace import make_frame as jax_make_frame
from sofa_tpu_torch.analysis import advice, comm, concurrency
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import pcap, procfs
from sofa_tpu_torch.trace import CopyKind, make_frame

TB = 1_700_000_000.0            # the run's time base


def _pcap(packets):
    out = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    for ts, data in packets:
        out += struct.pack("<IIII", int(ts), int(round((ts % 1) * 1e6)),
                           len(data), len(data))
        out += data
    return out


def _ipv4(src, dst, size, proto=6, dport=443):
    payload = b"x" * size
    hdr = struct.pack(
        "!BBHHHBBH4s4s", 0x45, 0, 20 + 4 + len(payload), 0, 0, 64, proto, 0,
        ipaddress.IPv4Address(src).packed, ipaddress.IPv4Address(dst).packed)
    return (b"\x00" * 12 + struct.pack("!H", 0x0800) + hdr
            + struct.pack("!HH", 1234, dport) + payload)


def _ipv6(src, dst, size, proto=17, dport=8471):
    l4 = struct.pack("!HH", 1234, dport) + b"y" * size
    hdr = struct.pack("!IHBB16s16s", 6 << 28, len(l4), proto, 64,
                      ipaddress.IPv6Address(src).packed,
                      ipaddress.IPv6Address(dst).packed)
    return b"\x00" * 12 + struct.pack("!H", 0x86DD) + hdr + l4


def _packets(seed=0):
    """8 s of traffic: a v4 flow in bursts that follow the device's busy
    half-seconds, a steady v4 flow, a v6 flow and a few strays."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(16):
        t = TB + 0.5 * i
        if i % 2 == 0:
            for k in range(6):
                out.append((t + 0.05 * k, _ipv4("10.0.0.1", "10.0.0.2",
                                                int(rng.integers(800, 1400)))))
        out.append((t + 0.25, _ipv4("10.0.0.3", "10.0.0.4", 300)))
        out.append((t + 0.3 + 0.1 * rng.random(),
                    _ipv6("fd00::1", "fd00::2", int(rng.integers(50, 900)))))
    out.append((TB + 3.3, _ipv6("fd00::2", "fd00::1", 60, proto=6, dport=22)))
    out.append((TB + 7.9, _ipv4("192.168.1.9", "10.0.0.1", 40, proto=17)))
    return sorted(out, key=lambda p: p[0])


def _netstat(seed=1, n=81, rate=10):
    rng = np.random.default_rng(seed)
    rx = tx = rxp = txp = 0
    lines = []
    for i in range(n):
        ts = TB + i / rate
        rx += int(rng.integers(0, 2 * 10 ** 6))
        tx += int(rng.integers(0, 2 * 10 ** 6)) * (2 if (i // 5) % 2 else 1)
        rxp += 7
        txp += 9
        lines.append(f"{ts:.6f} eth0 {rx} {tx} {rxp} {txp}")
    return "\n".join(lines) + "\n"


def _mpstat(seed=2, n=81, rate=10):
    """Two cores whose dominant activity moves between user, system,
    iowait and idle."""
    rng = np.random.default_rng(seed)
    cpus = {c: np.zeros(8, dtype=np.int64) for c in ("cpu0", "cpu1")}
    lines = []
    for i in range(n):
        ts = TB + i / rate
        phase = (i // 10) % 4
        for c in cpus:
            # usr, sys, iowait, then a phase of idle alone
            inc = rng.integers(0, 3, 8) if phase < 3 else \
                np.zeros(8, dtype=np.int64)
            inc[[0, 2, 4, 3][phase]] += 8
            cpus[c] += inc
        for name, vals in [("cpuall", sum(cpus.values()))] + list(
                cpus.items()):
            lines.append(f"{ts:.6f} {name} " + " ".join(map(str, vals)))
    return "\n".join(lines) + "\n"


def _device(seed=3):
    """Busy and quiet half-seconds, as (start, duration) rows relative to
    TB, and a few copies."""
    rng = np.random.default_rng(seed)
    kern, copies = [], []
    for i in range(16):
        t = 0.5 * i
        busy = 0.45 if i % 2 == 0 else 0.04
        for k in range(5):
            kern.append((t + busy * k / 5, busy / 5 * rng.uniform(0.6, 1.0)))
        copies.append((t + 0.47, 0.01))
    return kern, copies


def _util(seed=4, n=80):
    rng = np.random.default_rng(seed)
    ts = np.arange(n) * 0.1 + 0.05
    util = np.where((np.arange(n) // 5) % 2 == 0, 60.0, 0.2) \
        + rng.uniform(0, 5, n)
    util[30:40] = 0.1                    # a window the host must win
    hbm = util * 20 + rng.uniform(0, 10, n)
    return ts, util, hbm


@pytest.fixture
def both(tmp_path):
    """(port frames, port cfg, JAX frames, JAX cfg) over the same inputs."""
    kern, copies = _device()
    out = []
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        (d / "sofa.pcap").write_bytes(_pcap(_packets()))
        ts, util, hbm = _util()
        if side == "port":
            cfg = SofaConfig(logdir=str(d))
            frames = {
                "nettrace": pcap.ingest_pcap(str(d / "sofa.pcap"), TB),
                "netbandwidth": procfs.parse_netstat(_netstat(), TB),
                "mpstat": procfs.parse_mpstat(_mpstat(), TB),
                "gputrace": make_frame(
                    [{"timestamp": s, "duration": du, "deviceId": 0,
                      "copyKind": int(CopyKind.KERNEL), "name": "k"}
                     for s, du in kern]
                    + [{"timestamp": s, "duration": du, "deviceId": 0,
                        "copyKind": int(CopyKind.H2D), "name": "Memcpy HtoD"}
                       for s, du in copies]),
                "gpuutil": make_frame(
                    [{"timestamp": t, "event": u, "name": "kernel_util"}
                     for t, u in zip(ts, util)]
                    + [{"timestamp": t, "event": h, "name": "hbm_gbps"}
                       for t, h in zip(ts, hbm)]),
            }
        else:
            cfg = JaxConfig(logdir=str(d))
            frames = {
                "nettrace": jax_pcap.ingest_pcap(str(d / "sofa.pcap"), TB),
                "netbandwidth": jax_procfs.parse_netstat(_netstat(), TB),
                "mpstat": jax_procfs.parse_mpstat(_mpstat(), TB),
                "tputrace": jax_make_frame(
                    [{"timestamp": s, "duration": du, "deviceId": 0,
                      "category": 0, "name": "k", "device_kind": "tpu"}
                     for s, du in kern]
                    + [{"timestamp": s, "duration": du, "deviceId": 0,
                        "category": 1, "name": "copy", "device_kind": "tpu"}
                       for s, du in copies]),
                "tpuutil": jax_make_frame(
                    [{"timestamp": t, "event": u, "name": "tc_util"}
                     for t, u in zip(ts, util)]
                    + [{"timestamp": t, "event": h, "name": "hbm_gbps"}
                       for t, h in zip(ts, hbm)]),
            }
        out += [frames, cfg]
    return out


def _gpu_name(name: str) -> str:
    """A JAX feature name under the port's names (tpu -> gpu)."""
    return name.replace("elapsed_tpu_", "elapsed_gpu_").replace(
        "corr_tpu_", "corr_gpu_")


def _same_features(got: Features, ref: JaxFeatures):
    names = [_gpu_name(n) for n, _v in ref._rows]
    assert [n for n, _v in got._rows] == names
    np.testing.assert_allclose([v for _n, v in got._rows],
                               [v for _n, v in ref._rows], rtol=0,
                               atol=1e-12)
    assert got._info == ref._info


def test_the_inputs_cross_both_ingests_alike(both):
    port, _pcfg, jax, _jcfg = both
    for name in ("nettrace", "netbandwidth", "mpstat"):
        pd.testing.assert_frame_equal(port[name], jax[name])
    assert (port["nettrace"]["pkt_src"] >= 10 ** 12).any()    # v6 interned
    assert len(port["nettrace"]) >= 8


@pytest.mark.parametrize("name", ["netbandwidth_profile", "net_profile"])
def test_net_pass_matches_jax(both, name):
    port, pcfg, jax, jcfg = both
    got, ref = Features(), JaxFeatures()
    getattr(comm, name)(port, pcfg, got)
    getattr(jax_comm, name)(jax, jcfg, ref)
    assert got._rows
    _same_features(got, ref)
    if name == "net_profile":
        with open(pcfg.path("netrank.csv"), "rb") as a, \
                open(jcfg.path("netrank.csv"), "rb") as b:
            text = a.read()
            assert text == b.read()
        rank = pd.read_csv(pcfg.path("netrank.csv"))
        assert "corr_step" in rank.columns and "fd00::1" in set(rank["src"])
        assert got.get("dcn_top_peer_corr") is not None
        assert dict(got._info)["dcn_top_peer"] == "10.0.0.1->10.0.0.2"


def test_net_profile_without_a_device_trace_matches_jax(both):
    port, pcfg, jax, jcfg = both
    got, ref = Features(), JaxFeatures()
    comm.net_profile({"nettrace": port["nettrace"]}, pcfg, got)
    jax_comm.net_profile({"nettrace": jax["nettrace"]}, jcfg, ref)
    _same_features(got, ref)
    with open(pcfg.path("netrank.csv"), "rb") as a, \
            open(jcfg.path("netrank.csv"), "rb") as b:
        assert a.read() == b.read()
    assert "corr_step" not in pd.read_csv(pcfg.path("netrank.csv")).columns


@pytest.mark.parametrize("n_bins", [16, 64])
def test_dcn_step_correlation_matches_jax(both, n_bins):
    port, _pcfg, jax, _jcfg = both
    got = comm.dcn_step_correlation(port, n_bins=n_bins)
    ref = jax_comm.dcn_step_correlation(jax, n_bins=n_bins)
    assert got is not None and got == pytest.approx(ref, abs=1e-12)
    assert comm.dcn_step_correlation({"gputrace": port["gputrace"]}) is None
    # copies are not the device's busy time
    only_copies = dict(port, gputrace=port["gputrace"][
        port["gputrace"]["copyKind"] != int(CopyKind.KERNEL)])
    assert comm.dcn_step_correlation(only_copies) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_busy_bins_match_jax_and_brute_force(seed):
    rng = np.random.default_rng(seed)
    m = 400
    s = np.sort(rng.uniform(0, 10, m))
    d = rng.exponential(0.8, m)
    ops = make_frame({"timestamp": s, "duration": d})
    # the grid spans the rows, as the passes build it
    edges = np.linspace(s.min(), (s + d).max(), 65)
    got = comm._busy_bins(ops, edges)
    assert np.array_equal(got, jax_comm._busy_bins(ops, edges))
    brute = np.array([np.maximum(np.clip(s + d, lo, hi)
                                 - np.clip(s, lo, hi), 0).sum()
                      for lo, hi in zip(edges[:-1], edges[1:])])
    np.testing.assert_allclose(got, brute, rtol=0, atol=1e-9)


@pytest.mark.parametrize("roi", [None, (1.2, 6.4)], ids=["run", "roi"])
@pytest.mark.parametrize("rate", [10, 4])
def test_concurrency_breakdown_matches_jax(both, roi, rate):
    port, pcfg, jax, jcfg = both
    for cfg in (pcfg, jcfg):
        cfg.sys_mon_rate = rate
        if roi:
            cfg.roi_begin, cfg.roi_end = roi
    got, ref = Features(), JaxFeatures()
    concurrency.concurrency_breakdown(port, pcfg, got)
    jax_conc.concurrency_breakdown(jax, jcfg, ref)
    _same_features(got, ref)
    mine = pd.read_csv(pcfg.path("performance.csv"))
    theirs = pd.read_csv(jcfg.path("performance.csv")).rename(
        columns={"tpu_util": "gpu_util"})
    theirs["class"] = theirs["class"].replace("tpu", "gpu")
    pd.testing.assert_frame_equal(mine, theirs, check_exact=True)
    # every class occurs, and the five ratios cover the windows
    assert set(mine["class"]) == set(concurrency.CLASSES)
    ratios = [got.get(f"elapsed_{c}_ratio") for c in concurrency.CLASSES]
    assert abs(sum(ratios) - 1.0) < 1e-9
    assert got.get("breakdown_windows") == len(mine)
    assert got.by_regex(r"corr_gpu_\w+")


@pytest.mark.parametrize("threshold", [0.05, 0.3])
def test_concurrency_breakdown_idle_threshold_matches_jax(both, threshold):
    """--is_idle_threshold above the default: more windows are idle, and
    performance.csv and the ratios stay the JAX package's."""
    port, pcfg, jax, jcfg = both
    pcfg.is_idle_threshold = jcfg.is_idle_threshold = threshold
    got, ref = Features(), JaxFeatures()
    concurrency.concurrency_breakdown(port, pcfg, got)
    jax_conc.concurrency_breakdown(jax, jcfg, ref)
    _same_features(got, ref)
    mine = pd.read_csv(pcfg.path("performance.csv"))
    theirs = pd.read_csv(jcfg.path("performance.csv")).rename(
        columns={"tpu_util": "gpu_util"})
    theirs["class"] = theirs["class"].replace("tpu", "gpu")
    pd.testing.assert_frame_equal(mine, theirs, check_exact=True)
    default = Features()
    pcfg.is_idle_threshold = SofaConfig().is_idle_threshold
    concurrency.concurrency_breakdown(port, pcfg, default)
    assert got.get("elapsed_idl_ratio") > default.get("elapsed_idl_ratio")


def test_concurrency_breakdown_without_device_frames_matches_jax(both):
    port, pcfg, jax, jcfg = both
    got, ref = Features(), JaxFeatures()
    concurrency.concurrency_breakdown({"mpstat": port["mpstat"]}, pcfg, got)
    jax_conc.concurrency_breakdown({"mpstat": jax["mpstat"]}, jcfg, ref)
    _same_features(got, ref)
    assert got.get("elapsed_gpu_ratio") == 0.0
    assert not got.by_regex(r"corr_gpu_\w+")


def _hint_frames(dominant: int):
    """mpstat of a host whose one counter (4 iowait, 3 idle) dominates
    every interval."""
    lines = []
    vals = np.zeros(8, dtype=np.int64)
    for i in range(30):
        vals[dominant] += 50
        vals[0] += 0 if dominant == 3 else 1     # idle: nothing else runs
        lines.append(f"{TB + 0.1 * i:.6f} cpuall " + " ".join(map(str, vals)))
    return {"mpstat": procfs.parse_mpstat("\n".join(lines) + "\n", TB)}


@pytest.mark.parametrize("dominant,hint", [
    (4, "I/O-wait dominates"), (3, "of wall time is idle")],
    ids=["iowait", "idle"])
def test_iowait_and_idle_hints_fire_from_frames(tmp_path, dominant, hint):
    cfg = SofaConfig(logdir=str(tmp_path))
    feats = Features()
    concurrency.concurrency_breakdown(_hint_frames(dominant), cfg, feats)
    hints = advice.generate_hints(feats, cfg)
    assert [h for h in hints if hint in h], hints
    # and they stay silent on a GPU busier than any host counter
    busy = Features()
    frames = _hint_frames(dominant)
    ts = np.arange(30) * 0.1
    frames["gpuutil"] = make_frame({"timestamp": ts, "event": 99.5 + 0 * ts,
                                    "name": ["kernel_util"] * 30})
    concurrency.concurrency_breakdown(frames, cfg, busy)
    assert busy.get("elapsed_gpu_ratio") > 0.9
    assert not [h for h in advice.generate_hints(busy, cfg) if hint in h]
