"""The port's host parsers and host passes against the JAX package's.

Each parser of ``sofa_tpu_torch.ingest`` runs the same raw text as its
counterpart in ``sofa_tpu.ingest`` and the two frames must be equal, dtypes
included; each host pass must give the same features on the same frames.
The fixture texts are those of tests/test_ingest_procfs.py and
tests/test_ingest_misc.py (plus a few edge cases of the same shapes).
"""

import struct

import pandas as pd
import pytest

from sofa_tpu.analysis import host as jax_host
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.ingest import blktrace_parse as jax_blk
from sofa_tpu.ingest import pcap as jax_pcap
from sofa_tpu.ingest import perf_script as jax_perf
from sofa_tpu.ingest import procfs as jax_procfs
from sofa_tpu.ingest import strace_parse as jax_strace
from sofa_tpu.ingest import timebase_align as jax_tb
from sofa_tpu_torch.analysis import host
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.ingest import blktrace_parse, pcap, perf_script, procfs
from sofa_tpu_torch.ingest import strace_parse, timebase_align
from sofa_tpu_torch.trace import COLUMNS, packed_ip

T0 = 1000.0


def _mp(ts, cpu, vals):
    return f"{ts:.6f} {cpu} " + " ".join(str(v) for v in vals)


MPSTAT = "\n".join([
    _mp(T0, "cpuall", [100, 0, 100, 100, 0, 0, 0, 0]),
    _mp(T0, "cpu0", [100, 0, 100, 100, 0, 0, 0, 0]),
    _mp(T0, "cpu1", [7, 0, 7, 7, 0, 0, 0, 0]),
    _mp(T0 + 1, "cpuall", [150, 0, 125, 125, 0, 0, 0, 0]),
    _mp(T0 + 1, "cpu0", [150, 0, 125, 125, 0, 0, 0, 0]),
    _mp(T0 + 1, "cpu1", [7, 0, 7, 7, 0, 0, 0, 0]),     # no jiffies: idle
    _mp(T0 + 2, "cpuall", [190, 3, 140, 160, 4, 1, 1, 1]),
    "bogus",
    "1.0 cpu0 1 2",
])
DISKSTAT = "\n".join([
    f"{T0:.6f} vda 100 4096 500 50 0 0 0",
    f"{T0 + 1:.6f} vda 110 6144 550 50 0 0 0",
    f"{T0 + 2:.6f} vda 110 6144 550 60 800 40 1",
    f"{T0:.6f} idle0 5 5 5 5 5 5 0",
    f"{T0 + 1:.6f} idle0 5 5 5 5 5 5 0",
])
NETSTAT = "\n".join([
    f"{T0:.6f} eth0 1000 2000 10 20",
    f"{T0 + 2:.6f} eth0 3000 2000 30 20",
    f"{T0:.6f} eth1 5 5 1 1",
    f"{T0 + 2:.6f} eth1 5 5 1 1",
])
CPUINFO = f"{T0:.6f} 1000 3000\n{T0 + 10:.6f} 2000 4000\nbad\n"
VMSTAT = (
    "--procs-- -----memory---------- ---swap-- -----io---- -system-- "
    "------cpu-----\n"
    " r b swpd free buff cache si so bi bo in cs us sy id wa st "
    "gu date time\n"
    "r b swpd free buff cache si so bi bo in cs us sy id wa st\n"
    "1 0 0 100 200 300 0 0 5 6 100 200 10 5 84 1 0 2026-07-29 08:00:00\n"
    "2 0 0 100 200 300 0 0 7 8 110 210 20 6 73 1 0 2026-07-29 08:00:01\n"
)
VMSTAT_NO_DATE = (
    "r b swpd free buff cache si so bi bo in cs us sy id wa st\n"
    "1 0 0 100 200 300 0 0 5 6 100 200 10 5 84 1 0\n"
    "2 0 0 100 200 300 0 0 7 8 110 210 20 6 73 1 0\n"
)

PERF_SCRIPT = """\
# comm pid/tid cpu time period event ip sym dso
python 1234/1234 [000] 100.500000: 1010101 cycles: ffffffff81000000 do_syscall_64+0x20 ([kernel.kallsyms])
python 1234/1235 [001] 100.510000: 2020202 cycles: 00007f0000001000 PyEval_EvalFrameDefault+0x1b3 (/usr/bin/python3.12)
swapper 0/0 [000] 100.520000: 999 cycles: ffffffff81234567 [unknown] ([kernel.kallsyms])
garbage line that should be ignored
"""
PERF_CALLCHAIN = """\
python 1234/1234 [000] 100.500000: 1010101 cycles:
\tffffffff81000000 do_syscall_64+0x20 ([kernel.kallsyms])
\t00007f0000002000 __libc_read+0x10 (/usr/lib/libc.so.6)
\t00007f0000001000 PyEval_EvalFrameDefault+0x1b3 (/usr/bin/python3.12)
\t00007f0000000500 main+0x45 (/usr/bin/python3.12)
\t00007f0000000400 __libc_start_main+0x80 (/usr/lib/libc.so.6)

python 1234/1235 [001] 100.510000: 2020202 cycles:
\t00007f0000001000 PyEval_EvalFrameDefault+0x1b3 (/usr/bin/python3.12)

swapper 0/0 [000] 100.520000: 999 cycles: ffffffff81234567 flat_sample+0x1 ([kernel.kallsyms])
"""
STRACE = """\
77 00:00:01.000000 openat(AT_FDCWD, "/etc/hosts", O_RDONLY) = 3 <0.000123>
77 00:00:01.100000 clock_gettime(CLOCK_MONOTONIC, {...}) = 0 <0.000004>
77 00:00:01.200000 read(3, "x"..., 4096) = 4096 <0.000050>
78 00:00:01.300000 futex(0x7f, FUTEX_WAIT, 0, NULL) = 0 <0.500000>
77 00:00:01.400000 write(1, "y", 1) = 1 <0.0000001>
"""
PYSTACKS = (
    "10.5 111 mod.main;mod.step;mod.matmul\n"
    "10.6 111 mod.main;mod.step\n"
    "10.7 112 __main__.<module>;sofa_tpu_torch.workloads.transformer.main\n"
    "bad line\n"
)
BLKTRACE = """\
  8,0    3        1     0.000100000  1234  D   W 123456 + 8 [python]
  8,0    3        2     0.000500000  1234  D   R 999000 + 64 [python]
  8,0    1        3     0.002100000     0  C   W 123456 + 8 [0]
  8,0    1        4     0.010500000     0  C   R 999000 + 64 [0]
  8,0    3        5     0.020000000  1234  D   W 555000 + 16 [python]
  8,0    3        6     0.021000000  1234  Q   W 777000 + 8 [python]
  8,0    2        7     0.030000000  1234  D  RA 2048 + 256 [python]
  8,0    2        8     0.031000000     0  C  RA 2048 + 256 [0]
CPU0 (8,0):
 Reads Queued:           1,        32KiB
"""


def _pcap_blob(linktype: int, packets):
    out = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, linktype)
    for ts, data in packets:
        out += struct.pack("<IIII", int(ts), int((ts % 1) * 1e6), len(data),
                           len(data))
        out += data
    return out


def _ipv4(src, dst, proto=6, sport=1234, dport=443, payload=b"x" * 100):
    hdr = struct.pack(
        "!BBHHHBBH4s4s", 0x45, 0, 20 + 4 + len(payload), 0, 0, 64, proto, 0,
        bytes(int(o) for o in src.split(".")),
        bytes(int(o) for o in dst.split(".")))
    return hdr + struct.pack("!HH", sport, dport) + payload


def _ipv6(src, dst, proto=6, sport=1234, dport=443, payload=b"x" * 100,
          ext=b"", ext_type=0):
    import ipaddress

    l4 = struct.pack("!HH", sport, dport) + payload
    hdr = struct.pack(
        "!IHBB16s16s", 6 << 28, len(ext) + len(l4),
        ext_type if ext else proto, 64,
        ipaddress.IPv6Address(src).packed, ipaddress.IPv6Address(dst).packed)
    return hdr + ext + l4


ETH4 = b"\x00" * 12 + struct.pack("!H", 0x0800)
ETH6 = b"\x00" * 12 + struct.pack("!H", 0x86DD)
SLL4 = b"\x00" * 14 + struct.pack("!H", 0x0800)
PCAPS = {
    "ethernet_v4": _pcap_blob(1, [(5.25, ETH4 + _ipv4("10.0.0.1",
                                                      "10.0.0.2"))]),
    "sll_udp": _pcap_blob(113, [(1.0, SLL4 + _ipv4(
        "192.168.1.1", "192.168.1.2", proto=17, dport=53))]),
    "ethernet_v6": _pcap_blob(1, [
        (1.0, ETH6 + _ipv6("fd00::1", "fd00::2", dport=8471)),
        (2.0, ETH6 + _ipv6("fd00::2", "fd00::1", proto=17, dport=53))]),
    "v6_extension_headers": _pcap_blob(1, [(1.0, ETH6 + _ipv6(
        "2001:db8::a", "2001:db8::b", dport=9009,
        ext=bytes([6, 0]) + b"\x00" * 6))]),
    "raw_ip_mixed": _pcap_blob(101, [
        (1.0, _ipv4("10.0.0.3", "10.0.0.4")),
        (1.5, _ipv6("fd00::3", "fd00::4", proto=17))]),
    "garbage": b"not a pcap at all",
    "truncated_v6": _pcap_blob(1, [(1.0, ETH6 + b"\x60\x00")]),
}


def _same(port_df, jax_df):
    assert list(port_df.columns) == COLUMNS
    pd.testing.assert_frame_equal(port_df, jax_df)


@pytest.mark.parametrize("parser,text,kw", [
    ("parse_mpstat", MPSTAT, {"time_base": T0}),
    ("parse_mpstat", "bogus\n1.0 cpu0 1 2\n", {}),
    ("parse_diskstat", DISKSTAT, {"time_base": T0}),
    ("parse_diskstat", DISKSTAT, {"time_base": T0, "sector_bytes": 4096}),
    ("parse_netstat", NETSTAT, {"time_base": T0}),
    ("parse_cpuinfo", CPUINFO, {"time_base": T0}),
    ("parse_vmstat", VMSTAT, {"time_base": 0.0}),
    ("parse_vmstat", VMSTAT_NO_DATE, {"time_base": T0,
                                      "record_start": T0 + 5}),
], ids=["mpstat", "mpstat_garbage", "diskstat", "diskstat_4k_sectors",
        "netstat", "cpuinfo", "vmstat", "vmstat_no_date"])
def test_procfs_parser_matches_jax(parser, text, kw):
    got = getattr(procfs, parser)(text, **kw)
    assert not got.empty or parser == "parse_mpstat"
    _same(got, getattr(jax_procfs, parser)(text, **kw))


def test_procfs_load_and_mhz_interpolator_match_jax(tmp_path):
    path = tmp_path / "cpuinfo.txt"
    path.write_text(CPUINFO)
    got = procfs.load(str(path), procfs.parse_cpuinfo, T0)
    _same(got, jax_procfs.load(str(path), jax_procfs.parse_cpuinfo, T0))
    f, g = (procfs.cpu_mhz_interpolator(got),
            jax_procfs.cpu_mhz_interpolator(got))
    for t in (-1.0, 0.0, 5.0, 10.0, 11.0):
        assert f(t) == g(t)
    assert procfs.cpu_mhz_interpolator(got.iloc[:0])(3.0) == 2000.0
    assert procfs.load(str(tmp_path / "none.txt"),
                       procfs.parse_cpuinfo).empty


@pytest.mark.parametrize("text,kw", [
    (PERF_SCRIPT, {"time_base": 100.0, "mhz_at": lambda t: 1000.0}),
    (PERF_SCRIPT, {"time_base": 1100.0, "mono_to_unix": lambda t: t + 1000}),
    (PERF_CALLCHAIN, {"time_base": 100.0, "mhz_at": lambda t: 1000.0}),
    (PERF_CALLCHAIN + "garbage\n" + PERF_SCRIPT, {"time_base": 100.0}),
], ids=["flat", "clock_bridge", "callchains", "mixed_with_garbage"])
def test_parse_perf_script_matches_jax(text, kw):
    got = perf_script.parse_perf_script(text, **kw)
    assert not got.empty
    _same(got, jax_perf.parse_perf_script(text, **kw))


def test_ingest_perf_reads_a_converted_script(tmp_path):
    (tmp_path / "perf.script").write_text(PERF_SCRIPT)
    got = perf_script.ingest_perf(str(tmp_path), 100.0)
    _same(got, jax_perf.ingest_perf(str(tmp_path), 100.0))
    assert perf_script.ingest_perf(str(tmp_path / "none"), 0.0).empty


@pytest.mark.parametrize("min_time", [1e-6, 1e-4])
def test_parse_strace_matches_jax(min_time):
    kw = {"time_base": 0.0, "min_time": min_time, "day_origin": 0.0}
    got = strace_parse.parse_strace(STRACE, **kw)
    assert not got.empty
    _same(got, jax_strace.parse_strace(STRACE, **kw))


def test_parse_pystacks_matches_jax():
    got = strace_parse.parse_pystacks(PYSTACKS, time_base=10.0)
    assert len(got) == 3
    _same(got, jax_strace.parse_pystacks(PYSTACKS, time_base=10.0))


@pytest.mark.parametrize("name", sorted(PCAPS))
def test_parse_pcap_bytes_matches_jax(name):
    got = pcap.parse_pcap_bytes(PCAPS[name], time_base=0.5)
    _same(got, jax_pcap.parse_pcap_bytes(PCAPS[name], time_base=0.5))


def test_ingest_pcap_writes_the_same_address_table(tmp_path):
    for side, fn in (("port", pcap.ingest_pcap),
                     ("jax", jax_pcap.ingest_pcap)):
        (tmp_path / side).mkdir()
        path = tmp_path / side / "sofa.pcap"
        path.write_bytes(PCAPS["raw_ip_mixed"])
        fn(str(path))
    assert (tmp_path / "port" / "net_addrs.csv").read_text() == \
        (tmp_path / "jax" / "net_addrs.csv").read_text()
    assert packed_ip("10.0.0.1") == 10_000_000_001
    assert packed_ip("fd00::1") == -1
    bad = tmp_path / "bad.pcap"
    bad.write_bytes(b"\x00" * 30)
    with pytest.raises(ValueError, match="bad magic"):
        pcap.ingest_pcap(str(bad))


def test_parse_blktrace_matches_jax(tmp_path):
    got = blktrace_parse.parse_blktrace(BLKTRACE)
    assert len(got) == 3
    _same(got, jax_blk.parse_blktrace(BLKTRACE))
    (tmp_path / "blktrace.txt").write_text(BLKTRACE)
    _same(blktrace_parse.ingest_blktrace(str(tmp_path), 0.001),
          jax_blk.ingest_blktrace(str(tmp_path), 0.001))


@pytest.mark.parametrize("rows", [
    [f"{2_000_000_000 + i} {1_000_000_000 + i} 0 0" for i in range(3)],
    [f"{int(2_000_000_000 + m * 1e9 * 1.0001)} {int(1_000_000_000 + m * 1e9)}"
     " 0 0" for m in (0.0, 0.001, 100.0, 100.001)],
], ids=["offset", "drift"])
def test_timebase_converter_matches_jax(tmp_path, rows):
    p = tmp_path / "timebase.txt"
    p.write_text("\n".join(rows) + "\n")
    f = timebase_align.converter(str(p), "monotonic")
    g = jax_tb.converter(str(p), "monotonic")
    for t in (1.0, 1.5, 52.0, 101.0):
        assert f(t) == g(t)
    assert timebase_align.converter(str(tmp_path / "none.txt")) is None


def _host_frames():
    return {
        "mpstat": procfs.parse_mpstat(MPSTAT, time_base=T0),
        "vmstat": procfs.parse_vmstat(VMSTAT, time_base=0.0),
        "diskstat": procfs.parse_diskstat(DISKSTAT, time_base=T0),
        "blktrace": blktrace_parse.parse_blktrace(BLKTRACE),
        "strace": strace_parse.parse_strace(STRACE, time_base=0.0,
                                            day_origin=0.0),
        "pystacks": strace_parse.parse_pystacks(PYSTACKS, time_base=10.0),
        "cputrace": perf_script.parse_perf_script(
            PERF_CALLCHAIN + PERF_SCRIPT, time_base=100.0,
            mhz_at=lambda t: 1000.0),
    }


def _host_passes():
    """The host module's registered passes, in canonical order."""
    from sofa_tpu_torch.analysis import registry

    registry.load_builtin_passes()
    return [s.fn.__name__ for s in registry.registered()
            if s.fn.__module__ == host.__name__]


@pytest.mark.parametrize("name", _host_passes())
def test_host_pass_matches_jax(tmp_path, name):
    frames = _host_frames()
    got, ref = Features(), JaxFeatures()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    getattr(host, name)(frames, SofaConfig(logdir=str(tmp_path / "port")),
                        got)
    getattr(jax_host, name)(frames, JaxConfig(logdir=str(tmp_path / "jax")),
                            ref)
    assert got.to_frame().shape[0] > 0
    pd.testing.assert_frame_equal(got.to_frame(), ref.to_frame())
    # and the same artifacts (cpu_top.csv, disk_summary.csv, ...)
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for f in port_files:
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()
    # an absent frame is a silent no-op, as in the JAX package
    empty = Features()
    getattr(host, name)({}, SofaConfig(logdir=str(tmp_path)), empty)
    assert empty.to_frame().empty


def test_mpstat_profile_reads_cores_and_cpu_util():
    feats = Features()
    host.mpstat_profile(_host_frames(), SofaConfig(logdir="/unused/"), feats)
    assert feats.get("num_cores") == 2
    # cpuall: 50 and 40 usr, 25 and 15 sys jiffies of 100 in the two steps
    assert feats.get("mpstat_usr_pct") == pytest.approx(45.0)
    assert feats.get("cpu_util") == pytest.approx(0.65)


# /proc/stat as a sandbox shows it: the counters never advance
FROZEN_MPSTAT = "\n".join(
    _mp(T0 + i, cpu, [100, 0, 100, 100, 0, 0, 0, 0])
    for i in range(3) for cpu in ("cpuall", "cpu0", "cpu1"))


def test_mpstat_profile_matches_jax_on_moving_counters():
    """cpu_util is compared with the JAX pass only on counters that move
    (the fixture's cpuall advances every interval)."""
    frames = {"mpstat": procfs.parse_mpstat(MPSTAT, time_base=T0)}
    got, ref = Features(), JaxFeatures()
    host.mpstat_profile(frames, SofaConfig(logdir="/unused/"), got)
    jax_host.mpstat_profile(frames, JaxConfig(logdir="/unused/"), ref)
    assert got.get("cpu_util") == ref.get("cpu_util") == pytest.approx(0.65)


def test_frozen_proc_stat_gives_no_cpu_util(capsys):
    """A deliberate difference from the JAX package, which reads a frozen
    /proc/stat as an idle host (cpu_util 0.0): the port leaves cpu_util out
    and warns that the host CPU was not measured."""
    frames = {"mpstat": procfs.parse_mpstat(FROZEN_MPSTAT, time_base=T0)}
    got, ref = Features(), JaxFeatures()
    host.mpstat_profile(frames, SofaConfig(logdir="/unused/"), got)
    jax_host.mpstat_profile(frames, JaxConfig(logdir="/unused/"), ref)
    assert ref.get("cpu_util") == 0.0
    assert got.get("cpu_util") is None and got.get("mpstat_idl_pct") is None
    assert got.get("num_cores") == 2
    assert "host CPU was not measured" in capsys.readouterr().err


def test_preprocess_runs_the_jax_task_table_in_order(tmp_path):
    from sofa_tpu.preprocess import _ingest_tasks
    from sofa_tpu_torch.preprocess import KINETO_FRAMES, frame_names

    jax_names = [t.name for t in _ingest_tasks(JaxConfig(logdir=str(
        tmp_path)), 0.0, 1)]
    assert jax_names[-1] == "xplane"
    assert frame_names() == [n.replace("tpumon", "gpumon")
                             for n in jax_names[:-1]] + list(KINETO_FRAMES)


def test_preprocess_degrades_per_source(tmp_path, capsys):
    from sofa_tpu_torch.preprocess import sofa_preprocess

    cfg = SofaConfig(logdir=str(tmp_path))
    (tmp_path / "sofa_time.txt").write_text(f"{T0:.9f}\n")
    (tmp_path / "mpstat.txt").write_text(MPSTAT)
    (tmp_path / "sofa.pcap").write_bytes(b"\x00" * 30)     # corrupt
    frames = sofa_preprocess(cfg)
    assert "nettrace failed" in capsys.readouterr().err
    assert frames["nettrace"].empty and len(frames["mpstat"]) > 0
    _same(frames["mpstat"], jax_procfs.parse_mpstat(MPSTAT, time_base=T0))
    assert (tmp_path / "nettrace.csv").exists()
