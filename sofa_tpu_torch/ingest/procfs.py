"""Parsers for the procmon/sysmon sampler files and vmstat output.

Input formats are those of collectors/procmon.py (byte-identical to the JAX
package's sampler).  Counter files are cumulative; parsing differentiates
consecutive samples into rates, emitting typed rows.

Output row conventions (unified schema):
  mpstat:   one row per core per interval per metric; event = percent,
            deviceId = core index (-1 = all cores), name = metric
  diskstat: one row per device per interval per metric; event = value,
            name = "<dev>.<metric>", payload = bytes moved that interval
  netstat:  name = "<iface>.tx"/"<iface>.rx", event = bytes/s,
            payload = interval bytes
  cpu_mhz:  name = "cpu_mhz", event = mean MHz across cores
  vmstat:   name = vmstat column, event = value
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.trace import empty_frame, make_frame

MPSTAT_METRICS = ["usr", "nice", "sys", "idl", "iow", "irq", "sirq", "steal"]


def parse_mpstat(text: str, time_base: float = 0.0) -> pd.DataFrame:
    """mpstat.txt lines: ``<ts> cpu<id|all> u n s i io irq sirq st`` (jiffies)."""
    samples: Dict[str, List] = {}
    for line in text.splitlines():
        p = line.split()
        if len(p) != 10:
            continue
        try:
            ts = float(p[0])
            vals = np.array([int(v) for v in p[2:10]], dtype=np.int64)
        except ValueError:
            continue
        samples.setdefault(p[1], []).append((ts, vals))

    rows = []
    for cpu, series in samples.items():
        if cpu == "cpuall":
            device = -1
        else:
            try:
                device = int(cpu[3:])
            except ValueError:
                continue
        for (t0, v0), (t1, v1) in zip(series, series[1:]):
            delta = v1 - v0
            total = delta.sum()
            if t1 <= t0 or total < 0:
                continue
            for metric, d in zip(MPSTAT_METRICS, delta):
                if total > 0:
                    pct = 100.0 * float(d) / float(total)
                else:
                    # Jiffy counters did not advance this interval (sub-tick
                    # interval, or a sandboxed /proc/stat that reads all
                    # zeros): report the core as fully idle rather than
                    # dropping it, so the core inventory survives.
                    pct = 100.0 if metric == "idl" else 0.0
                rows.append(
                    {
                        "timestamp": t1 - time_base,
                        "event": pct,
                        "duration": t1 - t0,
                        "deviceId": device,
                        "payload": int(d),
                        "name": metric,
                        "device_kind": "cpu",
                    }
                )
    return make_frame(rows)


def parse_diskstat(text: str, time_base: float = 0.0,
                   sector_bytes: int = 512) -> pd.DataFrame:
    """diskstat.txt: ``<ts> <dev> rd_ios rd_sec rd_ms wr_ios wr_sec wr_ms inflight``."""
    samples: Dict[str, List] = {}
    for line in text.splitlines():
        p = line.split()
        if len(p) != 9:
            continue
        try:
            ts = float(p[0])
            vals = np.array([int(v) for v in p[2:9]], dtype=np.int64)
        except ValueError:
            continue
        samples.setdefault(p[1], []).append((ts, vals))

    rows = []
    for dev_idx, (dev, series) in enumerate(sorted(samples.items())):
        # Drop devices with no activity at all.
        if len(series) < 2 or not (series[-1][1][:6] - series[0][1][:6]).any():
            continue
        for (t0, v0), (t1, v1) in zip(series, series[1:]):
            if t1 <= t0:
                continue
            d = v1 - v0
            rd_ios, rd_sec, rd_ms, wr_ios, wr_sec, wr_ms, _ = d
            dt = t1 - t0
            metrics = {
                "r_iops": rd_ios / dt,
                "w_iops": wr_ios / dt,
                "r_bw": rd_sec * sector_bytes / dt,
                "w_bw": wr_sec * sector_bytes / dt,
                "r_await_ms": (rd_ms / rd_ios) if rd_ios > 0 else 0.0,
                "w_await_ms": (wr_ms / wr_ios) if wr_ios > 0 else 0.0,
            }
            payload = int((rd_sec + wr_sec) * sector_bytes)
            for metric, value in metrics.items():
                rows.append(
                    {
                        "timestamp": t1 - time_base,
                        "event": float(value),
                        "duration": dt,
                        "deviceId": dev_idx,
                        "payload": payload,
                        "bandwidth": metrics["r_bw"] + metrics["w_bw"],
                        "name": f"{dev}.{metric}",
                        "device_kind": "disk",
                    }
                )
    return make_frame(rows)


def parse_netstat(text: str, time_base: float = 0.0) -> pd.DataFrame:
    """netstat.txt: ``<ts> <iface> rx_bytes tx_bytes rx_pkts tx_pkts``."""
    samples: Dict[str, List] = {}
    for line in text.splitlines():
        p = line.split()
        if len(p) != 6:
            continue
        try:
            ts = float(p[0])
            vals = np.array([int(v) for v in p[2:6]], dtype=np.int64)
        except ValueError:
            continue
        samples.setdefault(p[1], []).append((ts, vals))

    rows = []
    for iface, series in sorted(samples.items()):
        if len(series) < 2:
            continue
        if not (series[-1][1] - series[0][1]).any():
            continue  # idle interface
        for (t0, v0), (t1, v1) in zip(series, series[1:]):
            if t1 <= t0:
                continue
            d = v1 - v0
            dt = t1 - t0
            for name, nbytes, npkts in (
                ("rx", d[0], d[2]),
                ("tx", d[1], d[3]),
            ):
                rows.append(
                    {
                        "timestamp": t1 - time_base,
                        "event": float(nbytes) / dt,
                        "duration": dt,
                        "payload": int(nbytes),
                        "bandwidth": float(nbytes) / dt,
                        "name": f"{iface}.{name}",
                        "device_kind": "net",
                    }
                )
    return make_frame(rows)


def parse_cpuinfo(text: str, time_base: float = 0.0) -> pd.DataFrame:
    """cpuinfo.txt: ``<ts> <mhz0> <mhz1> ...`` -> mean-MHz series."""
    rows = []
    for line in text.splitlines():
        p = line.split()
        if len(p) < 2:
            continue
        try:
            ts = float(p[0])
            mhz = [float(v) for v in p[1:]]
        except ValueError:
            continue
        rows.append(
            {
                "timestamp": ts - time_base,
                "event": float(np.mean(mhz)),
                "name": "cpu_mhz",
                "device_kind": "cpu",
            }
        )
    return make_frame(rows)


def cpu_mhz_interpolator(df: pd.DataFrame):
    """Return f(t)->MHz for converting perf cycle counts to seconds."""
    if df.empty:
        return lambda t: 2000.0
    ts = df["timestamp"].to_numpy(dtype=float)
    mhz = df["event"].to_numpy(dtype=float)

    def f(t):
        return float(np.interp(t, ts, mhz))

    return f


# `vmstat -w -t 1` column layout (procps-ng): r b | swpd free buff cache |
# si so | bi bo | in cs | us sy id wa st [gu] | date time
_VMSTAT_KEEP = ["bi", "bo", "in", "cs", "us", "sy", "wa", "st"]


def parse_vmstat(text: str, time_base: float = 0.0,
                 record_start: Optional[float] = None) -> pd.DataFrame:
    lines = text.splitlines()
    header: List[str] = []
    rows = []
    tick = 0
    for line in lines:
        p = line.split()
        if not p:
            continue
        if p[0] == "r":  # header row
            header = p
            continue
        if not header or not p[0].lstrip("-").isdigit():
            continue
        vals = p
        # -t appends "date time"; prefer it for absolute timestamps.
        ts: Optional[float] = None
        if len(vals) >= len(header) + 2:
            try:
                # datetime treats the naive string as LOCAL time, matching
                # what `vmstat -t` prints (pd.Timestamp would assume UTC).
                import datetime as _dt

                ts = _dt.datetime.strptime(
                    f"{vals[-2]} {vals[-1]}", "%Y-%m-%d %H:%M:%S"
                ).timestamp()
                vals = vals[:-2]
            except ValueError:
                ts = None
        if ts is None:
            ts = (record_start or time_base) + tick
        tick += 1
        named = dict(zip(header, vals))
        for key in _VMSTAT_KEEP:
            if key not in named:
                continue
            try:
                value = float(named[key])
            except ValueError:
                continue
            rows.append(
                {
                    "timestamp": ts - time_base,
                    "event": value,
                    "duration": 1.0,
                    "name": f"vmstat.{key}",
                    "device_kind": "cpu",
                }
            )
    return make_frame(rows)


def load(path: str, parser, time_base: float = 0.0, **kwargs) -> pd.DataFrame:
    if not os.path.isfile(path):
        return empty_frame()
    with open(path) as f:
        return parser(f.read(), time_base=time_base, **kwargs)
