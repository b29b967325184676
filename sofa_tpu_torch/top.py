"""``top``: a live terminal dashboard over a recording's logdir (the JAX
package's ``sofa_tpu/top.py``).

While ``record`` (or a program under ``api.profile()``) runs, its samplers
append to the logdir: the in-process memory sampler one ``gpumon`` file
per process (``gpumon.txt``, or ``gpumon.rank<r>.txt`` for rank r of a
process group; ``ingest/gpumon_parse.py`` parses each line) with the
sampled cards' names beside it (``<file>.meta.json``), its allocation-site
snapshot (``memprof.pb.gz``), and procmon's mpstat, netstat and diskstat.
``top`` reads the tail of each and redraws every ``--interval`` seconds;
``--once`` draws one frame and exits.  Over a finished capture it shows
the last samples, and its card names also come from ``gpu_topo.json``.
With ``--cluster_hosts`` it stacks one block per host's logdir.

Where ``/proc/stat`` does not advance (a sandboxed host) the CPU line
says "not measured" rather than 0 % busy.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional

import pandas as pd

from sofa_tpu_torch.ingest import procfs
from sofa_tpu_torch.printing import print_error

_BAR_W = 24
#: A sampler heartbeat older than this reads as stale.
LIVE_S = 5.0


def _bar(pct: float) -> str:
    pct = min(max(pct, 0.0), 100.0)
    fill = int(round(pct / 100.0 * _BAR_W))
    return "[" + "#" * fill + "-" * (_BAR_W - fill) + "]"


def _fmt_bytes_rate(bps: float) -> str:
    for unit, div in (("GiB/s", 2 ** 30), ("MiB/s", 2 ** 20),
                      ("KiB/s", 2 ** 10)):
        if bps >= div:
            return f"{bps / div:.1f} {unit}"
    return f"{bps:.0f} B/s"


def _latest(df: pd.DataFrame) -> pd.DataFrame:
    """The rows of the newest sample timestamp."""
    if df.empty:
        return df
    return df[df["timestamp"] == df["timestamp"].max()]


def _tail_text(path: str, max_bytes: int = 65536) -> Optional[str]:
    """The file's last ``max_bytes``, its first (maybe partial) line
    dropped: a sampler file grows for the whole run, a frame needs its
    last samples."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - max_bytes))
        text = f.read().decode(errors="replace")
    if size > max_bytes:
        text = text.split("\n", 1)[-1]
    return text


def _tail_load(path: str, parser, max_bytes: int = 65536) -> pd.DataFrame:
    text = _tail_text(path, max_bytes)
    if text is None:
        from sofa_tpu_torch.trace import empty_frame

        return empty_frame()
    return parser(text, time_base=0.0)


def _card_names(logdir: str, sampler_file: str) -> Dict[str, str]:
    """Device ordinal -> card name: the sampler's sidecar, else the
    topology the trace wrote at exit (``gpu_topo.json``)."""
    for path, key in ((sampler_file + ".meta.json", "devices"),
                      (os.path.join(logdir, "gpu_topo.json"), None)):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if key:
            return {str(k): str(v) for k, v in (doc.get(key) or {}).items()}
        return {str(d.get("index")): str(d.get("name", ""))
                for d in doc.get("devices", [])}
    return {}


def _gpu_lines(logdir: str, now: float) -> List[str]:
    """One line per sampled device of each process's gpumon file (its
    card, allocator bytes in use of the card's memory, the peak), and the
    file's heartbeat age."""
    from sofa_tpu_torch.ingest.gpumon_parse import (RANK_FILE_RE,
                                                    gpumon_files,
                                                    parse_gpumon_line)

    out: List[str] = []
    for path in gpumon_files(logdir):
        text = _tail_text(path)
        if text is None:
            continue
        m = RANK_FILE_RE.search(path)
        who = f"rank{m.group(1)} " if m else (
            "" if os.path.basename(path) == "gpumon.txt"
            else os.path.basename(path)[len("gpumon."):-len(".txt")] + " ")
        names = _card_names(logdir, path)
        latest = {}
        beat_ns = None
        for line in text.splitlines():
            parsed = parse_gpumon_line(line)
            if parsed is None:
                continue
            ts_ns, dev, used, limit, peak = parsed
            if dev == -1:
                beat_ns = ts_ns
            else:
                latest[dev] = (ts_ns, used, limit, peak)
        for dev in sorted(latest):
            ts_ns, used, limit, peak = latest[dev]
            card = names.get(str(dev), "")
            label = f"{who}gpu{dev} {card}".rstrip()
            if limit:
                occ = 100.0 * used / limit
                out.append(
                    f"{label}  mem {used / 1e9:6.2f}/{limit / 1e9:.2f} GB "
                    f"{_bar(occ)} {occ:5.1f}%  peak {peak / 1e9:.2f} GB")
            else:
                out.append(f"{label}  mem {used / 1e9:6.2f} GB (no limit "
                           f"reported)  peak {peak / 1e9:.2f} GB")
        if beat_ns is not None:
            age = max(0.0, now - beat_ns / 1e9)
            health = "live" if age < LIVE_S else f"STALE ({age:.0f}s)"
            out.append(f"{who}gpu    sample {age:4.1f}s ago — {health}")
    return out or ["GPU    no gpumon file (--disable_gpu_mon, a program "
                   "that never used the card, or nothing recording yet)"]


_MEM_CACHE: dict = {}   # path -> ((mtime_ns, size), rendered lines)


def _mem_lines(logdir: str) -> List[str]:
    """The top allocation sites of the sampler's latest snapshot of each
    process (``memprof.pb.gz``, ``memprof.rank<r>.pb.gz``), which it
    rewrites at each new peak; decoded again only when the file
    changed."""
    out: List[str] = []
    paths = [os.path.join(logdir, "memprof.pb.gz")] + sorted(
        glob.glob(os.path.join(logdir, "memprof.rank*.pb.gz")))
    for path in paths:
        try:
            st = os.stat(path)
        except OSError:
            continue
        key = (st.st_mtime_ns, st.st_size)
        cached = _MEM_CACHE.get(path)
        if cached is not None and cached[0] == key:
            out += cached[1]
            continue
        try:
            from sofa_tpu_torch.ingest.memprof import (aggregate_sites,
                                                       parse_memprof)

            sites = aggregate_sites(parse_memprof(path), top_k=3)
            with open(path + ".meta.json") as f:
                trigger = json.load(f).get("trigger", "peak")
        except Exception:  # noqa: BLE001 - a snapshot mid-rewrite, not cached
            continue
        held = sites[sites["bytes"] > 0]
        lines = []
        if not held.empty:
            tag = os.path.basename(path)[len("memprof"):-len(".pb.gz")]
            lines = [f"mem@{trigger}{tag}  top sites:"]
            for row in held.itertuples(index=False):
                lines.append(f"       {row.bytes / 1e9:6.2f} GB "
                             f"{row.share:4.0%}  {row.site[:48]}")
        _MEM_CACHE[path] = (key, lines)
        out += lines
    return out


def _cpu_line(logdir: str) -> Optional[str]:
    df = _tail_load(os.path.join(logdir, "mpstat.txt"), procfs.parse_mpstat)
    rows = _latest(df)
    if rows.empty:
        return None
    if not rows["payload"].any():
        return ("cpu    not measured (/proc/stat does not advance on this "
                "host)")
    vals = {n: float(rows[rows["name"] == n]["event"].mean())
            for n in ("usr", "sys", "iow", "idl")
            if not rows[rows["name"] == n].empty}
    busy = 100.0 - vals.get("idl", 100.0)
    return (f"cpu    {_bar(busy)} {busy:5.1f}%  "
            + "  ".join(f"{n} {vals[n]:4.1f}%" for n in ("usr", "sys", "iow")
                        if n in vals))


def _net_line(logdir: str) -> Optional[str]:
    df = _tail_load(os.path.join(logdir, "netstat.txt"),
                    procfs.parse_netstat)
    rows = _latest(df)
    if rows.empty:
        return None
    parts = [f"{name} {_fmt_bytes_rate(float(sel['event'].sum()))}"
             for name, sel in rows.groupby("name")]
    return "net    " + "  ".join(sorted(parts)[:6])


def _disk_line(logdir: str) -> Optional[str]:
    df = _tail_load(os.path.join(logdir, "diskstat.txt"),
                    procfs.parse_diskstat)
    rows = _latest(df)
    if rows.empty:
        return None
    rd = float(rows[rows["name"].str.endswith(".r_bw")]["event"].sum())
    wr = float(rows[rows["name"].str.endswith(".w_bw")]["event"].sum())
    return (f"disk   read {_fmt_bytes_rate(rd)}  "
            f"write {_fmt_bytes_rate(wr)}")


def render_frame(logdir: str, now: Optional[float] = None,
                 title: Optional[str] = None) -> str:
    now = time.time() if now is None else now
    stamp = time.strftime("%H:%M:%S", time.localtime(now))
    lines = [f"sofa top — {title or logdir}   {stamp}"]
    lines += _gpu_lines(logdir, now)
    lines += _mem_lines(logdir)
    for maker in (_cpu_line, _net_line, _disk_line):
        line = maker(logdir)
        if line:
            lines.append(line)
    return "\n".join(lines)


def render_cluster_frame(cfg, now: Optional[float] = None) -> str:
    """One frame stacking every host's logdir of a cluster recording
    (``record --cluster_hosts``' layout, ``<logdir>-<host>/``)."""
    from sofa_tpu_torch.analyze import cluster_host_cfgs
    from sofa_tpu_torch.printing import SofaUserError

    now = time.time() if now is None else now  # one clock for every block
    blocks = []
    seen_any = False
    for _i, hostname, host_cfg in cluster_host_cfgs(cfg):
        if not os.path.isdir(host_cfg.logdir):
            blocks.append(f"sofa top — {hostname}   (no logdir yet)")
            continue
        seen_any = True
        blocks.append(render_frame(host_cfg.logdir, now, title=hostname))
    if not seen_any:
        raise SofaUserError(
            f"no host logdirs under {cfg.logdir.rstrip('/')}-<host>/ — "
            "start a `record --cluster_hosts ...` first")
    return "\n\n".join(blocks)


def sofa_top(cfg, interval: float = 2.0, once: bool = False) -> int:
    interval = max(float(interval), 0.1)
    if cfg.cluster_hosts:
        def render():
            return render_cluster_frame(cfg)
    elif os.path.isdir(cfg.logdir):
        def render():
            return render_frame(cfg.logdir)
    else:
        print_error(f"logdir {cfg.logdir} does not exist — start a "
                    "`record` first")
        return 1
    try:
        if once:
            print(render())
            return 0
        while True:
            sys.stdout.write("\x1b[2J\x1b[H" + render() + "\n")
            sys.stdout.flush()
            time.sleep(interval)
    except FileNotFoundError as e:
        print_error(str(e))
        return 1
    except KeyboardInterrupt:
        return 0
