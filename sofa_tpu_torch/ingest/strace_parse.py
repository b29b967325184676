"""strace -q -T -tt -f output -> strace frame.

Line shape: ``<pid> <HH:MM:SS.ffffff> <syscall>(<args>) = <ret> <dur>``
(duration in seconds inside angle brackets), with a noise filter and a
minimum-duration cut.
"""

from __future__ import annotations

import datetime as _dt
import re

import pandas as pd

from sofa_tpu_torch.trace import make_frame

_LINE_RE = re.compile(
    r"^(?P<pid>\d+)\s+(?P<time>\d{2}:\d{2}:\d{2}\.\d+)\s+"
    r"(?P<call>\w+)\((?P<args>.*?)\)\s*=\s*(?P<ret>[-\w?]+).*?"
    r"<(?P<dur>[\d.]+)>\s*$"
)

# Bookkeeping syscalls that drown the signal.
NOISE = {
    "nanosleep", "clock_nanosleep", "clock_gettime", "gettimeofday", "brk",
    "stat", "fstat", "lstat", "newfstatat", "statx", "access", "faccessat",
    "getpid", "gettid", "sched_yield", "rt_sigprocmask", "rt_sigaction",
}


def parse_strace(text: str, time_base: float = 0.0,
                 min_time: float = 1e-6, day_origin: float | None = None) -> pd.DataFrame:
    """day_origin: unix timestamp of local midnight for the -tt wall times;
    derived from time_base when omitted."""
    if day_origin is None:
        base_dt = _dt.datetime.fromtimestamp(time_base or 0)
        day_origin = _dt.datetime(base_dt.year, base_dt.month, base_dt.day).timestamp()
    rows = []
    for line in text.splitlines():
        m = _LINE_RE.match(line.strip())
        if not m:
            continue
        call = m.group("call")
        dur = float(m.group("dur"))
        if call in NOISE or dur < min_time:
            continue
        hh, mm, ss = m.group("time").split(":")
        t = day_origin + int(hh) * 3600 + int(mm) * 60 + float(ss)
        rows.append(
            {
                "timestamp": t - time_base,
                "event": float(dur),
                "duration": dur,
                "pid": int(m.group("pid")),
                "tid": int(m.group("pid")),
                "name": f"{call}({m.group('args')[:60]}) = {m.group('ret')}",
                "device_kind": "cpu",
            }
        )
    return make_frame(rows)


def parse_pystacks(text: str, time_base: float = 0.0) -> pd.DataFrame:
    """pystacks.txt (collectors/pystacks.py): ``<ts> <tid> <f0;f1;...;leaf>``.

    Emits one row per sample: name = leaf frame, event = stack depth, and the
    full stack in `module` for flame-style analysis."""
    rows = []
    for line in text.splitlines():
        p = line.split(None, 2)
        if len(p) != 3:
            continue
        try:
            ts = float(p[0])
            tid = int(p[1])
        except ValueError:
            continue
        stack = p[2].strip()
        if not stack:
            continue
        frames = stack.split(";")
        rows.append(
            {
                "timestamp": ts - time_base,
                "event": float(len(frames)),
                "tid": tid,
                "name": frames[-1],
                "module": stack,
                "device_kind": "cpu",
            }
        )
    return make_frame(rows)
