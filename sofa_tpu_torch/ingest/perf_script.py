"""`perf script` output -> cputrace frame.

perf.data is converted with ``perf script -F
comm,pid,tid,cpu,time,event,ip,sym,dso,period`` and each sample maps to a
row whose y-value is log10(instruction pointer) (it clusters samples by
code region on the scatter timeline) and whose duration is period/CPU-MHz
(the right duration for cycle-period sampling).

Expected line shape (fields joined by whitespace):

  <comm> <pid>/<tid> [<cpu>] <time>: <period> <event>: <ip> <sym>+<off> (<dso>)

comm may contain spaces; we anchor on the ``pid/tid`` and ``[cpu]`` tokens.
"""

from __future__ import annotations

import math
import os
import re
import subprocess
from typing import Callable, Optional

import pandas as pd

from sofa_tpu_torch.ingest import IngestToolError
from sofa_tpu_torch.trace import empty_frame, make_frame

# Deadline for the perf.data -> text conversion subprocess; a large
# perf.data can legitimately take minutes, so the bound is generous and
# env-tunable.
_PERF_SCRIPT_TIMEOUT_S = 600.0


def _conversion_timeout_s() -> float:
    try:
        return float(os.environ.get("SOFA_PERF_SCRIPT_TIMEOUT_S",
                                    _PERF_SCRIPT_TIMEOUT_S))
    except ValueError:
        return _PERF_SCRIPT_TIMEOUT_S

_LINE_RE = re.compile(
    r"^(?P<comm>.+?)\s+(?P<pid>\d+)(?:/(?P<tid>\d+))?\s+"
    r"\[(?P<cpu>\d+)\]\s+(?P<time>[\d.]+):\s+"
    r"(?:(?P<period>\d+)\s+)?(?P<event>[\w\-:.]+):\s*"
    r"(?P<ip>[0-9a-fA-F]+)?\s*(?P<sym>.*?)?(?:\s+\((?P<dso>[^)]*)\))?\s*$"
)

# Callchain frame line emitted under `perf record --call-graph`: the sample
# header then carries no ip/sym, followed by one indented line per stack
# frame and a blank separator line.
_FRAME_RE = re.compile(
    r"^\s+(?P<ip>[0-9a-fA-F]+)\s+(?P<sym>.*?)(?:\s+\((?P<dso>[^)]*)\))?\s*$"
)

_MAX_FOLDED_CALLERS = 3  # callers folded into name after the leaf frame


def parse_perf_script(
    text: str,
    time_base: float = 0.0,
    mono_to_unix: Optional[Callable[[float], float]] = None,
    mhz_at: Optional[Callable[[float], float]] = None,
) -> pd.DataFrame:
    """Parse `perf script` text.

    mono_to_unix converts perf's clock (CLOCK_MONOTONIC seconds) to unix
    seconds, built from timebase.txt (ingest/timebase_align.py); identity
    means timestamps are already unix.
    """
    rows = []
    lines = text.splitlines()
    i, n = 0, len(lines)
    while i < n:
        line = lines[i]
        i += 1
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        try:
            t = float(m.group("time"))
        except ValueError:
            continue
        if mono_to_unix is not None:
            t = mono_to_unix(t)
        period = int(m.group("period") or 1)
        mhz = mhz_at(t - time_base) if mhz_at else 2000.0
        if mhz <= 0:
            mhz = 2000.0
        ip_hex = m.group("ip") or ""
        sym = (m.group("sym") or "").strip()
        dso = os.path.basename(m.group("dso") or "")
        if not ip_hex:
            # Callchain block: header carries no ip/sym — the frames follow,
            # leaf first.  The leaf provides ip/sym/dso; a few callers are
            # folded into the name ("leaf<-caller1<-caller2").
            frames = []
            while i < n:
                fm = _FRAME_RE.match(lines[i])
                if fm is None:
                    break
                frames.append(fm)
                i += 1
            if not frames:
                continue
            ip_hex = frames[0].group("ip")
            sym = (frames[0].group("sym") or "").strip()
            dso = os.path.basename(frames[0].group("dso") or "")
            callers = [
                (f.group("sym") or "").strip()
                for f in frames[1:1 + _MAX_FOLDED_CALLERS]
            ]
            callers = [c for c in callers if c and c != "[unknown]"]
            if callers:
                sym = (sym if sym and sym != "[unknown]" else ip_hex) \
                    + "<-" + "<-".join(callers)
        try:
            ip = int(ip_hex or "0", 16)
        except ValueError:
            ip = 0
        name = sym if sym and sym != "[unknown]" else (ip_hex or "0")
        if dso:
            name = f"{name} @ {dso}"
        rows.append(
            {
                "timestamp": t - time_base,
                "event": math.log10(ip) if ip > 0 else 0.0,
                "duration": period / (mhz * 1e6),
                "deviceId": int(m.group("cpu")),
                "pid": int(m.group("pid")),
                "tid": int(m.group("tid") or m.group("pid")),
                "name": name,
                "device_kind": "cpu",
            }
        )
    return make_frame(rows)


def run_perf_script(perf_data: str, kallsyms: Optional[str] = None) -> str:
    """Convert perf.data to text; returns "" when there is nothing to do.

    Raises :class:`IngestToolError` when perf.data EXISTS but the
    conversion subprocess is missing, fails, or exceeds its deadline:
    there are raw samples on disk the run could not use, and preprocess
    must say so rather than quietly show an empty cputrace.
    """
    if not os.path.isfile(perf_data):
        return ""
    argv = [
        "perf", "script", "-i", perf_data,
        "-F", "comm,pid,tid,cpu,time,event,ip,sym,dso,period",
    ]
    if kallsyms and os.path.isfile(kallsyms):
        argv += ["--kallsyms", kallsyms]
    timeout_s = _conversion_timeout_s()
    try:
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        raise IngestToolError(
            perf_data, f"perf script exceeded {timeout_s:.0f}s "
            "(SOFA_PERF_SCRIPT_TIMEOUT_S to raise)") from None
    except (subprocess.SubprocessError, OSError, FileNotFoundError) as e:
        raise IngestToolError(perf_data, f"perf script failed: {e}") \
            from None
    if out.returncode != 0:
        raise IngestToolError(
            perf_data,
            f"perf script rc={out.returncode}: {out.stderr[:200]}")
    return out.stdout


def ingest_perf(
    logdir: str,
    time_base: float,
    mono_to_unix: Optional[Callable[[float], float]] = None,
    mhz_at: Optional[Callable[[float], float]] = None,
) -> pd.DataFrame:
    path = os.path.join(logdir, "perf.data")
    script_path = os.path.join(logdir, "perf.script")
    text = ""
    if os.path.isfile(script_path):  # pre-converted (tests, offline machines)
        with open(script_path) as f:
            text = f.read()
    else:
        text = run_perf_script(path, os.path.join(logdir, "kallsyms"))
        if text:
            with open(script_path, "w") as f:
                f.write(text)
    if not text:
        return empty_frame()
    return parse_perf_script(text, time_base, mono_to_unix, mhz_at)
