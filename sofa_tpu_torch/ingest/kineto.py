"""Kineto (torch.profiler Chrome trace) -> the unified schema.

The port's counterpart of ``sofa_tpu/ingest/xplane.py``.  One capture file
per profiled process (``logdir/kineto/trace_<pid>.json``) yields three
frames:

  gputrace   ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` events: deviceId
             from ``args.device``, copyKind KERNEL or the memcpy direction,
             payload the bytes copied, name the kernel symbol, and module
             the innermost ``user_annotation`` (a ``record_function`` range)
             that was open on the host when the event was launched;
  hosttrace  ``cpu_op`` / ``user_annotation`` / ``cuda_runtime`` events;
  gpusteps   one row per ``sofa_step_N`` / ``ProfilerStep#N`` range, its
             device span (first start to last end of the device work it
             launched) when it launched any, else its host span.

An event's launch is the ``cuda_runtime`` / ``cuda_driver`` call with the
same ``args.correlation``, on whichever thread of the process made it: the
autograd engine launches a backward's kernels from its own device thread
while the calling thread waits inside the step's range, so those kernels
count in that step.  (Kineto's own ``gpu_user_annotation`` spans follow
only the thread that opened the range, and are not used.)

Clock: an event's time is ``baseTimeNanoseconds`` + ``ts`` (microseconds).
The collector's ``sofa_timebase_marker:<unix_ns>`` range pins that clock to
unix time (offset = marker's unix_ns - its trace time), and the schema's
timestamp is seconds since the run's time base.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List

import numpy as np
import pandas as pd

from sofa_tpu_torch.printing import print_warning
from sofa_tpu_torch.trace import CopyKind, empty_frame, make_frame

MARKER_RE = re.compile(r"sofa_timebase_marker:(\d+)")
STEP_RE = re.compile(r"^(?:sofa_step_(\d+)|ProfilerStep#(\d+))$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_MEMCPY_KINDS = (("HtoD", CopyKind.H2D), ("DtoH", CopyKind.D2H),
                 ("DtoD", CopyKind.D2D), ("PtoP", CopyKind.P2P))


def copy_kind(cat: str, name: str) -> int:
    """CopyKind of a device event: kernels compute; memcpys by direction;
    memsets ride the on-device copy kind."""
    if cat == "kernel":
        return int(CopyKind.KERNEL)
    if cat == "gpu_memset":
        return int(CopyKind.D2D)
    for key, kind in _MEMCPY_KINDS:
        if key in name:
            return int(kind)
    return int(CopyKind.NA)


def _device_of(ev: dict) -> int:
    args = ev.get("args") or {}
    return int(args.get("device", ev.get("pid", -1)))


def clock_shift_s(doc: dict, time_base: float) -> float:
    """Seconds to add to an event's ``ts * 1e-6`` to get seconds since
    ``time_base`` (unix seconds), pinned by the earliest timebase marker."""
    base_ns = int(doc.get("baseTimeNanoseconds", 0))
    marks = []
    for ev in doc.get("traceEvents", []):
        m = MARKER_RE.search(str(ev.get("name", "")))
        if m and ev.get("ph") == "X":
            marks.append((float(ev["ts"]), int(m.group(1))))
    offset_ns = 0
    if marks:
        ts, unix_ns = min(marks)
        offset_ns = unix_ns - (base_ns + round(ts * 1000))
    else:
        print_warning("kineto: no timebase marker in the trace; trusting "
                      "its clock as unix time")
    return (base_ns + offset_ns - round(time_base * 1e9)) / 1e9


def _innermost_ranges(t: np.ndarray, ranges) -> np.ndarray:
    """Name of the narrowest host range (start, end, name) containing each
    time in ``t``, "" where none does (and where ``t`` is NaN)."""
    module = np.full(len(t), "", dtype=object)
    # widest first, so narrower (inner) ranges overwrite
    for a_start, a_end, a_name in sorted(ranges, key=lambda a: a[1] - a[0],
                                         reverse=True):
        module[(t >= a_start) & (t <= a_end)] = a_name
    return module


def ingest_trace(doc: dict, time_base: float) -> Dict[str, pd.DataFrame]:
    """One parsed Chrome trace -> {"gputrace", "hosttrace", "gpusteps"}."""
    shift = clock_shift_s(doc, time_base)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    host_pid = next((e.get("pid") for e in events
                     if e.get("cat") in HOST_CATS), -1)

    def correlation(e):
        return (e.get("args") or {}).get("correlation")

    launched_at = {correlation(e): float(e["ts"]) for e in events
                   if e.get("cat") in LAUNCH_CATS
                   and correlation(e) is not None}
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
               str(e["name"])) for e in events
              if e.get("cat") == "user_annotation"
              and not MARKER_RE.search(str(e.get("name", "")))]

    dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS]
    dev = np.array([_device_of(e) for e in dev_ev], dtype=int)
    start = np.array([float(e["ts"]) for e in dev_ev])
    dur = np.array([float(e.get("dur", 0)) for e in dev_ev])
    launch = np.array([launched_at.get(correlation(e), np.nan)
                       for e in dev_ev])
    modules = _innermost_ranges(launch, ranges)
    gpu_rows = []
    for i, e in enumerate(dev_ev):
        args = e.get("args") or {}
        nbytes = int(args.get("bytes", 0) or 0)
        d = dur[i] * 1e-6
        gpu_rows.append({
            "timestamp": start[i] * 1e-6 + shift, "event": float(dev[i]),
            "duration": d, "deviceId": int(dev[i]),
            "copyKind": copy_kind(e["cat"], str(e["name"])),
            "payload": nbytes,
            "bandwidth": nbytes / d if nbytes and d > 0 else 0.0,
            "pid": int(host_pid), "tid": int(args.get("stream", e.get("tid", -1))),
            "name": str(e["name"]), "device_kind": "gpu",
            "hlo_category": e["cat"], "module": modules[i]})

    host_rows = [{
        "timestamp": float(e["ts"]) * 1e-6 + shift,
        "duration": float(e.get("dur", 0)) * 1e-6,
        "pid": int(e.get("pid", -1)), "tid": int(e.get("tid", -1)),
        "name": str(e["name"]), "device_kind": "cpu",
        "hlo_category": e["cat"]} for e in events if e.get("cat") in HOST_CATS]

    step_rows = []
    for a_start, a_end, name in ranges:
        m = STEP_RE.match(name)
        if not m:
            continue
        mine = np.flatnonzero((launch >= a_start) & (launch <= a_end))
        row = {"event": float(m.group(1) or m.group(2)), "pid": int(host_pid),
               "name": name, "timestamp": a_start * 1e-6 + shift,
               "duration": (a_end - a_start) * 1e-6, "deviceId": -1,
               "device_kind": "cpu"}
        if len(mine):
            first = mine[np.argmin(start[mine])]
            end = float((start[mine] + dur[mine]).max())
            row.update(timestamp=start[first] * 1e-6 + shift,
                       duration=(end - start[first]) * 1e-6,
                       deviceId=int(dev[first]), device_kind="gpu")
        step_rows.append(row)
    return {"gputrace": make_frame(gpu_rows),
            "hosttrace": make_frame(host_rows),
            "gpusteps": make_frame(step_rows)}


def ingest_kineto_dir(kineto_dir: str, time_base: float
                      ) -> Dict[str, pd.DataFrame]:
    """Every ``*.json`` capture under ``kineto_dir``, merged and sorted by
    time.  A missing or empty directory yields empty frames."""
    parts: Dict[str, List[pd.DataFrame]] = {
        "gputrace": [], "hosttrace": [], "gpusteps": []}
    for path in sorted(glob.glob(os.path.join(kineto_dir, "*.json"))):
        with open(path) as f:
            doc = json.load(f)
        for name, df in ingest_trace(doc, time_base).items():
            if not df.empty:
                parts[name].append(df)
    return {name: (pd.concat(dfs, ignore_index=True)
                   .sort_values("timestamp", kind="stable")
                   .reset_index(drop=True) if dfs else empty_frame())
            for name, dfs in parts.items()}
