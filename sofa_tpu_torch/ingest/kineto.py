"""Kineto (torch.profiler Chrome trace) -> the unified schema.

The port's counterpart of ``sofa_tpu/ingest/xplane.py``.  One capture file
per profiled process (``logdir/kineto/trace_<pid>.json``) yields three
frames:

  gputrace   ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` events: deviceId
             from ``args.device``, copyKind KERNEL or the memcpy direction,
             payload the bytes copied, name the kernel symbol, and module
             the innermost ``gpu_user_annotation`` (a ``record_function``
             range as the device saw it) containing the event;
  hosttrace  ``cpu_op`` / ``user_annotation`` / ``cuda_runtime`` events;
  gpusteps   one row per ``sofa_step_N`` / ``ProfilerStep#N`` range, its
             device span when the range launched device work, else its
             host span.

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


def _innermost_modules(dev, start, end, annots) -> np.ndarray:
    """Name of the innermost annotation (device, start, end, name) that
    contains each device event, "" where none does."""
    module = np.full(len(dev), "", dtype=object)
    # widest first, so narrower (inner) ranges overwrite
    for a_dev, a_start, a_end, a_name in sorted(
            annots, key=lambda a: a[2] - a[1], reverse=True):
        inside = (dev == a_dev) & (start >= a_start - 1e-3) \
            & (end <= a_end + 1e-3)
        module[inside] = a_name
    return module


def ingest_trace(doc: dict, time_base: float) -> Dict[str, pd.DataFrame]:
    """One parsed Chrome trace -> {"gputrace", "hosttrace", "gpusteps"}."""
    shift = clock_shift_s(doc, time_base)
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    host_pid = next((e.get("pid") for e in events
                     if e.get("cat") in HOST_CATS), -1)

    dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS]
    annots = [(_device_of(e), float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               str(e["name"])) for e in events
              if e.get("cat") == "gpu_user_annotation"
              and not MARKER_RE.search(str(e.get("name", "")))]
    dev = np.array([_device_of(e) for e in dev_ev], dtype=int)
    start = np.array([float(e["ts"]) for e in dev_ev])
    dur = np.array([float(e.get("dur", 0)) for e in dev_ev])
    modules = _innermost_modules(dev, start, start + dur, annots)
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

    steps: Dict[str, dict] = {}
    for e in events:
        m = STEP_RE.match(str(e.get("name", "")))
        on_device = e.get("cat") == "gpu_user_annotation"
        if not m or not (on_device or e.get("cat") == "user_annotation"):
            continue
        if e["name"] in steps and not on_device:
            continue                    # a device span wins over the host's
        steps[e["name"]] = {
            "timestamp": float(e["ts"]) * 1e-6 + shift,
            "duration": float(e.get("dur", 0)) * 1e-6,
            "event": float(m.group(1) or m.group(2)),
            "deviceId": _device_of(e) if on_device else -1,
            "pid": int(host_pid), "name": str(e["name"]),
            "device_kind": "gpu" if on_device else "cpu"}
    return {"gputrace": make_frame(gpu_rows),
            "hosttrace": make_frame(host_rows),
            "gpusteps": make_frame(list(steps.values()))}


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
