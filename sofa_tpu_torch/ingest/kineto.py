"""Kineto (torch.profiler Chrome trace) -> the unified schema.

The port's counterpart of ``sofa_tpu/ingest/xplane.py``.  One capture file
per profiled process (``logdir/kineto/trace_<pid>.json``) yields three
frames, and the device ones a fourth:

  gputrace   ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` events: deviceId
             from ``args.device``, or the process's global rank whenever
             the trace's ``distributedInfo`` names one and its events name
             one card (two ranks on one card stay two devices, as the JAX
             package's chip ids do); a rank that drives several cards
             keeps their ordinals, with a warning;
             category 0 for kernels and 2 for the copy engines' memcpys
             and memsets (the TPU trace's synchronous and asynchronous
             lines); copyKind KERNEL, the memcpy direction, or an NCCL
             kernel's collective (below); payload the bytes copied or
             communicated, name the kernel symbol, and, from
             the host ranges open when the event was launched (its
             context, below): ``module`` the innermost ``user_annotation``
             (a ``record_function`` range), ``op_path`` every range of the
             context joined by "/" (``sofa_step_3/aten::conv2d/...``),
             ``phase`` "bw" for work launched by the autograd engine (from
             its device thread or under its ``autograd::engine`` ranges),
             else "fw"; a kernel's ``flops`` and ``bytes_accessed`` are its
             share of its owner's cost (``costs.py``) and ``hlo_category``
             the owner's name (``aten::cudnn_convolution``,
             ``sofa_flash_fwd``), else the Kineto category;
  hosttrace  ``cpu_op`` / ``user_annotation`` / ``cuda_runtime`` events;
  gpusteps   one row per ``sofa_step_N`` / ``ProfilerStep#N`` range, its
             device span (first start to last end of the device work it
             launched) when it launched any, else its host span;
  gpuutil    a windowed series per device derived from gputrace
             (``gpu_utilization``).

An NCCL kernel takes its copyKind from the ``record_param_comms`` op in
its launch context, the op torch's process group wraps each collective
in: its ``Collective name`` gives AllReduce 20, AllGather 21,
ReduceScatter 22, AllToAll 23, Broadcast 25 or a send/recv's P2P 10, its
message sizes and ``dtype`` the payload (the larger of the input and
output message: nccl-tests' size), its ``Process Group Ranks`` the
``groups`` column (a JSON list of lists of global ranks, as the JAX
package writes replica groups).  Without that op the kernel's name
decides (``ncclDevKernel_AllReduce_Sum_bf16_RING_LL``,
``ncclKernel_AllReduce_RING_LL_Sum_float``, ``ncclDevKernel_SendRecv``):
only a context tells a grouped SendRecv that serves ``all_to_all`` from a
ring's P2P hop.  A gloo collective records no such op and launches no
kernel: the tracer wraps it in a ``sofa_comms:<collective>:<ranks>``
range, and the device work launched inside it on its thread (gloo's copy
of a CUDA tensor to the host, its device side) takes the collective's
copyKind and its ranks as ``groups``, its payload the bytes it copied.

An event's launch is the ``cuda_runtime`` / ``cuda_driver`` call with the
same ``args.correlation``, on whichever thread of the process made it: the
autograd engine launches a backward's kernels from its own device thread
while the calling thread waits inside the step's range, so those kernels
count in that step.  (Kineto's own ``gpu_user_annotation`` spans follow
only the thread that opened the range, and are not used.)  The context of
a launch is every cpu_op and user_annotation of the launching thread that
contains it, and the user_annotations of other threads that do.

A kernel's owner is the innermost range of its launching thread that is an
aten op with a tensor operand or a flash kernel's cost range.  The owner's
flops and bytes are split over the kernels it launched in proportion to
their device time (equally when all took none), so each kernel of a
several-kernel op (a cuDNN convolution with its layout transforms, say)
runs at the op's own share of the roofline, and the op's totals stay whole.

What the trace could see comes from its ``sofa_trace_detail`` (the
collector's ``host_tracer_level``; 2 when absent).  Below level 2 no op
carries its operand shapes: a kernel owned by no flash cost range gets
NaN ``flops`` and ``bytes_accessed`` (absent, never 0), and ``gpuutil``
leaves out ``tensor_util`` and ``hbm_gbps``.  At level 0 no aten op or
autograd range is recorded: ``op_path`` holds the record_function ranges
alone and ``phase`` is empty (absent).

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
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.costs import is_cost_range, op_cost, range_cost
from sofa_tpu_torch.ingest import CorruptRawError
from sofa_tpu_torch.printing import print_warning
from sofa_tpu_torch.trace import (CopyKind, empty_frame, make_frame,
                                  merged_intervals)

MARKER_RE = re.compile(r"sofa_timebase_marker:(\d+)")
STEP_RE = re.compile(r"^(?:sofa_step_(\d+)|ProfilerStep#(\d+))$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the autograd engine's ranges, and so its device threads
ENGINE_PREFIX = "autograd::engine"
_MEMCPY_KINDS = (("HtoD", CopyKind.H2D), ("DtoH", CopyKind.D2H),
                 ("DtoD", CopyKind.D2D), ("PtoP", CopyKind.P2P))
#: the op torch's process groups wrap a collective in, and its argument keys
COMMS_OP = "record_param_comms"
#: a collective's name (lower case, no underscores) by prefix -> its kind
_COMM_KINDS = (("allreduce", CopyKind.ALL_REDUCE),
               ("allgather", CopyKind.ALL_GATHER),
               ("reducescatter", CopyKind.REDUCE_SCATTER),
               ("alltoall", CopyKind.ALL_TO_ALL),
               ("broadcast", CopyKind.COLLECTIVE_BROADCAST),
               ("send", CopyKind.P2P), ("recv", CopyKind.P2P))
#: the tracer's range around a gloo collective: its name and global ranks
COMMS_RANGE_RE = re.compile(r"^sofa_comms:([a-z_]+):([0-9,]+)$")
#: an NCCL kernel's collective, from its symbol
NCCL_KERNEL_RE = re.compile(r"^nccl(?:Dev)?Kernel_([A-Za-z]+)")
_NCCL_KERNELS = {"AllReduce": CopyKind.ALL_REDUCE,
                 "AllGather": CopyKind.ALL_GATHER,
                 "ReduceScatter": CopyKind.REDUCE_SCATTER,
                 "AllToAll": CopyKind.ALL_TO_ALL,
                 "Broadcast": CopyKind.COLLECTIVE_BROADCAST,
                 "SendRecv": CopyKind.P2P, "Send": CopyKind.P2P,
                 "Recv": CopyKind.P2P}
#: bytes of an element of each c10 scalar type the ``dtype`` argument names
DTYPE_BYTES = {"Float": 4, "Double": 8, "Half": 2, "BFloat16": 2, "Int": 4,
               "Long": 8, "Short": 2, "Char": 1, "Byte": 1, "Bool": 1,
               "ComplexFloat": 8, "ComplexDouble": 16, "Float8_e4m3fn": 1,
               "Float8_e5m2": 1}


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


def comm_kind(collective: str) -> Optional[int]:
    """CopyKind of a ``record_param_comms`` op's ``Collective name``, or
    None for one outside the taxonomy (reduce, barrier, gather, ...)."""
    key = collective.lower().replace("_", "")
    for prefix, kind in _COMM_KINDS:
        if key.startswith(prefix):
            return int(kind)
    return None


def nccl_kernel_kind(name: str) -> Optional[int]:
    """CopyKind of an NCCL kernel from its symbol alone, or None."""
    m = NCCL_KERNEL_RE.match(name)
    kind = _NCCL_KERNELS.get(m.group(1)) if m else None
    return None if kind is None else int(kind)


def _ranks_list(value) -> List[int]:
    """``Process Group Ranks`` (a list, or its text "[0, 1]") as ints."""
    if isinstance(value, str):
        try:
            value = json.loads(value)
        except ValueError:
            return []
    return [int(x) for x in value] if isinstance(value, list) else []


def comm_columns(args: dict) -> Optional[dict]:
    """copyKind, payload and groups of a kernel launched under the
    ``record_param_comms`` op whose args are ``args``, or None when that
    op's collective is outside the taxonomy."""
    kind = comm_kind(str(args.get("Collective name", "")))
    if kind is None:
        return None
    size = DTYPE_BYTES.get(str(args.get("dtype", "")), 0)
    nelems = max(int(args.get("In msg nelems", 0) or 0),
                 int(args.get("Out msg nelems", 0) or 0))
    ranks = _ranks_list(args.get("Process Group Ranks", []))
    return {"copyKind": kind, "payload": nelems * size,
            "groups": json.dumps([ranks]) if ranks else ""}


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


def _stacks(ranges, queries):
    """For each query time, the indices of ``ranges`` (start, end) that
    contain it, outermost first.  The ranges are one thread's and nest, as
    one thread's profiler ranges do; a sweep in time order keeps the open
    ones on a stack."""
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i][0], -ranges[i][1]))
    out = [()] * len(queries)
    stack, j = [], 0
    for q in sorted(range(len(queries)), key=queries.__getitem__):
        t = queries[q]
        while j < len(order) and ranges[order[j]][0] <= t:
            i = order[j]
            while stack and ranges[stack[-1]][1] < ranges[i][0]:
                stack.pop()
            stack.append(i)
            j += 1
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        # a range that ended before t may sit under one still open
        out[q] = tuple(i for i in stack if ranges[i][1] >= t)
    return out


def _launch_context(events, launches):
    """For each launch (time, thread) or None: the host ranges open at it,
    outermost first, as event indices into ``events``: every cpu_op and
    user_annotation of the launching thread that contains it, and the
    user_annotations of other threads that do (a training step's range
    spans the backward kernels the autograd engine launches from its own
    thread)."""
    by_tid, ann_by_tid = {}, {}
    for i, e in enumerate(events):
        cat = e.get("cat")
        if cat not in ("cpu_op", "user_annotation") \
                or MARKER_RE.search(str(e.get("name", ""))):
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), i)
        by_tid.setdefault(e.get("tid"), []).append(span)
        if cat == "user_annotation":
            ann_by_tid.setdefault(e.get("tid"), []).append(span)
    slots = [k for k, x in enumerate(launches) if x is not None]
    open_at = {k: [] for k in slots}
    for tid, spans in by_tid.items():
        mine = [k for k in slots if launches[k][1] == tid]
        for k, st in zip(mine, _stacks(spans, [launches[k][0] for k in mine])):
            open_at[k] += [spans[i] for i in st]
    for tid, spans in ann_by_tid.items():
        other = [k for k in slots if launches[k][1] != tid]
        for k, st in zip(other, _stacks(spans,
                                        [launches[k][0] for k in other])):
            open_at[k] += [spans[i] for i in st]
    context = [()] * len(launches)
    for k, spans in open_at.items():
        context[k] = tuple(i for _, _, i in sorted(
            spans, key=lambda s: (s[0], -s[1])))
    return context


def _owner(ctx, events, tid_of_launch):
    """The event index whose cost a kernel carries: the innermost range on
    the launching thread that is a flash cost range or an aten op with a
    tensor operand, or None."""
    for i in reversed(ctx):
        e = events[i]
        if e.get("tid") != tid_of_launch:
            continue
        name = str(e.get("name", ""))
        if is_cost_range(name):
            return i
        if e.get("cat") == "cpu_op" and op_cost(name, e.get("args") or {}):
            return i
    return None


def ingest_trace(doc: dict, time_base: float) -> Dict[str, pd.DataFrame]:
    """One parsed Chrome trace -> {"gputrace", "hosttrace", "gpusteps"}."""
    shift = clock_shift_s(doc, time_base)
    rank = (doc.get("distributedInfo") or {}).get("rank")
    level = int((doc.get("sofa_trace_detail") or {}).get(
        "host_tracer_level", 2))
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    host_pid = next((e.get("pid") for e in events
                     if e.get("cat") in HOST_CATS), -1)

    def correlation(e):
        return (e.get("args") or {}).get("correlation")

    launched_at = {correlation(e): (float(e["ts"]), e.get("tid"))
                   for e in events if e.get("cat") in LAUNCH_CATS
                   and correlation(e) is not None}
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
               str(e["name"])) for e in events
              if e.get("cat") == "user_annotation"
              and not MARKER_RE.search(str(e.get("name", "")))]
    engine_tids = {e.get("tid") for e in events
                   if str(e.get("name", "")).startswith(ENGINE_PREFIX)}

    dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS]
    dev = np.array([_device_of(e) for e in dev_ev], dtype=int)
    if rank is not None:
        cards = sorted(set(dev.tolist()))
        if len(cards) <= 1:
            dev[:] = int(rank)
        else:
            print_warning("kineto: rank %s drives cards %s: its events keep "
                          "the ordinals (one device per rank holds for a "
                          "rank that drives one card)" % (rank, cards))
    start = np.array([float(e["ts"]) for e in dev_ev])
    dur = np.array([float(e.get("dur", 0)) for e in dev_ev])
    launches = [launched_at.get(correlation(e)) for e in dev_ev]
    launch = np.array([x[0] if x else np.nan for x in launches])
    contexts = _launch_context(events, launches)

    # each owner's cost, split over the kernels it launched by device time
    owners = [_owner(ctx, events, x[1]) if x and e["cat"] == "kernel"
              else None for ctx, x, e in zip(contexts, launches, dev_ev)]
    owner_time: Dict[int, float] = {}
    owner_count: Dict[int, int] = {}
    for o, d in zip(owners, dur):
        if o is not None:
            owner_time[o] = owner_time.get(o, 0.0) + d
            owner_count[o] = owner_count.get(o, 0) + 1
    gpu_rows = []
    no_cost = []        # kernels whose cost the trace cannot give
    for i, e in enumerate(dev_ev):
        args = e.get("args") or {}
        nbytes = int(args.get("bytes", 0) or 0)
        d = dur[i] * 1e-6
        ctx = [events[j] for j in contexts[i]]
        names = [str(c["name"]) for c in ctx]
        module = next((n for c, n in zip(reversed(ctx), reversed(names))
                       if c.get("cat") == "user_annotation"
                       and not is_cost_range(n)), "")
        flops = cost_bytes = 0.0
        category = e["cat"]
        o = owners[i]
        if o is not None:
            oname = str(events[o]["name"])
            cost = range_cost(oname) or op_cost(oname,
                                                events[o].get("args") or {})
            share = (dur[i] / owner_time[o] if owner_time[o] > 0
                     else 1.0 / owner_count[o])
            flops, cost_bytes = cost[0] * share, cost[1] * share
            category = oname.partition("[")[0]
        elif e["cat"] == "kernel" and level < 2:
            no_cost.append(i)
        phase = ""
        if launches[i] is not None and level > 0:
            phase = "bw" if (launches[i][1] in engine_tids or any(
                n.startswith(ENGINE_PREFIX) for n in names)) else "fw"
        kind, groups = copy_kind(e["cat"], str(e["name"])), ""
        if e["cat"] == "kernel" and NCCL_KERNEL_RE.match(str(e["name"])):
            comm = next((comm_columns(c.get("args") or {})
                         for c in reversed(ctx) if c.get("name") == COMMS_OP
                         and c.get("tid") == launches[i][1]), None)
            if comm is not None:
                kind, nbytes, groups = (comm["copyKind"], comm["payload"],
                                        comm["groups"])
            else:
                kind = nccl_kernel_kind(str(e["name"])) or kind
        elif launches[i] is not None:
            coll = next((c for c in reversed(ctx)
                         if c.get("tid") == launches[i][1]
                         and COMMS_RANGE_RE.match(str(c["name"]))), None)
            if coll is not None:
                name, ranks = COMMS_RANGE_RE.match(str(coll["name"])).groups()
                kind = comm_kind(name) or kind
                groups = json.dumps([[int(r) for r in ranks.split(",")]])
        gpu_rows.append({
            "timestamp": start[i] * 1e-6 + shift, "event": float(dev[i]),
            "duration": d, "deviceId": int(dev[i]), "copyKind": kind,
            "category": 0 if e["cat"] == "kernel" else 2,
            "payload": nbytes, "groups": groups,
            "bandwidth": nbytes / d if nbytes and d > 0 else 0.0,
            "pid": int(host_pid), "tid": int(args.get("stream", e.get("tid", -1))),
            "name": str(e["name"]), "device_kind": "gpu",
            "hlo_category": category, "module": module, "flops": flops,
            "bytes_accessed": cost_bytes, "phase": phase,
            "op_path": "/".join(names)})

    gputrace = make_frame(gpu_rows)
    if no_cost:
        gputrace.loc[no_cost, ["flops", "bytes_accessed"]] = np.nan

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
    return {"gputrace": gputrace,
            "hosttrace": make_frame(host_rows),
            "gpusteps": make_frame(step_rows)}


def capture_files(kineto_dir: str) -> List[str]:
    """The capture files under ``kineto_dir``, in name order."""
    return sorted(glob.glob(os.path.join(kineto_dir, "*.json")))


def load_capture(path: str) -> dict:
    """One Chrome trace; CorruptRawError when it is not one."""
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read())
    except (ValueError, UnicodeDecodeError) as e:
        raise CorruptRawError(path, f"not a JSON document ({e})") from None
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("traceEvents"), list):
        raise CorruptRawError(path, "no traceEvents list")
    return doc


def ingest_kineto_dir(kineto_dir: str, time_base: float
                      ) -> Dict[str, pd.DataFrame]:
    """Every ``*.json`` capture under ``kineto_dir``, merged and sorted by
    time.  A missing or empty directory yields empty frames; a capture that
    does not decode (a run killed mid-export) or that holds no
    ``traceEvents`` list raises CorruptRawError."""
    parts: Dict[str, List[pd.DataFrame]] = {
        "gputrace": [], "hosttrace": [], "gpusteps": []}
    for path in capture_files(kineto_dir):
        doc = load_capture(path)
        for name, df in ingest_trace(doc, time_base).items():
            if not df.empty:
                parts[name].append(df)
    return {name: (pd.concat(dfs, ignore_index=True)
                   .sort_values("timestamp", kind="stable")
                   .reset_index(drop=True) if dfs else empty_frame())
            for name, dfs in parts.items()}


def _windowed_integral(starts: np.ndarray, ends: np.ndarray,
                       rates: np.ndarray, t0: float, n_win: int,
                       window_s: float) -> np.ndarray:
    """Exact per-window integral of sum_i rates[i]*[starts_i <= t < ends_i]
    over a uniform window grid, in O(len(starts) + n_win)."""
    acc = np.zeros(n_win)
    delta = np.zeros(n_win + 1)
    a = (starts - t0) / window_s
    b = (ends - t0) / window_s
    ia = np.clip(np.floor(a).astype(np.int64), 0, n_win - 1)
    ib = np.clip(np.floor(b).astype(np.int64), 0, n_win - 1)
    same = ia == ib
    if same.any():
        np.add.at(acc, ia[same], rates[same] * (ends[same] - starts[same]))
    d = ~same
    if d.any():
        np.add.at(acc, ia[d], rates[d] * ((ia[d] + 1) - a[d]) * window_s)
        np.add.at(acc, ib[d], rates[d] * (b[d] - ib[d]) * window_s)
        np.add.at(delta, ia[d] + 1, rates[d])
        np.add.at(delta, ib[d], -rates[d])
    return acc + np.cumsum(delta[:-1]) * window_s


def gpu_utilization(gputrace: pd.DataFrame, window_s: float = 0.1,
                    device_meta: Optional[Dict[str, Dict[str, float]]] = None
                    ) -> pd.DataFrame:
    """Windowed utilization series per device, derived from the kernels of
    the trace (no NVML), the counterpart of ``tpu_utilization``:

      ==================  ================  =================================
      JAX (tpuutil)       port (gpuutil)    per window
      ==================  ================  =================================
      ``tc_util``         ``kernel_util``   % covered by kernels (union)
      ``mxu_util``        ``tensor_util``   % of the card's peak FLOP/s
      ``hbm_gbps``        ``hbm_gbps``      bytes_accessed rate, GB/s
      ==================  ================  =================================

    ``tensor_util`` needs the card's peak (``device_meta``, as
    ``analysis.sol.device_peaks`` gives it); an unknown card has none.
    Where a kernel's flops (bytes) are absent, so is ``tensor_util``
    (``hbm_gbps``)."""
    if gputrace.empty:
        return empty_frame()
    frames = []
    for device_id, df in gputrace.groupby("deviceId"):
        kern = df[df["copyKind"] == int(CopyKind.KERNEL)]
        if kern.empty:
            continue
        starts = kern["timestamp"].to_numpy(dtype=float)
        ends = starts + kern["duration"].to_numpy(dtype=float)
        t0 = float(starts.min())
        t1 = float(ends.max())
        edges = np.arange(t0, t1 + window_s, window_s)
        n_win = len(edges) - 1
        if n_win <= 0:
            continue
        marr = merged_intervals(starts, ends)
        durs = np.maximum(ends - starts, 1e-12)
        busy = _windowed_integral(
            marr[:, 0], marr[:, 1], np.ones(len(marr)), t0, n_win, window_s)
        wflops = _windowed_integral(
            starts, ends, kern["flops"].to_numpy(dtype=float) / durs,
            t0, n_win, window_s)
        wbytes = _windowed_integral(
            starts, ends, kern["bytes_accessed"].to_numpy(dtype=float) / durs,
            t0, n_win, window_s)
        peaks = (device_meta or {}).get(str(device_id), {})
        peak_flops = peaks.get("peak_teraflops_per_second", 0.0) * 1e12
        ts = edges[1:n_win + 1]
        series = [("kernel_util", 100.0 * busy / window_s, np.zeros(n_win))]
        if not kern["bytes_accessed"].isna().any():
            series.append(("hbm_gbps", wbytes / window_s / 1e9,
                           wbytes / window_s))
        if peak_flops > 0 and not kern["flops"].isna().any():
            series.append(
                ("tensor_util", 100.0 * (wflops / window_s) / peak_flops,
                 np.zeros(n_win)))
        frames.append(make_frame({
            "timestamp": np.concatenate([ts] * len(series)),
            "event": np.concatenate([v for _, v, _ in series]),
            "bandwidth": np.concatenate([b for _, _, b in series]),
            "duration": np.full(n_win * len(series), window_s),
            "deviceId": np.full(n_win * len(series), int(device_id)),
            "name": np.repeat([n for n, _, _ in series], n_win),
            "device_kind": ["gpu"] * (n_win * len(series)),
        }))
    if not frames:
        return empty_frame()
    out = pd.concat(frames, ignore_index=True)
    return out.sort_values(["deviceId", "timestamp"],
                           kind="stable").reset_index(drop=True)
