"""``export --perfetto``: the timeline as ``trace.json.gz`` in the Trace
Event Format, which ui.perfetto.dev and chrome://tracing open (the JAX
package's ``sofa_tpu/export_perfetto.py``).

  process  a GPU (``gpu<N>``, N the deviceId: a rank's global index under
           torch.distributed), a host, or the profiler itself
  thread   a lane of the GPU (kernels, copies, steps) or a host thread
  X events the spans: kernels and copies with the schema's analysis
           columns as args (flops, bytes, phase, op_path, ...), steps,
           host events
  C events counters: ``gpuutil`` (kernel and tensor-core utilization %,
           HBM GB/s), ``gpumon`` (allocator bytes and occupancy per
           device), the host's CPU and network series

Timestamps are microseconds from the run's time base.

The kernel frame is the large one.  It is reduced to one JSON prefix per
distinct (name, args) signature and flat ts/dur/pid/lane/signature
arrays, which the native writer (``native/perfetto_write.cc``, built by
``collectors/native_build.py`` into ``build/torch_native/``) formats and
deflates in one pass.  Without a C++ compiler, or with
``SOFA_NATIVE_PERFETTO=0``, the Python path writes the same JSON text: both
print a kernel's ts and dur as ``%.3f`` (nanoseconds), so the two files
decompress to the same bytes.  (The JAX package's Python path prints
``repr`` of the floats, and uses its native writer above 100,000 device
events only.)
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from sofa_tpu_torch.printing import print_progress, print_warning

# synthetic pids of the non-device processes: Perfetto groups tracks by pid
_HOST_PID = 1_000_000
_SELF_PID = 1_200_000  # the profiler's own spans (sofa_self_trace.json)

PERFETTO_FRAMES = ["gputrace", "gpusteps", "hosttrace", "gpuutil",
                   "gpumon", "mpstat", "netbandwidth"]
#: The device tracks: lane -> thread name.
DEVICE_THREADS = {0: "CUDA kernels", 1: "Copies (memcpy, memset)",
                  3: "Steps"}


def _op_args(row) -> Dict[str, object]:
    args: Dict[str, object] = {}
    for key in ("hlo_category", "module", "phase", "op_path", "source"):
        v = getattr(row, key, "")
        if v:
            args[key] = str(v)
    for key in ("flops", "bytes_accessed", "payload"):
        v = getattr(row, key, 0)
        if v:
            args[key] = float(v)
    g = getattr(row, "groups", "")
    if g:
        args["replica_groups"] = str(g)
    return args


class _DeviceColumns:
    """The kernel frame as per-signature JSON prefixes and flat
    ts/dur/pid/lane/sig arrays: the native writer's input, and the Python
    path's."""

    def __init__(self, ops: pd.DataFrame) -> None:
        self.n = len(ops)
        # clamp after the µs scale: ±1e15 µs (~31 years) is past any real
        # trace, and keeps both writers' %.3f within their buffers
        self.ts = np.clip(np.nan_to_num(
            ops["timestamp"].to_numpy(dtype=float) * 1e6,
            posinf=1e15, neginf=-1e15), -1e15, 1e15)
        self.dur = np.clip(np.nan_to_num(
            ops["duration"].to_numpy(dtype=float) * 1e6,
            posinf=1e15), 0.0, 1e15)
        self.pid = ops["deviceId"].to_numpy(dtype=np.int32)
        cat = ops["category"].to_numpy(dtype=int)
        self.lane = np.where(
            cat == 0, 0, np.where(cat == 2, 1, 2)).astype(np.uint8)
        # the (name, args) pairs are few: an exact vectorized signature,
        # and only each signature's first row becomes Python objects
        sig_cols = [k for k in ("name", "hlo_category", "module", "phase",
                                "op_path", "source", "flops",
                                "bytes_accessed", "payload", "groups")
                    if k in ops.columns]
        sig_arr = ops.groupby(sig_cols, sort=False, dropna=False).ngroup() \
            .to_numpy()
        self.sig = sig_arr.astype(np.uint32)
        uniq, firsts = np.unique(sig_arr, return_index=True)
        dumps = json.dumps
        self.prefixes: List[str] = [""] * len(uniq)
        for s, row in zip(uniq.tolist(),
                          ops.iloc[firsts].itertuples(index=False)):
            self.prefixes[s] = (
                f'{{"name":{dumps(str(row.name))},"ph":"X","cat":"gpu_op",'
                f'"args":{dumps(_op_args(row), separators=(",", ":"))},')

    def event_strings(self) -> "List[str]":
        """The Python path's event lines, formatted as the native
        writer's."""
        prefix = self.prefixes
        sig = self.sig.tolist()
        ts = self.ts.tolist()
        dur = self.dur.tolist()
        pid = self.pid.tolist()
        lane = self.lane.tolist()
        return [f'{prefix[sig[i]]}"ts":{ts[i]:.3f},"dur":{dur[i]:.3f},'
                f'"pid":{pid[i]},"tid":{lane[i]}}}' for i in range(self.n)]


def _steps_events(steps: pd.DataFrame, events: List[dict]) -> None:
    for row in steps.itertuples(index=False):
        events.append({
            "name": row.name, "ph": "X", "cat": "step",
            "ts": row.timestamp * 1e6,
            "dur": max(row.duration, 0.0) * 1e6,
            # a step that launched no device work keeps its host span
            "pid": int(row.deviceId) if row.deviceId >= 0 else _HOST_PID,
            "tid": 3,
        })


def _host_events(host: pd.DataFrame, events: List[dict]) -> None:
    # deviceId of a host row is its host's base in a cluster export
    # (ordinal * 256): each host gets a process of its own
    for row in host.itertuples(index=False):
        events.append({
            "name": row.name, "ph": "X", "cat": "host",
            "ts": row.timestamp * 1e6,
            "dur": max(row.duration, 0.0) * 1e6,
            "pid": _HOST_PID + max(int(row.deviceId), 0),
            "tid": int(row.tid) & 0x7FFFFFFF,
            "args": ({"thread": row.module}
                     if getattr(row, "module", "") else {}),
        })


def _counter_events(util: pd.DataFrame, events: List[dict]) -> None:
    for row in util.itertuples(index=False):
        events.append({
            "name": row.name, "ph": "C", "cat": "util",
            "ts": row.timestamp * 1e6,
            "pid": int(row.deviceId),
            "args": {row.name: float(row.event)},
        })


def _host_counter_events(df: pd.DataFrame, names: List[str],
                         label: str, events: List[dict]) -> None:
    """The per-timestamp mean of a host sampler series as a counter, per
    host (``pid`` holds the host's ordinal in a cluster export, -1 for
    one host)."""
    if df.empty:
        return
    for hpid, host_rows in df.groupby("pid"):
        pid = _HOST_PID + max(int(hpid), 0) * 256
        for name in names:
            rows = host_rows[host_rows["name"] == name]
            if rows.empty:
                continue
            agg = rows.groupby("timestamp")["event"].mean()
            for ts, v in agg.items():
                events.append({
                    "name": f"{label}{name}", "ph": "C", "cat": "host_util",
                    "ts": ts * 1e6, "pid": pid,
                    "args": {f"{label}{name}": float(v)},
                })


def _self_trace_events(cfg) -> List[dict]:
    """The profiler's own spans (``telemetry``'s self trace, on the
    capture's clock already) as one more process."""
    from sofa_tpu_torch.telemetry import load_self_trace

    doc = load_self_trace(cfg.logdir)
    if doc is None:
        return []
    out = []
    for e in doc["traceEvents"]:
        if not isinstance(e, dict) or "ph" not in e:
            continue
        e = dict(e)
        e["pid"] = _SELF_PID
        out.append(e)
    return out


def _host_threads(sel: pd.DataFrame) -> Dict[int, str]:
    """tid -> thread name for one host: its first row's module, else
    "tid <n>"."""
    dd = sel.drop_duplicates("tid")
    tids = dd["tid"].to_numpy()
    mods = dd["module"].to_numpy() if "module" in dd.columns \
        else [""] * len(dd)
    return {int(tid) & 0x7FFFFFFF: str(mod) or f"tid {tid}"
            for tid, mod in zip(tids.tolist(), list(mods))}


def _meta(events: List[dict], pid: int, name: str,
          threads: Optional[Dict[int, str]] = None) -> None:
    events.append({"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": name}})
    for tid, tname in (threads or {}).items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})


def export_perfetto(cfg, frames: Optional[Dict[str, pd.DataFrame]] = None,
                    out_name: str = "trace.json.gz") -> Optional[str]:
    """Write the Trace Event Format export; returns its path, or None
    (with a warning) when there is nothing to export."""
    if frames is None:
        from sofa_tpu_torch.preprocess import load_frames

        frames = load_frames(cfg, only=PERFETTO_FRAMES)

    def get(name: str) -> pd.DataFrame:
        df = frames.get(name)
        return df if df is not None else pd.DataFrame()

    events: "List[dict]" = []
    ops = get("gputrace")
    dev = _DeviceColumns(ops) if not ops.empty else None
    steps = get("gpusteps")
    if not steps.empty:
        _steps_events(steps, events)
    host = get("hosttrace")
    if not host.empty:
        _host_events(host, events)
    util = get("gpuutil")
    if not util.empty:
        _counter_events(util, events)
    # the allocator's bytes per device; the heartbeat rows (-1) are not a
    # device counter
    mon = get("gpumon")
    if not mon.empty:
        mon = mon[(mon["name"] != "alive") & (mon["deviceId"] >= 0)]
    if not mon.empty:
        _counter_events(mon, events)
    _host_counter_events(get("mpstat"), ["usr", "sys", "iow"], "cpu_",
                         events)
    net = get("netbandwidth")
    if not net.empty:
        _host_counter_events(net, sorted(set(net["name"])), "", events)
    if dev is None and not events:
        print_warning("perfetto export: no trace frames — run `report` "
                      "first")
        return None
    events.extend(_self_trace_events(cfg))

    device_ids = set()
    for df in (ops, steps, util, mon):
        if not df.empty:
            device_ids.update(int(d) for d in df["deviceId"].unique()
                              if int(d) >= 0)
    for pid in sorted(device_ids):
        _meta(events, pid, f"gpu{pid}", DEVICE_THREADS)
    if not host.empty:
        for base, sel in host.groupby("deviceId"):
            base = max(int(base), 0)
            name = "host" if host["deviceId"].nunique() == 1 \
                else f"host{base // 256}"
            _meta(events, _HOST_PID + base, name, _host_threads(sel))

    os.makedirs(cfg.logdir, exist_ok=True)
    path = cfg.path(out_name)
    dumps = json.dumps
    tail = ('],"displayTimeUnit":"ms","otherData":'
            + dumps({"producer": "sofa_tpu_torch", "logdir": cfg.logdir})
            + "}")
    n_total = (dev.n if dev is not None else 0) + len(events)

    if dev is not None and os.environ.get("SOFA_NATIVE_PERFETTO",
                                          "1") != "0":
        other_json = ",".join(
            dumps(e, separators=(",", ":")) for e in events)
        if _native_write(dev, other_json, tail, path):
            print_progress(f"perfetto export: {n_total} events -> {path} "
                           "(native writer; open in ui.perfetto.dev)")
            return path

    # the Python path: streamed, gzip level 5, ~64k strings a write
    from sofa_tpu_torch.trace import atomic_replace

    with atomic_replace(path) as tmp_path, \
            gzip.open(tmp_path, "wt", encoding="utf-8",  # sofa-lint: disable=SL009 — streamed gzip body inside atomic_replace; the rename IS the atomic step
                      compresslevel=5) as f:
        f.write('{"traceEvents":[')
        batch: List[str] = []
        wrote_any = False

        def flush():
            nonlocal wrote_any
            if not batch:
                return
            if wrote_any:
                f.write(",")
            f.write(",".join(batch))
            wrote_any = True
            batch.clear()

        for e in (dev.event_strings() if dev is not None else []):
            batch.append(e)
            if len(batch) >= 65536:
                flush()
        for e in events:
            batch.append(dumps(e, separators=(",", ":")))
            if len(batch) >= 65536:
                flush()
        flush()
        f.write(tail)
    print_progress(f"perfetto export: {n_total} events -> {path} "
                   "(Python writer; open in ui.perfetto.dev)")
    return path


def _native_write(dev: _DeviceColumns, other_json: str, tail: str,
                  path: str) -> bool:
    """Hand the columnar kernel events to ``native/perfetto_write.cc``.
    False on any failure (no compiler, a bad exit, no output), with a
    warning: the caller then takes the Python path."""
    import struct
    import subprocess
    import tempfile

    from sofa_tpu_torch.collectors.native_build import ensure_built

    tool = ensure_built("perfetto_write")
    if tool is None:
        return False
    tmp = None
    out_tmp = path + f".native.{os.getpid()}"
    try:
        with tempfile.NamedTemporaryFile(
                prefix="sofa_perfetto_", suffix=".bin",
                dir=os.path.dirname(path) or ".", delete=False) as f:
            tmp = f.name
            f.write(struct.pack("<IIII", 0x31504653, 1, 4,
                                len(dev.prefixes)))
            for p in dev.prefixes:
                b = p.encode("utf-8")
                f.write(struct.pack("<I", len(b)))
                f.write(b)
            f.write(struct.pack("<Q", dev.n))
            f.write(dev.ts.tobytes())
            f.write(dev.dur.tobytes())
            f.write(dev.sig.tobytes())
            f.write(dev.pid.tobytes())
            f.write(dev.lane.tobytes())
            other = other_json.encode("utf-8")
            f.write(struct.pack("<Q", len(other)))
            f.write(other)
            tail_b = tail.encode("utf-8")
            f.write(struct.pack("<Q", len(tail_b)))
            f.write(tail_b)
        r = subprocess.run([tool, tmp, out_tmp],
                           capture_output=True, timeout=600)
        if r.returncode != 0 or not os.path.isfile(out_tmp):
            print_warning("native perfetto_write failed "
                          f"(rc={r.returncode}): "
                          f"{r.stderr.decode(errors='replace')[:200]} — "
                          "using the Python writer")
            return False
        os.replace(out_tmp, path)
        return True
    except Exception as e:  # noqa: BLE001 - any failure takes the Python path
        print_warning(f"native perfetto_write failed ({e}) — "
                      "using the Python writer")
        return False
    finally:
        for leftover in (tmp, out_tmp):
            if leftover:
                try:
                    os.unlink(leftover)
                except OSError:
                    pass
