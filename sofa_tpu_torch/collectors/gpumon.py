"""Live GPU memory sampler and allocation-site snapshots, in process.

The counterpart of the JAX package's ``collectors/tpumon.py``.  The
sampler lives inside the profiled program (the Kineto collector's
sitecustomize starts it the moment ``import torch`` finishes) and reads the
caching allocator's own view at ``gpu_mon_rate`` Hz, through ``torch.cuda``:

    bytes_in_use       memory_stats(d)["allocated_bytes.all.current"]
    peak_bytes_in_use  memory_stats(d)["allocated_bytes.all.peak"]
    bytes_limit        get_device_properties(d).total_memory


It needs no NVML and no ``nvidia-smi``, and it never initializes CUDA: it
writes nothing until the program has (``torch.cuda.is_initialized()``), and
then samples only devices whose primary context already exists.

Output format (gpumon.txt), one line per device per tick plus a liveness
heartbeat (device -1), byte-compatible with tpumon.txt:

    <unix_ns> <device_id> <bytes_in_use> <bytes_limit> <peak_bytes_in_use>

Parsed by ingest/gpumon_parse.py.  Beside it, ``gpumon.txt.meta.json``
names each sampled device (``{"devices": {"0": "NVIDIA H100 80GB
HBM3"}}``), written when the device is first sampled: ``top`` reads it
while the run is still going.

The files are per process (``_Names``).  A rank of a process group of two
or more, the rank its Kineto trace names (the group's, noted while the
group exists), writes ``gpumon.rank<r>.txt`` and ``memprof.rank<r>.pb.gz``;
any other process the plain names.  A process that may yet join a group (a
torchrun worker, RANK in its environment, or a ``multiprocessing`` child
such as the ranks of ``torch.multiprocessing.spawn``) writes
``gpumon.pid<pid>.txt`` until it does, and then moves what it wrote to its
rank's names.  So no two processes share a file, except two processes
launched otherwise that both initialize CUDA before they join their group:
they share the plain names until then.

The sampler doubles as the trigger for allocation-site snapshots: when the
summed bytes in use grow more than 2 % past the last snapshot (at most one
every 2 s), it walks ``torch.cuda.memory._snapshot()``, aggregates the
``active_allocated`` blocks by (allocation stack, device) and writes them
as a gzipped pprof ``Profile`` to ``memprof.pb.gz`` (decoded by
ingest/memprof.py).  The stacks exist because the injection arms
``torch.cuda.memory._record_memory_history`` through
``torch.cuda._lazy_call``: it runs inside the program's own CUDA
initialization, before its first allocation, and never initializes CUDA by
itself.

The autograd engine allocates a backward's gradients and temporaries on its
own device thread, which has no Python frames.  So the injection also wraps
``torch.autograd.backward`` and ``torch.autograd.grad`` to note when each
call ran and from which line (nothing else about the call changes); a block
with no frames that was allocated while a backward ran takes that call's
stack under an ``(autograd engine)`` leaf frame.  Blocks with no frames
outside any backward aggregate as ``(stackless buffer)``.

A 1 Hz gate sees a training step's peak only by chance, and a run shorter
than the 2 s rate limit gets one snapshot at its first tick.  So the
recording also keeps the allocator's alloc/free trace, a ring of its last
``MAX_ENTRIES`` entries, and at exit the sampler walks it backward from the
blocks live at exit to the highest point the ring reaches: when that is
more than 2 % above the last gate snapshot, the published snapshot is the
set of blocks live there (``"replayed": true`` in the sidecar, with the
ring's length, whether it wrapped, and the allocator's own peak beside the
replayed one).  The ring covers the whole run until it wraps, and then its
last ``MAX_ENTRIES`` entries only.  The gate snapshot stays: it is what a
program that dies before its exit handlers leaves behind, and what the
replay must beat.  Without a readable trace the JAX package's rule holds:
a final snapshot at exit only when none was taken.

A snapshot never imports.  torch's symbolizer names Python frames and
probes ``hasattr(torch, "_inductor")`` to map compiled code back to its
source; ``torch``'s lazy ``__getattr__`` turns that probe into an import
of ``torch._inductor``, which, on the sampler thread while the program
makes its own first import of ``torch._dynamo``, deadlocks against it and
fails the program (torch 2.11).  So the snapshot runs with that module
``__getattr__`` answering "no such attribute" to the lazy modules on the
snapshotting thread only (``_snapshot``): frames are named all the same,
and code that inductor generated is mapped only when the program has
imported it.  An eager program gets its gate snapshots too.
"""

from __future__ import annotations

import os

# Self-contained module text written into the injection directory: it runs
# inside whatever Python the profiled command uses and imports nothing of
# this package.  The same text is exec'd below so tests drive one
# implementation.
_SAMPLER = '''
"""sofa_tpu_torch in-process GPU memory sampler (auto-generated)."""
import collections
import os
import sys
import threading
import time


def _cuda_ready():
    """torch imported AND the program has initialized CUDA (never calls
    anything that would initialize it)."""
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    try:
        return torch if cuda is not None and cuda.is_initialized() else None
    except Exception:
        return None


def _live_devices(torch):
    """Ordinals whose CUDA context exists: a query must not create one on
    a card the program never used."""
    has_context = getattr(torch._C, "_cuda_hasPrimaryContext", None)
    if has_context is None:
        return [torch.cuda.current_device()]
    return [d for d in range(torch.cuda.device_count()) if has_context(d)]


_MEMPROF = {"snap": 0, "last": 0.0}   # bytes at / time of last snapshot
# Bound of the recorded alloc/free trace, a ring per device that the at-exit
# peak replay walks.
MAX_ENTRIES = 100000
# [start_us, end_us or None, caller frames] of the latest backward calls
_BACKWARDS = collections.deque(maxlen=4096)
_ENGINE = ("(autograd engine)", "", 0)    # leaf frame of their blocks


def _pprof_encode(samples):
    """Minimal pprof ``Profile`` wire encoding (proto3, unpacked repeateds).

    samples: [(frames [(func, file, line), ...leaf-first], device, kind,
    count, bytes)].  Hand-rolled so the injected sampler stays import-free;
    every conformant protobuf parser accepts unpacked repeated scalars.
    """
    def vi(n):
        out = bytearray()
        n &= (1 << 64) - 1
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    def tagv(field, n):                       # wire type 0 (varint)
        return vi(field << 3) + vi(n)

    def tagl(field, payload):                 # wire type 2 (length-delim)
        return vi((field << 3) | 2) + vi(len(payload)) + payload

    strings = [""]
    sidx = {"": 0}

    def s(x):
        if x not in sidx:
            sidx[x] = len(strings)
            strings.append(x)
        return sidx[x]

    functions = {}                            # (name, file) -> id
    fn_msgs = []
    locations = {}                            # (name, file, line) -> id
    loc_msgs = []

    def loc_id(fr):
        if fr not in locations:
            name, fname, line = fr
            fkey = (name, fname)
            if fkey not in functions:
                fid = len(functions) + 1
                functions[fkey] = fid
                fn_msgs.append(tagl(5, tagv(1, fid) + tagv(2, s(name))
                                    + tagv(4, s(fname))))
            lid = len(locations) + 1
            locations[fr] = lid
            line_msg = tagv(1, functions[fkey]) + tagv(2, max(int(line), 0))
            loc_msgs.append(tagl(4, tagv(1, lid) + tagl(4, line_msg)))
        return locations[fr]

    out = bytearray()
    # sample_type: (allocations, count), (space, bytes) -- the column pair
    # ingest/memprof.py resolves by unit.
    out += tagl(1, tagv(1, s("allocations")) + tagv(2, s("count")))
    out += tagl(1, tagv(1, s("space")) + tagv(2, s("bytes")))
    for frames, device, kind, cnt, nbytes in samples:
        msg = bytearray()
        for fr in frames:
            msg += tagv(1, loc_id(fr))
        msg += tagv(2, max(int(cnt), 0)) + tagv(2, max(int(nbytes), 0))
        msg += tagl(3, tagv(1, s("device")) + tagv(2, s(device)))
        msg += tagl(3, tagv(1, s("kind")) + tagv(2, s(kind)))
        out += tagl(2, bytes(msg))
    for m in loc_msgs:
        out += m
    for m in fn_msgs:
        out += m
    for st in strings:
        out += tagl(6, st.encode("utf-8", "replace"))
    return bytes(out)


def _frame(f):
    """(function, file, line) of one snapshot frame.  The function label
    carries its file and line, so a site names the allocating line."""
    fname = str(f.get("filename", ""))
    line = int(f.get("line", 0) or 0)
    rel = os.path.relpath(fname) if os.path.isabs(fname) else fname
    where = fname if rel.startswith("..") else rel
    return ("%s (%s:%d)" % (f.get("name", "?"), where, line), fname, line)


def _backward_at(t_us):
    """Caller frames of the innermost backward call running at ``t_us``,
    or None."""
    for start, end, frames in reversed(list(_BACKWARDS)):
        if start <= t_us and (end is None or t_us <= end):
            return frames
    return None


def _frames_of(blk, t_us):
    """Aggregation key frames of one block allocated at ``t_us`` (None
    when unknown)."""
    frames = tuple(_frame(f) for f in (blk.get("frames") or ())[:48])
    if frames:
        return frames
    caller = _backward_at(t_us) if t_us is not None else None
    if caller is not None:
        return (_ENGINE,) + tuple(_frame(f) for f in caller[:47])
    return (("(stackless buffer)", "", 0),)


def _aggregate(blocks, label, agg, times):
    """Add blocks ({"size", "frames"}, keyed by address) of one device to
    {(frames, device): (count, bytes)}.  ``times`` maps an address to the
    time its block was allocated."""
    for addr, blk in blocks.items():
        key = (_frames_of(blk, times.get(addr)), label)
        c, b = agg.get(key, (0, 0))
        agg[key] = (c + 1, b + int(blk.get("size", 0)))
    return agg


def _samples(agg):
    return [(list(fr), dev, "buffer", c, b)
            for (fr, dev), (c, b) in sorted(agg.items(), key=str)]


def _live_blocks(snapshot):
    """{device: {address: block}} of the allocator's active blocks, each
    block's size the size its trace entries carry (the requested one)."""
    live = {}
    for seg in snapshot.get("segments", ()):
        blocks = live.setdefault(int(seg.get("device", 0)), {})
        for b in seg.get("blocks", ()):
            if b.get("state") == "active_allocated":
                blocks[b["address"]] = {
                    "size": int(b.get("requested_size", b.get("size", 0))),
                    "frames": b.get("frames")}
    return live


def _alloc_times(trace):
    """{address: time_us} of the latest alloc in a device's trace."""
    return {e["addr"]: e.get("time_us") for e in trace
            if e.get("action") == "alloc"}


def _snapshot_samples(snapshot):
    """The allocator's active blocks as pprof samples, aggregated by
    (allocation stack, device)."""
    traces = snapshot.get("device_traces") or ()
    agg = {}
    for dev, blocks in _live_blocks(snapshot).items():
        times = _alloc_times(traces[dev]) if dev < len(traces) else {}
        _aggregate(blocks, "cuda:%d" % dev, agg, times)
    return _samples(agg)


def _undo(live, e):
    """Step ``live`` back over trace entry ``e``; the bytes it changed by,
    or None when the trace and the live blocks disagree."""
    action, addr = e.get("action"), e.get("addr")
    if action == "alloc":
        blk = live.pop(addr, None)
        return None if blk is None else -int(blk["size"])
    if action == "free_requested":
        if addr in live:
            return None
        live[addr] = e
        return int(e["size"])
    return 0


def _replay_peak(snapshot):
    """The blocks live at each device's highest point within its recorded
    trace, rebuilt by walking the trace backward from the blocks live now:
    (samples, bytes, entries per device), or None when nothing was
    recorded or the trace and the live blocks disagree."""
    traces = snapshot.get("device_traces") or ()
    if not any(traces):
        return None
    now = _live_blocks(snapshot)
    agg, peak, lengths = {}, 0, []
    for dev in sorted(set(now) | set(range(len(traces)))):
        trace = traces[dev] if dev < len(traces) else []
        lengths.append(len(trace))
        live = dict(now.get(dev, {}))
        total = sum(int(b["size"]) for b in live.values())
        best, best_i = total, len(trace)
        for i in range(len(trace) - 1, -1, -1):   # live = state before i
            step = _undo(live, trace[i])
            if step is None:
                return None
            total += step
            if total > best:
                best, best_i = total, i
        live = dict(now.get(dev, {}))
        for e in trace[best_i:][::-1]:
            _undo(live, e)
        _aggregate(live, "cuda:%d" % dev, agg, _alloc_times(trace[:best_i]))
        peak += best
    return _samples(agg), peak, lengths


def _publish(path, samples, meta):
    """Write the gzipped pprof and its meta sidecar, each atomically: the
    sampler thread and the at-exit snapshot may write concurrently, each
    through its own tmp file, and readers only ever see complete files."""
    import gzip
    import json
    blob = gzip.compress(_pprof_encode(samples))
    for name, mode, data in ((path, "wb", blob),
                             (path + ".meta.json", "w", json.dumps(meta))):
        tmp = "%s.tmp.%d.%d" % (name, os.getpid(), threading.get_ident())
        with open(tmp, mode) as f:
            f.write(data)
        os.replace(tmp, name)


_NOTE = ("active_allocated blocks of the caching allocator; blocks "
         "allocated with no Python frames during a backward call carry "
         "that call's stack under (autograd engine), the others are "
         "(stackless buffer)")


# torch's lazily imported submodules (its module __getattr__)
_LAZY_MODULES = ("_dynamo", "_inductor", "_export", "onnx")
_NO_IMPORT = threading.local()


def _guard_lazy_imports(torch):
    """Wrap torch's module ``__getattr__`` so that, on a thread inside
    ``_snapshot``, a lazy submodule not yet imported reads as absent
    instead of being imported; other threads see no change."""
    orig = getattr(torch, "__dict__", {}).get("__getattr__")
    if orig is None or getattr(orig, "_sofa_torch_guard", False):
        return

    def __getattr__(name):
        if name in _LAZY_MODULES and getattr(_NO_IMPORT, "on", False):
            raise AttributeError(name)
        return orig(name)

    __getattr__._sofa_torch_guard = True
    torch.__getattr__ = __getattr__


def _snapshot(torch):
    """``torch.cuda.memory._snapshot()``, importing nothing."""
    _guard_lazy_imports(torch)
    _NO_IMPORT.on = True
    try:
        return torch.cuda.memory._snapshot()
    finally:
        _NO_IMPORT.on = False


def snapshot_memprof(torch, path, trigger, total_bytes):
    """Write an allocation-site snapshot of the present state.

    Best-effort by contract: the profiled program must never die because
    an observability snapshot failed; a failure warns and returns False.
    """
    try:
        t0 = time.perf_counter()
        samples = _snapshot_samples(_snapshot(torch))
        _publish(path, samples, {
            "unix_ns": time.time_ns(), "trigger": trigger,
            "total_bytes": int(total_bytes), "encoder": "memory_snapshot",
            "snapshot_s": time.perf_counter() - t0, "note": _NOTE})
        return True
    except Exception as e:
        sys.stderr.write("sofa_tpu_torch: memprof snapshot failed: %r\\n"
                         % (e,))
        return False


def final_memprof(torch, path):
    """The at-exit snapshot.  When the highest point of the recorded trace
    is more than 2 % above the last gate snapshot (a run too short or too
    fast for the sampler's ticks), write the blocks live there (trigger
    "peak", replayed); otherwise, when no snapshot was taken at all, the
    state at exit (trigger "final").  Best-effort, as snapshot_memprof."""
    try:
        t0 = time.perf_counter()
        snap = _snapshot(torch)
        replay = _replay_peak(snap)
        if replay is not None and replay[1] > _MEMPROF["snap"] * 1.02:
            samples, peak, lengths = replay
            _publish(path, samples, {
                "unix_ns": time.time_ns(), "trigger": "peak",
                "replayed": True, "total_bytes": peak,
                "trace_entries": lengths,
                "wrapped": any(n >= MAX_ENTRIES for n in lengths),
                "allocator_peak_bytes": sum(
                    int(torch.cuda.memory_stats(d).get(
                        "allocated_bytes.all.peak", 0))
                    for d in _live_devices(torch)),
                "gate_bytes": _MEMPROF["snap"],
                "encoder": "memory_snapshot",
                "snapshot_s": time.perf_counter() - t0, "note": _NOTE})
        elif not os.path.exists(path):
            _publish(path, _snapshot_samples(snap), {
                "unix_ns": time.time_ns(), "trigger": "final",
                "total_bytes": 0, "encoder": "memory_snapshot",
                "snapshot_s": time.perf_counter() - t0, "note": _NOTE})
        return True
    except Exception as e:
        sys.stderr.write("sofa_tpu_torch: final memprof failed: %r\\n"
                         % (e,))
        return False


def _maybe_memprof(torch, path, total_bytes):
    """Growth-gated, rate-limited peak snapshot.

    The gate baseline is the bytes at the last *successful snapshot*, never
    the per-tick observation, so gradual growth still re-triggers once it
    sums past 2 % since the snapshot, and a rate-limited tick re-arms
    instead of raising the bar.
    """
    if not path or total_bytes <= 0:
        return
    if total_bytes <= _MEMPROF["snap"] * 1.02:
        return
    now = time.time()
    if now - _MEMPROF["last"] < 2.0:
        return
    if snapshot_memprof(torch, path, "peak", total_bytes):
        _MEMPROF["snap"] = total_bytes
        _MEMPROF["last"] = now


def _caller_frames(frame):
    """A Python stack, leaf first, as memory-snapshot frames."""
    out = []
    while frame is not None and len(out) < 47:
        out.append({"name": frame.f_code.co_name,
                    "filename": frame.f_code.co_filename,
                    "line": frame.f_lineno})
        frame = frame.f_back
    return out


def _noting_backward(fn, torch):
    """``fn`` (a backward entry point), noting in _BACKWARDS when each call
    ran and its caller's stack; the call itself is unchanged."""
    import functools
    compiling = getattr(getattr(torch, "compiler", None), "is_compiling",
                        lambda: False)

    if getattr(fn, "_sofa_torch_noted", False):
        return fn                          # armed before: note each call once

    @functools.wraps(fn)
    def backward(*args, **kwargs):
        if compiling():
            return fn(*args, **kwargs)
        call = [time.time_ns() // 1000, None,
                _caller_frames(sys._getframe(1))]
        _BACKWARDS.append(call)
        try:
            return fn(*args, **kwargs)
        finally:
            call[1] = time.time_ns() // 1000

    backward._sofa_torch_noted = True
    return backward


# What allocation-stack recording keeps (torch.cuda.memory
# _record_memory_history's arguments besides max_entries), chosen from the
# sweep of sofa_tpu_torch/tools/overhead_budget.py: the cost is the Python
# stack taken at each allocation (context=None costs nothing measurable,
# "state" as much as "alloc", "all" and C++ stacks more); "alloc" is the
# cheapest setting whose trace entries carry the stacks the at-exit replay
# names the peak's freed blocks by, and the trace ("all") is that replay.
HISTORY = {"enabled": "all", "context": "alloc", "stacks": "python"}
_ARMED = {"on": False}


def arm_history(torch, history=None):
    """Record allocation stacks, and the alloc/free trace the at-exit peak
    replay walks, from the program's first CUDA allocation on, as
    ``history`` (default HISTORY) says.
    ``_lazy_call`` queues the call into the program's own CUDA
    initialization (or runs it now if that already happened), so this never
    initializes CUDA; a failure inside it only warns, since a queued call
    that raised would fail the program's initialization.

    It also wraps ``torch.autograd.backward`` (which ``Tensor.backward``
    calls) and ``torch.autograd.grad`` to note each call's time and caller,
    for the blocks the autograd engine allocates on its device threads,
    which have no Python frames.  ``--disable_memprof`` leaves all of it
    alone."""
    kwargs = dict(history or HISTORY, max_entries=MAX_ENTRIES)
    _ARMED["on"] = True

    def _arm():
        if not _ARMED["on"]:
            return                  # disarmed before CUDA came up
        try:
            torch.cuda.memory._record_memory_history(**kwargs)
        except Exception as e:
            sys.stderr.write("sofa_tpu_torch: allocation stacks not "
                             "recorded: %r\\n" % (e,))

    try:
        for name in ("backward", "grad"):
            setattr(torch.autograd, name, _noting_backward(
                getattr(torch.autograd, name), torch))
        torch.cuda._lazy_call(_arm)
    except Exception as e:
        sys.stderr.write("sofa_tpu_torch: allocation stacks not armed: "
                         "%r\\n" % (e,))


def disarm_history(torch):
    """Undo arm_history in a program that goes on running: stop recording
    (or cancel the queued start) and unwrap the backward entry points."""
    _ARMED["on"] = False
    for name in ("backward", "grad"):
        fn = getattr(torch.autograd, name)
        if getattr(fn, "_sofa_torch_noted", False):
            setattr(torch.autograd, name, fn.__wrapped__)
    if torch.cuda.is_initialized():
        torch.cuda.memory._record_memory_history(enabled=None)


def _tagged(path, tag):
    """gpumon.txt -> gpumon.<tag>.txt, memprof.pb.gz -> memprof.<tag>.pb.gz"""
    stem, dot, ext = os.path.basename(path).partition(".")
    return os.path.join(os.path.dirname(path),
                        "%s.%s%s%s" % (stem, tag, dot, ext))


def _group_rank():
    """(rank, world size) of the process group this process joined, or
    None; imports nothing."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:
        pass
    return None


class _Names:
    """Where this process's sampler files go (the module docstring)."""

    def __init__(self, **plain):
        import multiprocessing

        self.plain = {k: p for k, p in plain.items() if p}
        self.rank = None
        self.unsettled = ("RANK" in os.environ
                          or multiprocessing.parent_process() is not None)
        self.now = {k: self._want(p) for k, p in self.plain.items()}

    def _want(self, path):
        if self.rank is not None:
            rank, world = self.rank
            return path if world < 2 else _tagged(path, "rank%d" % rank)
        return _tagged(path, "pid%d" % os.getpid()) if self.unsettled \
            else path

    def get(self, key):
        return self.now.get(key)

    def update(self):
        """Note the group's rank once it exists (it sticks: a group torn
        down before exit keeps it) and move the files written so far to
        the rank's names.  Same thread as the writes, or after them."""
        if self.rank is not None:
            return
        self.rank = _group_rank()
        if self.rank is None:
            return
        for key, old in self.now.items():
            new = self._want(self.plain[key])
            for suffix in ("", ".meta.json"):
                if os.path.exists(old + suffix):
                    os.replace(old + suffix, new + suffix)
            self.now[key] = new


def _write_devices(out_path, names_of):
    """The sampled devices' names beside the samples
    (``<out>.meta.json``, which moves with its file to the rank's name):
    what ``top`` labels a live run's devices with."""
    import json

    try:
        with open(out_path + ".meta.json.tmp", "w") as f:
            json.dump({"devices": names_of}, f)
        os.replace(out_path + ".meta.json.tmp", out_path + ".meta.json")
    except OSError:
        pass


def _loop(rate_hz, names, stop):
    torch = None
    while torch is None:
        if stop.is_set():
            return
        torch = _cuda_ready()
        if torch is None:
            time.sleep(0.1)
    interval = 1.0 / max(rate_hz, 1e-3)
    limits = {}
    names_of = {}
    try:
        names.update()
        out = open(names.get("out"), "a", buffering=1)
    except OSError:
        return
    with out:
        while True:
            # One more tick after the stop request: the allocator's peak is
            # a high-water counter, so a reading at the end holds the run's
            # true peak whatever the rate.
            stopping = stop.is_set()
            ts = time.time_ns()
            try:
                out.write("%d -1 0 0 0\\n" % ts)   # liveness heartbeat
                total_used = 0
                for d in _live_devices(torch):
                    ms = torch.cuda.memory_stats(d)
                    if not ms:
                        continue
                    if d not in limits:
                        props = torch.cuda.get_device_properties(d)
                        limits[d] = int(props.total_memory)
                        names_of[str(d)] = str(getattr(props, "name", ""))
                        _write_devices(names.get("out"), names_of)
                    used = int(ms.get("allocated_bytes.all.current", 0))
                    total_used += used
                    out.write("%d %d %d %d %d\\n" % (
                        ts, d, used, limits[d],
                        int(ms.get("allocated_bytes.all.peak", 0))))
                names.update()      # the open file moves with its name
                _maybe_memprof(torch, names.get("memprof"), total_used)
            except Exception:
                return
            if stopping:
                return
            stop.wait(interval)


def _mark(memprof_path, payload):
    """The at-exit breadcrumb (_inject/atexit_stop.json): when the final
    snapshot started, its deadline, and whether it finished.  The Kineto
    stop writes the same file after this (atexit is last-in, first-out);
    both merge with the same process's earlier write, "ok" false sticky
    (the tracer's write_marker)."""
    try:
        import json
        d = os.path.join(os.path.dirname(os.path.abspath(memprof_path)),
                         "_inject")
        if not os.path.isdir(d):
            return
        p = os.path.join(d, "atexit_stop.json")
        try:
            with open(p) as f:
                prev = json.load(f)
        except Exception:
            prev = {}
        if isinstance(prev, dict) and prev.get("pid") == payload["pid"] \\
                and prev.get("ok") is False:
            payload["ok"] = False
        with open(p + ".tmp", "w") as f:
            json.dump(payload, f)
        os.replace(p + ".tmp", p)
    except Exception:
        pass


def start_sampler(rate_hz, out_path, stop=None, memprof_path=None):
    """Start the sampler thread; returns it.  It waits for the program to
    initialize CUDA by itself, so it is safe to start right after ``import
    torch``.  Pass a threading.Event as ``stop`` to end the loop yourself;
    without one the sampler stops and joins at exit.  Pass
    ``memprof_path`` to take peak-triggered allocation-site snapshots.
    Both paths are the plain names; a rank's files take its rank's names
    (``_Names``), and the thread's ``names`` says where they are."""
    own_stop = stop is None
    if own_stop:
        stop = threading.Event()
    if memprof_path:
        _MEMPROF.update(snap=0, last=0.0)
    names = _Names(out=out_path, memprof=memprof_path)
    t = threading.Thread(
        target=_loop, args=(rate_hz, names, stop),
        daemon=True, name="sofa_torch_gpumon",
    )
    t.names = names
    t.start()
    if own_stop:
        # A daemon thread inside a CUDA call during interpreter teardown can
        # abort the process: stop and join the sampler BEFORE shutdown.
        import atexit

        def _shutdown():
            stop.set()
            t.join(timeout=2.0)
            if not t.is_alive():
                names.update()      # a group joined after the last tick
            memprof_path = names.get("memprof")
            # The at-exit snapshot (final_memprof), only when the program
            # initialized CUDA (the snapshot must not).
            if not (memprof_path and _cuda_ready() is not None):
                return
            try:
                timeout = float(os.environ.get(
                    "SOFA_TORCH_STOP_TIMEOUT_S", "30") or 0)
            except ValueError:
                timeout = 30.0
            _mark(memprof_path, {"pid": os.getpid(), "t": time.time(),
                                 "timeout_s": timeout, "grace_s": 0})
            snap = threading.Thread(
                target=lambda: final_memprof(sys.modules["torch"],
                                             memprof_path),
                daemon=True, name="sofa_torch_final_memprof")
            snap.start()
            snap.join(timeout if timeout > 0 else None)
            if snap.is_alive():
                sys.stderr.write("sofa_tpu_torch: final memprof exceeded "
                                 "%gs -- skipped\\n" % timeout)
            _mark(memprof_path, {"pid": os.getpid(), "t": time.time(),
                                 "timeout_s": timeout, "grace_s": 0,
                                 "done": True, "ok": not snap.is_alive()})

        atexit.register(_shutdown)
    return t
'''

# One implementation: exec the injected text for in-process callers (tests).
_ns: dict = {}
exec(compile(_SAMPLER, "<sofa_torch_gpumon>", "exec"), _ns)
start_sampler = _ns["start_sampler"]
snapshot_memprof = _ns["snapshot_memprof"]
final_memprof = _ns["final_memprof"]
arm_history = _ns["arm_history"]
disarm_history = _ns["disarm_history"]
MAX_ENTRIES = _ns["MAX_ENTRIES"]
HISTORY = _ns["HISTORY"]


def write_sampler_module(inject_dir: str) -> None:
    with open(os.path.join(inject_dir, "sofa_torch_gpumon.py"), "w") as f:
        f.write(_SAMPLER)
