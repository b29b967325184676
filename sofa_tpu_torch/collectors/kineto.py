"""Device tracing by zero-code-change injection, with torch.profiler (Kineto).

The JAX package's xprof collector gets inside the profiled program by
writing a ``sitecustomize.py`` into ``logdir/_inject/`` and putting that
directory first on the child's PYTHONPATH.  This collector keeps the design
and swaps the tracer:

  1. the injected file chains to the next ``sitecustomize`` on sys.path (an
     environment's own hook must still run), bounded by SIGALRM;
  2. it arms lazily: a meta-path finder wraps the loader of ``torch`` and,
     the moment ``import torch`` finishes in the profiled program, starts
     ``torch.profiler.profile`` on the importing thread, recording each
     op's operand shapes and dtypes (``record_shapes``, ``with_flops``:
     what ingest computes a kernel's flops and bytes from), with the CUDA
     activity added only when ``torch.cuda.is_available()`` in the child —
     so CUPTI is live before the program's first CUDA launch.  How much it
     records is ``--kineto_host_tracer_level`` (0 to 3, ``_profiler``)
     and ``--kineto_python_tracer``; ``--kineto_delay_s`` starts it later
     and ``--kineto_duration_s`` stops it early, each on the importing
     thread at its next Python call after the timer fires (a
     ``sys.monitoring`` hook: the profiler records, and stops from, the
     thread that started it);
  3. it stamps a ``record_function("sofa_timebase_marker:<unix_ns>")`` range
     that pins the trace clock to unix time at ingest, at the start and
     again at the stop;
  4. at exit it synchronizes the card (only if the program initialized
     CUDA), stops the profiler and exports the Chrome trace to
     ``logdir/kineto/trace_<pid>.json``, under a watchdog that force-exits
     with code 120 if the epilogue wedges; then writes ``gpu_topo.json``
     (device properties, peer access, and the ``nvidia-smi`` name and
     power limit, when that binary exists), or, in a rank of a process
     group (noted when the program calls ``init_process_group``: the
     trace started before it), the rank's record
     ``gpu_topo/rank_<rank>.json``, and the rank into the trace's
     ``distributedInfo``; ``preprocess`` merges the records
     (``merge_rank_topology``).  The stop writes the at-exit breadcrumb
     ``_inject/atexit_stop.json`` as it begins and as it ends (the JAX
     tracer's, ``sofa_tpu/collectors/xprof.py:219-303``), so that record
     can bound its wait on a child that wedges there (``record.py``).

Steps 2 to 4 live in the tracer module written beside the sitecustomize
(``sofa_torch_kineto.py``, the ``_TRACER`` text); the in-process
``sofa_tpu_torch.api.profile()`` runs the same text.

The same injection carries the in-process samplers, as the xprof one does:
the Python stack sampler (collectors/pystacks.py) starts at interpreter
start-up; on ``import torch`` the GPU memory sampler (collectors/gpumon.py)
starts and allocation-stack recording is armed for its snapshots.  Their
at-exit stop is registered after the profiler's, so it runs first (atexit
is last-in, first-out) and neither waits on the other.

Programs that never import torch leave the torch half inert.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from sofa_tpu_torch.collectors import gpumon, pystacks
from sofa_tpu_torch.collectors.base import Collector

# Dependency-free: it runs inside whatever Python the user's command uses.
_SITECUSTOMIZE = r'''
"""sofa_tpu_torch record-time injection (auto-generated)."""
import atexit
import json
import os
import sys
import threading
import time

_OPTS = json.loads(os.environ.get("SOFA_TORCH_KINETO_OPTS", "{}"))
_STATE = {"armed": False}


def _warn(msg):
    sys.stderr.write("sofa_tpu_torch: %s\n" % msg)


def _chain_next_sitecustomize():
    # Python imports one sitecustomize, the first on sys.path (ours); run
    # the next one too so an environment's own hook is not shadowed.  A hook
    # that blocks is cut off by SIGALRM so the profiled program still starts.
    import importlib.util
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    for p in sys.path:
        try:
            ap = os.path.abspath(p or os.getcwd())
        except OSError:
            continue
        cand = os.path.join(ap, "sitecustomize.py")
        if ap == here or not os.path.isfile(cand):
            continue

        def _alarm(signum, frame):
            raise TimeoutError("chained sitecustomize %s took over 120 s" % cand)

        armed, old = False, None
        try:
            old = signal.signal(signal.SIGALRM, _alarm)
            signal.alarm(120)
            armed = True
        except (ValueError, OSError):
            pass                # not the main thread: run it unguarded
        try:
            spec = importlib.util.spec_from_file_location("sitecustomize", cand)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as e:  # noqa: BLE001 - never break the program
            _warn("chained sitecustomize %s failed: %r" % (cand, e))
        finally:
            if armed:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old or signal.SIG_DFL)
        return


_chain_next_sitecustomize()


def _start(torch):
    from sofa_torch_kineto import start_trace, stop_trace   # beside us

    state = start_trace(torch, _OPTS["logdir"], _OPTS)
    if state is not None:
        atexit.register(stop_trace, torch, state, True)


def _start_gpumon(torch):
    try:
        from sofa_torch_gpumon import arm_history, start_sampler  # beside us

        if os.environ.get("SOFA_TORCH_MEMPROF_OUT"):
            arm_history(torch)
        start_sampler(float(os.environ["SOFA_TORCH_GPUMON_HZ"]),
                      os.environ["SOFA_TORCH_GPUMON_OUT"],
                      memprof_path=os.environ.get("SOFA_TORCH_MEMPROF_OUT"))
    except Exception as e:  # noqa: BLE001
        _warn("gpu memory sampler start failed: %r" % (e,))


class _StartAfterExec:
    # Delegating loader: runs torch's own loader, then starts the profiler
    # on the thread that imported torch (the profiler's CPU-side ranges are
    # per thread, so it must be the program's, not a watcher's), then the
    # memory sampler.
    def __init__(self, inner):
        self._inner = inner

    def create_module(self, spec):
        return self._inner.create_module(spec)

    def exec_module(self, module):
        self._inner.exec_module(module)
        if _OPTS.get("enable"):
            _start(module)
        if os.environ.get("SOFA_TORCH_GPUMON_HZ"):
            _start_gpumon(module)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _ArmOnTorchImport:
    # Observes the first `import torch` and wraps its loader; returns None
    # (normal import) for everything else and after arming.
    def find_spec(self, name, path=None, target=None):
        if name != "torch" or _STATE["armed"]:
            return None
        _STATE["armed"] = True
        from importlib.machinery import PathFinder

        spec = PathFinder.find_spec(name, path)
        if spec is None or spec.loader is None:
            return None
        spec.loader = _StartAfterExec(spec.loader)
        return spec


if ((_OPTS.get("enable") or os.environ.get("SOFA_TORCH_GPUMON_HZ"))
        and "torch" not in sys.modules):
    sys.meta_path.insert(0, _ArmOnTorchImport())

if os.environ.get("SOFA_TORCH_PYSTACKS_HZ"):
    from sofa_torch_pystacks import start_sampler as _pystacks_start

    _pystacks_start(float(os.environ["SOFA_TORCH_PYSTACKS_HZ"]),
                    os.environ["SOFA_TORCH_PYSTACKS_OUT"])
'''

# The trace's start and stop, imported by the sitecustomize above from
# beside it, and exec'd below for the in-process profile() (api.py).
_TRACER = r'''
"""sofa_tpu_torch Kineto tracer (auto-generated)."""
import json
import os
import sys
import threading
import time

STOP_TIMEOUT_S = 300.0     # bound on the at-exit stop and trace export


def _warn(msg):
    sys.stderr.write("sofa_tpu_torch: %s\n" % msg)


def write_marker(logdir, payload):
    """The at-exit breadcrumb (logdir/_inject/atexit_stop.json) that lets
    the parent record bound its wait on a child wedged at exit: written as
    a stop begins ({pid, t, timeout_s, grace_s}) and as it ends (done, ok).
    The memory sampler's final snapshot writes the same file, before this
    stop (atexit runs last-in, first-out), so each write merges with the
    same process's earlier one: "ok" false is sticky, and one writer's
    success never hides the other's failure.  Only under record (the
    injection directory exists)."""
    d = os.path.join(logdir, "_inject")
    if not os.path.isdir(d):
        return
    p = os.path.join(d, "atexit_stop.json")
    try:
        with open(p) as f:
            prev = json.load(f)
    except Exception:  # noqa: BLE001 - none yet, or torn
        prev = {}
    if isinstance(prev, dict) and prev.get("pid") == payload.get("pid") \
            and prev.get("ok") is False:
        payload["ok"] = False
    try:
        with open(p + ".tmp", "w") as f:
            json.dump(payload, f)
        os.replace(p + ".tmp", p)
    except OSError:
        pass


def _marker(torch):
    with torch.profiler.record_function(
            "sofa_timebase_marker:%d" % time.time_ns()):
        pass


def _arm_watchdog(timeout, state):
    def _force_exit():
        time.sleep(timeout)
        if not state["done"]:
            _warn("trace export exceeded %g s; force-exiting (120)" % timeout)
            write_marker(state["logdir"], {
                "pid": os.getpid(), "t": time.time(), "timeout_s": timeout,
                "grace_s": 0, "done": True, "ok": False})
            os._exit(120)

    threading.Thread(target=_force_exit, daemon=True,
                     name="sofa_torch_watchdog").start()


def _dist_info(torch):
    """{backend, rank, world_size} of the process group this process
    joined, or None (none yet, or torch.distributed is absent)."""
    try:
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return {"backend": str(dist.get_backend()), "rank": dist.get_rank(),
                "world_size": dist.get_world_size()}
    except Exception:  # noqa: BLE001 - a probe of the program's state
        return None


#: the collectives whose process group a gloo trace would not name
GLOO_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather",
                    "reduce_scatter_tensor", "reduce_scatter",
                    "all_to_all_single", "broadcast")
#: the range a named collective runs in: ``sofa_comms:<name>:<ranks>``
COMMS_RANGE = "sofa_comms:%s:%s"


def _group_range(torch, dist, name, fn):
    """``fn`` inside a ``sofa_comms:<name>:<ranks>`` range naming its
    process group's global ranks, where the group's backend is not NCCL
    (whose collectives record ``record_param_comms`` with their ranks
    themselves; gloo's record neither)."""
    def collective(*args, **kwargs):
        group = kwargs.get("group")
        try:
            if dist.get_backend(group) == "nccl":
                return fn(*args, **kwargs)
            ranks = dist.get_process_group_ranks(
                group or dist.group.WORLD)
        except Exception:  # noqa: BLE001 - the collective raises itself
            return fn(*args, **kwargs)
        label = COMMS_RANGE % (name, ",".join(map(str, ranks)))
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    collective.__wrapped__ = fn
    return collective


def _watch_process_group(torch, state):
    """Note the rank when the program joins a process group: the profiler
    started before it did, so its trace names no rank, and a program may
    leave the group before exit.  Name each gloo collective's process
    group in a range around it (``_group_range``).  Undone by
    stop_trace."""
    try:
        import torch.distributed as dist

        if not dist.is_available():
            return
        c10d = dist.distributed_c10d
        orig = c10d.init_process_group

        def init_process_group(*args, **kwargs):
            out = orig(*args, **kwargs)
            state["dist"] = _dist_info(torch) or state.get("dist")
            return out

        c10d.init_process_group = dist.init_process_group = \
            init_process_group
        colls = {n: getattr(c10d, n) for n in GLOO_COLLECTIVES
                 if hasattr(c10d, n)}
        for n, fn in colls.items():
            setattr(c10d, n, _group_range(torch, dist, n, fn))
            setattr(dist, n, getattr(c10d, n))

        def unwatch():
            c10d.init_process_group = dist.init_process_group = orig
            for n, fn in colls.items():
                setattr(c10d, n, fn)
                setattr(dist, n, fn)

        state["unwatch"] = unwatch
    except Exception as e:  # noqa: BLE001 - never break the program
        _warn("process-group watch failed: %r" % (e,))


def write_topology(torch, logdir, dist_info=None):
    """The devices the program initialized (name, memory, SMs,
    capability, uuid), which of them can reach each other's memory (peer
    access), and the nvidia-smi name and power limit: gpu_topo.json, or,
    for a rank of a process group (``dist_info``), the rank's own record
    ``gpu_topo/rank_<rank>.json`` with its rank, world size, backend,
    host and CUDA ordinal (preprocess merges the records into
    gpu_topo.json).  A process that never joined a group (torchrun's
    agent, a plain program) is not a rank."""
    info = {"cuda_available": False, "devices": []}
    try:
        info["cuda_available"] = bool(torch.cuda.is_available())
        if info["cuda_available"] and torch.cuda.is_initialized():
            n = torch.cuda.device_count()
            for i in range(n):
                p = torch.cuda.get_device_properties(i)
                info["devices"].append({
                    "index": i, "name": p.name,
                    "total_memory": int(p.total_memory),
                    "multi_processor_count": int(p.multi_processor_count),
                    "capability": "%d.%d" % (p.major, p.minor),
                    "uuid": str(getattr(p, "uuid", ""))})
            info["peer_access"] = [
                [i, j] for i in range(n) for j in range(n)
                if i != j and torch.cuda.can_device_access_peer(i, j)]
        import shutil
        import socket
        import subprocess

        if shutil.which("nvidia-smi"):
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
            info["nvidia_smi"] = r.stdout.strip()
        path = os.path.join(logdir, "gpu_topo.json")
        if dist_info is not None:
            info.update(dist_info, host=socket.gethostname(),
                        pid=os.getpid(), cuda_ordinal=(
                            torch.cuda.current_device()
                            if torch.cuda.is_initialized() else None))
            path = os.path.join(logdir, "gpu_topo",
                                "rank_%d.json" % dist_info["rank"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump(info, f, indent=1)
        os.replace(path + ".tmp", path)
    except Exception as e:  # noqa: BLE001
        _warn("topology snapshot failed: %r" % (e,))


def _profiler(torch, opts):
    """A started torch.profiler at the detail ``opts`` asks for, and
    whether it records the CUDA activity (when the program sees a card).

    ``host_tracer_level``: 0 records the device activity, the runtime
    calls that launched it and the program's record_function ranges (the
    clock marker, sofa_step_N, module ranges and the flash kernels' cost
    ranges) but no aten op; 1 adds the aten ops, without their operand
    shapes; 2 (the default) adds the shapes and flops, which a kernel's
    flops and bytes come from; 3 adds each op's Python stack, as
    ``python_tracer`` does at any level."""
    import torch.profiler as tp

    level = int(opts.get("host_tracer_level", 2))
    cuda = bool(torch.cuda.is_available())
    acts = [tp.ProfilerActivity.CPU]
    if cuda:
        acts.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=acts, record_shapes=level >= 2,
                      with_flops=level >= 2,
                      with_stack=level >= 3 or bool(opts.get("python_tracer")))
    if level > 0:
        prof.start()
        return prof, cuda
    # level 0: the CPU callbacks are registered for the record_function
    # scope alone, through the scopes argument torch.profiler leaves unset
    import torch.autograd.profiler as ap
    from torch._C._profiler import RecordScope

    enable = ap._enable_profiler

    def user_scope_only(config, activities, scopes=None):
        return enable(config, activities, {RecordScope.USER_SCOPE})

    ap._enable_profiler = user_scope_only
    try:
        prof.start()
    finally:
        ap._enable_profiler = enable
    return prof, cuda


def _on_thread(ident, fn):
    """Run ``fn()`` on the thread ``ident`` at its next Python call outside
    this module, through a sys.monitoring PY_START hook that removes itself
    (torch.profiler records the CPU side of the thread that starts it, and
    stops only from that thread).  The hook does nothing once the program
    is exiting: the at-exit stop owns that.  False when there is no free
    monitoring tool (or no sys.monitoring: Python < 3.12)."""
    mon = getattr(sys, "monitoring", None)
    if mon is None:
        return False
    tool = None
    for t in (4, 3, 5, 2, 1, 0):
        try:
            mon.use_tool_id(t, "sofa_tpu_torch")
            tool = t
            break
        except ValueError:
            continue
    if tool is None:
        return False
    here = _on_thread.__code__.co_filename
    fired = []

    def hook(code, offset):
        if fired or threading.get_ident() != ident \
                or code.co_filename == here:
            return None
        fired.append(True)
        mon.set_events(tool, 0)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.free_tool_id(tool)
        if threading.main_thread().is_alive():
            fn()
        return None

    mon.register_callback(tool, mon.events.PY_START, hook)
    mon.set_events(tool, mon.events.PY_START)
    return True


def _later(seconds, ident, fn, what):
    """``fn()`` on the thread ``ident`` ``seconds`` from now."""
    def arm():
        if not _on_thread(ident, fn):
            _warn("%s: no sys.monitoring tool is free; ignored" % what)

    timer = threading.Timer(seconds, arm)
    timer.daemon = True
    timer.start()


def start_trace(torch, logdir, opts=None):
    """Start torch.profiler on the calling thread at the detail of
    ``opts`` (``_profiler``) and stamp the timebase marker; returns the
    state stop_trace takes, or None when the profiler would not start.

    The window: with ``opts["delay_s"]`` the trace starts that long from
    now, at the calling thread's next Python call (``_on_thread``), and
    with ``opts["duration_s"]`` it stops that long after it started, on
    that thread too; the at-exit stop then finds it stopped."""
    opts = dict(opts or {})
    state = {"logdir": logdir, "opts": opts, "done": False,
             "dist": _dist_info(torch)}
    ident = threading.get_ident()
    delay = float(opts.get("delay_s") or 0)
    if delay > 0:
        state["pending"] = True
        _later(delay, ident, lambda: _begin(torch, state, ident),
               "kineto_delay_s")
        return state
    return state if _begin(torch, state, ident) else None


def _begin(torch, state, ident):
    if state.get("stopping") or "prof" in state:
        return False
    state.pop("pending", None)
    try:
        prof, cuda = _profiler(torch, state["opts"])
    except Exception as e:  # noqa: BLE001
        _warn("profiler start failed: %r" % (e,))
        return False
    _marker(torch)
    state.update(prof=prof, cuda=cuda, t_start=time.time(),
                 dist=_dist_info(torch) or state.get("dist"))
    _watch_process_group(torch, state)
    duration = float(state["opts"].get("duration_s") or 0)
    if duration > 0:
        _later(duration, ident, lambda: stop_trace(torch, state),
               "kineto_duration_s")
    return True


def stop_trace(torch, state, watchdog=False):
    """Stamp the end marker, synchronize the card (only if the program
    initialized CUDA), stop the profiler (with the detail and window in
    the trace's ``sofa_trace_detail``), export the Chrome trace to
    ``logdir/kineto/trace_<pid>.json`` (with the rank, when the program
    joined a process group) and write the topology.  At exit
    (``watchdog``) a wedged export force-exits the process with code 120
    after STOP_TIMEOUT_S."""
    state["stopping"] = True       # a start still pending never fires
    prof = state.pop("prof", None)
    if prof is None:
        if state.pop("pending", False):
            _warn("the trace never started: the run ended within "
                  "kineto_delay_s")
            write_topology(torch, state["logdir"], state.get("dist"))
        return
    if watchdog:
        write_marker(state["logdir"], {
            "pid": os.getpid(), "t": time.time(),
            "timeout_s": STOP_TIMEOUT_S, "grace_s": 0})
        _arm_watchdog(STOP_TIMEOUT_S, state)
    state.pop("unwatch", lambda: None)()
    dist_info = _dist_info(torch) or state.get("dist")
    try:
        _marker(torch)
        if dist_info is not None:
            # what torch.profiler records only when the group exists as
            # the trace starts: ingest reads the rank from it
            prof.add_metadata_json("distributedInfo", json.dumps(dist_info))
        # what the trace recorded, and when: ingest reads the level
        opts = state["opts"]
        prof.add_metadata_json("sofa_trace_detail", json.dumps({
            "host_tracer_level": int(opts.get("host_tracer_level", 2)),
            "python_tracer": bool(opts.get("python_tracer")),
            "delay_s": float(opts.get("delay_s") or 0),
            "duration_s": float(opts.get("duration_s") or 0),
            "start_unix": state.get("t_start"), "stop_unix": time.time()}))
        if state["cuda"] and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        elif getattr(prof, "profiler", None) is not None:
            # The program never used the card: stop without the profiler's
            # own device synchronize, which would initialize CUDA.
            prof.profiler.use_device = None
        prof.stop()
        out = os.path.join(state["logdir"], "kineto",
                           "trace_%d.json" % os.getpid())
        os.makedirs(os.path.dirname(out), exist_ok=True)
        prof.export_chrome_trace(out + ".tmp")
        os.replace(out + ".tmp", out)
    except Exception as e:  # noqa: BLE001
        _warn("trace stop/export failed: %r" % (e,))
    write_topology(torch, state["logdir"], dist_info)
    state["done"] = True
    if watchdog:
        # finished inside its bound: "ok" (an export error is warned
        # above; it wedged nothing)
        write_marker(state["logdir"], {
            "pid": os.getpid(), "t": time.time(),
            "timeout_s": STOP_TIMEOUT_S, "grace_s": 0, "done": True,
            "ok": True})
'''

def merge_rank_topology(logdir: str) -> bool:
    """Merge the ranks' records (``gpu_topo/rank_<r>.json``) into the
    ``gpu_topo.json`` the passes read: one device per rank, its ``id``
    and ``index`` the global rank (the trace's deviceId), with the card it
    ran on (host, CUDA ordinal, name, uuid), the rank records themselves
    and, per host, the cards' peer access.  False (nothing written) when
    no rank wrote a record."""
    import glob

    records = []
    for path in glob.glob(os.path.join(logdir, "gpu_topo", "rank_*.json")):
        try:
            with open(path) as f:
                records.append(json.load(f))
        except (OSError, ValueError):
            continue
    if not records:
        return False
    records.sort(key=lambda r: r["rank"])
    devices = []
    for r in records:
        card = next((d for d in r.get("devices", [])
                     if d.get("index") == r.get("cuda_ordinal")), {})
        devices.append({**card, "id": r["rank"], "index": r["rank"],
                        "rank": r["rank"], "host": r.get("host", ""),
                        "cuda_ordinal": r.get("cuda_ordinal")})
    merged = {"cuda_available": any(r.get("cuda_available")
                                    for r in records),
              "world_size": records[0].get("world_size", len(records)),
              "backend": records[0].get("backend", ""),
              "devices": devices,
              "peer_access": {r.get("host", ""): r.get("peer_access", [])
                              for r in records},
              "ranks": records}
    smi = next((r["nvidia_smi"] for r in records if r.get("nvidia_smi")),
               None)
    if smi is not None:
        merged["nvidia_smi"] = smi
    path = os.path.join(logdir, "gpu_topo.json")
    with open(path + ".tmp", "w") as f:
        json.dump(merged, f, indent=1)
    os.replace(path + ".tmp", path)
    return True


def trace_opts(cfg) -> dict:
    """The trace's detail and window from a SofaConfig, as start_trace
    takes them."""
    return {"host_tracer_level": int(cfg.kineto_host_tracer_level),
            "python_tracer": bool(cfg.kineto_python_tracer),
            "delay_s": float(cfg.kineto_delay_s),
            "duration_s": float(cfg.kineto_duration_s)}


# One implementation: exec the tracer text for in-process callers.
_ns: dict = {}
exec(compile(_TRACER, "<sofa_torch_kineto>", "exec"), _ns)
start_trace = _ns["start_trace"]
stop_trace = _ns["stop_trace"]
write_topology = _ns["write_topology"]


class KinetoCollector(Collector):
    name = "kineto"

    def probe(self) -> Optional[str]:
        # The injection carries the trace AND the gpumon/pystacks samplers;
        # it is only pointless when all three are off.
        cfg = self.cfg
        if not (cfg.enable_kineto or cfg.enable_gpu_mon
                or cfg.enable_py_stacks):
            return "disabled (--disable_kineto and --disable_gpu_mon)"
        return None

    def start(self) -> None:
        cfg = self.cfg
        os.makedirs(cfg.inject_dir, exist_ok=True)
        if cfg.enable_kineto:
            os.makedirs(cfg.kineto_dir, exist_ok=True)
        for name, text in (("sitecustomize.py", _SITECUSTOMIZE),
                           ("sofa_torch_kineto.py", _TRACER)):
            with open(os.path.join(cfg.inject_dir, name), "w") as f:
                f.write(text)
        gpumon.write_sampler_module(cfg.inject_dir)
        pystacks.write_sampler_module(cfg.inject_dir)

    def child_env(self) -> Dict[str, str]:
        cfg = self.cfg
        opts = {"enable": bool(cfg.enable_kineto),
                "logdir": os.path.abspath(cfg.logdir),
                **trace_opts(cfg)}
        existing = os.environ.get("PYTHONPATH", "")
        env = {
            "SOFA_TORCH_KINETO_OPTS": json.dumps(opts),
            "PYTHONPATH": os.path.abspath(cfg.inject_dir)
            + (os.pathsep + existing if existing else ""),
        }
        if cfg.enable_py_stacks:
            env["SOFA_TORCH_PYSTACKS_HZ"] = str(cfg.py_stack_rate)
            env["SOFA_TORCH_PYSTACKS_OUT"] = os.path.abspath(
                cfg.path("pystacks.txt"))
        if cfg.enable_gpu_mon:
            env["SOFA_TORCH_GPUMON_HZ"] = str(cfg.gpu_mon_rate)
            env["SOFA_TORCH_GPUMON_OUT"] = os.path.abspath(
                cfg.path("gpumon.txt"))
            if cfg.enable_mem_prof:
                env["SOFA_TORCH_MEMPROF_OUT"] = os.path.abspath(
                    cfg.path("memprof.pb.gz"))
        return env

    def outputs(self) -> List[str]:
        cfg = self.cfg
        return [cfg.kineto_dir, cfg.path("gpu_topo.json"),
                cfg.path("gpu_topo"),
                cfg.path("gpumon.txt"), cfg.path("pystacks.txt"),
                cfg.path("memprof.pb.gz"),
                cfg.path("memprof.pb.gz.meta.json")]
