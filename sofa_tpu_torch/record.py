"""record: run a command under the collector swarm.

  prologue  clean the previous recording's files, then probe and start the
            collectors in order (timebase, procmon, vmstat, tcpdump,
            blktrace, the Kineto injection, then the prefix-only strace and
            perf); a collector whose probe fails is skipped with a warning,
            one that fails to start costs its own series only;
  launch    ``[prefixes...] /bin/sh -c cmd`` in its own session (so an
            interrupt takes its whole process tree down), with every
            collector's environment.  The Kineto injection directory keeps
            PYTHONPATH position 0 (its sitecustomize must be the one Python
            imports) and the repo root is appended after it, so the child
            can import the port's workloads from any directory;
  epilogue  stop the collectors in reverse order, then harvest each, and
            write ``misc.txt`` (elapsed time, cores, pid, rc).

Returns the command's exit code.
"""

from __future__ import annotations

import glob
import os
import shutil
import signal
import subprocess
import time

from sofa_tpu_torch.collectors.hostproc import (
    BlktraceCollector,
    StraceCollector,
    TcpdumpCollector,
    VmstatCollector,
)
from sofa_tpu_torch.collectors.kineto import KinetoCollector
from sofa_tpu_torch.collectors.perf import PerfCollector
from sofa_tpu_torch.collectors.procmon import ProcMonCollector
from sofa_tpu_torch.collectors.timebase import TimebaseCollector
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.printing import print_info, print_warning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_collectors(cfg: SofaConfig):
    """Construction order == start order; stop is the reverse."""
    return [
        TimebaseCollector(cfg),
        ProcMonCollector(cfg),
        VmstatCollector(cfg),
        TcpdumpCollector(cfg),
        BlktraceCollector(cfg),
        KinetoCollector(cfg),
        # prefix-only collectors last so their probe warnings read near launch
        StraceCollector(cfg),
        PerfCollector(cfg),
    ]


# What a recording and its preprocess/analyze leave in the logdir, beside
# the frame CSVs; only these are cleaned, never other files of the logdir.
_RUN_FILES = (
    "sofa_time.txt", "timebase.txt", "misc.txt", "gpu_topo.json",
    "mpstat.txt", "diskstat.txt", "netstat.txt", "cpuinfo.txt", "vmstat.txt",
    "sofa.pcap", "net_addrs.csv", "blktrace.txt", "strace.txt", "perf.data",
    "perf.script", "time.txt", "kallsyms", "gpumon.txt", "pystacks.txt",
    "memprof.pb.gz", "memprof.pb.gz.meta.json", "features.csv",
    "gpu_top_kernels.csv", "gpu_memprof.csv", "cpu_top.csv",
    "disk_summary.csv", "strace_top.csv", "pystacks_top.csv",
    "gpu_categories.csv", "gpu_modules_summary.csv", "gpu_op_tree.csv",
    "gpu_input_pipeline.csv", "roofline.csv", "sol_roofline.csv",
)


def _clean_stale(cfg: SofaConfig) -> None:
    """Drop a previous recording's files so frames never mix runs."""
    from sofa_tpu_torch.preprocess import frame_names

    stale = [cfg.path(n) for n in _RUN_FILES]
    stale += [cfg.path(f"{n}.csv") for n in frame_names()]
    stale += glob.glob(os.path.join(cfg.kineto_dir, "*.json*"))
    stale += glob.glob(cfg.path("blktrace.blktrace.*"))
    for path in stale:
        if os.path.isfile(path):
            os.unlink(path)
    shutil.rmtree(cfg.inject_dir, ignore_errors=True)


def _signal_tree(child: subprocess.Popen, sig: int) -> None:
    try:
        os.killpg(child.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def _raise_interrupt(signum, frame):
    raise KeyboardInterrupt


def _wait(child: subprocess.Popen) -> int:
    """Wait for the child; an interrupt (SIGINT, or SIGTERM while we wait)
    terminates its process group, then kills it after 10 s."""
    try:
        old = signal.signal(signal.SIGTERM, _raise_interrupt)
    except ValueError:                  # not the main thread
        old = None
    try:
        return child.wait()
    except KeyboardInterrupt:
        print_warning("interrupted; terminating the profiled command")
        _signal_tree(child, signal.SIGTERM)
        try:
            return child.wait(timeout=10)
        except subprocess.TimeoutExpired:
            _signal_tree(child, signal.SIGKILL)
            return child.wait()
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)


def _start_collectors(cfg: SofaConfig, child_env: dict):
    """Probe and start every collector; returns (started, prefix)."""
    started, prefix = [], []
    for col in build_collectors(cfg):
        reason = col.probe()
        if reason is not None:
            print_warning(f"{col.name}: {reason} — skipping this collector")
            continue
        try:
            col.start()
        except Exception as e:  # noqa: BLE001 - costs this series only
            print_warning(f"{col.name}: start failed: {e}")
            continue
        started.append(col)
        prefix += col.command_prefix()
        child_env.update(col.child_env())
    return started, prefix


def _stop_collectors(started) -> None:
    for col in reversed(started):
        try:
            col.stop()
        except Exception as e:  # noqa: BLE001
            print_warning(f"{col.name}: stop failed: {e}")
    for col in started:
        try:
            col.harvest()
        except Exception as e:  # noqa: BLE001
            print_warning(f"{col.name}: harvest failed: {e}")


def sofa_record(command: str, cfg: SofaConfig) -> int:
    os.makedirs(cfg.logdir, exist_ok=True)
    _clean_stale(cfg)
    child_env = dict(os.environ)
    started, prefix = _start_collectors(cfg, child_env)
    try:
        parts = [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
                 if p]
        if REPO not in parts:
            parts.append(REPO)
        child_env["PYTHONPATH"] = os.pathsep.join(parts)

        print_info(f"launching: {command}")
        t0 = time.time()
        child = subprocess.Popen(prefix + ["/bin/sh", "-c", command],
                                 env=child_env, start_new_session=True)
        rc = _wait(child)
        elapsed = time.time() - t0
        if rc < 0:                      # killed by a signal: shell convention
            rc = 128 - rc
        print_info(f"command finished in {elapsed:.3f} s (rc={rc})")
    finally:
        _stop_collectors(started)
    with open(cfg.path("misc.txt"), "w") as f:
        f.write(f"elapsed_time {elapsed:.6f}\n")
        f.write(f"cores {os.cpu_count() or 1}\n")
        f.write(f"pid {child.pid}\n")
        f.write(f"rc {rc}\n")
    return rc
