"""record: run a command under the collectors.

The command runs as ``/bin/sh -c cmd`` in its own session (so an interrupt
takes its whole process tree down), with each collector's environment.  The
Kineto injection directory keeps PYTHONPATH position 0 (its sitecustomize
must be the one Python imports) and the repo root is appended after it, so
the child can import the port's workloads from any directory.  Writes
``sofa_time.txt`` (the run's time zero, unix seconds) and ``misc.txt``
(elapsed time, cores, pid, rc); returns the command's exit code.
"""

from __future__ import annotations

import glob
import os
import signal
import subprocess
import time

from sofa_tpu_torch.collectors.kineto import KinetoCollector
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.printing import print_info, print_warning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_stale(cfg: SofaConfig) -> None:
    """Drop a previous recording's outputs so frames never mix runs."""
    stale = glob.glob(os.path.join(cfg.kineto_dir, "*.json*"))
    stale += [cfg.path(n) for n in ("gpu_topo.json", "misc.txt",
                                    "features.csv", "gputrace.csv",
                                    "gpusteps.csv", "hosttrace.csv",
                                    "gpu_top_kernels.csv")]
    for path in stale:
        if os.path.isfile(path):
            os.unlink(path)


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


def sofa_record(command: str, cfg: SofaConfig) -> int:
    os.makedirs(cfg.logdir, exist_ok=True)
    _clean_stale(cfg)
    child_env = dict(os.environ)
    started = []
    for col in [KinetoCollector(cfg)]:
        reason = col.probe()
        if reason is not None:
            print_warning(f"{col.name}: {reason} — skipping this collector")
            continue
        col.start()
        started.append(col)
        child_env.update(col.child_env())
    parts = [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
             if p]
    if REPO not in parts:
        parts.append(REPO)
    child_env["PYTHONPATH"] = os.pathsep.join(parts)

    t0 = time.time()
    with open(cfg.path("sofa_time.txt"), "w") as f:
        f.write(f"{t0:.9f}\n")
    print_info(f"launching: {command}")
    child = subprocess.Popen(["/bin/sh", "-c", command], env=child_env,
                             start_new_session=True)
    rc = _wait(child)
    elapsed = time.time() - t0
    if rc < 0:                          # killed by a signal: shell convention
        rc = 128 - rc
    print_info(f"command finished in {elapsed:.3f} s (rc={rc})")
    for col in reversed(started):
        col.stop()
        col.harvest()
    with open(cfg.path("misc.txt"), "w") as f:
        f.write(f"elapsed_time {elapsed:.6f}\n")
        f.write(f"cores {os.cpu_count() or 1}\n")
        f.write(f"pid {child.pid}\n")
        f.write(f"rc {rc}\n")
    return rc
