"""record: run a command under the collector swarm.

  prologue  clean the previous recording's files, then probe and start the
            collectors in order (timebase, procmon, vmstat, tcpdump,
            blktrace, the Kineto injection, then the prefix-only strace and
            perf) through the instrumented lifecycle (collectors/base.py);
            a collector whose probe fails is skipped, one that fails to
            start costs its own series only;
  supervise a CollectorSupervisor (supervisor.py) watches the started
            collectors from this process until the epilogue: restarts,
            stalls, disk budgets;
  launch    ``[prefixes...] /bin/sh -c cmd`` in its own session (so an
            interrupt or a SIGTERM takes its whole process tree down),
            with every collector's environment.  The Kineto injection
            directory keeps PYTHONPATH position 0 (its sitecustomize must
            be the one Python imports) and the repo root is appended after
            it.  The wait is bounded once the child is wedged at exit
            (``_wait_epilogue_bounded``).  With ``--pid``, attach to a
            running process instead and wait for it to exit;
  epilogue  stop the collectors in reverse order, then harvest each, under
            their deadlines, and write ``misc.txt`` (elapsed time, cores,
            pid, rc).  A failure before it kills every collector first.

The run manifest (``telemetry.py``) is written on every exit.  This is the
JAX package's ``record.py:287-598, 649-697``, without its docker scoping
and cluster recording.  Returns the command's exit code.
``sofa_clean`` (the ``clean`` verb) removes what preprocess and analyze
derived, keeping the raw output.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import signal
import subprocess
import time
from typing import List, Optional

from sofa_tpu_torch import faults, telemetry
from sofa_tpu_torch.collectors.base import ensure_logdir, signal_tree
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
from sofa_tpu_torch.printing import (print_error, print_info,
                                     print_progress, print_warning)

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


# What a recording leaves in the logdir (beside kineto/): kept by clean.
RAW_FILES = (
    "sofa_time.txt", "timebase.txt", "misc.txt", "gpu_topo.json",
    "mpstat.txt", "diskstat.txt", "netstat.txt", "cpuinfo.txt", "vmstat.txt",
    "sofa.pcap", "blktrace.txt", "strace.txt", "perf.data", "perf.script",
    "time.txt", "kallsyms", "gpumon.txt", "pystacks.txt", "memprof.pb.gz",
    "memprof.pb.gz.meta.json",
)
# What preprocess and analyze derive from it, beside the frame CSVs and the
# staged board pages: removed by clean.
ANALYSIS_FILES = (
    "net_addrs.csv", "report.js", "features.csv", "hints.txt",
    "gpu_top_kernels.csv", "gpu_memprof.csv", "cpu_top.csv",
    "disk_summary.csv", "strace_top.csv", "pystacks_top.csv",
    "gpu_categories.csv", "gpu_modules_summary.csv", "gpu_op_tree.csv",
    "gpu_input_pipeline.csv", "roofline.csv", "sol_roofline.csv",
    "_derived.writing", "run_manifest.json", "sofa_self_trace.json",
)
DERIVED_DIRS = ("_tiles", "_ingest_cache", "_quarantine")
# The at-exit breadcrumb of the injected stops, in the injection directory.
MARKER_NAME = "atexit_stop.json"


def derived_names():
    """THE list of derived files (frame CSVs, analysis files, staged
    pages), shared by ``_clean_stale`` and ``sofa_clean``."""
    from sofa_tpu_torch.analyze import board_pages
    from sofa_tpu_torch.preprocess import frame_names

    return ([f"{n}.csv" for n in frame_names()] + list(ANALYSIS_FILES)
            + board_pages())


def _remove(path: str) -> bool:
    """Remove a file or a directory tree; a failure costs this entry only,
    with a warning.  Returns whether something was removed."""
    try:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.isfile(path):
            os.unlink(path)
        else:
            return False
        return True
    except OSError as e:
        print_warning(f"cannot remove {path}: {e}")
        return False


def _clean_stale(cfg: SofaConfig) -> None:
    """Drop a previous recording's files, raw and derived, so frames
    never mix runs."""
    stale = [cfg.path(n) for n in RAW_FILES + DERIVED_DIRS]
    stale += [cfg.path(n) for n in derived_names()]
    stale += glob.glob(os.path.join(cfg.kineto_dir, "*.json*"))
    stale += glob.glob(cfg.path("blktrace.blktrace.*"))
    stale.append(cfg.inject_dir)
    for path in stale:
        _remove(path)


def sofa_clean(cfg: SofaConfig) -> int:
    """Remove the derived files (frame and analysis CSVs, report.js, the
    tile pyramid, the staged pages, hints.txt, features.csv, the run
    manifest and self trace, the ingest cache, the quarantine) and every
    stray ``*.tmp`` under the logdir (an interrupted atomic write); keep
    the raw collector output and ``kineto/``.  Returns how many entries
    went."""
    if not os.path.isdir(cfg.logdir):
        print_info(f"nothing to clean: {cfg.logdir} does not exist")
        return 0
    names = derived_names() + list(DERIVED_DIRS)
    removed = sum(_remove(cfg.path(n)) for n in names)
    removed += _remove(cfg.inject_dir)
    for root, _dirs, files in os.walk(cfg.logdir):
        removed += sum(_remove(os.path.join(root, n)) for n in files
                       if n.endswith(".tmp"))
    print_info(f"cleaned {removed} derived entries from {cfg.logdir}")
    return removed


def _warn_partial_stop(cfg: SofaConfig, rc: int) -> None:
    """Say so beside the rc line when the child's at-exit trace stop
    wedged or gave up (its breadcrumb reads done and not ok)."""
    try:
        with open(os.path.join(cfg.inject_dir, MARKER_NAME)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return
    if not (isinstance(m, dict) and m.get("done") and not m.get("ok", True)):
        return
    if rc == 120:
        # rc alone is not enough (a program may exit 120 itself); the
        # force-exit path always leaves done and not ok
        print_warning("profiled process force-exited after a wedged trace "
                      "stop (rc=120) — the device trace may be partial")
    else:
        print_warning("the trace stop inside the profiled process did not "
                      "finish cleanly — the device trace may be partial")


def _marker_authoritative(child: subprocess.Popen, m: dict) -> bool:
    """Is this breadcrumb grounds to kill the child's process group?

    Descendants of the workload inherit the injection and write the same
    file at their own exits; their wedge must never get a healthy main
    workload killed.  The breadcrumb counts only when its writer is (a)
    the main workload process: the /bin/sh wrapper itself (sh execs a
    single command) or a direct child of it, and (b) still alive: one
    from an exited writer is a leftover, not a wedge."""
    pid = m.get("pid")
    if not isinstance(pid, int) or pid <= 0:
        return False
    if pid == child.pid:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
        # field 4 is the ppid; the comm (field 2) may hold spaces
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
    except (OSError, ValueError, IndexError):
        return False
    return ppid == child.pid


def _epilogue_deadline(cfg: SofaConfig, m: dict) -> Optional[float]:
    """Unix time past which a child stuck in its at-exit epilogue is
    presumed wedged, or None to keep waiting (the in-process stops
    reported success: what still runs is the program's own teardown)."""
    if m.get("done") and m.get("ok"):
        return None
    if cfg.epilogue_deadline_s is not None:
        allow = cfg.epilogue_deadline_s
    elif m.get("done"):
        # a stop gave up; the child armed its force-exit watchdog
        allow = float(m.get("grace_s", 20)) + 60
    else:
        # the epilogue began and has not finished: two bounded calls, the
        # force-exit grace, and a margin
        allow = (2 * float(m.get("timeout_s", 30))
                 + float(m.get("grace_s", 20)) + 60)
    return float(m.get("t", 0)) + allow


def _wait_epilogue_bounded(child: subprocess.Popen, cfg: SofaConfig) -> int:
    """``child.wait()``, but never forever once the child is wedged at
    exit.  The injected stops run under in-process deadlines, yet a C call
    that wedges while holding the GIL defeats them all.  The at-exit
    breadcrumb (``_inject/atexit_stop.json``, written as the stop begins
    and ends) lets record see it: past the deadline the whole process
    group is TERMed, then KILLed, and the trace stays partial.  A workload
    still doing real work writes no breadcrumb, so its run time stays
    unbounded."""
    marker = os.path.join(cfg.inject_dir, MARKER_NAME)
    while True:
        try:
            return child.wait(timeout=1.0)
        except subprocess.TimeoutExpired:
            pass
        try:
            with open(marker) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(m, dict) or not _marker_authoritative(child, m):
            continue
        deadline = _epilogue_deadline(cfg, m)
        if deadline is None or time.time() <= deadline:
            continue
        print_warning(
            "profiled command finished but wedged in its at-exit trace "
            "stop — killing its process group; the trace may be partial")
        signal_tree(child, signal.SIGTERM)
        try:
            return child.wait(timeout=15)
        except subprocess.TimeoutExpired:
            signal_tree(child, signal.SIGKILL)
            return child.wait()


@contextlib.contextmanager
def _term_as_interrupt(extra_signals=()):
    """Route SIGTERM (and SIGHUP) into KeyboardInterrupt while recording,
    so that a CI job's timeout takes the same path as Ctrl-C: the child's
    tree is terminated and every collector's epilogue still runs.  A
    signal deliberately ignored (nohup) stays ignored."""

    def _on_term(signum, frame):
        raise KeyboardInterrupt

    saved = []
    for sig in (signal.SIGTERM,) + tuple(extra_signals):
        try:
            if signal.getsignal(sig) is signal.SIG_IGN:
                continue
            saved.append((sig, signal.signal(sig, _on_term)))
        except (ValueError, OSError):      # not the main thread
            pass
    try:
        yield
    finally:
        for sig, old in saved:
            try:
                signal.signal(sig, old if old is not None else signal.SIG_DFL)
            except (ValueError, OSError):
                pass


def sofa_record(command: Optional[str], cfg: SofaConfig) -> int:
    """Record ``command`` (or, with ``cfg.pid``, the running process) under
    the collectors; returns the command's exit code.  The run manifest is
    written on every exit, an aborted one included."""
    ensure_logdir(cfg.logdir)
    _clean_stale(cfg)
    tel = telemetry.begin("record")
    try:
        # inside the run, so that its warning counts; a bad spec aborts
        # before any collector starts
        faults.install_from(cfg)
    except Exception:
        telemetry.end(tel)
        raise
    rc = None
    try:
        with _term_as_interrupt((signal.SIGHUP,)):
            rc = _record_body(command, cfg, build_collectors(cfg), tel)
        return rc
    finally:
        tel.write(cfg.logdir, rc=rc, cfg=cfg)
        telemetry.end(tel)
        faults.clear()


def _record_body(command: Optional[str], cfg: SofaConfig, collectors,
                 tel) -> int:
    from sofa_tpu_torch.supervisor import CollectorSupervisor

    started = []
    prefix: List[str] = []
    child_env = dict(os.environ)
    supervisor = None
    try:
        with tel.span("prologue", cat="record"):
            for col in collectors:
                reason = col.probe()
                if reason is not None:
                    col.unavailable(reason)
                    continue
                try:
                    col.run_start()
                except Exception as e:  # noqa: BLE001 - costs its series
                    print_warning(f"{col.name}: start failed: {e}")
                    continue
                started.append(col)
                prefix += col.command_prefix()
                child_env.update(col.child_env())
        supervisor = CollectorSupervisor(cfg, started)
        supervisor.start()

        # after the collectors' env: the Kineto injection directory keeps
        # PYTHONPATH position 0, the repo root goes after it
        parts = [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
                 if p]
        if REPO not in parts:
            parts.append(REPO)
        child_env["PYTHONPATH"] = os.pathsep.join(parts)

        if cfg.pid is not None:
            perf = next((c for c in started if isinstance(c, PerfCollector)),
                        None)
            with tel.span("attach", cat="record", pid=cfg.pid):
                rc = _attach(cfg, cfg.pid, perf)
        else:
            rc = _launch(command, cfg, prefix, child_env, tel)
    except Exception as e:
        # kill-all: the collectors end now, the epilogue below still runs
        print_error(f"record failed: {e!r}")
        if supervisor is not None:
            supervisor.stop()           # no restart may race the kill-all
        for col in reversed(started):
            try:
                col.run_kill()
            except Exception:  # noqa: BLE001
                pass
        raise
    finally:
        if supervisor is not None:
            # before any stop, so that a deliberate stop never reads as a
            # death worth a restart
            supervisor.stop()
            budget = supervisor.budget_summary()
            if budget is not None:
                tel.set_meta(disk_budget=budget)
        with tel.span("epilogue", cat="record"):
            for col in reversed(started):
                try:
                    col.run_stop()
                except Exception as e:  # noqa: BLE001
                    print_warning(f"{col.name}: stop failed: {e}")
            for col in started:
                try:
                    col.run_harvest()
                except Exception as e:  # noqa: BLE001
                    print_warning(f"{col.name}: harvest failed: {e}")
    return rc


def _launch(command: str, cfg: SofaConfig, prefix: List[str],
            child_env: dict, tel) -> int:
    """Run ``[prefixes...] /bin/sh -c command`` in a session of its own (an
    interrupt takes its whole process tree down), wait for it under the
    epilogue bound, and write misc.txt."""
    print_info(f"launching: {command}")
    t0 = time.time()
    child = subprocess.Popen(prefix + ["/bin/sh", "-c", command],
                             env=child_env, start_new_session=True)
    try:
        rc = _wait_epilogue_bounded(child, cfg)
    except KeyboardInterrupt:
        try:
            print_warning("interrupted; terminating the profiled command")
            signal_tree(child, signal.SIGTERM)
            rc = child.wait(timeout=10)
        except (subprocess.TimeoutExpired, KeyboardInterrupt):
            signal_tree(child, signal.SIGKILL)
            rc = child.wait()
    elapsed = time.time() - t0
    if rc < 0:                          # killed by a signal: shell convention
        rc = 128 - rc
    tel.add_span("launch", "record", t0, elapsed, rc=rc,
                 command=command[:200])
    print_info(f"command finished in {elapsed:.3f} s (rc={rc})")
    _warn_partial_stop(cfg, rc)
    _write_misc(cfg, elapsed, child.pid, rc)
    return rc


def _attach(cfg: SofaConfig, pid: int,
            perf: Optional[PerfCollector] = None) -> int:
    """Attach mode (``--pid``): profile a running process until it exits,
    with ``perf record -p`` on it when perf is usable beside the
    system-wide samplers.  Returns 0 (the process is not our child, so its
    exit code is not ours to read)."""
    p_perf = None
    argv = perf.attach_argv(pid) if perf is not None else []
    if argv:
        try:
            p_perf = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
            print_progress(f"perf attached to pid {pid}")
        except OSError as e:
            print_warning(f"perf attach failed: {e}")
    print_progress(f"attached to pid {pid}; waiting for it to exit")
    t0 = time.time()
    try:
        while os.path.exists(f"/proc/{pid}") and not _is_zombie(pid):
            time.sleep(0.2)
    except KeyboardInterrupt:
        print_warning("detached")
    finally:
        if p_perf is not None:
            p_perf.terminate()
            try:
                p_perf.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p_perf.kill()
    _write_misc(cfg, time.time() - t0, pid, 0)
    return 0


def _is_zombie(pid: int) -> bool:
    """Whether ``pid`` has exited and waits only to be reaped (its parent
    may be slow to reap it: it is gone all the same)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return False


def _write_misc(cfg: SofaConfig, elapsed: float, pid: int, rc: int) -> None:
    with open(cfg.path("misc.txt"), "w") as f:
        f.write(f"elapsed_time {elapsed:.6f}\n")
        f.write(f"cores {os.cpu_count() or 1}\n")
        f.write(f"pid {pid}\n")
        f.write(f"rc {rc}\n")
