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
            with every collector's environment.  A ``docker run`` command
            gets the logdir as a volume and the injection environment as
            ``-e`` flags (``wrap_docker_command``), and perf is scoped to
            the container's cgroup, else to its pid, instead of wrapping
            the docker CLI (``_DockerPerfScope``).  The Kineto injection
            directory keeps PYTHONPATH position 0 (its sitecustomize must
            be the one Python imports) and the repo root is appended after
            it.  The wait is bounded once the child is wedged at exit
            (``_wait_epilogue_bounded``).  With ``--pid``, attach to a
            running process instead and wait for it to exit;
  epilogue  stop the collectors in reverse order, then harvest each, under
            their deadlines, and write ``misc.txt`` (elapsed time, cores,
            pid, rc).  A failure before it kills every collector first.

The run manifest (``telemetry.py``) is written on every exit.  This is the
JAX package's ``record.py:85-598, 649-697``.  Returns the command's exit
code.

``cluster_record`` (``--cluster_hosts``, the JAX package's
``record.py:698-910``) runs one such record on each host at once, each
into ``<logdir>-<host>/``: a local ``python -m sofa_tpu_torch record`` for
localhost, ``ssh <host> python3 -m sofa_tpu_torch record`` into a remote
temp logdir fetched back with ``scp`` for any other host.
``sofa_clean`` (the ``clean`` verb) removes what preprocess and analyze
derived, keeping the raw output.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import shlex
import shutil
import signal
import subprocess
import sys
import threading
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
from sofa_tpu_torch.concurrency import Guard
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
    "time.txt", "kallsyms", "gpumon.txt", "gpumon.txt.meta.json",
    "pystacks.txt", "memprof.pb.gz", "memprof.pb.gz.meta.json",
)
# What preprocess and analyze derive from it, beside the frame CSVs and the
# staged board pages: removed by clean.
ANALYSIS_FILES = (
    "net_addrs.csv", "report.js", "features.csv", "hints.txt",  # sofa-lint: disable=SL017 — net_addrs.csv is read through read_net_addrs(path), a parameter
    "gpu_top_kernels.csv", "gpu_memprof.csv", "cpu_top.csv",
    "disk_summary.csv", "strace_top.csv", "pystacks_top.csv",
    "gpu_categories.csv", "gpu_modules_summary.csv", "gpu_op_tree.csv",
    "gpu_input_pipeline.csv", "roofline.csv", "sol_roofline.csv",
    "netrank.csv", "performance.csv", "cluster_summary.csv", "comm.csv",  # sofa-lint: disable=SL017 — cluster_summary.csv is an end artifact for the user
    "commtrace.csv", "link_matrix.csv", "gpu_step_skew.csv",  # sofa-lint: disable=SL017 — gpu_step_skew.csv is an end artifact for the user
    "_derived.writing", "run_manifest.json", "sofa_self_trace.json",
    # the container id docker publishes for perf's scoping: scratch
    "docker.cid",
    # the run journal and the digests (durability.py)
    "_journal.jsonl", "_digests.json",
    # live's offset ledger (live.py); its chunks are in _ingest_cache
    "_live_offsets.json",
)
# What the mining passes and the verbs beyond the report write (ml/,
# whatif/, export): derived too, removed by clean; status names the ones
# a logdir holds.
VERB_FILES = (
    "iterations.csv", "auto_caption.csv", "swarms_report.csv",  # sofa-lint: disable=SL017 — the mining passes' tables, end artifacts for the user
    "swarms_report.txt", "gpu_diff.csv", "mem_diff.csv", "swarm_diff.csv",
    "whatif_model.csv", "whatif_report.json", "sofa_report.pdf",  # sofa-lint: disable=SL017 — whatif_model.csv is an end artifact for the user
    "overview.png", "trace.json.gz", "pystacks.folded", "cputrace.folded",
    "memprof.folded", "regress_verdict.json",
)
# The ledgers of the roots beside the logdirs (an archive, a fleet root,
# a backup, an agent's spool; durability.MARKED_ROOTS) and the chunk-store
# index, which lives under _frames/<name>/ or an archive's _index/: no
# logdir sweep or digest walk enters those roots, which keep their own
# fsck.  Listed so that every file the package writes has a registry.
ROOT_FILES = (
    "agent_state.json", "catalog.gen", "fleet_trace.json",
    "frame_index.json", "sofa_backup.json", "sofa_fleet.json",
)
# ... and the directories (_frames: the chunk store, frames.py).
DERIVED_DIRS = ("_tiles", "_ingest_cache", "_quarantine", "sofa_hints",
                "_frames")
# Never digested: the ledgers themselves (they change on every write,
# fsck's own included, and every live epoch rewrites its offset ledger),
# the live sentinel and scratch, regress's verdict (rewritten by every
# `regress`, which refreshes no digests: an archived run's id must not
# change with it); the ingest cache,
# the quarantine and the injection directory; and the chunk store, whose
# chunks its own index hashes (fsck re-hashes them, frames.py).
DIGEST_SKIP_FILES = frozenset({
    "_digests.json", "_journal.jsonl", "run_manifest.json",
    "sofa_self_trace.json", "_derived.writing", "docker.cid",
    "_live_offsets.json", "regress_verdict.json",
})
DIGEST_SKIP_DIRS = frozenset({
    "_ingest_cache", "_quarantine", "_inject", "__pycache__", "_frames",
})
# The at-exit breadcrumb of the injected stops, in the injection directory.
MARKER_NAME = "atexit_stop.json"


def derived_names():
    """THE list of derived files (frame CSVs, analysis files, staged
    pages), shared by ``_clean_stale`` and ``sofa_clean``."""
    from sofa_tpu_torch.analyze import board_pages
    from sofa_tpu_torch.preprocess import frame_names

    return ([f"{n}.{ext}" for n in frame_names() for ext in ("csv",
                                                             "parquet")]
            + list(ANALYSIS_FILES) + list(VERB_FILES) + board_pages())


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
    tile pyramid, the chunk store, the staged pages, hints.txt,
    features.csv, the run manifest and self trace, the journal and the
    digests, live's offset ledger, the ingest cache with live's chunks,
    the quarantine) and every
    stray ``*.tmp`` under the logdir (an interrupted atomic write); keep
    the raw collector output and ``kineto/``.  An archive or fleet root
    nested in the logdir (marked by ``sofa_archive.json`` or
    ``sofa_fleet.json``) is never removed or walked into, whatever its
    name: it holds other runs' history, and ``archive gc`` is its only
    deletion path.  Returns how many entries went."""
    from sofa_tpu_torch.durability import marked_root

    if not os.path.isdir(cfg.logdir):
        print_info(f"nothing to clean: {cfg.logdir} does not exist")
        return 0
    removed = 0
    for path in ([cfg.path(n) for n in derived_names() + list(DERIVED_DIRS)]
                 + [cfg.inject_dir]):
        marker = os.path.isdir(path) and marked_root(path)
        if marker:
            print_warning(f"clean: {path} is a trace archive or fleet root "
                          f"({marker}) — left untouched; `archive gc` is "
                          "its only deletion path")
            continue
        removed += _remove(path)
    top = os.path.normpath(cfg.logdir)
    for root, dirs, files in os.walk(cfg.logdir):
        if os.path.normpath(root) != top and marked_root(root):
            dirs[:] = []        # the archive's own fsck owns its leftovers
            continue
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


# --- docker scoping (the JAX package's record.py:85-284) ----------------------

# Anchored to an actual docker-run invocation (optionally after environment
# assignments and sudo): "docker run" inside a quoted argument of another
# command must not trigger the rewrite.
_DOCKER_RUN_RE = re.compile(r"^\s*(?:[A-Za-z_][A-Za-z0-9_]*=\S*\s+)*"
                            r"(?:sudo\s+)?docker\s+run\b")
# The injection's environment, re-exported into the container explicitly
# (docker does not pass the parent's environment on): the sitecustomize
# directory on PYTHONPATH, the Kineto options, the memory sampler and its
# snapshots, the Python stack sampler.
DOCKER_ENV_KEYS = ("PYTHONPATH", "SOFA_TORCH_KINETO_OPTS",
                   "SOFA_TORCH_GPUMON_HZ", "SOFA_TORCH_GPUMON_OUT",
                   "SOFA_TORCH_MEMPROF_OUT", "SOFA_TORCH_PYSTACKS_HZ",
                   "SOFA_TORCH_PYSTACKS_OUT")


def _add_cidfile(command: str, cidfile: str) -> str:
    """Insert ``--cidfile`` so that docker publishes the container id."""
    m = _DOCKER_RUN_RE.match(command)
    if m is None:
        return command
    return (command[:m.end()] + " --cidfile " + shlex.quote(cidfile)
            + command[m.end():])


def _perf_cgroup_rel(cgroup_text: str) -> Optional[str]:
    """The cgroup perf filters on (relative, no leading /) from a
    /proc/<pid>/cgroup dump: the perf_event controller's path on cgroup v1
    (dockerd over cgroupfs puts containers at docker/<cid>), else the v2
    unified path (dockerd over systemd: system.slice/docker-<cid>.scope)."""
    v2 = None
    for line in cgroup_text.splitlines():
        parts = line.split(":", 2)
        if len(parts) != 3:
            continue
        if "perf_event" in parts[1].split(","):
            return parts[2].lstrip("/")
        if parts[0] == "0" and parts[1] == "":
            v2 = parts[2].lstrip("/")
    return v2


class _DockerPerfScope:
    """Scope CPU sampling to the container, not the docker CLI.

    ``docker run`` is an RPC client: a ``perf record`` prefix would sample
    the CLI's event loop while the workload runs under dockerd.  The
    rewritten command publishes its container id through ``--cidfile``;
    this watcher resolves the container's init pid and cgroup, then starts
    a system-wide ``perf record -a -G <cgroup>``, or ``perf record -p
    <pid>`` when the cgroup cannot be resolved or the cgroup-scoped perf
    exits at once (perf_event_paranoid too strict for -a)."""

    def __init__(self, cfg: SofaConfig, perf: PerfCollector, cidfile: str):
        self.cfg, self.perf, self.cidfile = cfg, perf, cidfile
        self.proc: Optional[subprocess.Popen] = None
        self._stop = threading.Event()
        # serializes launch against stop: once stop() holds it and has set
        # _stop, a late watcher can never launch an orphan perf
        self._lock = Guard("record.docker_perf", protects=("proc",))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sofa_docker_perf")

    def start(self) -> None:
        self._thread.start()

    def _wait_cid(self, timeout_s: float = 60.0) -> Optional[str]:
        t0 = time.time()
        while not self._stop.is_set() and time.time() - t0 < timeout_s:
            try:
                with open(self.cidfile) as f:
                    cid = f.read().strip()
                if cid:
                    return cid
            except OSError:
                pass
            time.sleep(0.1)
        return None

    def _container_pid(self, cid: str, timeout_s: float = 30.0) -> int:
        """The container's init pid (0 until it runs), asked of ``docker
        inspect`` with a per-call timeout, so that a wedged dockerd cannot
        hold this thread past stop()'s join."""
        t0 = time.time()
        while not self._stop.is_set() and time.time() - t0 < timeout_s:
            try:
                out = subprocess.run(
                    ["docker", "inspect", "--format", "{{.State.Pid}}", cid],
                    capture_output=True, text=True, timeout=5)
            except subprocess.TimeoutExpired:
                continue
            if out.returncode == 0:
                try:
                    pid = int(out.stdout.strip())
                except ValueError:
                    pid = 0
                if pid > 0:
                    return pid
            time.sleep(0.1)
        return 0

    def _run(self) -> None:
        cid = self._wait_cid()
        if cid is None:
            print_warning("docker: no container id appeared; container CPU "
                          "samples unavailable for this run")
            return
        pid = self._container_pid(cid)
        if not pid:
            print_warning(f"docker: cannot resolve init pid of {cid[:12]}; "
                          "container CPU samples unavailable")
            return
        try:
            with open(f"/proc/{pid}/cgroup") as f:
                cgroup = _perf_cgroup_rel(f.read())
        except OSError:
            cgroup = None
        attempts = []
        if cgroup:
            attempts.append((self.perf.scoped_argv(cgroup),
                             f"cgroup {cgroup}"))
        attempts.append((self.perf.attach_argv(pid), f"pid {pid}"))
        tried = []
        for argv, how in attempts:
            with self._lock:
                if self._stop.is_set():
                    return              # the run has ended: no orphan perf
                try:
                    self.proc = subprocess.Popen(
                        argv, stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
                except OSError as e:
                    print_warning(f"docker-scoped perf failed to launch: {e}")
                    return
            tried.append(how)
            time.sleep(0.5)
            if self.proc.poll() is None:
                print_progress(f"perf scoped to container {cid[:12]} ({how})")
                return
            with self._lock:
                self.proc = None
        print_warning(
            f"docker-scoped perf exited immediately for {cid[:12]} (tried "
            f"{'; '.join(tried)}): container CPU samples unavailable; common "
            "causes: perf_event_paranoid too strict for system-wide -G, or "
            "the container exited at once")

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
        self._thread.join(timeout=70)
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def wrap_docker_command(command: str, cfg: SofaConfig,
                        child_env: dict) -> str:
    """Thread the profiling context through a ``docker run`` boundary:

      -v <logdir>:<logdir>   the same absolute path inside, so that the
                             injected sitecustomize and its output files
                             resolve;
      -e KEY=VALUE           each of DOCKER_ENV_KEYS that the collectors
                             set, since docker does not pass the parent's
                             environment on.

    The host-side samplers already see the container's processes (one
    kernel).  The card, ``--gpus``, is the user's ``docker run``'s to
    give.  Any other command passes through."""
    m = _DOCKER_RUN_RE.match(command)
    if m is None:
        return command
    logdir = os.path.abspath(cfg.logdir)
    extra = [f"-v {shlex.quote(f'{logdir}:{logdir}')}"]
    for key in DOCKER_ENV_KEYS:
        if key in child_env:
            extra.append(f"-e {shlex.quote(f'{key}={child_env[key]}')}")
    return (command[:m.end()] + " " + " ".join(extra)
            + command[m.end():])


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
    from sofa_tpu_torch import durability

    ensure_logdir(cfg.logdir)
    _clean_stale(cfg)
    tel = telemetry.begin("record")
    # a fresh journal (the clean took the old one): a crash from here on
    # leaves a begun, uncommitted record that `resume` reports
    journal = durability.Journal(cfg.logdir)
    journal.begin("record")
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
        if rc is not None:
            # the epilogue ran: digest the harvest and commit (an aborted
            # record stays uncommitted)
            durability.write_digests(cfg.logdir)
            journal.commit("record", rc=rc,
                           key=durability.logdir_raw_key(cfg.logdir))
        telemetry.end(tel)
        faults.clear()


def _record_body(command: Optional[str], cfg: SofaConfig, collectors,
                 tel) -> int:
    from sofa_tpu_torch.supervisor import CollectorSupervisor

    started = []
    prefix: List[str] = []
    child_env = dict(os.environ)
    supervisor = None
    is_docker = (cfg.pid is None
                 and _DOCKER_RUN_RE.match(command or "") is not None)
    docker_perf = None
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
                if (is_docker and isinstance(col, PerfCollector)
                        and col.mode == "perf"):
                    # a perf prefix would sample the docker client: the
                    # collector is scoped to the container instead (its
                    # harvest still runs)
                    docker_perf = col
                else:
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
            rc = _launch(command, cfg, prefix, child_env, tel, docker_perf)
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
            child_env: dict, tel,
            docker_perf: Optional[PerfCollector] = None) -> int:
    """Run ``[prefixes...] /bin/sh -c command`` in a session of its own (an
    interrupt takes its whole process tree down), wait for it under the
    epilogue bound, and write misc.txt.  A ``docker run`` command is
    rewritten by ``wrap_docker_command``; with ``docker_perf`` it also
    publishes its container id, which ``_DockerPerfScope`` scopes perf
    to."""
    docker_scope = None
    if docker_perf is not None:
        cidfile = cfg.path("docker.cid")
        try:
            os.unlink(cidfile)          # docker refuses a stale cidfile
        except OSError:
            pass
        command = _add_cidfile(command, cidfile)
        docker_scope = _DockerPerfScope(cfg, docker_perf, cidfile)
    command = wrap_docker_command(command, cfg, child_env)
    print_info(f"launching: {command}")
    t0 = time.time()
    if docker_scope is not None:
        docker_scope.start()
    try:
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
    finally:
        if docker_scope is not None:
            docker_scope.stop()
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


# --- cluster record (the JAX package's record.py:698-910) ---------------------

# Record fields re-materialized as CLI flags for the per-host launches, so
# that cluster_record never resets a host to the defaults.  Not forwarded:
# ``pid`` (an attach names a process of one host), ``cluster_hosts`` (each
# host records alone), and ``py_stack_rate`` and ``enable_vmstat``, which
# have no flag (as in the JAX package); the other fields are preprocess's,
# analyze's or the board's, and ``plugins`` are loaded by the verb itself.
_VALUED_FLAGS = (
    ("perf_events", "--perf_events"),
    ("cpu_sample_rate", "--cpu_sample_rate"),
    ("perf_call_graph", "--perf_call_graph"),
    ("sys_mon_rate", "--sys_mon_rate"),
    ("strace_min_time", "--strace_min_time"),
    ("netstat_interface", "--netstat_interface"),
    ("blkdev", "--blkdev"),
    ("gpu_mon_rate", "--gpu_mon_rate"),
    ("epilogue_deadline_s", "--epilogue_deadline_s"),
    ("inject_faults", "--inject_faults"),
    ("collector_restarts", "--collector_restarts"),
    ("collector_stop_timeout_s", "--collector_stop_timeout_s"),
    ("collector_harvest_timeout_s", "--collector_harvest_timeout_s"),
    ("disk_budget_mb", "--disk_budget"),
    ("collector_disk_budget_mb", "--collector_disk_budget"),
    ("kineto_host_tracer_level", "--kineto_host_tracer_level"),
    ("kineto_delay_s", "--kineto_delay_s"),
    ("kineto_duration_s", "--kineto_duration_s"),
)
# set when the field is True (its default is False)
_ENABLE_FLAGS = (
    ("no_perf_events", "--no-perf-events"),
    ("enable_strace", "--enable_strace"),
    ("enable_py_stacks", "--enable_py_stacks"),
    ("enable_tcpdump", "--enable_tcpdump"),
    ("verbose", "--verbose"),
    ("kineto_python_tracer", "--kineto_python_tracer"),
)
# set when the field is False (its default is True)
_DISABLE_FLAGS = (
    ("enable_kineto", "--disable_kineto"),
    ("enable_gpu_mon", "--disable_gpu_mon"),
    ("enable_mem_prof", "--disable_memprof"),
)


def _record_flags(cfg: SofaConfig) -> List[str]:
    """The record fields of ``cfg`` that differ from the defaults, as the
    CLI flags that set them."""
    base = SofaConfig()
    flags: List[str] = []
    for name, flag in _DISABLE_FLAGS:
        if not getattr(cfg, name) and getattr(base, name):
            flags.append(flag)
    for name, flag in _VALUED_FLAGS:
        v = getattr(cfg, name)
        if v is not None and v != getattr(base, name):
            flags += [flag, str(v)]
    for name, flag in _ENABLE_FLAGS:
        if getattr(cfg, name) and not getattr(base, name):
            flags.append(flag)
    return flags


# Per-host epilogue bounds: a dead host's scp would otherwise hang on TCP
# timeouts (the recorders themselves stay unbounded; only the fetch and
# the clean-up get deadlines).
_CLUSTER_FETCH_TIMEOUT_S = 300
_CLUSTER_RM_TIMEOUT_S = 30
LOCAL_HOSTS = ("localhost", "127.0.0.1")


def cluster_record(command: str, cfg: SofaConfig) -> int:
    """One record over the hosts of ``cfg.cluster_hosts``, all at once,
    each into ``<logdir>-<host>/`` with its own sofa_time.txt (which
    ``analyze.cluster_analyze`` aligns the merged timeline by):

      localhost, 127.0.0.1   ``python -m sofa_tpu_torch record`` here, with
                             the package root on PYTHONPATH;
      any other host         ``ssh <host> python3 -m sofa_tpu_torch record``
                             into a directory that the host's ``mktemp``
                             makes under its own ``$TMPDIR`` (else /tmp),
                             fetched back with scp (at most 300 s) and
                             removed (at most 30 s).

    The remote leg never probes for a console script: the port has none,
    and a host's ``sofa`` is the JAX package's.  TERM and HUP stop every
    host's recorder (each runs its own epilogue).  Returns the largest
    host exit code (a signal folded to 128 + n), so that any host's
    failure shows."""
    flags = _record_flags(cfg)
    child_env = dict(os.environ)
    parts = [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
             if p]
    if REPO not in parts:
        parts.append(REPO)
    child_env["PYTHONPATH"] = os.pathsep.join(parts)
    # the launches, the waits and the fetches all run with TERM and HUP
    # routed into KeyboardInterrupt, so that a CI timeout stops every host
    with _term_as_interrupt((signal.SIGHUP,)):
        return _cluster_record_body(command, cfg, flags, child_env)


def _remote_tmpdir(host: str) -> Optional[str]:
    """A fresh directory on ``host`` for its record, made by the host's own
    ``mktemp`` under its ``$TMPDIR`` (else /tmp): unique, so that the
    interrupt's ``pkill -f`` matches this record alone.  None (said) when
    the host cannot make one."""
    try:
        made = subprocess.run(
            ["ssh", "-o", "BatchMode=yes", host,
             'mktemp -d "${TMPDIR:-/tmp}/sofa_tpu_torch_record_XXXXXX"'],
            capture_output=True, text=True, timeout=_CLUSTER_RM_TIMEOUT_S)
    except (subprocess.SubprocessError, OSError) as e:
        print_error(f"cluster: cannot make a logdir on {host}: {e}")
        return None
    lines = made.stdout.split()
    if made.returncode != 0 or not lines or not lines[-1].startswith("/"):
        print_error(f"cluster: cannot make a logdir on {host}: "
                    f"{made.stderr.strip() or made.stdout.strip()}")
        return None
    return lines[-1].rstrip("/") + "/"


def _cluster_record_body(command: str, cfg: SofaConfig, flags: List[str],
                         child_env: dict) -> int:
    launches = []                   # (host, proc, host_logdir, remote_dir)
    interrupted = False

    def _interrupt_all() -> None:
        """Terminate every host's recorder, once: all local ones first
        (instant), then a ``pkill`` of each remote one by its unique logdir
        (terminating an ssh client does not signal the remote side), so
        that the remote record runs its epilogue before the fetch.  A
        second signal in the middle re-enters the local loop rather than
        leaving recorders running."""
        nonlocal interrupted
        if interrupted:
            return
        interrupted = True
        print_warning("cluster: interrupted; terminating the per-host "
                      "recorders")
        while True:
            try:
                for _h, p, _ld, _rd in launches:
                    if p.poll() is None:
                        p.terminate()
                break
            except KeyboardInterrupt:
                continue
        for h, _p, _ld, rd in launches:
            if rd is None:
                continue
            try:
                subprocess.run(
                    ["ssh", "-o", "BatchMode=yes", h,
                     f"pkill -f {shlex.quote(rd)} || true"],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                    timeout=10)
            except (subprocess.SubprocessError, KeyboardInterrupt):
                continue

    launch_failed = False
    try:
        for host in cfg.cluster_hosts:
            host_logdir = cfg.logdir.rstrip("/") + f"-{host}/"
            if host in LOCAL_HOSTS:
                argv = [sys.executable, "-m", "sofa_tpu_torch", "record",
                        command, "--logdir", host_logdir] + flags
                remote_dir = None
            else:
                remote_dir = _remote_tmpdir(host)
                if remote_dir is None:
                    launch_failed = True
                    _interrupt_all()
                    break
                remote = " ".join(
                    ["python3", "-m", "sofa_tpu_torch", "record",
                     shlex.quote(command), "--logdir",
                     shlex.quote(remote_dir)]
                    + [shlex.quote(f) for f in flags])
                argv = ["ssh", "-o", "BatchMode=yes", host, remote]
            print_progress(f"cluster: recording on {host}")
            try:
                proc = subprocess.Popen(argv, env=child_env)
            except OSError as e:
                # the hosts already launched must not record forever
                print_error(f"cluster: cannot launch on {host}: {e}")
                launch_failed = True
                _interrupt_all()
                break
            launches.append((host, proc, host_logdir, remote_dir))
    except KeyboardInterrupt:
        _interrupt_all()

    rc = 1 if launch_failed else 0
    for host, proc, host_logdir, remote_dir in launches:
        try:
            host_rc = proc.wait()
        except KeyboardInterrupt:
            _interrupt_all()
            try:
                host_rc = proc.wait(timeout=15)
            except (subprocess.TimeoutExpired, KeyboardInterrupt):
                proc.kill()
                host_rc = proc.wait()
        if host_rc < 0:                 # killed by a signal: 128 + n
            host_rc = 128 - host_rc
        rc = max(rc, host_rc)
        if host_rc != 0:
            print_warning(f"cluster: {host} record exited rc={host_rc}")
        if remote_dir is None:
            continue
        ensure_logdir(host_logdir)
        try:
            fetch = subprocess.run(
                ["scp", "-q", "-r", "-o", "BatchMode=yes",
                 f"{host}:{remote_dir.rstrip('/')}/.", host_logdir],
                timeout=_CLUSTER_FETCH_TIMEOUT_S)
            if fetch.returncode != 0:
                print_warning(f"cluster: could not fetch logs from {host}")
        except (subprocess.SubprocessError, OSError) as e:
            print_warning(f"cluster: fetching logs from {host} failed: {e}")
        try:
            subprocess.run(["ssh", "-o", "BatchMode=yes", host,
                            f"rm -rf {shlex.quote(remote_dir)}"],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL,
                           timeout=_CLUSTER_RM_TIMEOUT_S)
        except (subprocess.SubprocessError, OSError):
            print_warning(f"cluster: could not remove {remote_dir} on "
                          f"{host} (dead host?); leaving it")
    print_progress(f"cluster: recorded {len(launches)} hosts into "
                   f"{cfg.logdir.rstrip('/')}-<host>/")
    return rc
