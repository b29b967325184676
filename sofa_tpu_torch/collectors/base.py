"""Collector lifecycle: probe() -> start() -> [child runs] -> stop() ->
harvest() (the JAX package's ``sofa_tpu/collectors/base.py:32-237``).

A collector whose probe fails is skipped with a warning; the recording
goes on without its series, so profiling works on machines that lack any
subset of the tools.

Every lifecycle transition also lands in the run manifest's collector
ledger (``telemetry.py``): ``record`` drives the instrumented wrappers
``run_start`` / ``run_stop`` / ``run_harvest`` / ``run_kill``, subclasses
override the bare hooks.  Stop and harvest run under deadlines
(``--collector_stop_timeout_s``, ``--collector_harvest_timeout_s``): a step
that overruns is abandoned on its daemon thread and recorded
``timed_out``, so one wedged collector costs its own series only.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional

from sofa_tpu_torch import faults, telemetry
from sofa_tpu_torch.printing import print_info, print_warning


def _next_seq() -> int:
    """Start/stop ordinal within the active run (0 outside one): the
    manifest's proof that stops ran in the reverse order of the starts."""
    tel = telemetry.current()
    return tel.next_seq() if tel is not None else 0


def _run_bounded(fn, timeout: Optional[float], name: str, phase: str) -> bool:
    """Run an epilogue step with a wall-clock deadline.  True when ``fn``
    finished (its exception, if any, propagates); False once the deadline
    passed, with ``fn`` left running on a daemon thread that dies with the
    process (a C call wedged without the GIL cannot be cancelled from
    Python).  A timeout of None or <= 0 calls ``fn`` directly."""
    if not timeout or timeout <= 0:
        fn()
        return True
    box: dict = {}

    def _run():
        try:
            fn()
        except BaseException as e:  # sofa-lint: disable=SL002 — re-raised in the caller via box["err"]
            box["err"] = e

    t = threading.Thread(target=_run, daemon=True,
                         name=f"sofa_{name}_{phase}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        return False
    if "err" in box:
        raise box["err"]
    return True


def signal_tree(proc: subprocess.Popen, sig: int) -> None:
    """Signal a process's group (record starts the profiled command in a
    session of its own); a process that leads no group is signalled
    alone."""
    try:
        os.killpg(proc.pid, sig)
    except OSError:
        try:
            proc.send_signal(sig)
        except OSError:
            pass


class Collector:
    """Base collector; subclasses override the hooks they need."""

    name = "collector"

    def __init__(self, cfg):
        self.cfg = cfg

    # -- lifecycle hooks ---------------------------------------------------
    def probe(self) -> Optional[str]:
        """None if usable, else a human-readable reason it is not."""
        return None

    def start(self) -> None:
        """Begin collection (background process, thread or file setup)."""

    def stop(self) -> None:
        """End collection and flush output files."""

    def harvest(self) -> None:
        """Post-run transformation of raw output (e.g. blkparse)."""

    def command_prefix(self) -> List[str]:
        """Tokens to prepend to the profiled command (e.g. strace ...)."""
        return []

    def child_env(self) -> Dict[str, str]:
        """Environment variables to inject into the profiled command."""
        return {}

    def outputs(self) -> List[str]:
        """Paths this collector writes (directories too): the manifest's
        bytes_captured, the disk budget and ``truncate`` walk them."""
        return []

    # -- supervision hooks (supervisor.py) ---------------------------------
    def alive(self) -> Optional[bool]:
        """True/False while a watchable worker (a process or a sampler
        thread) backs this collector; None when there is nothing to watch
        (prefix-only or one-shot collectors)."""
        return None

    def fault_kill(self) -> None:
        """The ``die`` fault: make the backing worker vanish as a crash
        would."""
        self.kill()

    def kill(self) -> None:
        """End the backing worker at once (the kill-all path)."""

    def _escalate_kill(self) -> None:
        """TERM, then KILL, then abandon the backing process after a stop
        deadline."""
        proc = getattr(self, "proc", None)
        if proc is None or proc.poll() is not None:
            return
        signal_tree(proc, signal.SIGTERM)
        try:
            proc.wait(timeout=2)
            return
        except subprocess.TimeoutExpired:
            pass
        signal_tree(proc, signal.SIGKILL)
        try:
            proc.wait(timeout=2)
        except subprocess.TimeoutExpired:
            pass                    # abandoned; the manifest says timed_out

    # -- the instrumented lifecycle (driven by record) ---------------------
    def run_start(self) -> None:
        t0 = time.perf_counter()
        try:
            with telemetry.maybe_span(f"{self.name}.start", cat="collector"):
                faults.maybe_inject(self.name, "start")
                self.start()
        except Exception as e:  # noqa: BLE001 - the ledger first
            telemetry.collector_event(
                self.name, "failed", phase="start", error=str(e)[:300])
            raise
        telemetry.collector_event(
            self.name, "started", start_seq=_next_seq(),
            start_wall_s=round(time.perf_counter() - t0, 6))
        faults.arm_die(self)

    def run_stop(self) -> None:
        t0 = time.perf_counter()

        def _do_stop():
            faults.maybe_inject(self.name, "stop")
            self.stop()

        timeout = getattr(self.cfg, "collector_stop_timeout_s", 15.0)
        try:
            with telemetry.maybe_span(f"{self.name}.stop", cat="collector"):
                finished = _run_bounded(_do_stop, timeout, self.name, "stop")
        except Exception as e:  # noqa: BLE001
            telemetry.collector_event(
                self.name, "failed", phase="stop", error=str(e)[:300])
            raise
        if not finished:
            self._escalate_kill()
            telemetry.collector_event(
                self.name, "timed_out", phase="stop", timed_out=True,
                stop_seq=_next_seq(),
                stop_wall_s=round(time.perf_counter() - t0, 6))
            print_warning(
                f"{self.name}: stop exceeded {timeout:g}s — killed and "
                "abandoned; its series may be partial "
                "(--collector_stop_timeout_s)")
            return
        fields = {"stop_seq": _next_seq(),
                  "stop_wall_s": round(time.perf_counter() - t0, 6)}
        proc = getattr(self, "proc", None)
        if proc is not None and proc.returncode is not None:
            fields["exit_code"] = int(proc.returncode)
        telemetry.collector_event(self.name, "stopped", **fields)

    def run_harvest(self) -> None:
        t0 = time.perf_counter()

        def _do_harvest():
            faults.maybe_inject(self.name, "harvest")
            self.harvest()
            faults.maybe_truncate(self)

        timeout = getattr(self.cfg, "collector_harvest_timeout_s", 120.0)
        try:
            with telemetry.maybe_span(f"{self.name}.harvest",
                                      cat="collector"):
                finished = _run_bounded(_do_harvest, timeout, self.name,
                                        "harvest")
        except Exception as e:  # noqa: BLE001
            telemetry.collector_event(
                self.name, "failed", phase="harvest", error=str(e)[:300])
            raise
        finally:
            telemetry.collector_event(
                self.name,
                bytes_captured=telemetry.collector_bytes(self.outputs()))
        if not finished:
            telemetry.collector_event(
                self.name, "timed_out", phase="harvest", timed_out=True)
            print_warning(
                f"{self.name}: harvest exceeded {timeout:g}s — abandoned; "
                "its derived series may be missing "
                "(--collector_harvest_timeout_s)")
            return
        telemetry.collector_event(
            self.name, harvest_wall_s=round(time.perf_counter() - t0, 6))

    def run_kill(self) -> None:
        self.kill()
        telemetry.collector_event(self.name, "killed")

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def which(tool: str) -> Optional[str]:
        return shutil.which(tool)

    def unavailable(self, reason: str) -> None:
        telemetry.collector_event(self.name, "skipped", reason=reason)
        print_warning(f"{self.name}: {reason} — skipping this collector")


class ProcessCollector(Collector):
    """A collector backed by one background process."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.proc: Optional[subprocess.Popen] = None

    def launch(self, argv, **popen_kwargs) -> None:
        print_info(f"{self.name}: {' '.join(argv)}")
        self.proc = subprocess.Popen(argv, **popen_kwargs)

    def alive(self) -> Optional[bool]:
        """True/False while a backing process exists, None before launch."""
        if self.proc is None:
            return None
        return self.proc.poll() is None

    def stop(self, sig=signal.SIGTERM, timeout: float = 5.0) -> None:
        """Signal the process (TERM by default), then KILL it if it has not
        exited within ``timeout`` seconds; a process not reaped even then
        is recorded ``unreaped`` and abandoned."""
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                print_warning(f"{self.name}: did not exit on signal; killing")
                self.proc.kill()
                try:
                    self.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    print_warning(f"{self.name}: not reaped after SIGKILL; "
                                  "abandoning the wait")
                    telemetry.collector_event(self.name, unreaped=True)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.kill()
            except ProcessLookupError:
                pass


def ensure_logdir(path: str) -> None:
    """Create the logdir; a path component that is a file is a usage
    error."""
    try:
        os.makedirs(path, exist_ok=True)
    except (FileExistsError, NotADirectoryError):
        from sofa_tpu_torch.printing import SofaUserError

        raise SofaUserError(
            f"cannot create logdir {path}: a path component exists and is "
            "not a directory — pick another --logdir") from None
