"""Collector supervision during ``record`` (the JAX package's
``sofa_tpu/supervisor.py``).

A watchdog thread in the ``record`` process (never in the profiled
program) polls every started collector that exposes liveness
(``Collector.alive``) and the size of its outputs:

  * a collector found dead is recorded at once (``died: true``,
    ``deaths``, ``exit_code``) and restarted with capped, jittered
    exponential backoff (``--collector_restarts``, default 1; 0.5 s *
    2^attempt, at most 30 s, scaled by [0.5, 1]).  A restart lands
    ``restarts: n``: the series has a gap, the rest of the run is covered;
  * once the budget is spent the status becomes ``died``, sticky over the
    epilogue's stop, and ``status`` exits nonzero;
  * outputs that stop growing while the collector stays alive are flagged
    once (``output_stalled: true``), a warning, not a kill;
  * disk budgets (``--disk_budget`` over all watched collectors,
    ``--collector_disk_budget`` each, in MB): a collector over its cap
    loses its oldest output files first (``rotated_files``), never the
    newest; one that still does not fit is stopped and marked
    ``truncated_by_budget``.  The recording itself goes on.

The poll period is 0.5 s, ``SOFA_SUPERVISOR_POLL_S`` to change it (at
least 0.05).  ``record`` starts the supervisor after the collectors start
and stops it before the epilogue, so that no restart races a deliberate
stop.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from sofa_tpu_torch import telemetry
from sofa_tpu_torch.concurrency import Guard, jittered_backoff
from sofa_tpu_torch.printing import print_warning

# Polls with no output growth (while alive) before the one-time stall flag:
# 20 * 0.5 s = 10 s of silence.
_STALL_POLLS = 20

_BACKOFF_BASE_S = 0.5
_BACKOFF_CAP_S = 30.0


def _poll_s() -> float:
    try:
        return max(float(os.environ.get("SOFA_SUPERVISOR_POLL_S", "0.5")),
                   0.05)
    except ValueError:
        return 0.5


class CollectorSupervisor:
    """The watchdog over one recording's started collectors."""

    def __init__(self, cfg, collectors: List):
        self.cfg = cfg
        self.collectors = collectors
        self.poll_s = _poll_s()
        self._stop = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sofa_supervisor")
        # The watchdog owns the per-collector dicts; the guard covers the
        # containers, which budget_summary reads from the main thread.
        self._lock = Guard("supervisor.state",
                           protects=("_state", "_truncated"))
        self._state: Dict[str, dict] = {}
        per_mb = float(getattr(cfg, "collector_disk_budget_mb", 0) or 0)
        total_mb = float(getattr(cfg, "disk_budget_mb", 0) or 0)
        self._per_cap = int(per_mb * 2 ** 20)
        self._total_cap = int(total_mb * 2 ** 20)
        self._truncated: List[str] = []

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Idempotent; after it returns no restart can fire."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    # -- the watchdog loop -------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            for col in list(self.collectors):
                if self._stop.is_set():
                    return
                try:
                    self._check(col)
                except Exception as e:  # noqa: BLE001 - the watchdog lives on
                    print_warning(f"supervisor: check of {col.name} "
                                  f"failed: {e}")
            if self._total_cap and not self._stop.is_set():
                try:
                    self._enforce_total_budget()
                except Exception as e:  # noqa: BLE001
                    print_warning(f"supervisor: disk-budget check "
                                  f"failed: {e}")

    def _check(self, col) -> None:
        alive = col.alive()
        if alive is None:
            return
        with self._lock:
            st = self._state.setdefault(col.name, {
                "deaths": 0, "restarts": 0, "retry_at": None,
                "gave_up": False, "bytes": -1, "stall_polls": 0,
                "stalled_flagged": False, "rotated": 0,
            })
        if st["gave_up"]:
            return
        if st["retry_at"] is not None:
            # monotonic: a clock step must not fire the restart early
            if time.monotonic() >= st["retry_at"]:
                self._restart(col, st)
            return
        if alive:
            b = self._track_growth(col, st)
            if self._per_cap and b > self._per_cap:
                self._enforce_budget(col, st, b, self._per_cap,
                                     "its --collector_disk_budget")
            return
        # -- a death ----------------------------------------------------------
        st["deaths"] += 1
        proc = getattr(col, "proc", None)
        exit_code = proc.poll() if proc is not None else None
        fields = {"died": True, "deaths": st["deaths"]}
        if exit_code is not None:
            fields["exit_code"] = int(exit_code)
        budget = max(int(getattr(self.cfg, "collector_restarts", 1) or 0), 0)
        if st["restarts"] >= budget:
            telemetry.collector_event(col.name, "died", **fields)
            print_warning(
                f"{col.name}: died mid-run (exit {exit_code}) — restart "
                f"budget ({budget}) exhausted; its series end here")
            st["gave_up"] = True
            return
        telemetry.collector_event(col.name, **fields)
        backoff = jittered_backoff(st["restarts"], _BACKOFF_BASE_S,
                                   _BACKOFF_CAP_S)
        print_warning(f"{col.name}: died mid-run (exit {exit_code}) — "
                      f"restarting in {backoff:.1f}s")
        st["retry_at"] = time.monotonic() + backoff

    def _restart(self, col, st: dict) -> None:
        st["retry_at"] = None
        try:
            col.start()
        except Exception as e:  # noqa: BLE001 - a failed restart gives up
            telemetry.collector_event(col.name, "died",
                                      restart_error=str(e)[:300])
            print_warning(f"{col.name}: restart failed: {e}")
            st["gave_up"] = True
            return
        st["restarts"] += 1
        st["bytes"], st["stall_polls"] = -1, 0
        telemetry.collector_event(col.name, restarts=st["restarts"])
        print_warning(f"{col.name}: restarted (attempt {st['restarts']})")

    def _track_growth(self, col, st: dict) -> int:
        b = telemetry.collector_bytes(col.outputs())
        if b != st["bytes"]:
            st["bytes"], st["stall_polls"] = b, 0
            return b
        st["stall_polls"] += 1
        if st["stall_polls"] == _STALL_POLLS and not st["stalled_flagged"]:
            st["stalled_flagged"] = True
            telemetry.collector_event(col.name, output_stalled=True)
            print_warning(
                f"{col.name}: alive but its output has not grown for "
                f"{_STALL_POLLS * self.poll_s:.0f}s — series may be "
                "wedged or buffering")
        return b

    # -- disk budgets --------------------------------------------------------
    def _enforce_total_budget(self) -> None:
        """``--disk_budget`` over every watched collector: on a breach the
        biggest producer pays first, its own files oldest first."""
        with self._lock:
            tracked = [(st["bytes"], name)
                       for name, st in self._state.items()
                       if st["bytes"] > 0 and not st["gave_up"]]
        total = sum(b for b, _n in tracked)
        if total <= self._total_cap:
            return
        by_name = {c.name: c for c in list(self.collectors)}
        for b, name in sorted(tracked, reverse=True):
            col = by_name.get(name)
            if col is None:
                continue
            over = total - self._total_cap
            with self._lock:
                st = self._state[name]
            freed = self._enforce_budget(col, st, b, b - over,
                                         "the run's --disk_budget")
            total -= freed
            if total <= self._total_cap:
                return

    def _enforce_budget(self, col, st: dict, used: int, cap: int,
                        why: str) -> int:
        """Bring one collector under ``cap`` bytes: rotate its oldest
        output files away (never the newest, which is being written); stop
        it as ``truncated_by_budget`` if it still does not fit.  Returns
        the bytes freed."""
        sigs = []
        for p in telemetry.output_files(col.outputs()):
            try:
                fst = os.stat(p)
            except OSError:
                continue
            sigs.append((fst.st_mtime_ns, fst.st_size, p))
        sigs.sort()
        freed = 0
        for _mt, size, path in sigs[:-1]:
            if used - freed <= cap:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            freed += size
            st["rotated"] += 1
        if freed:
            st["bytes"] = max(st["bytes"] - freed, 0)
            telemetry.collector_event(col.name, rotated_files=st["rotated"],
                                      budget_bytes=cap)
            print_warning(
                f"{col.name}: over {why} — rotated "
                f"{st['rotated']} oldest output file(s) "
                f"({freed / 2**20:.1f} MB freed)")
        if used - freed > cap:
            st["gave_up"] = True
            with self._lock:
                self._truncated.append(col.name)
            print_warning(
                f"{col.name}: still over {why} after rotation — stopping "
                "it; its series are truncated at this point "
                "(truncated_by_budget)")
            try:
                col.run_kill()
            except Exception as e:  # noqa: BLE001 - best effort
                print_warning(f"{col.name}: budget stop failed: {e}")
            # after the kill, whose own "killed" it replaces: the cause
            telemetry.collector_event(col.name, "truncated_by_budget",
                                      budget_bytes=cap,
                                      bytes_captured=int(used - freed))
        return freed

    def budget_summary(self) -> Optional[dict]:
        """``meta.disk_budget`` for the manifest; None without a budget."""
        if not (self._per_cap or self._total_cap):
            return None
        with self._lock:
            return {
                "budget_mb": self._total_cap // 2 ** 20 or None,
                "collector_budget_mb": self._per_cap // 2 ** 20 or None,
                "rotated_files": sum(st.get("rotated", 0)
                                     for st in self._state.values()),
                "truncated": sorted(set(self._truncated)),
            }

