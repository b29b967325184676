"""Fault injection: the record and ingest degradation paths, on demand
(the JAX package's ``sofa_tpu/faults.py:1-158, 159-531, 609-623``, the
record and ingest kinds).

    SOFA_FAULTS='procmon:die@2s,kineto:wedge@harvest,vmstat:fail@start'
    python -m sofa_tpu_torch record "python train.py" \
        --inject_faults 'kineto:truncate@harvest,kineto:corrupt'

Grammar (comma-joined entries)::

    entry  = <target> ":" <kind> [ "@" <when> ]
    target = a collector name (procmon, vmstat, kineto, perf, ...) or an
             ingest source name (mpstat, kineto, nettrace, ...; "pcap"
             aliases nettrace)
    kind   = die      end the collector's backing process or thread mid-run
                      (@<delay> after start, e.g. @2s; default at once)
             wedge    block at @<phase> (stop|harvest; default stop): the
                      bounded epilogue's deadlines must cut it off
             fail     raise at @<phase> (start|stop|harvest; default start)
             truncate halve the collector's output files at harvest (the
                      files inside an output directory too)
             corrupt  ingest: the source's parse raises CorruptRawError,
                      which drives the quarantine path
    when   = "start" | "stop" | "harvest" | <float>"s" (die delay)

The JAX package's network, tier and stream kinds (``conn_refused``,
``worker_die``, ``tail_torn``, ...) drive its archive, fleet and live
modules, which this package does not have yet: a spec naming one is a
usage error that says so.

Without a plan every hook returns at once.  ``record`` and ``preprocess``
install the plan from ``cfg.inject_faults`` (else ``SOFA_FAULTS``) and
clear it in their ``finally``.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

KINDS = ("die", "wedge", "fail", "truncate", "corrupt")
# The JAX package's kinds whose consumers this package lacks, by module.
UNPORTED_KINDS = {
    "conn_refused": "archive", "conn_reset": "archive", "http_500": "archive",
    "partial": "archive", "worker_die": "fleet", "replica_stale": "fleet",
    "slo_breach": "fleet", "scrape_stall": "fleet", "disk_full": "fleet",
    "tail_truncate": "live", "tail_torn": "live", "rotate": "live",
    "stall": "archive or live",
}
PHASES = ("start", "stop", "harvest")

ALIASES = {"pcap": "nettrace"}

# The phase a kind fires in when the entry names none.
DEFAULT_PHASE = {"fail": "start", "wedge": "stop", "truncate": "harvest"}

# A wedge blocks for longer than any sane deadline; the bounded epilogue
# abandons its daemon thread, which dies with the process.
_WEDGE_S = 3600.0

_DELAY_RE = re.compile(r"^(\d+(?:\.\d+)?)s?$")


class FaultInjected(RuntimeError):
    """Raised by a ``fail`` injection: a synthetic collector failure."""


@dataclass(frozen=True)
class FaultSpec:
    target: str
    kind: str
    phase: Optional[str] = None      # start|stop|harvest (fail/wedge/truncate)
    delay_s: Optional[float] = None  # die only

    def fires_at(self, phase: str) -> bool:
        return (self.phase or DEFAULT_PHASE.get(self.kind)) == phase


class FaultPlan:
    """A parsed spec, indexed by target."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._by_target: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_target.setdefault(s.target, []).append(s)

    def find(self, target: str, kind: str,
             phase: Optional[str] = None) -> Optional[FaultSpec]:
        for s in self._by_target.get(target, ()):
            if s.kind == kind and (phase is None or s.fires_at(phase)):
                return s
        return None

    def corrupt_for(self, source: str) -> Optional[FaultSpec]:
        return self.find(source, "corrupt")


def parse(text: str) -> FaultPlan:
    """Parse a spec string; raises ValueError naming the bad entry."""
    specs: List[FaultSpec] = []
    for entry in (e.strip() for e in text.split(",")):
        if not entry:
            continue
        target, sep, rest = entry.partition(":")
        if not sep or not target or not rest:
            raise ValueError(
                f"fault entry {entry!r}: expected <target>:<kind>[@<when>]")
        kind, _, when = rest.partition("@")
        if kind in UNPORTED_KINDS:
            raise ValueError(
                f"fault entry {entry!r}: kind {kind!r} drives the "
                f"{UNPORTED_KINDS[kind]} module, which sofa_tpu_torch does "
                f"not have yet; this package takes {KINDS}")
        if kind not in KINDS:
            raise ValueError(
                f"fault entry {entry!r}: kind {kind!r} not in {KINDS}")
        phase: Optional[str] = None
        delay: Optional[float] = None
        if when:
            if when in PHASES:
                phase = when
            else:
                m = _DELAY_RE.match(when)
                if m is None:
                    raise ValueError(
                        f"fault entry {entry!r}: {when!r} is neither a "
                        f"phase {PHASES} nor a delay like '2s'")
                delay = float(m.group(1))
        if kind == "die" and phase is not None:
            raise ValueError(
                f"fault entry {entry!r}: die takes a delay (e.g. @2s), "
                "not a phase")
        if kind in ("fail", "wedge", "truncate") and delay is not None:
            raise ValueError(
                f"fault entry {entry!r}: {kind} takes a phase "
                f"{PHASES}, not a delay")
        if kind == "wedge" and phase == "start":
            raise ValueError(
                f"fault entry {entry!r}: wedge supports the bounded "
                "phases stop|harvest (start is unbounded by design — "
                "use fail@start)")
        specs.append(FaultSpec(target=ALIASES.get(target, target),
                               kind=kind, phase=phase, delay_s=delay))
    return FaultPlan(specs)


# --- the active plan ---------------------------------------------------------
# One per process, installed per verb: the hooks fire from collector
# threads and pool workers that must all see it.

_PLAN: Optional[FaultPlan] = None
# Armed die timers, cancelled by clear(): a death scheduled near the end of
# a run must not fire into the next run's collectors.
_TIMERS: List[threading.Timer] = []


def active() -> Optional[FaultPlan]:
    return _PLAN


def install_from(cfg=None) -> Optional[FaultPlan]:
    """Install the plan from ``cfg.inject_faults``, else ``SOFA_FAULTS``.
    A bad spec raises SofaUserError.  Pair with :func:`clear`."""
    global _PLAN
    _PLAN = None
    text = (getattr(cfg, "inject_faults", "")
            or os.environ.get("SOFA_FAULTS", "") or "").strip()
    if not text:
        return None
    from sofa_tpu_torch.printing import SofaUserError, print_warning

    try:
        _PLAN = parse(text)
    except ValueError as e:
        raise SofaUserError(f"bad --inject_faults/SOFA_FAULTS spec: {e}") \
            from None
    # a warning, so the run's manifest counts that faults were active
    print_warning(f"fault injection ACTIVE: {text}")
    return _PLAN


def clear() -> None:
    global _PLAN
    _PLAN = None
    while _TIMERS:
        _TIMERS.pop().cancel()


# --- hook points -------------------------------------------------------------

def maybe_inject(name: str, phase: str) -> None:
    """The collector lifecycle hook (run_start / run_stop / run_harvest):
    ``fail`` raises FaultInjected, ``wedge`` blocks (stop and harvest
    only, which the bounded epilogue cuts off)."""
    plan = _PLAN
    if plan is None:
        return
    if plan.find(name, "fail", phase) is not None:
        raise FaultInjected(f"injected {name} failure at {phase} "
                            "(--inject_faults)")
    if phase != "start" and plan.find(name, "wedge", phase) is not None:
        time.sleep(_WEDGE_S)


def arm_die(col) -> None:
    """After a start: schedule the collector's backing worker to vanish as
    a crash would (``Collector.fault_kill``)."""
    plan = _PLAN
    if plan is None:
        return
    spec = plan.find(col.name, "die")
    if spec is None:
        return
    t = threading.Timer(spec.delay_s or 0.0, col.fault_kill)
    t.daemon = True
    _TIMERS.append(t)
    t.start()


def maybe_truncate(col) -> None:
    """The harvest hook: halve every output file, those inside an output
    directory too (the Kineto collector's ``kineto/``)."""
    plan = _PLAN
    if plan is None or plan.find(col.name, "truncate", "harvest") is None:
        return
    from sofa_tpu_torch.telemetry import output_files

    for path in output_files(col.outputs()):
        try:
            os.truncate(path, os.path.getsize(path) // 2)
        except OSError:
            pass
