"""Fault injection: the record, ingest, stream, network and tier
degradation paths, on demand (the JAX package's ``sofa_tpu/faults.py``).

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

The stream kinds act on a source ``live`` tails (strace, pystacks,
cpuinfo, gpumon), in one epoch (``@<n>``, 1-based, default 1) or in every
one (``@always``):

    tail_truncate  the epoch reads only half of the new bytes
    tail_torn      the read is cut mid-record: the torn tail waits
    rotate         the source is treated as rotated: re-read from byte 0
    stall          the source freezes for the epoch

The network kinds act on the fleet client (``archive/client.py``), against
the target ``service``; the service itself is never faulted, so what they
prove is the client's retry, resume and backoff:

    service:conn_refused[@start|@always]   the connection is refused
    service:conn_reset[@start|@always]     the connection is reset
                                           mid-request: the ack is lost,
                                           the retry a committed no-op
    service:stall[@start|@always]          the request passes its deadline
    service:http_500[@start|@always]       a 5xx from the service
    service:partial@<fraction>             the object body is cut at the
                                           fraction (0 < f < 1): the
                                           service's hash check rejects it

A network kind fires once per request key by default (one object upload,
one commit), so the first attempt fails and the retry runs; ``@start``
fires once for the whole plan; ``@always`` never clears.  ``partial`` is
always once per key and only on object uploads.  (``stall`` against any
other target is a stream kind.)

The tier kinds act on the service side of the fleet tier
(``archive/tier.py``, ``archive/service.py``, ``metrics.py``), against the
target ``service``; the client never applies them:

    service:worker_die@<n>     pool worker <n> (1-based) hard-exits on its
                               next write request, once, at spawn
                               generation 0: the supervisor's respawn
                               comes back healthy
    service:replica_stale      the replica's puller holds its current
                               commit while it learns the upstream sha:
                               queries carry X-Sofa-Replica-Stale
    service:slo_breach@<n>     scrape window <n> (1-based) folds a
                               synthetic breached target into its verdict
                               (once)
    service:scrape_stall       the scrape loop's ticks return without a
                               scrape, so the last scrape ages
    service:disk_full@<n>      the <n>-th WAL or store write of the process
                               (1-based) raises ENOSPC: a typed 507, once,
                               so the retry lands

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

# The kinds the ``live`` tailer applies to a source (live.py).
STREAM_KINDS = ("tail_truncate", "tail_torn", "rotate", "stall")
# The kinds the fleet client applies to a request (archive/client.py).
# ``stall`` is in both vocabularies: the ``service`` target picks the
# transport kind, any other target a stream source.
NET_KINDS = ("conn_refused", "conn_reset", "stall", "http_500", "partial",
             "worker_die", "replica_stale", "slo_breach", "scrape_stall",
             "disk_full")
# The network kinds the tier's service side consumes; the client skips
# them.
TIER_KINDS = ("worker_die", "replica_stale", "slo_breach", "scrape_stall",
              "disk_full")
KINDS = ("die", "wedge", "fail", "truncate", "corrupt", "conn_refused",
         "conn_reset", "http_500", "partial") + TIER_KINDS + STREAM_KINDS
# The firing policies of the network kinds ("" is once per request key).
NET_WHENS = ("start", "always")
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
    fraction: Optional[float] = None  # partial only: where the body is cut
    when: Optional[str] = None       # network kinds: start|always|None (per
                                     # key); stream kinds: always|None
    epoch: Optional[int] = None      # stream kinds: the 1-based live
                                     # epoch; tier kinds: their ordinal

    def fires_at(self, phase: str) -> bool:
        return (self.phase or DEFAULT_PHASE.get(self.kind)) == phase


class FaultPlan:
    """A parsed spec, indexed by target."""

    def __init__(self, specs: List[FaultSpec]):
        from sofa_tpu_torch.concurrency import Guard

        self.specs = list(specs)
        self._by_target: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_target.setdefault(s.target, []).append(s)
        # the network kinds are consumed (fire-once policies) from whatever
        # thread runs the client
        self._fired_guard = Guard("faults.fired", protects=("_fired",))
        self._fired: Dict[tuple, bool] = {}

    def find(self, target: str, kind: str,
             phase: Optional[str] = None) -> Optional[FaultSpec]:
        for s in self._by_target.get(target, ()):
            if s.kind == kind and (phase is None or s.fires_at(phase)):
                return s
        return None

    def corrupt_for(self, source: str) -> Optional[FaultSpec]:
        return self.find(source, "corrupt")

    def stream_fault(self, source: str, epoch: int) -> Optional[FaultSpec]:
        """The stream fault to apply to ``source`` in live epoch ``epoch``
        (1-based): a spec fires in its declared epoch (default 1), or in
        every one with ``@always``."""
        for s in self._by_target.get(source, ()):
            if s.kind in STREAM_KINDS and (
                    s.when == "always" or (s.epoch or 1) == epoch):
                return s
        return None

    def service_fault(self, target: str, op: str,
                      key: str) -> Optional[FaultSpec]:
        """Consult and consume: the first network spec for ``target`` that
        fires for the request ``op:key``.  ``@always`` never clears,
        ``@start`` clears after the plan's first matching request, the
        default clears per request key; ``partial`` fires on object
        uploads (op ``put``) only."""
        for s in self._by_target.get(target, ()):
            if s.kind not in NET_KINDS or s.kind in TIER_KINDS:
                continue
            if s.kind == "partial" and op != "put":
                continue
            if s.when == "always":
                return s
            fkey = (s.kind, s.target,
                    "" if s.when == "start" else f"{op}:{key}")
            with self._fired_guard:
                if self._fired.get(fkey):
                    continue
                self._fired[fkey] = True
            return s
        return None

    def tier_worker_die(self, ordinal: int, generation: int) -> bool:
        """Consult-and-consume for ``worker_die@<n>``: True exactly once,
        for pool worker ``ordinal`` (1-based) at spawn generation 0 — a
        respawned worker (generation > 0) never re-fires even though its
        plan still lists the spec."""
        if generation != 0:
            return False
        for s in self._by_target.get("service", ()):
            if s.kind != "worker_die" or (s.epoch or 1) != ordinal:
                continue
            fkey = ("worker_die", ordinal)
            with self._fired_guard:
                if self._fired.get(fkey):
                    continue
                self._fired[fkey] = True
            return True
        return False

    def tier_replica_stale(self) -> bool:
        """Whether a ``replica_stale`` spec is active (never consumed —
        the replica stays pinned until the plan clears)."""
        return any(s.kind == "replica_stale"
                   for s in self._by_target.get("service", ()))

    def tier_slo_breach(self, window: int) -> bool:
        """Consult-and-consume for ``slo_breach@<n>``: True exactly once,
        at scrape window ``window`` (1-based) — the metrics plane folds a
        synthetic breached target into that window's verdict so the
        breach plumbing (typed verdict, catalog event, fleet-status exit)
        is exercised without real load."""
        for s in self._by_target.get("service", ()):
            if s.kind != "slo_breach" or (s.epoch or 1) != window:
                continue
            fkey = ("slo_breach", window)
            with self._fired_guard:
                if self._fired.get(fkey):
                    continue
                self._fired[fkey] = True
            return True
        return False

    def tier_scrape_stall(self) -> bool:
        """Whether a ``scrape_stall`` spec is active (never consumed —
        scrape ticks keep skipping until the plan clears)."""
        return any(s.kind == "scrape_stall"
                   for s in self._by_target.get("service", ()))

    def tier_disk_full(self) -> bool:
        """Consult-and-consume for ``disk_full@<n>``: True exactly once,
        at the plan's <n>-th consulted WAL/store write (1-based, counted
        process-wide across tenants).  The write site answers with a
        typed out-of-space refusal instead of acking bytes it never made
        durable; the consumed spec lets the client's retry land."""
        spec = None
        for s in self._by_target.get("service", ()):
            if s.kind == "disk_full":
                spec = s
                break
        if spec is None:
            return False
        with self._fired_guard:
            if self._fired.get(("disk_full",)):
                return False
            count = int(self._fired.get(("disk_full_writes",), 0)) + 1
            self._fired[("disk_full_writes",)] = count
            if count != (spec.epoch or 1):
                return False
            self._fired[("disk_full",)] = True
        return True


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
        if kind not in KINDS:
            raise ValueError(
                f"fault entry {entry!r}: kind {kind!r} not in {KINDS}")
        if kind in NET_KINDS and (target == "service"
                                  or kind not in STREAM_KINDS):
            specs.append(_parse_net(entry, target, kind, when))
            continue
        if kind in STREAM_KINDS:
            specs.append(_parse_stream(entry, target, kind, when))
            continue
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


def _parse_stream(entry: str, target: str, kind: str,
                  when: str) -> FaultSpec:
    """``<source>:<kind>[@<epoch>|@always]``; the epoch is 1-based."""
    target = ALIASES.get(target, target)
    if not when:
        return FaultSpec(target=target, kind=kind)
    if when == "always":
        return FaultSpec(target=target, kind=kind, when="always")
    try:
        epoch = int(when)
    except ValueError:
        epoch = 0
    if epoch < 1:
        raise ValueError(
            f"fault entry {entry!r}: stream kinds take a 1-based epoch "
            "ordinal (e.g. tail_torn@2) or 'always'")
    return FaultSpec(target=target, kind=kind, epoch=epoch)


def _parse_net(entry: str, target: str, kind: str,
               when: str) -> FaultSpec:
    """``service:<kind>[@start|@always]``, ``service:partial@<f>``, or
    a tier kind with its ordinal."""
    if kind == "worker_die":
        if not when:
            return FaultSpec(target=target, kind=kind, epoch=1)
        try:
            ordinal = int(when)
        except ValueError:
            ordinal = 0
        if ordinal < 1:
            raise ValueError(
                f"fault entry {entry!r}: worker_die takes a 1-based "
                "pool-worker ordinal (e.g. worker_die@2)")
        return FaultSpec(target=target, kind=kind, epoch=ordinal)
    if kind in ("replica_stale", "scrape_stall"):
        if when and when != "always":
            raise ValueError(
                f"fault entry {entry!r}: {kind} takes no firing "
                "policy (it holds until the plan clears)")
        return FaultSpec(target=target, kind=kind, when="always")
    if kind == "slo_breach":
        if not when:
            return FaultSpec(target=target, kind=kind, epoch=1)
        try:
            window = int(when)
        except ValueError:
            window = 0
        if window < 1:
            raise ValueError(
                f"fault entry {entry!r}: slo_breach takes a 1-based "
                "scrape-window ordinal (e.g. slo_breach@2)")
        return FaultSpec(target=target, kind=kind, epoch=window)
    if kind == "disk_full":
        if not when:
            return FaultSpec(target=target, kind=kind, epoch=1)
        try:
            nth = int(when)
        except ValueError:
            nth = 0
        if nth < 1:
            raise ValueError(
                f"fault entry {entry!r}: disk_full takes a 1-based "
                "write ordinal (e.g. disk_full@3)")
        return FaultSpec(target=target, kind=kind, epoch=nth)
    if kind == "partial":
        try:
            fraction = float(when)
        except ValueError:
            fraction = -1.0
        if not 0.0 < fraction < 1.0:
            raise ValueError(
                f"fault entry {entry!r}: partial needs a fraction in "
                "(0, 1), e.g. partial@0.5")
        return FaultSpec(target=target, kind=kind, fraction=fraction)
    if when and when not in NET_WHENS:
        raise ValueError(
            f"fault entry {entry!r}: {when!r} is not a network firing "
            f"policy {NET_WHENS} (default: once per request key)")
    return FaultSpec(target=target, kind=kind, when=when or None)


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


def maybe_service_fault(op: str, key: str = "",
                        target: str = "service") -> Optional[FaultSpec]:
    """The fleet client's hook: the network fault to apply to the request
    ``op:key`` (e.g. ``put:<sha>``), or None; the client turns it into a
    refused connection, a reset, a timeout, a 500 or a cut body."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.service_fault(target, op, key)


def maybe_worker_die(ordinal: int, generation: int = 0) -> bool:
    """The pool worker's hook (archive/service.py): True when pool
    worker ``ordinal`` (1-based) should hard-exit NOW — the
    ``worker_die@<n>`` cell.  Fires once, and only at spawn generation 0:
    the supervisor's respawn must come back healthy."""
    plan = _PLAN
    if plan is None:
        return False
    return plan.tier_worker_die(ordinal, generation)


def maybe_replica_stale() -> bool:
    """The replica puller's hook (archive/tier.py): True while a
    ``replica_stale`` spec pins the replica at its current commit."""
    plan = _PLAN
    if plan is None:
        return False
    return plan.tier_replica_stale()


def maybe_slo_breach(window: int) -> bool:
    """The metrics plane's hook (metrics.py): True when scrape window
    ``window`` (1-based) should fold a synthetic breached target into its
    slo_verdict — the ``slo_breach@<n>`` cell.  Fires once."""
    plan = _PLAN
    if plan is None:
        return False
    return plan.tier_slo_breach(window)


def maybe_disk_full() -> bool:
    """The hook of the tier's durable writes (WAL appends in
    archive/tier.py, object uploads in archive/service.py): True when this durable write should see ENOSPC — the
    ``disk_full@<n>`` cell.  The caller refuses the request with a typed
    out-of-space error instead of acking; fires once, so the client's
    backed-off retry proves recovery."""
    plan = _PLAN
    if plan is None:
        return False
    return plan.tier_disk_full()


def maybe_scrape_stall() -> bool:
    """The metrics plane's hook (metrics.py): True while a
    ``scrape_stall`` spec freezes the scrape loop — ticks return without
    scraping, so last-scrape age grows honestly."""
    plan = _PLAN
    if plan is None:
        return False
    return plan.tier_scrape_stall()


def maybe_stream_fault(source: str, epoch: int) -> Optional[FaultSpec]:
    """The live tailer's hook: the stream fault to apply to ``source`` in
    epoch ``epoch``, or None."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.stream_fault(source, epoch)


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
