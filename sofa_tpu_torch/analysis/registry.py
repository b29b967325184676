"""The analysis-pass registry: every pass declares its contract, and
``run_passes`` schedules, isolates and records them (the JAX package's
``sofa_tpu/analysis/registry.py``).

A pass is a function ``fn(frames, cfg, features)`` registered with
``@analysis_pass(...)`` (or ``register_pass``) under a contract:

* the **frames** and **columns** it reads (columns are checked against
  ``trace.COLUMNS`` at registration),
* the **features** it reads (fnmatch patterns over feature names:
  ``gpu*_kernel_time`` covers every device),
* what it **provides**: feature patterns, artifacts (files in the logdir),
  and whether it returns board series,
* ``after`` edges for what no feature says (the spotlight pass sets
  ``cfg.roi_begin`` / ``roi_end``: every pass that clips to the region of
  interest runs ``after=("spotlight",)``),
* ``enabled_when``: cfg attributes, any of which turns it on.

The schedule comes from the declarations alone: a pass that reads a
feature another provides runs in a later wave, and the passes of a wave
run on the shared ``--jobs`` thread pool (``pool.thread_map``).  Each pass
writes into a buffer of its own; its reads see the features analyze
began with and every completed wave's buffers, in canonical order
(``order``, then registration); the buffers merge in that order.  So
``--jobs 1`` and ``--jobs 4`` write byte-identical ``features.csv`` and
``hints.txt``.

The frames may be lazy ``frames.FrameHandle``s (analyze over a chunk
store): each pass then receives its declared ``reads_frames`` read to its
declared ``reads_columns`` on entry and dropped on exit
(``frames.ProjectionPool``), and every other frame as its handle, so that
a pass reading a frame it did not declare fails inside its own fault
isolation.  Eager frames pass through as they are.

A pass that raises is a warning (``print_warning``, which the run's
telemetry counts) and a ``failed`` entry in the run manifest's
``meta.passes`` ledger; the other passes and analyze go on.
A ``live`` epoch re-runs only the passes ``select_for_dirty`` picks from
the same declarations: those reading a frame that changed, and every pass
consuming their features, transitively.  The rest are ``skipped`` as
"inputs unchanged (live incremental)".

``sofa_passes`` (the ``passes`` verb) prints the schedule, the contracts
and the last run's statuses and timings.
"""

from __future__ import annotations

import contextlib
import re
import time
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Callable, Dict, List, Optional, Tuple

import pandas as pd

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_title, print_warning

#: Features analyze adds before any pass runs: reading one needs
#: no producing pass.
AMBIENT_FEATURES = ("elapsed_time", "num_cores")


class RegistryError(ValueError):
    """A broken pass declaration or an unschedulable pass graph."""


@dataclass(frozen=True)
class PassSpec:
    """One registered pass and its contract."""

    name: str
    fn: Callable
    #: canonical merge and tie-break position (plugins default past every
    #: built-in)
    order: int
    reads_frames: Tuple[str, ...] = ()
    reads_columns: Tuple[str, ...] = ()
    reads_features: Tuple[str, ...] = ()
    provides_features: Tuple[str, ...] = ()
    provides_artifacts: Tuple[str, ...] = ()
    provides_series: bool = False
    after: Tuple[str, ...] = ()
    #: cfg attributes gating the pass (on when ANY is truthy; empty = on)
    enabled_when: Tuple[str, ...] = ()
    origin: str = "builtin"
    seq: int = 0

    def enabled(self, cfg) -> bool:
        if not self.enabled_when:
            return True
        return any(getattr(cfg, attr, False) for attr in self.enabled_when)


# Written by the import-time decorators, plugin loads and the per-host
# workers of cluster_analyze (``scoped``).
_lock = Guard("analysis.registry",
              protects=("_registry", "_declared_builtins", "_seq"))
_registry: Dict[str, PassSpec] = {}
#: every built-in ever registered: the decorators run once, at the first
#: import, so ``load_builtin_passes`` after ``clear`` restores from here
_declared_builtins: Dict[str, PassSpec] = {}
_seq = 0
_origin = ["builtin"]


def _as_tuple(value, what: str) -> Tuple[str, ...]:
    if isinstance(value, str):
        raise RegistryError(f"{what} must be a tuple of strings, got the "
                            f"bare string {value!r}")
    out = tuple(value)
    for v in out:
        if not isinstance(v, str) or not v:
            raise RegistryError(f"{what} entries must be non-empty strings, "
                                f"got {v!r}")
    return out


def register_pass(fn: Callable, *, name: str, order: int = 0,
                  reads_frames=(), reads_columns=(), reads_features=(),
                  provides_features=(), provides_artifacts=(),
                  provides_series: bool = False, after=(),
                  enabled_when=()) -> PassSpec:
    """Register ``fn(frames, cfg, features)`` under its contract.  A
    duplicate name or a column outside ``trace.COLUMNS`` is a coding
    error, raised here.  Returns the spec; ``fn`` stays as it is."""
    global _seq
    from sofa_tpu_torch.trace import COLUMNS

    if not name or not isinstance(name, str):
        raise RegistryError(f"pass name must be a non-empty string: {name!r}")
    spec_cols = _as_tuple(reads_columns, f"pass {name}: reads_columns")
    unknown = [c for c in spec_cols if c not in COLUMNS]
    if unknown:
        raise RegistryError(
            f"pass {name}: reads_columns {unknown} not in trace.COLUMNS — "
            "fix the declaration or add the column to trace.py")
    with _lock:
        if name in _registry:
            raise RegistryError(f"pass {name!r} is already registered "
                                f"(by {_registry[name].origin})")
        _seq += 1
        spec = PassSpec(
            name=name, fn=fn, order=order if order else 1000 + _seq,
            reads_frames=_as_tuple(reads_frames,
                                   f"pass {name}: reads_frames"),
            reads_columns=spec_cols,
            reads_features=_as_tuple(reads_features,
                                     f"pass {name}: reads_features"),
            provides_features=_as_tuple(provides_features,
                                        f"pass {name}: provides_features"),
            provides_artifacts=_as_tuple(provides_artifacts,
                                         f"pass {name}: provides_artifacts"),
            provides_series=bool(provides_series),
            after=_as_tuple(after, f"pass {name}: after"),
            enabled_when=_as_tuple(enabled_when,
                                   f"pass {name}: enabled_when"),
            origin=_origin[-1], seq=_seq)
        _registry[name] = spec
        # only the package's own passes come back after a clear
        if spec.origin == "builtin" and (getattr(fn, "__module__", "")
                                         or "").startswith("sofa_tpu_torch."):
            _declared_builtins[name] = spec
    return spec


def analysis_pass(**contract):
    """Decorator form of :func:`register_pass`."""
    def deco(fn: Callable) -> Callable:
        register_pass(fn, **contract)
        return fn
    return deco


@contextlib.contextmanager
def plugin_origin(label: str):
    """Passes registered inside this block are tagged ``plugin:<label>``
    in ``passes`` and ``meta.passes``."""
    _origin.append(f"plugin:{label}")
    try:
        yield
    finally:
        _origin.pop()


@contextlib.contextmanager
def scoped():
    """Snapshot the registry and restore it on exit."""
    with _lock:
        before = dict(_registry)
    try:
        yield
    finally:
        with _lock:
            _registry.clear()
            _registry.update(before)


def clear() -> None:
    with _lock:
        _registry.clear()


def registered() -> List[PassSpec]:
    """Every registered pass in canonical order (order, then seq)."""
    with _lock:
        specs = list(_registry.values())
    return sorted(specs, key=lambda s: (s.order, s.seq))


def get(name: str) -> Optional[PassSpec]:
    with _lock:
        return _registry.get(name)


def load_builtin_passes() -> None:
    """Import the analysis modules so that their decorators register
    (idempotent); built-ins a ``clear`` removed come back from the
    declarations archived at the first import."""
    import sofa_tpu_torch.analysis.advice  # noqa: F401
    import sofa_tpu_torch.analysis.comm  # noqa: F401
    import sofa_tpu_torch.analysis.concurrency  # noqa: F401
    import sofa_tpu_torch.analysis.device  # noqa: F401
    import sofa_tpu_torch.analysis.gpu  # noqa: F401
    import sofa_tpu_torch.analysis.host  # noqa: F401
    import sofa_tpu_torch.analysis.mlpass  # noqa: F401
    import sofa_tpu_torch.analysis.sol  # noqa: F401
    import sofa_tpu_torch.whatif.model  # noqa: F401
    with _lock:
        for name, spec in _declared_builtins.items():
            _registry.setdefault(name, spec)


# --- the pattern algebra ----------------------------------------------------

def patterns_overlap(a: str, b: str) -> bool:
    """Whether two fnmatch feature patterns can name the same feature:
    either matches the other as a literal."""
    return fnmatchcase(a, b) or fnmatchcase(b, a)


def covered(pattern: str, declared) -> bool:
    return any(patterns_overlap(pattern, d) for d in declared)


# --- scheduling -------------------------------------------------------------

def pass_dependencies(specs: List[PassSpec],
                      ambient=AMBIENT_FEATURES) -> Dict[str, List[str]]:
    """name -> the sorted names it depends on: every other pass that
    provides a feature pattern it reads (``ambient`` features need none),
    and its ``after`` edges to passes in ``specs``."""
    by_name = {s.name: s for s in specs}
    deps: Dict[str, set] = {s.name: set() for s in specs}
    for s in specs:
        for dep in s.after:
            if dep in by_name and dep != s.name:
                deps[s.name].add(dep)
        for pat in s.reads_features:
            if covered(pat, ambient):
                continue
            for other in specs:
                if other.name != s.name and covered(pat,
                                                    other.provides_features):
                    deps[s.name].add(other.name)
    return {k: sorted(v) for k, v in deps.items()}


def resolve_schedule(specs: List[PassSpec], strict: bool = False,
                     ambient=AMBIENT_FEATURES) -> List[List[PassSpec]]:
    """Waves over the dependency graph (Kahn's levels), canonical order in
    each.  A cycle raises in ``strict`` mode (``passes``); at run time its
    passes run in canonical order after a warning: analysis must not
    become unrunnable because a plugin declared wrong."""
    specs = sorted(specs, key=lambda s: (s.order, s.seq))
    deps = pass_dependencies(specs, ambient=ambient)
    done: set = set()
    waves: List[List[PassSpec]] = []
    pending = list(specs)
    while pending:
        ready = [s for s in pending if all(d in done for d in deps[s.name])]
        if not ready:
            cyclic = [s.name for s in pending]
            if strict:
                raise RegistryError(
                    f"dependency cycle among passes: {cyclic}")
            print_warning(
                f"analysis registry: dependency cycle among {cyclic} — "
                "running them in canonical order (fix the declarations)")
            ready = pending
        waves.append(ready)
        done.update(s.name for s in ready)
        pending = [s for s in pending if s.name not in done]
    return waves


def select_for_dirty(cfg, dirty_frames) -> set:
    """The passes a ``live`` epoch re-runs: every enabled pass whose
    ``reads_frames`` names a dirty frame, closed over the dependency graph
    the scheduler uses (feature reads and ``after`` edges), so that a pass
    consuming a re-run pass's features re-runs too."""
    dirty = set(dirty_frames)
    specs = [s for s in registered() if s.enabled(cfg)]
    consumers: Dict[str, set] = {s.name: set() for s in specs}
    for name, producers in pass_dependencies(specs).items():
        for p in producers:
            consumers[p].add(name)
    selected = {s.name for s in specs if set(s.reads_frames) & dirty}
    frontier = list(selected)
    while frontier:
        for c in consumers[frontier.pop()]:
            if c not in selected:
                selected.add(c)
                frontier.append(c)
    return selected


# --- deterministic feature views --------------------------------------------

class _PassFeatures:
    """The features one pass sees: its writes go to a buffer of its own;
    its reads see the features analyze began with and every completed
    pass's buffer in canonical order, then its own."""

    def __init__(self, base: Features, completed: List[Features]):
        self._base = base
        self._completed = completed  # canonical order, frozen for a wave
        self.buf = Features()

    def add(self, name: str, value: float) -> None:
        self.buf.add(name, value)

    def add_info(self, name: str, value: str) -> None:
        self.buf.add_info(name, value)

    def _layers(self) -> List[Features]:
        return [self._base] + self._completed + [self.buf]

    def get(self, name: str) -> Optional[float]:
        for layer in reversed(self._layers()):
            v = layer.get(name)
            if v is not None:
                return v
        return None

    def by_regex(self, pattern: str):
        rx = re.compile(pattern)
        latest: Dict[str, float] = {}
        for layer in self._layers():
            for n, v in layer._rows:
                if rx.fullmatch(n):
                    latest[n] = v
        return sorted(latest.items())

    def to_frame(self) -> pd.DataFrame:
        rows = [r for layer in self._layers() for r in layer._rows]
        return pd.DataFrame(rows, columns=["name", "value"])


# --- execution --------------------------------------------------------------

def run_passes(frames, cfg, features: Features, tel=None,
               jobs: Optional[int] = None, select=None):
    """Run every registered, enabled pass on the declared schedule, wave
    by wave on the ``--jobs`` pool, and merge their features into
    ``features`` in canonical order.  Returns ``(ledger, series)``: the
    ``meta.passes`` ledger (schedule, canonical order, jobs, and per pass
    status, origin, wave, wall_s, error or skip_reason) and the board
    series that series-providing passes returned, in canonical order.  A
    pass that raises is warned about and marked ``failed``; the rest
    run.  ``select`` (pass names, None for all) is a ``live`` epoch's
    window: an enabled pass outside it is ``skipped``, its inputs
    unchanged, and its previous features are the caller's to carry."""
    from sofa_tpu_torch import pool, telemetry
    from sofa_tpu_torch.frames import ProjectionPool

    proj = ProjectionPool(frames)
    specs = registered()
    jobs = pool.cfg_jobs(cfg) if jobs is None else max(1, int(jobs))
    enabled = [s for s in specs if s.enabled(cfg)]
    report: Dict[str, dict] = {}
    for s in specs:
        if s not in enabled:
            report[s.name] = {
                "status": "skipped", "origin": s.origin,
                "skip_reason": "/".join(s.enabled_when) + " off",
            }
    if select is not None:
        for s in enabled:
            if s.name not in select:
                report[s.name] = {
                    "status": "skipped", "origin": s.origin,
                    "skip_reason": "inputs unchanged (live incremental)"}
        enabled = [s for s in enabled if s.name in select]
    waves = resolve_schedule(enabled)
    rank = {s.name: (s.order, s.seq) for s in enabled}
    wave_of = {s.name: i for i, wave in enumerate(waves) for s in wave}
    buffers: Dict[str, Features] = {}
    series_by_pass: Dict[str, list] = {}
    completed: List[Features] = []   # canonical order, grows by the wave

    def run_one(spec: PassSpec) -> None:
        view = _PassFeatures(features, list(completed))
        buffers[spec.name] = view.buf
        entry = report.setdefault(spec.name, {})
        entry.update(origin=spec.origin, wave=wave_of[spec.name])
        t0 = time.perf_counter()
        span = (tel.span(spec.name, cat="analyze") if tel is not None
                else telemetry.maybe_span(spec.name, cat="analyze"))
        try:
            with span:
                out = spec.fn(proj.for_pass(spec.reads_frames,
                                            spec.reads_columns), cfg, view)
            if spec.provides_series and out:
                series_by_pass[spec.name] = list(out)
            entry["status"] = "ok"
        except Exception as e:  # noqa: BLE001 - per-pass fault isolation
            print_warning(f"analyze pass {spec.name}: "
                          f"{type(e).__name__}: {e}")
            entry["status"] = "failed"
            entry["error"] = f"{type(e).__name__}: {e}"[:300]
        entry["wall_s"] = round(time.perf_counter() - t0, 6)

    for wave in waves:
        pool.thread_map(run_one, wave, jobs)
        # this wave's output becomes visible to the next, canonical order
        completed = [buffers[n] for n in sorted(buffers, key=rank.__getitem__)]

    canonical = sorted(enabled, key=lambda s: (s.order, s.seq))
    for spec in canonical:
        features.merge_from(buffers[spec.name])
    series = [s for spec in canonical
              for s in series_by_pass.get(spec.name, ())]
    ledger = {
        "schedule": [[s.name for s in wave] for wave in waves],
        "order": [s.name for s in canonical],
        "jobs": jobs,
        "passes": report,
    }
    return ledger, series


# --- the `passes` verb ------------------------------------------------------

def sofa_passes(cfg) -> int:
    """Print the schedule, each pass's contract and, when the logdir's
    manifest has ``meta.passes``, the last run's status and time of each.
    Exit 2 on an unschedulable graph."""
    from sofa_tpu_torch import telemetry

    load_builtin_passes()
    specs = registered()
    enabled = [s for s in specs if s.enabled(cfg)]
    try:
        waves = resolve_schedule(enabled, strict=True)
    except RegistryError as e:
        print_warning(str(e))
        return 2
    deps = pass_dependencies(enabled)
    last = ((telemetry.load_manifest(cfg.logdir) or {}).get("meta") or {}) \
        .get("passes") or {}
    last_passes = last.get("passes") or {}

    print_title(f"SOFA analysis passes — {len(specs)} registered, "
                f"{len(enabled)} enabled, {len(waves)} wave(s)")
    for i, wave in enumerate(waves):
        print(f"wave {i}: {', '.join(s.name for s in wave)}")
    print()
    for spec in specs:
        run = last_passes.get(spec.name) or {}
        tail = ""
        if run.get("status"):
            tail = f"  [last run: {run['status']}"
            if isinstance(run.get("wall_s"), (int, float)):
                tail += f" {run['wall_s']:.3f}s"
            if run.get("error"):
                tail += f" — {run['error'][:60]}"
            tail += "]"
        gate = (f" (gated by {'/'.join(spec.enabled_when)};"
                f" {'on' if spec.enabled(cfg) else 'off'})"
                if spec.enabled_when else "")
        print(f"{spec.name}  [{spec.origin}]{gate}{tail}")
        if spec.reads_frames:
            print(f"  reads frames:   {', '.join(spec.reads_frames)}")
        if spec.reads_columns:
            print(f"  reads columns:  {', '.join(spec.reads_columns)}")
        if spec.reads_features:
            print(f"  reads features: {', '.join(spec.reads_features)}")
        if spec.provides_features:
            print(f"  provides:       {', '.join(spec.provides_features)}")
        if spec.provides_artifacts:
            print(f"  artifacts:      {', '.join(spec.provides_artifacts)}")
        if spec.provides_series:
            print("  board series:   yes")
        if deps.get(spec.name):
            print(f"  after:          {', '.join(deps[spec.name])}")
    return 0
