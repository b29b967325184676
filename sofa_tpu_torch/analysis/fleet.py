"""The fleet-pass engine: incremental cross-run analysis over ``_index/``
(the JAX package's ``sofa_tpu/analysis/fleet.py``).

Second registry domain beside the per-run analysis passes: a
``@fleet_pass`` reads declared slices of the archive's column families
(``catalog``/``features``, plus point lookups into ``runs``) and folds
them into a schema-versioned fleet report under ``<root>/_fleet/``.
Scheduling, contract validation and the determinism discipline are the
per-run registry's (``analysis/registry.py``): literal
contracts, Kahn waves from the declarations alone, private feature
buffers merged in canonical order — so ``--jobs 1`` and ``--jobs 4``
produce byte-identical reports.

The perf core is **incrementality** (the ``_index/`` suffix discipline
lifted to analysis).  Every pass is a *fold*::

    @fleet_pass(name=..., reads_frames=("features",),
                reads_columns=("features.name", "features.value"), ...)
    def my_pass(state, tables, ctx, features):
        ...
        return {"state": new_state, "report": section}

``state`` is the pass's previous JSON state (None on a cold run) and
``tables`` holds exactly the declared families projected to the declared
columns — on a cold run every row, on a warm run only the rows from the
first *dirty* index chunk onward (the committed full chunks before it
are immutable under append, so their folded partials are reusable
verbatim).  ``fold_chunks`` is the canonical state shape: one partial
per index chunk, combined at render time with ``math.fsum`` — chunk
partials are a pure function of the chunk bytes and ``fsum`` is exactly
rounded, so a warm fold is byte-identical to a cold recompute.

Results are memoized in ``_fleet/fleet_state.json`` keyed on the index
``commit_sha`` and each pass's contract fingerprint; a refresh after N
new ingests touches only the delta chunks.  A ``catalog.gen`` bump or a
fingerprint change falls back to a full recompute — never a silently
stale fold.  Layout::

    _fleet/fleet_report.json   the served artifact (schema
                               ``sofa_tpu/fleet_report`` v1): per-pass
                               report sections + fleet features, stamped
                               with the index commit sha it covers (the
                               /v1/<tenant>/fleet ETag)
    _fleet/fleet_state.json    the memo (schema ``sofa_tpu/fleet_state``
                               v1, written LAST): per-pass fold state +
                               fingerprints + the per-family chunk shas
                               the next delta window is validated
                               against

Both land via fsync'd ``atomic_write`` with no wall clock anywhere, so a
SIGKILL between the two (the ``SOFA_FLEET_EXIT_AFTER`` knob)
leaves a report the next run reproduces byte-identically.  Everything
under ``_fleet/`` is derived state: :func:`drop` + :func:`analyze` is
always safe, and the tier's post-drain refresh hook keeps served
tenants warm.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.analysis.registry import (
    PassSpec,
    RegistryError,
    _as_tuple,
    resolve_schedule,
)
from sofa_tpu_torch.concurrency import Guard
from sofa_tpu_torch.printing import print_title, print_warning

FLEET_DIR_NAME = "_fleet"
FLEET_REPORT_NAME = "fleet_report.json"
FLEET_REPORT_SCHEMA = "sofa_tpu/fleet_report"
# Bumps on any breaking report-shape change; additive keys do not.
FLEET_REPORT_VERSION = 1

FLEET_STATE_NAME = "fleet_state.json"
FLEET_STATE_SCHEMA = "sofa_tpu/fleet_state"
FLEET_STATE_VERSION = 1

#: Families a fleet pass may read as TABLES.  The refresh builds both by
#: appending conformed suffix rows to the committed prefix, so committed
#: full chunks are immutable and a delta window is sound.  The ``runs``
#: family is rebuilt (deduped, re-sorted) every refresh — passes reach
#: it through ``ctx.runs_meta`` point lookups only, never as a delta.
APPEND_ONLY_FAMILIES = ("catalog", "features")

#: Part of every contract fingerprint — bump to force a fleet-wide full
#: recompute when the fold/render semantics change without any
#: declaration changing.
ENGINE_FOLD_VERSION = 1


class FleetError(RegistryError):
    """A broken fleet-pass declaration or an unusable fleet substrate."""


# The analysis registry's guard discipline: decorators at import time,
# scoped()/clear() from tests.
_lock = Guard("analysis.fleet",
              protects=("_registry", "_declared_builtins"))
_registry: Dict[str, PassSpec] = {}
_declared_builtins: Dict[str, PassSpec] = {}
_seq = 0


def fleet_dir(root: str) -> str:
    return os.path.join(root, FLEET_DIR_NAME)


def report_path(root: str) -> str:
    return os.path.join(root, FLEET_DIR_NAME, FLEET_REPORT_NAME)


def state_path(root: str) -> str:
    return os.path.join(root, FLEET_DIR_NAME, FLEET_STATE_NAME)


def _chaos_tick() -> None:
    """``SOFA_FLEET_EXIT_AFTER=<n>`` hard-exits at the n-th fleet commit
    point of this process — between the report write and the memo
    write, the widest crash window, where a re-run must converge to
    the byte-identical artifact."""
    try:
        n = int(os.environ.get("SOFA_FLEET_EXIT_AFTER", "0"))
    except ValueError:
        n = 0
    if not n:
        return
    count = int(os.environ.get("_SOFA_FLEET_TICKS", "0")) + 1
    os.environ["_SOFA_FLEET_TICKS"] = str(count)
    if count >= n:
        os._exit(86)


# ---------------------------------------------------------------------------
# Registration (the @fleet_pass domain).
# ---------------------------------------------------------------------------

def _family_columns() -> Dict[str, List[str]]:
    from sofa_tpu_torch.archive import index as aindex

    return {aindex.CATALOG_FAMILY: aindex.CATALOG_COLUMNS,
            aindex.RUNS_FAMILY: aindex.RUNS_COLUMNS,
            aindex.FEATURES_FAMILY: aindex.FEATURE_COLUMNS}


def register_fleet_pass(fn: Callable, *, name: str, order: int = 0,
                        reads_frames=(), reads_columns=(),
                        reads_features=(), provides_features=(),
                        provides_artifacts=(), after=(),
                        enabled_when=()) -> PassSpec:
    """Register a fleet fold ``fn(state, tables, ctx, features)``.

    The contract vocabulary is the analysis domain's, re-anchored on the
    index: ``reads_frames`` names column FAMILIES, ``reads_columns``
    entries are family-qualified (``"features.value"``) and validated
    against the pinned family schemas.  ``after`` edges may only name
    other FLEET passes; an edge into the per-run analysis domain is a
    category error this validation rejects."""
    global _seq
    from sofa_tpu_torch.analysis import registry as analysis_registry

    if not name or not isinstance(name, str):
        raise FleetError(f"fleet pass name must be a non-empty string: "
                         f"{name!r}")
    fam_cols = _family_columns()
    spec_frames = _as_tuple(reads_frames,
                            f"fleet pass {name}: reads_frames")
    unknown = [f for f in spec_frames if f not in fam_cols]
    if unknown:
        raise FleetError(
            f"fleet pass {name}: reads_frames {unknown} not an index "
            f"family {tuple(sorted(fam_cols))} — fix the declaration")
    spec_cols = _as_tuple(reads_columns,
                          f"fleet pass {name}: reads_columns")
    for qual in spec_cols:
        fam, _, col = qual.partition(".")
        if fam not in spec_frames or col not in fam_cols.get(fam, ()):
            raise FleetError(
                f"fleet pass {name}: reads_columns entry {qual!r} is not "
                "a declared-family column (spell it <family>.<column> "
                "against the pinned schemas in archive/index.py)")
    spec_after = _as_tuple(after, f"fleet pass {name}: after")
    for dep in spec_after:
        if analysis_registry.get(dep) is not None and dep not in _registry:
            raise FleetError(
                f"fleet pass {name}: after={dep!r} crosses into the "
                "per-run analysis domain — fleet passes schedule only "
                "against fleet passes")
    with _lock:
        if name in _registry:
            raise FleetError(f"fleet pass {name!r} is already registered "
                             f"(by {_registry[name].origin})")
        _seq += 1
        spec = PassSpec(
            name=name, fn=fn,
            order=order if order else 1000 + _seq,
            reads_frames=spec_frames,
            reads_columns=spec_cols,
            reads_features=_as_tuple(
                reads_features, f"fleet pass {name}: reads_features"),
            provides_features=_as_tuple(
                provides_features,
                f"fleet pass {name}: provides_features"),
            provides_artifacts=_as_tuple(
                provides_artifacts,
                f"fleet pass {name}: provides_artifacts"),
            after=spec_after,
            enabled_when=_as_tuple(
                enabled_when, f"fleet pass {name}: enabled_when"),
            origin="fleet", seq=_seq)
        _registry[name] = spec
        if (getattr(fn, "__module__", "") or "").startswith("sofa_tpu_torch."):
            _declared_builtins[name] = spec
    return spec


def fleet_pass(**contract):
    """Decorator form of :func:`register_fleet_pass`; keep every argument
    a literal."""
    def deco(fn: Callable) -> Callable:
        register_fleet_pass(fn, **contract)
        return fn
    return deco


@contextlib.contextmanager
def scoped():
    """Snapshot the fleet registry and restore on exit (tests, chaos)."""
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
    with _lock:
        specs = list(_registry.values())
    return sorted(specs, key=lambda s: (s.order, s.seq))


def get(name: str) -> Optional[PassSpec]:
    with _lock:
        return _registry.get(name)


def load_builtin_passes() -> None:
    """Import the builtin fleet passes (idempotent; the declaration
    archive restores them after a ``clear``/``scoped``, exactly the
    analysis registry's rule)."""
    import sofa_tpu_torch.analysis.fleet_passes  # noqa: F401
    with _lock:
        for name, spec in _declared_builtins.items():
            _registry.setdefault(name, spec)


def fingerprint(spec: PassSpec) -> str:
    """The contract fingerprint a pass's memoized state is keyed on: a
    pure function of the DECLARATION (plus the engine fold version), so
    editing any contract — or bumping ENGINE_FOLD_VERSION — forces that
    pass onto the full-recompute path."""
    doc = {"name": spec.name, "order": spec.order,
           "reads_frames": list(spec.reads_frames),
           "reads_columns": list(spec.reads_columns),
           "reads_features": list(spec.reads_features),
           "provides_features": list(spec.provides_features),
           "after": list(spec.after),
           "fold": ENGINE_FOLD_VERSION}
    return hashlib.sha1(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# The fold substrate.
# ---------------------------------------------------------------------------

@dataclass
class FleetContext:
    """What a fleet pass sees beside its tables: where the fold window
    starts (``base``, the first index-chunk ordinal each provided table
    begins at) and bounded point lookups into the runs family."""

    root: str
    commit: dict
    mode: str                      # "full" | "delta"
    chunk_rows: int
    base: Dict[str, int] = field(default_factory=dict)
    _meta_cache: Dict[str, dict] = field(default_factory=dict)
    _meta_absent: set = field(default_factory=set)

    def runs_meta(self, run_ids) -> Dict[str, dict]:
        """Provenance rows for a SET of runs — O(result) projected
        lookups into the runs family (newest ingest wins).  Lookups at
        *render* time are byte-identity safe (warm and cold render
        against the same commit); a fold baking lookups into memoized
        partials accepts that a re-ingest which CHANGES a run's
        label/host re-attributes its old rows only on the next full
        recompute.

        Memoized per context (the commit is immutable for the life of
        an analyze): a full fan-out's per-chunk folds ask for largely
        disjoint id sets, and without the cache each call re-read the
        whole run column."""
        from sofa_tpu_torch.archive import index as aindex

        ids = set(run_ids)
        miss = ids - self._meta_cache.keys() - self._meta_absent
        if miss:
            got = aindex._runs_meta(self.root, self.commit, miss)
            self._meta_cache.update(got)
            self._meta_absent.update(miss - got.keys())
        return {r: self._meta_cache[r] for r in ids
                if r in self._meta_cache}


def fold_chunks(parts: Dict[str, dict], tbl, base: int, chunk_rows: int,
                fn: Callable) -> None:
    """The canonical incremental state shape: one partial per index
    chunk, keyed by the chunk ordinal (as a string — JSON state).

    Drops every partial at or past ``base`` (the store rewrote its tail
    chunk, so those partials are stale) and recomputes one partial per
    ``chunk_rows`` slice of ``tbl`` — slices align with the store's
    fixed chunk boundaries, so a partial is a pure function of the chunk
    bytes and a warm fold reproduces the cold fold's partials exactly.
    Combine partials at render time with :func:`math.fsum` (exactly
    rounded, hence order- and split-invariant)."""
    for key in [k for k in parts if int(k) >= base]:
        del parts[key]
    for i in range((tbl.num_rows + chunk_rows - 1) // chunk_rows):
        parts[str(base + i)] = fn(tbl.slice(i * chunk_rows, chunk_rows))


def parts_in_order(parts: Dict[str, dict]) -> List[dict]:
    """Chunk partials in chunk order — combine their per-chunk sums with
    ``math.fsum`` (exactly rounded, hence split-invariant: a warm fold's
    partial list is identical to a cold recompute's, so so are the
    combined totals)."""
    return [parts[k] for k in sorted(parts, key=int)]


# ---------------------------------------------------------------------------
# Memo + report I/O.
# ---------------------------------------------------------------------------

def load_report(root: str) -> Optional[dict]:
    """The committed fleet report, or None when absent/unreadable/not a
    v1 doc (the /v1/<tenant>/fleet route then answers 404 and the board
    falls back)."""
    try:
        with open(report_path(root)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) \
            or doc.get("schema") != FLEET_REPORT_SCHEMA \
            or doc.get("version") != FLEET_REPORT_VERSION:
        return None
    return doc


def _load_state(root: str) -> Optional[dict]:
    try:
        with open(state_path(root)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) \
            or doc.get("schema") != FLEET_STATE_SCHEMA \
            or doc.get("version") != FLEET_STATE_VERSION:
        return None
    return doc


def drop(root: str) -> None:
    """Remove the fleet tier wholesale — everything under ``_fleet/`` is
    derived from the index; the next :func:`analyze` rebuilds it."""
    shutil.rmtree(fleet_dir(root), ignore_errors=True)


def verify(root: str) -> List[str]:
    """fsck's view: a PRESENT but unreadable report/memo is damage; an
    absent or torn-in-between ``_fleet/`` (report ahead of memo — the
    chaos window) is a healthy pending state the next analyze converges.
    Returns root-relative damage paths."""
    bad: List[str] = []
    if not os.path.isdir(fleet_dir(root)):
        return bad
    if os.path.exists(report_path(root)) and load_report(root) is None:
        bad.append(f"{FLEET_DIR_NAME}/{FLEET_REPORT_NAME}")
    if os.path.exists(state_path(root)) and _load_state(root) is None:
        bad.append(f"{FLEET_DIR_NAME}/{FLEET_STATE_NAME}")
    return bad


# ---------------------------------------------------------------------------
# The incremental engine.
# ---------------------------------------------------------------------------

def _family_index(root: str, family: str) -> Optional[dict]:
    from sofa_tpu_torch import frames
    from sofa_tpu_torch.archive import index as aindex

    return frames._load_index(os.path.join(
        aindex.family_dir(root, family), frames.FRAME_INDEX_NAME))


def _family_sig(root: str) -> Dict[str, dict]:
    """Per-append-only-family {rows, chunk shas} — what the memo records
    and the next run's delta window is validated against."""
    sig: Dict[str, dict] = {}
    for family in APPEND_ONLY_FAMILIES:
        doc = _family_index(root, family) or {}
        sig[family] = {
            "rows": int(doc.get("rows") or 0),
            "chunks": [c.get("sha") for c in doc.get("chunks") or []],
        }
    return sig


def _delta_base(prev: dict, cur: dict, chunk_rows: int) -> Optional[int]:
    """The first dirty chunk ordinal for one family, or None when the
    committed prefix moved (a full rebuild changed history) and only a
    full recompute is sound.  Full chunks before the memo's tail are
    immutable under append — their shas must match exactly."""
    prev_rows = int(prev.get("rows") or 0)
    if int(cur.get("rows") or 0) < prev_rows:
        return None
    base = prev_rows // chunk_rows
    prev_chunks = prev.get("chunks") or []
    cur_chunks = cur.get("chunks") or []
    if len(cur_chunks) < base or prev_chunks[:base] != cur_chunks[:base]:
        return None
    return base


def _pass_columns(spec: PassSpec, family: str) -> Optional[List[str]]:
    cols = [c.split(".", 1)[1] for c in spec.reads_columns
            if c.startswith(family + ".")]
    return cols or None


def _read_window(root: str, family: str, base: int,
                 columns: Optional[List[str]]):
    """The family's rows from chunk ``base`` onward as one Arrow table —
    chunk boundaries preserved (the concat keeps each feather chunk a
    distinct buffer), so downstream per-chunk slices see the exact
    standalone-chunk data a cold run sees."""
    import pyarrow as pa

    from sofa_tpu_torch import frames
    from sofa_tpu_torch.archive import index as aindex

    handle = frames.open_chunk_store(aindex.family_dir(root, family))
    if handle is None:
        return pa.table({c: pa.array([], type=pa.string())
                         for c in (columns or [])})
    if base <= 0:
        return handle.read_table(columns=columns)
    n = len(handle.index.get("chunks") or [])
    tables = [handle.read_chunk_table(i, columns=columns)
              for i in range(base, n)]
    if not tables:
        return handle.read_chunk_table(0, columns=columns).slice(0, 0)
    return pa.concat_tables(tables)


def analyze(root: str, jobs: int = 0, select=None,
            refresh_index: bool = True) -> dict:
    """Run every registered fleet pass over the archive index and commit
    ``_fleet/``; returns the report doc with a transient ``_stats`` key
    (per-pass mode + wall, not part of the artifact — the artifact
    carries no wall clock, so warm/cold/resumed runs are byte-identical).

    Modes per pass, cheapest wins:

    * ``memo``  — index commit sha and contract fingerprint both match
      the memo: the pass does not run at all; its report section and
      fleet features replay from the memo.
    * ``delta`` — fingerprint matches and every table family's committed
      chunk prefix is intact: the pass folds only the rows from the
      first dirty chunk onward over its previous state.
    * ``full``  — anything else (first run, ``catalog.gen`` bump,
      contract edit, rebuilt history): state starts from None over every
      row.

    A wholly-memoized run whose on-disk report already matches is a
    no-op: 0 bytes written, untouched mtimes (the index refresh rule).
    """
    from sofa_tpu_torch import pool
    from sofa_tpu_torch.archive import index as aindex

    if not aindex.available():
        raise FleetError("fleet analyze needs the columnar index "
                         "(pyarrow) — unavailable here")
    t_total = time.perf_counter()
    commit = aindex.refresh(root, jobs=jobs) if refresh_index \
        else aindex.load_commit(root)
    if commit is None or not aindex.is_current(root, commit):
        raise FleetError("no current archive index under "
                         f"{root!r} — ingest something (or run "
                         "`archive fsck --repair`) first")
    commit = {k: v for k, v in commit.items() if k != "_stats"}

    load_builtin_passes()
    specs = registered()
    enabled = [s for s in specs
               if select is None or s.name in select]
    waves = resolve_schedule(enabled, ambient=())
    wave_of = {s.name: i for i, wave in enumerate(waves) for s in wave}
    fps = {s.name: fingerprint(s) for s in enabled}
    order = [s.name for s in sorted(enabled,
                                    key=lambda s: (s.order, s.seq))]

    memo = _load_state(root)
    cur_sig = _family_sig(root)
    chunk_rows = int((_family_index(root, "catalog") or {})
                     .get("chunk_rows") or aindex.INDEX_CHUNK_ROWS)
    memo_ok = memo is not None \
        and memo.get("catalog_gen") == commit.get("catalog_gen") \
        and int(memo.get("chunk_rows") or 0) == chunk_rows
    bases: Dict[str, Optional[int]] = {}
    for family in APPEND_ONLY_FAMILIES:
        prev = ((memo or {}).get("families") or {}).get(family) or {}
        bases[family] = _delta_base(prev, cur_sig[family], chunk_rows) \
            if memo_ok else None
    memo_passes = (memo or {}).get("passes") or {} if memo_ok else {}
    memo_hit = memo_ok and memo.get("commit_sha") == commit["commit_sha"]

    plan: Dict[str, str] = {}
    for s in enabled:
        prev = memo_passes.get(s.name) or {}
        if prev.get("fingerprint") != fps[s.name]:
            plan[s.name] = "full"
        elif memo_hit:
            plan[s.name] = "memo"
        elif all(bases.get(f) is not None for f in s.reads_frames
                 if f in APPEND_ONLY_FAMILIES):
            plan[s.name] = "delta"
        else:
            plan[s.name] = "full"

    # short-circuit: everything memoized AND the on-disk report already
    # covers this commit with these contracts — touch nothing
    existing = load_report(root)
    if existing is not None \
            and all(m == "memo" for m in plan.values()) \
            and existing.get("commit_sha") == commit["commit_sha"] \
            and existing.get("order") == order \
            and all((existing.get("passes") or {}).get(n, {})
                    .get("fingerprint") == fps[n] for n in order):
        existing["_stats"] = {
            "noop": True, "jobs": 0,
            "wall_s": round(time.perf_counter() - t_total, 6),
            "passes": {n: {"mode": "memo", "wall_s": 0.0} for n in order}}
        return existing

    # shared table cache: one read per (family, base), union columns —
    # passes then select their declared projection
    union_cols: Dict[Tuple[str, int], set] = {}
    for s in enabled:
        if plan[s.name] == "memo":
            continue
        for family in s.reads_frames:
            if family not in APPEND_ONLY_FAMILIES:
                continue
            base = 0 if plan[s.name] == "full" else bases[family]
            key = (family, int(base or 0))
            cols = _pass_columns(s, family)
            union_cols.setdefault(key, set()).update(
                cols or _family_columns()[family])
    cache = {key: _read_window(root, family, base, sorted(cols))
             for (family, base), cols in union_cols.items()
             for key in [(family, base)]}

    jobs_n = pool.resolve_jobs(jobs)
    report_entries: Dict[str, dict] = {}
    stats_passes: Dict[str, dict] = {}
    new_memo_passes: Dict[str, dict] = {}
    buffers: Dict[str, Features] = {}
    completed: List[Features] = []
    spec_of = {s.name: s for s in enabled}

    def run_one(spec: PassSpec) -> None:
        mode = plan[spec.name]
        entry = {"origin": spec.origin, "wave": wave_of[spec.name],
                 "fingerprint": fps[spec.name]}
        t0 = time.perf_counter()
        prev = memo_passes.get(spec.name) or {}
        if mode == "memo":
            buf = Features()
            for fname, fvalue in prev.get("features") or []:
                buf.add(fname, fvalue)
            buffers[spec.name] = buf
            entry.update(status="ok", report=prev.get("report"))
            report_entries[spec.name] = entry
            new_memo_passes[spec.name] = prev
            stats_passes[spec.name] = {
                "mode": mode,
                "wall_s": round(time.perf_counter() - t0, 6)}
            return
        state = None if mode == "full" else prev.get("state")
        ctx = FleetContext(root=root, commit=commit, mode=mode,
                           chunk_rows=chunk_rows)
        tables = {}
        for family in spec.reads_frames:
            if family not in APPEND_ONLY_FAMILIES:
                continue
            base = 0 if mode == "full" else int(bases[family] or 0)
            cols = _pass_columns(spec, family)
            tbl = cache[(family, base)]
            tables[family] = tbl.select(cols) if cols else tbl
            ctx.base[family] = base
        view = _PassView(completed, buffers, spec.name)
        try:
            out = spec.fn(state, tables, ctx, view) or {}
            entry.update(status="ok", report=out.get("report"))
            new_memo_passes[spec.name] = {
                "fingerprint": fps[spec.name],
                "state": out.get("state"),
                "report": out.get("report"),
                "features": [[n, v] for n, v in view.buf._rows],
            }
        except Exception as e:  # noqa: BLE001 — per-pass fault isolation
            print_warning(f"fleet pass {spec.name}: {e}")
            entry.update(status="failed",
                         error=f"{type(e).__name__}: {e}"[:300])
        report_entries[spec.name] = entry
        stats_passes[spec.name] = {
            "mode": mode, "wall_s": round(time.perf_counter() - t0, 6)}

    for wave in waves:
        pool.thread_map(run_one, wave, jobs_n)
        completed = [buffers[n] for n in order if n in buffers]

    features: Dict[str, float] = {}
    for name in order:
        buf = buffers.get(name)
        if buf is not None:
            for fname, fvalue in buf._rows:
                features[fname] = fvalue

    report = {
        "schema": FLEET_REPORT_SCHEMA, "version": FLEET_REPORT_VERSION,
        "commit_sha": commit["commit_sha"],
        "catalog_gen": commit.get("catalog_gen"),
        "runs": commit.get("runs"),
        "ingest_events": commit.get("ingest_events"),
        "features_rows": commit.get("features_rows"),
        "schedule": [[s.name for s in wave] for wave in waves],
        "order": order,
        "passes": report_entries,
        "features": features,
    }
    state_doc = {
        "schema": FLEET_STATE_SCHEMA, "version": FLEET_STATE_VERSION,
        "commit_sha": commit["commit_sha"],
        "catalog_gen": commit.get("catalog_gen"),
        "chunk_rows": chunk_rows,
        "families": cur_sig,
        "passes": new_memo_passes,
    }
    # No wall clock in either doc: both are pure functions of the index
    # commit + the contracts, so a killed-and-resumed analyze converges
    # byte-identical.  Report first, memo LAST: a crash in between (the
    # chaos knob) leaves a fresh report and a stale memo — the re-run
    # folds again and rewrites the same bytes.
    from sofa_tpu_torch.durability import atomic_write

    os.makedirs(fleet_dir(root), exist_ok=True)
    with atomic_write(report_path(root), fsync=True) as f:
        json.dump(report, f, indent=1, sort_keys=True)
    _chaos_tick()
    # the memo is machine-read only and holds a partial per chunk —
    # compact one-shot dumps (the C encoder; json.dump streaming to a
    # file never takes it) keep the per-refresh rewrite cheap at fleet
    # scale: the pretty-printed write dominated the warm wall
    with atomic_write(state_path(root), fsync=True) as f:
        f.write(json.dumps(state_doc, sort_keys=True,
                           separators=(",", ":")))
    report["_stats"] = {
        "noop": False, "jobs": jobs_n,
        "wall_s": round(time.perf_counter() - t_total, 6),
        "passes": stats_passes,
    }
    return report


class _PassView:
    """The features facade handed to one fleet pass: writes land in a
    private buffer, reads see completed earlier-wave passes' buffers in
    canonical order — `--jobs` width cannot reorder anything."""

    def __init__(self, completed: List[Features],
                 buffers: Dict[str, Features], name: str):
        self._completed = list(completed)
        self.buf = Features()
        buffers[name] = self.buf

    def add(self, name: str, value: float) -> None:
        self.buf.add(name, value)

    def get(self, name: str) -> Optional[float]:
        for layer in reversed(self._completed + [self.buf]):
            v = layer.get(name)
            if v is not None:
                return v
        return None


def refresh_after_ingest(root: str, jobs: int = 0) -> Optional[dict]:
    """The tier's post-drain hook (archive/tier.py refresh_tenant):
    refresh the fleet report right after the index commit so
    /v1/<tenant>/fleet reads are always warm — degrading to a warning on
    ANY failure, because fleet state is derived and must never fail the
    write path.  ``SOFA_FLEET_REFRESH=0`` opts a deployment out."""
    from sofa_tpu_torch.archive import index as aindex

    if os.environ.get("SOFA_FLEET_REFRESH", "1") == "0" \
            or not aindex.enabled():
        return None
    try:
        return analyze(root, jobs=jobs, refresh_index=False)
    except Exception as e:  # noqa: BLE001 — derived state: degrade, never fail the drain
        print_warning(f"fleet analyze: refresh failed ({e}) — the "
                      "report stays at its last commit until the next "
                      "refresh; `fleet analyze` rebuilds")
        return None


# ---------------------------------------------------------------------------
# ``fleet`` (the CLI verb).
# ---------------------------------------------------------------------------

def sofa_fleet(cfg, usr_command: str, root: str) -> int:
    """``fleet analyze <root>``: run the fleet passes over an
    archive and print the per-pass table.  Exit 0 on success, 1 when any
    pass failed (the report still commits — fault isolation), 2 on
    usage/substrate errors (no pyarrow, no index, unschedulable)."""
    from sofa_tpu_torch import pool
    from sofa_tpu_torch.telemetry import _table

    if usr_command != "analyze" or not root:
        print_warning("usage: fleet analyze <archive-root>")
        return 2
    if not os.path.isdir(root):
        print_warning(f"fleet: no archive at {root!r}")
        return 2
    try:
        report = analyze(root, jobs=pool.cfg_jobs(cfg))
    except FleetError as e:
        print_warning(str(e))
        return 2
    stats = report.get("_stats") or {}
    print_title(f"SOFA fleet analyze — {len(report['order'])} pass(es), "
                f"commit {str(report['commit_sha'])[:12]}"
                + (" (memoized no-op)" if stats.get("noop") else ""))
    rows = [["pass", "status", "mode", "wall"]]
    failed = 0
    for name in report["order"]:
        entry = (report["passes"] or {}).get(name) or {}
        pstat = (stats.get("passes") or {}).get(name) or {}
        if entry.get("status") != "ok":
            failed += 1
        rows.append([name, entry.get("status", "?"),
                     pstat.get("mode", "?"),
                     f"{pstat.get('wall_s', 0):.3f}s"])
    for line in _table(rows):
        print(line)
    print(f"fleet features: {len(report.get('features') or {})}  "
          f"report: {report_path(root)}  "
          f"total {stats.get('wall_s', 0):.3f}s")
    return 1 if failed else 0
