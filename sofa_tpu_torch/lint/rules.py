"""The port's rule set: each rule machine-enforces one runtime contract
the package keeps.  sofa_tpu_torch/docs/STATIC_ANALYSIS.md documents the
rationale of each; keep the two in sync when adding rules.

Rules are heuristic by design — they run on every commit, so a rare false
positive is answered with an inline ``# sofa-lint: disable=RULE`` (with a
justification), never by weakening the rule for the whole tree.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from sofa_tpu_torch.lint.core import (
    FileContext,
    Finding,
    Rule,
    SEV_ERROR,
    SEV_WARN,
)

# ---------------------------------------------------------------------------
# SL001 — every subprocess call is bounded (the deadline contract).
# ---------------------------------------------------------------------------

_SUBPROCESS_FNS = frozenset({
    "subprocess.run", "subprocess.check_output", "subprocess.check_call",
    "subprocess.call",
})


class BoundedSubprocess(Rule):
    """subprocess.run/check_* without ``timeout=``: one wedged external
    tool (perf, scp, getcap, docker) hangs the whole pipeline.  The only
    sanctioned unbounded path is collectors/base.py, whose deadline
    helpers (_run_bounded / _escalate_kill) own the escalation ladder."""

    rule_id = "SL001"
    severity = SEV_ERROR
    node_types = (ast.Call,)
    exempt_files = ("collectors/base.py",)

    def visit(self, ctx: FileContext, node: ast.Call) -> Iterable[Finding]:
        if ctx.resolve_call(node) not in _SUBPROCESS_FNS:
            return
        for kw in node.keywords:
            if kw.arg == "timeout" or kw.arg is None:  # **kwargs may carry it
                return
        yield self.finding(
            ctx, node,
            "subprocess call without timeout= — a wedged tool hangs the "
            "pipeline; bound it (or route through collectors/base.py's "
            "deadline helpers)")


# ---------------------------------------------------------------------------
# SL002 — no silent broad excepts (the telemetry-counter contract).
# ---------------------------------------------------------------------------

_PRINT_FUNCS = frozenset({
    "print_error", "print_warning", "print_info", "print_hint",
    "print_progress", "print_title", "print_main_progress",
})
# Attribute calls that count as routing regardless of receiver: the printing
# helpers, telemetry ledger methods, and stdlib-logging spellings.
_ROUTE_ATTRS = _PRINT_FUNCS | frozenset({
    "console", "console_event", "count", "source_event", "collector_event",
    "unavailable", "warning", "error", "exception", "log",
})
_BROAD_NAMES = frozenset({"Exception", "BaseException"})


class SilentBroadExcept(Rule):
    """``except:`` / ``except Exception`` that neither re-raises nor routes
    through printing/telemetry swallows the evidence the run manifest
    exists to keep.  Degrade loudly (print_warning counts into the noise
    counters even when display-filtered) or re-raise."""

    rule_id = "SL002"
    severity = SEV_ERROR
    node_types = (ast.ExceptHandler,)
    # printing.py IS the routing layer; its internal guards cannot route
    # through themselves.
    exempt_files = ("printing.py",)

    def _is_broad(self, ctx: FileContext, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names = t.elts if isinstance(t, ast.Tuple) else [t]
        for n in names:
            if isinstance(n, ast.Name) and n.id in _BROAD_NAMES:
                return True
        return False

    def _routed(self, ctx: FileContext, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(ast.Module(body=handler.body,
                                        type_ignores=[])):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Name) and fn.id in _PRINT_FUNCS:
                    return True
                if isinstance(fn, ast.Attribute) and fn.attr in _ROUTE_ATTRS:
                    return True
        return False

    def visit(self, ctx: FileContext,
              node: ast.ExceptHandler) -> Iterable[Finding]:
        if self._is_broad(ctx, node) and not self._routed(ctx, node):
            what = "bare except" if node.type is None else "broad except"
            yield self.finding(
                ctx, node,
                f"{what} neither re-raises nor routes through printing/"
                "telemetry — the failure vanishes from the run manifest; "
                "print_warning it, count it, or re-raise")


# ---------------------------------------------------------------------------
# SL003 — deadline/timebase math uses a monotonic clock (the supervisor
# and epilogue contract; the timebase-anchored capture clock).
# ---------------------------------------------------------------------------

_DEADLINE_WORDS = re.compile(
    r"deadline|timeout|backoff|retry|budget|stall|expire", re.IGNORECASE)


class WallClockInDeadlineMath(Rule):
    """``time.time()`` compared against (or added to) a deadline: an NTP
    step or leap smear spoofs stalled-collector flags and fires epilogue
    kills early/late.  Use time.monotonic() for intervals; wall clock is
    only for the anchored capture timestamps the timebase collector
    correlates (those are plain assignments and do not trip this rule)."""

    rule_id = "SL003"
    severity = SEV_ERROR
    node_types = (ast.Call,)

    def visit(self, ctx: FileContext, node: ast.Call) -> Iterable[Finding]:
        if ctx.resolve_call(node) != "time.time":
            return
        in_compare = any(isinstance(a, ast.Compare)
                         for a in ctx.ancestors(node))
        in_binop = any(isinstance(a, ast.BinOp)
                       and isinstance(a.op, (ast.Add, ast.Sub))
                       for a in ctx.ancestors(node))
        if in_compare or (in_binop and
                          _DEADLINE_WORDS.search(ctx.stmt_source(node))):
            yield self.finding(
                ctx, node,
                "time.time() in deadline/interval arithmetic — wall-clock "
                "steps (NTP, leap smear) spoof the comparison; use "
                "time.monotonic() or the anchored capture clock")


# ---------------------------------------------------------------------------
# SL004 — event-row dicts stay inside trace.COLUMNS (the unified schema).
# ---------------------------------------------------------------------------

class SchemaDriftColumn(Rule):
    """A parser emitting a row key outside trace.COLUMNS silently loses the
    column at make_frame() — schema drift that only surfaces as a board
    page with missing data.  Detection: in the ingest layer, a dict literal
    whose string keys are mostly known schema columns AND include an anchor
    column every event row carries (timestamp/duration/name/event) is an
    event row; any unknown key in it is drift.  Internal helper dicts that
    merely share field names (per-metadata caches) carry no anchor and are
    skipped."""

    rule_id = "SL004"
    severity = SEV_ERROR
    node_types = (ast.Dict,)
    _ANCHORS = frozenset({"timestamp", "duration", "name", "event"})

    def applies(self, ctx: FileContext) -> bool:
        return ("/ingest/" in f"/{ctx.relpath}"
                or ctx.relpath.endswith("preprocess.py")) and \
            bool(ctx.project.columns) and super().applies(ctx)

    def visit(self, ctx: FileContext, node: ast.Dict) -> Iterable[Finding]:
        keys: List[str] = []
        for k in node.keys:
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return  # computed/unpacked keys: not a literal event row
            keys.append(k.value)
        known = [k for k in keys if k in ctx.project.columns]
        if len(keys) < 3 or len(known) < max(2, len(keys) // 2) \
                or not (set(keys) & self._ANCHORS):
            return
        for k, knode in zip(keys, node.keys):
            if k not in ctx.project.columns:
                yield Finding(
                    ctx.relpath, knode.lineno, self.rule_id,
                    f"event-row key {k!r} is not in trace.COLUMNS — "
                    "make_frame() drops unknown keys (schema drift); add "
                    "the column to trace.py or fix the name",
                    self.severity)


# ---------------------------------------------------------------------------
# SL005 — every collector declares its lifecycle surface (the manifest
# health-ledger contract).
# ---------------------------------------------------------------------------

_COLLECTOR_BASES = frozenset({"Collector", "ProcessCollector"})
_PARTICIPATION_HOOKS = ("start", "command_prefix", "child_env")


class CollectorLifecycleSurface(Rule):
    """A collector without ``outputs()`` is invisible to the bytes-captured
    ledger and the supervisor's stall detection; one without any
    participation hook (start / command_prefix / child_env) can never
    collect.  Both are contract holes the manifest cannot see."""

    rule_id = "SL005"
    severity = SEV_ERROR
    node_types = (ast.ClassDef,)
    exempt_files = ("collectors/base.py",)

    def applies(self, ctx: FileContext) -> bool:
        return "/collectors/" in f"/{ctx.relpath}" and super().applies(ctx)

    def visit(self, ctx: FileContext, node: ast.ClassDef) -> Iterable[Finding]:
        base_names = set()
        for b in node.bases:
            if isinstance(b, ast.Name):
                base_names.add(b.id)
            elif isinstance(b, ast.Attribute):
                base_names.add(b.attr)
        if not (base_names & _COLLECTOR_BASES):
            return
        methods = {n.name for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if "outputs" not in methods:
            yield self.finding(
                ctx, node,
                f"collector {node.name} does not define outputs() — its "
                "bytes-captured ledger entry and output-stall supervision "
                "are blind")
        if not (methods & set(_PARTICIPATION_HOOKS)):
            yield self.finding(
                ctx, node,
                f"collector {node.name} defines none of "
                f"{'/'.join(_PARTICIPATION_HOOKS)} — it can never collect; "
                "add a lifecycle hook or drop the class")


# ---------------------------------------------------------------------------
# SL006 — no module-global writes from pool-driven worker code (the
# --jobs fan-out contract).
# ---------------------------------------------------------------------------

_WORKER_FILES = ("ingest/", "preprocess.py", "trace.py", "pool.py")


class WorkerGlobalWrite(Rule):
    """Ingest parsers and frame helpers run on pool.py's thread/process
    pools; a ``global`` write from one is a data race on threads and a
    silent no-op across a process boundary.  Pass state explicitly (the
    task table does) or guard with a lock."""

    rule_id = "SL006"
    severity = SEV_WARN
    node_types = (ast.Global,)

    def applies(self, ctx: FileContext) -> bool:
        return any(
            (p.endswith("/") and f"/{p}" in f"/{ctx.relpath}")
            or ctx.relpath == p or ctx.relpath.endswith("/" + p)
            for p in _WORKER_FILES) and super().applies(ctx)

    def visit(self, ctx: FileContext, node: ast.Global) -> Iterable[Finding]:
        if not any(isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for a in ctx.ancestors(node)):
            return
        yield self.finding(
            ctx, node,
            f"module-level state ({', '.join(node.names)}) written from "
            "pool-driven worker code — races on the thread pool, silently "
            "diverges across the process pool; pass it explicitly or lock")


# ---------------------------------------------------------------------------
# SL007 — raw logdir artifacts flow through the ingest cache/quarantine
# path (the cache and corrupt-input contract).
# ---------------------------------------------------------------------------

# The raw collector files ingest parses (record.RAW_FILES' parsed half:
# the gpumon sampler's text and its allocation-site snapshots are the
# card's raw files here), and the Kineto capture under kineto/.
_RAW_ARTIFACTS = frozenset({
    "perf.data", "perf.script", "kallsyms", "sofa.pcap", "strace.txt",
    "pystacks.txt", "mpstat.txt", "vmstat.txt", "diskstat.txt",
    "netstat.txt", "cpuinfo.txt", "gpumon.txt", "blktrace.txt",
    "timebase.txt", "memprof.pb.gz",
})
_RAW_DIR = "kineto"
# Layers allowed to touch raw bytes: producers (collectors, record, api),
# the ingest/preprocess pipeline itself, and the live dashboard (top tails
# files mid-recording — there is nothing cached to serve yet).
_RAW_ALLOWED = ("ingest/", "collectors/", "record.py", "preprocess.py",
                "api.py", "top.py", "telemetry.py", "faults.py",
                # the live tailer IS an ingest layer: it reads raw byte
                # ranges and commits them into the chunk cache
                "live.py")


class RawArtifactBypass(Rule):
    """Opening a raw collector file outside the ingest layer bypasses the
    content-keyed cache (reparsing on every run) AND the quarantine path —
    corrupt bytes preprocess already moved aside would be read back."""

    rule_id = "SL007"
    severity = SEV_WARN
    node_types = (ast.Call,)
    exempt_files = _RAW_ALLOWED

    def visit(self, ctx: FileContext, node: ast.Call) -> Iterable[Finding]:
        if ctx.resolve_call(node) not in ("open", "io.open", "gzip.open"):
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                    and (sub.value in _RAW_ARTIFACTS
                         or sub.value == _RAW_DIR
                         or sub.value.startswith(_RAW_DIR + "/")):
                yield self.finding(
                    ctx, node,
                    f"raw artifact {sub.value!r} opened outside the ingest "
                    "layer — bypasses the content-keyed cache and the "
                    "quarantine path (sofa_tpu_torch/ingest/cache.py)")
                return


# ---------------------------------------------------------------------------
# SL008 — process kills go through the escalation ladder (the
# TERM->KILL->abandon contract).
# ---------------------------------------------------------------------------

_KILL_ALLOWED = ("record.py", "collectors/base.py", "faults.py")


class DirectKill(Rule):
    """A direct os.kill/os.killpg/proc.kill() skips _signal_tree's
    group-signal fallback and the TERM->KILL->abandon escalation — child
    helpers survive as orphans and the manifest never records the kill.
    Route through record._signal_tree or the base-collector helpers."""

    rule_id = "SL008"
    severity = SEV_ERROR
    node_types = (ast.Call,)
    exempt_files = _KILL_ALLOWED

    def visit(self, ctx: FileContext, node: ast.Call) -> Iterable[Finding]:
        resolved = ctx.resolve_call(node)
        if resolved in ("os.kill", "os.killpg"):
            yield self.finding(
                ctx, node,
                f"direct {resolved}() bypasses _signal_tree — no group "
                "fallback, no TERM->KILL escalation, nothing in the "
                "manifest; use record._signal_tree or the collector kill "
                "helpers")
            return
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "kill" \
                and not node.args and not node.keywords:
            yield self.finding(
                ctx, node,
                ".kill() called directly — use Collector.run_kill/"
                "_escalate_kill (TERM->KILL->abandon, manifest-recorded) "
                "instead of an unescalated SIGKILL")


# ---------------------------------------------------------------------------
# SL009 — derived-artifact writes are atomic (the durability contract).
# ---------------------------------------------------------------------------

# Modules that produce derived logdir artifacts: every open()-for-write in
# them must route through durability.atomic_write/atomic_replace (tmp +
# fsync-optional + rename), so a crash — or a board request racing the
# writer — can never observe a torn derived file.  Producers of RAW files
# (collectors/, record.py, api.py) are out of scope: raw streams are
# append-by-nature and their integrity is fsck's digest ledger's problem.
_DERIVED_WRITER_FILES = (
    "trace.py", "telemetry.py", "tiles.py", "preprocess.py", "analyze.py",
    "ingest/cache.py", "ingest/pcap.py", "export_folded.py",
    "export_perfetto.py", "export_static.py", "analysis/", "ml/",
    "durability.py", "archive/", "whatif/", "live.py",
    # the chunked columnar frame store: chunk files + frame_index.json
    # are derived artifacts, every byte atomic (docs/FRAMES.md)
    "frames.py",
)

_OPEN_FNS = frozenset({"open", "io.open", "gzip.open", "bz2.open",
                       "lzma.open"})
_WRITE_MODES = ("w", "a", "x")


class NonAtomicDerivedWrite(Rule):
    """A derived artifact written with a bare ``open(..., 'w')`` can be
    observed torn — by the viz server, by a concurrent verb, or by the
    next run after a crash.  Route it through durability.atomic_write
    (or atomic_replace for writers that need their own opener); the
    helper's tmp+rename is what `sofa resume`'s replay correctness and
    fsck's corrupt/orphaned verdicts are built on."""

    rule_id = "SL009"
    severity = SEV_ERROR
    node_types = (ast.Call,)
    # durability.py IS the helper: its internal tmp write cannot route
    # through itself.
    exempt_files = ("durability.py",)

    def applies(self, ctx: FileContext) -> bool:
        return any(
            (p.endswith("/") and f"/{p}" in f"/{ctx.relpath}")
            or ctx.relpath == p or ctx.relpath.endswith("/" + p)
            for p in _DERIVED_WRITER_FILES) and super().applies(ctx)

    def _mode_of(self, node: ast.Call) -> "str | None":
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            return node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
        return None

    def visit(self, ctx: FileContext, node: ast.Call) -> Iterable[Finding]:
        if ctx.resolve_call(node) not in _OPEN_FNS:
            return
        mode = self._mode_of(node)
        if mode is None or not any(m in mode for m in _WRITE_MODES):
            return
        yield self.finding(
            ctx, node,
            f"derived artifact opened with mode {mode!r} outside the "
            "atomic write helper — a crash or concurrent reader sees a "
            "torn file; use durability.atomic_write (atomic_replace for "
            "stream writers)")


from sofa_tpu_torch.lint.artifact_rules import (  # noqa: E402 — SL014-SL018:
    ARTIFACT_RULES,                     # artifact-lifecycle flow analysis
)
from sofa_tpu_torch.lint.concurrency_rules import (  # noqa: E402 — SL019-SL023:
    CONCURRENCY_RULES,                  # concurrency & commit ordering
)
from sofa_tpu_torch.lint.pass_rules import (  # noqa: E402 — SL010-SL013 live in
    PASS_RULES,                         # their own module; one rule set
)
from sofa_tpu_torch.lint.protocol_rules import (  # noqa: E402 — SL024-SL028:
    PROTOCOL_RULES,                     # client<->server protocol closure
)

ALL_RULES = (
    BoundedSubprocess,
    SilentBroadExcept,
    WallClockInDeadlineMath,
    SchemaDriftColumn,
    CollectorLifecycleSurface,
    WorkerGlobalWrite,
    RawArtifactBypass,
    DirectKill,
    NonAtomicDerivedWrite,
) + PASS_RULES + ARTIFACT_RULES + CONCURRENCY_RULES + PROTOCOL_RULES


def default_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULES]
