"""SL010–SL013 — the pass contract rules (analysis + fleet domains).

``sofa_tpu_torch/analysis/registry.py`` makes every analysis pass declare its
contract (frames/columns/features read, features/artifacts produced,
ordering edges) as plain literals on the ``@analysis_pass`` decorator,
and ``sofa_tpu_torch/analysis/fleet.py`` reuses the same machinery for
``@fleet_pass`` cross-run passes over the archive index.  These rules
are what make those declarations *verified* rather than documentation:
each decorated pass body is checked against its own declaration, and the
cross-pass dependency graph is validated from the declarations alone —
statically, before any trace is ever analyzed.

SL010  a pass body may only touch frames, columns, and feature keys it
       declared (undeclared read/write = finding).  Analysis passes are
       checked against the trace schema; fleet passes against the
       pinned index family schemas (their ``reads_columns`` entries are
       ``family.column`` qualified and must exist in archive/index.py's
       column constants)
SL011  a declaration may not claim outputs the body never produces
SL012  the declared graph must schedule: no dependency cycles, no read
       of a feature no registered pass (or analyze's ambient set —
       analysis domain only; the fleet engine injects nothing)
       provides, no ``after`` edge to an unknown pass, and no ``after``
       edge crossing the analysis/fleet domain boundary — the two
       registries never co-schedule
SL013  pass bodies must not call another pass directly — composition
       happens in the scheduler, where fault isolation and the
       meta.passes ledger live

Feature names are fnmatch-style patterns; dynamic feature names
(f-strings) canonicalize with ``*`` replacing each interpolated segment,
and ``by_regex`` arguments canonicalize by collapsing regex metacharacter
runs to ``*``.  The overlap test below is the SAME algebra the runtime
scheduler uses (registry.patterns_overlap — keep them in sync): what
lints clean is exactly what schedules.
"""

from __future__ import annotations

import ast
import re
from fnmatch import fnmatchcase
from typing import Dict, Iterable, List, Optional, Tuple

from sofa_tpu_torch.lint.core import FileContext, Finding, PassDecl, Rule, SEV_ERROR

_FEATURE_WRITES = ("add", "add_info")
_FEATURE_READS = ("get", "by_regex")


def _overlap(a: str, b: str) -> bool:
    """Mirror of registry.patterns_overlap (no import: lint never loads
    the pandas-heavy analysis stack)."""
    return fnmatchcase(a, b) or fnmatchcase(b, a)


def _covered(pattern: str, declared) -> bool:
    return any(_overlap(pattern, d) for d in declared)


def _canon_str(node: ast.expr) -> str:
    """Canonical feature pattern of a name expression: literals verbatim,
    f-strings with ``*`` per interpolation, anything fully dynamic ``*``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return "".join(parts) or "*"
    return "*"


_REGEX_META = re.compile(r"(\\[dwsDWS][*+?]?|\[[^]]*\][*+?]?|\.[*+?]?"
                         r"|[*+?]|\{\d+(,\d*)?\}|\(|\)|\||\^|\$)+")


def _canon_regex(pattern: str) -> str:
    """Collapse regex metacharacter runs to ``*`` and unescape literals:
    ``gpu\\d+_op_time`` -> ``gpu*_op_time``."""
    out = _REGEX_META.sub("*", pattern)
    return out.replace("\\", "")


class _PassIndex:
    """Per-file cache joining FileContext to the project's PassDecls."""

    def __init__(self, ctx: FileContext):
        self.decls: Dict[str, PassDecl] = {
            d.func: d for d in ctx.project.passes
            if d.relpath == ctx.relpath}
        #: function name -> pass name, across the whole linted tree.
        self.all_funcs: Dict[str, str] = {
            d.func: d.name for d in ctx.project.passes}
        #: ids of nodes inside any decorator expression (the declaration's
        #: own literals must not be mistaken for body accesses).
        self.deco_nodes = set()
        self.funcdefs: Dict[str, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in self.decls:
                    self.funcdefs[node.name] = node
                for deco in node.decorator_list:
                    for sub in ast.walk(deco):
                        self.deco_nodes.add(id(sub))


def _index(ctx: FileContext) -> _PassIndex:
    idx = getattr(ctx, "_pass_index", None)
    if idx is None:
        idx = _PassIndex(ctx)
        ctx._pass_index = idx
    return idx


def _enclosing_pass(ctx: FileContext,
                    node: ast.AST) -> "Tuple[PassDecl, ast.AST] | None":
    idx = _index(ctx)
    if not idx.decls or id(node) in idx.deco_nodes:
        return None
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            decl = idx.decls.get(anc.name)
            if decl is not None and idx.funcdefs.get(anc.name) is anc:
                return decl, anc
    return None


def _param_names(funcdef, decl: PassDecl) -> Tuple[str, str]:
    """(frames, features) parameter names of a pass body.  Analysis
    passes are ``fn(frames, cfg, features)``; fleet passes are
    ``fn(state, tables, ctx, features)`` — their "frames" mapping is the
    declared-slice table dict in slot 1."""
    args = [a.arg for a in funcdef.args.args]
    if decl.domain == "fleet":
        frames = args[1] if len(args) > 1 else "tables"
        features = args[3] if len(args) > 3 else "features"
    else:
        frames = args[0] if args else "frames"
        features = args[2] if len(args) > 2 else "features"
    return frames, features


class UndeclaredPassAccess(Rule):
    """SL010 — a registered pass touches only what it declared.  Frame
    lookups (``frames.get("x")`` / ``frames["x"]``) must name declared
    ``reads_frames``; any string literal naming a trace column (analysis)
    or a declared index family's column (fleet, ``family.column``
    qualified) must be in ``reads_columns``; ``features.add/add_info``
    names must match ``provides_features``; ``features.get/by_regex``
    must match ``reads_features`` (or the pass's own provides — reading
    back your own output is composition-free).  :meth:`finish` also
    checks fleet declarations themselves against the pinned family
    schemas: a ``reads_columns`` entry naming an unknown family or a
    column outside its schema is a phantom read."""

    rule_id = "SL010"
    severity = SEV_ERROR
    node_types = (ast.Call, ast.Subscript, ast.Constant)

    def visit(self, ctx: FileContext, node: ast.AST) -> Iterable[Finding]:
        hit = _enclosing_pass(ctx, node)
        if hit is None:
            return
        decl, funcdef = hit
        frames_p, features_p = _param_names(funcdef, decl)
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, str):
                return
            if decl.domain == "fleet":
                qualified = [f"{fam}.{node.value}"
                             for fam in decl.reads_frames
                             if f"{fam}.{node.value}"
                             in ctx.project.index_columns]
                if qualified and not any(q in decl.reads_columns
                                         for q in qualified):
                    yield self.finding(
                        ctx, node,
                        f"fleet pass {decl.name!r} touches index column "
                        f"{node.value!r} of a declared family without a "
                        f"matching reads_columns entry ({qualified[0]!r})")
            elif node.value in ctx.project.columns and \
                    node.value not in decl.reads_columns:
                yield self.finding(
                    ctx, node,
                    f"pass {decl.name!r} touches trace column "
                    f"{node.value!r} it does not declare in reads_columns")
            return
        if isinstance(node, ast.Subscript):
            if isinstance(node.value, ast.Name) \
                    and node.value.id == frames_p \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str) \
                    and node.slice.value not in decl.reads_frames:
                yield self.finding(
                    ctx, node,
                    f"pass {decl.name!r} reads frame "
                    f"{node.slice.value!r} it does not declare in "
                    "reads_frames")
            return
        fn = node.func
        if not isinstance(fn, ast.Attribute) \
                or not isinstance(fn.value, ast.Name):
            return
        recv, attr = fn.value.id, fn.attr
        arg0 = node.args[0] if node.args else None
        if recv == frames_p and attr == "get" and arg0 is not None:
            if isinstance(arg0, ast.Constant) \
                    and isinstance(arg0.value, str) \
                    and arg0.value not in decl.reads_frames:
                yield self.finding(
                    ctx, node,
                    f"pass {decl.name!r} reads frame {arg0.value!r} it "
                    "does not declare in reads_frames")
            return
        if recv != features_p or arg0 is None:
            return
        if attr in _FEATURE_WRITES:
            pat = _canon_str(arg0)
            if not _covered(pat, decl.provides_features):
                yield self.finding(
                    ctx, node,
                    f"pass {decl.name!r} writes feature {pat!r} its "
                    "declaration does not provide — declare it in "
                    "provides_features")
        elif attr in _FEATURE_READS:
            pat = _canon_str(arg0)
            if attr == "by_regex" and isinstance(arg0, ast.Constant) \
                    and isinstance(arg0.value, str):
                pat = _canon_regex(arg0.value)
            allowed = (tuple(decl.reads_features)
                       + tuple(decl.provides_features)
                       + tuple(ctx.project.ambient_features))
            if not _covered(pat, allowed):
                yield self.finding(
                    ctx, node,
                    f"pass {decl.name!r} reads feature {pat!r} it does "
                    "not declare in reads_features — undeclared reads "
                    "hide scheduling dependencies")

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        index_cols = ctx.project.index_columns
        if not index_cols:
            return
        families = {q.split(".", 1)[0] for q in index_cols}
        idx = _index(ctx)
        for _func, decl in sorted(idx.decls.items()):
            if decl.domain != "fleet":
                continue
            for fam in decl.reads_frames:
                if fam not in families:
                    yield Finding(
                        ctx.relpath, decl.line, self.rule_id,
                        f"fleet pass {decl.name!r} declares reads_frames "
                        f"{fam!r} which is not an archive index family "
                        f"({sorted(families)})", self.severity)
            for col in decl.reads_columns:
                fam, _, bare = col.partition(".")
                if not bare or fam not in decl.reads_frames:
                    yield Finding(
                        ctx.relpath, decl.line, self.rule_id,
                        f"fleet pass {decl.name!r} declares reads_columns "
                        f"{col!r} — entries must be 'family.column' with "
                        "the family in reads_frames", self.severity)
                elif col not in index_cols:
                    yield Finding(
                        ctx.relpath, decl.line, self.rule_id,
                        f"fleet pass {decl.name!r} declares reads_columns "
                        f"{col!r} outside the pinned {fam!r} family "
                        "schema — a phantom read the index can never "
                        "serve", self.severity)


class PhantomPassOutput(Rule):
    """SL011 — a declaration may not claim outputs the body never writes:
    every ``provides_features`` pattern needs a matching
    ``features.add/add_info`` and every ``provides_artifacts`` file a
    naming literal.  A body that *forwards* the features object into a
    helper call delegates its writes (the aisi/hsg wrappers); delegated
    contracts are trusted, not flagged."""

    rule_id = "SL011"
    severity = SEV_ERROR
    node_types = ()

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        idx = _index(ctx)
        for func, decl in sorted(idx.decls.items()):
            funcdef = idx.funcdefs.get(func)
            if funcdef is None:
                continue
            frames_p, features_p = _param_names(funcdef, decl)
            writes: List[str] = []
            strings: List[str] = []
            forwarded = False
            for node in ast.walk(funcdef):
                if id(node) in idx.deco_nodes:
                    continue
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    strings.append(node.value)
                if not isinstance(node, ast.Call):
                    continue
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id == features_p:
                        forwarded = True
                fn = node.func
                if isinstance(fn, ast.Attribute) \
                        and isinstance(fn.value, ast.Name) \
                        and fn.value.id == features_p \
                        and fn.attr in _FEATURE_WRITES and node.args:
                    writes.append(_canon_str(node.args[0]))
            if forwarded:
                continue
            for pat in decl.provides_features:
                if not any(_overlap(w, pat) for w in writes):
                    yield Finding(
                        ctx.relpath, decl.line, self.rule_id,
                        f"pass {decl.name!r} declares provides_features "
                        f"{pat!r} but its body never writes a matching "
                        "feature — drop the claim or produce it",
                        self.severity)
            for artifact in decl.provides_artifacts:
                if artifact not in strings:
                    yield Finding(
                        ctx.relpath, decl.line, self.rule_id,
                        f"pass {decl.name!r} declares artifact "
                        f"{artifact!r} but its body never names it — "
                        "drop the claim or write the file",
                        self.severity)


class UnschedulablePassGraph(Rule):
    """SL012 — the declared dependency graph must schedule, verified from
    the declarations alone: every ``reads_features`` pattern needs a
    provider (some registered pass of the same domain, or — analysis
    domain only — analyze's AMBIENT_FEATURES), every ``after`` edge a
    registered target *in the same domain* (the analysis and fleet
    registries never co-schedule, so a cross-domain edge is a contract
    error, not an ordering hint), and each domain's graph must be
    acyclic.  Findings anchor at the declaring decorator."""

    rule_id = "SL012"
    severity = SEV_ERROR
    node_types = ()

    def _graph(self, decls: Tuple[PassDecl, ...]) -> Dict[str, set]:
        by_name = {d.name: d for d in decls}
        deps: Dict[str, set] = {d.name: set() for d in decls}
        for d in decls:
            for dep in d.after:
                if dep in by_name and dep != d.name \
                        and by_name[dep].domain == d.domain:
                    deps[d.name].add(dep)
            for pat in d.reads_features:
                for other in decls:
                    if other.name != d.name \
                            and other.domain == d.domain and \
                            _covered(pat, other.provides_features):
                        deps[d.name].add(other.name)
        return deps

    def _cyclic_names(self, deps: Dict[str, set]) -> set:
        # Kahn peel: whatever cannot be scheduled is on (or behind) a cycle.
        remaining = dict(deps)
        changed = True
        done: set = set()
        while changed:
            changed = False
            for name, d in list(remaining.items()):
                if d <= done:
                    done.add(name)
                    del remaining[name]
                    changed = True
        return set(remaining)

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        mine = [d for d in ctx.project.passes if d.relpath == ctx.relpath]
        if not mine:
            return
        all_decls = tuple(ctx.project.passes)
        domain_of = {d.name: d.domain for d in all_decls}
        deps = self._graph(all_decls)
        cyclic = self._cyclic_names(deps)
        for d in mine:
            for dep in d.after:
                if dep not in domain_of:
                    yield Finding(
                        ctx.relpath, d.line, self.rule_id,
                        f"pass {d.name!r} declares after={dep!r} but no "
                        "registered pass has that name",
                        self.severity)
                elif domain_of[dep] != d.domain:
                    yield Finding(
                        ctx.relpath, d.line, self.rule_id,
                        f"{d.domain} pass {d.name!r} declares "
                        f"after={dep!r}, a {domain_of[dep]} pass — the "
                        "two registries never co-schedule, so a "
                        "cross-domain edge can never order anything",
                        self.severity)
            for pat in d.reads_features:
                if d.domain == "analysis" \
                        and _covered(pat, ctx.project.ambient_features):
                    continue
                if not any(_covered(pat, o.provides_features)
                           for o in all_decls if o.domain == d.domain):
                    yield Finding(
                        ctx.relpath, d.line, self.rule_id,
                        f"pass {d.name!r} reads feature {pat!r} that no "
                        "registered pass provides (and the analyze verb "
                        "does not supply ambiently) — it will never be "
                        "satisfied",
                        self.severity)
            if d.name in cyclic:
                yield Finding(
                    ctx.relpath, d.line, self.rule_id,
                    f"pass {d.name!r} is part of a declared dependency "
                    f"cycle ({sorted(cyclic)}) — the scheduler cannot "
                    "order it",
                    self.severity)


class DirectPassCall(Rule):
    """SL013 — pass bodies must not call another registered pass
    directly: composition happens through the scheduler, which is where
    fault isolation, the telemetry span, and the meta.passes entry live.
    A direct call runs the callee twice, outside its contract."""

    rule_id = "SL013"
    severity = SEV_ERROR
    node_types = (ast.Call,)

    def visit(self, ctx: FileContext, node: ast.Call) -> Iterable[Finding]:
        hit = _enclosing_pass(ctx, node)
        if hit is None:
            return
        decl, _funcdef = hit
        resolved = ctx.resolve_call(node)
        if not resolved:
            return
        leaf = resolved.rsplit(".", 1)[-1]
        target = _index(ctx).all_funcs.get(leaf)
        if target is not None and leaf != decl.func:
            yield self.finding(
                ctx, node,
                f"pass {decl.name!r} calls pass {target!r} "
                f"({leaf}) directly — compose via declared dependencies "
                "(reads_features/after); the scheduler owns execution, "
                "fault isolation, and the meta.passes ledger")


PASS_RULES = (
    UndeclaredPassAccess,
    PhantomPassOutput,
    UnschedulablePassGraph,
    DirectPassCall,
)
