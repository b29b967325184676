"""SL024–SL028 — client↔server protocol-contract flow analysis.

The fleet tier's contract — routes, HTTP statuses, typed ``{"error":
...}`` refusal bodies, Retry-After discipline, client retry/fatal
dispatch sets, fault-kind grammars, and the ``SOFA_*`` environment
knobs — is declared once, in ``sofa_tpu_torch/archive/protocol.py``,
which both sides import.  This module extracts the whole protocol graph
statically (the artifact_rules.py playbook applied to the wire surface)
and enforces closure against that vocabulary:

SL024  route/status closure: a handler-emitted status STATUS_ERRORS
       does not declare; a client/board route no ROUTES entry shapes;
       a declared route no handler dispatches; a declared status nobody
       emits or handles; an error string nobody ever attaches
SL025  refusal discipline: RETRY_AFTER_STATUSES sends must attach
       Retry-After, NO_RETRY_AFTER_STATUSES (deadline 504) must NOT,
       every >=400 refusal carries a typed error body drawn from the
       shared vocabulary, and no raw ``send_response`` bypasses the
       typed helpers for a retryable status
SL026  env-knob registry: every SOFA_* token in the package has a row
       in the package's docs/OBSERVABILITY.md knob registry; a documented
       knob referenced nowhere (the package, its tests
       ``tests/test_torch_*.py``, ``chip_smoke.py``) is dead
SL027  fault-kind closure: every faults.py grammar kind has a consume
       site and a chaos/test reference; a consumed kind outside the
       grammar is a phantom the injection plan can never trigger
SL028  client retry-set soundness: the client's extracted dispatch
       sets match the declared CLIENT_* constants, every status the
       server marks retryable (Retry-After) is client-retryable, and
       fatal-error overrides stay inside FATAL_ERRORS

The graph activates only when the linted file set carries a
vocabulary module (a module-level ``STATUS_ERRORS`` dict) — fixture
trees and single-file lints opt in per rule by providing exactly the
companions a rule needs (the package's board/ and docs/OBSERVABILITY.md,
its tools/ and the repo's tests/test_torch_*.py and chip_smoke.py as
reference text), mirroring the artifact graph's discipline.  The
companions are the port's own, never the JAX package's docs/, tools/,
tests/ or bench.py beside it.
Extraction is purely syntactic: the checked code is never imported.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from sofa_tpu_torch.lint.core import FileContext, Finding, Rule, SEV_ERROR

#: A SOFA_* env-knob token: hard word boundaries on both sides so the
#: ``"SOFA_TPU_" + name`` template-prefix idiom and prose like
#: ``SOFA_Config`` never read as knobs.
_KNOB_RE = re.compile(r"(?<![A-Za-z0-9_])SOFA_[A-Z0-9_]*[A-Z0-9]"
                      r"(?![A-Za-z0-9_])")
#: A docs knob-registry row: ``| `SOFA_<NAME>` | ... |``.
_DOCS_KNOB_RE = re.compile(r"^\|\s*`(SOFA_[A-Z0-9_]+)`")
#: Characters a /v1/ path literal may contain — spaces/backticks reject
#: docstrings and prose that merely mention a route.
_PATH_OK_RE = re.compile(r"^[A-Za-z0-9_<>{}.:/?=&,-]*$")
#: A /v1/ path literal in a board page (double-quoted JS string); the
#: charset rejects display labels like ``"/v1/query ("``.
_BOARD_V1_RE = re.compile(r'"(/v1/[A-Za-z0-9_\-./<>]*(?:\?[^"]*)?)"')
#: The continuation literal after an open ``"/v1/" +`` prefix compose.
_BOARD_CONT_RE = re.compile(r'"(/[A-Za-z0-9_\-./?=&]*(?:\?[^"]*)?)"')
#: A short route-segment token a server dispatch compare uses.
_SEGMENT_RE = re.compile(r"^[a-z0-9_]{1,40}$")

#: Vocabulary constants build_protocol_graph reads from the vocab file.
_DECL_TUPLES = ("RETRY_AFTER_STATUSES", "NO_RETRY_AFTER_STATUSES",
                "CLIENT_RETRY_STATUSES", "CLIENT_FATAL_STATUSES",
                "CLIENT_RESUME_STATUSES")


@dataclass(frozen=True)
class Emission:
    """One typed-helper response site (``_json``/``_refuse``)."""

    relpath: str
    line: int
    status: int
    attach: bool          # Retry-After attached
    body_known: bool      # the doc arg resolved to a dict literal
    has_error: bool       # ... with an "error" key
    error: "str | None"   # ... whose value resolved to this string
    kind: str             # "json" | "refuse"


@dataclass(frozen=True)
class DispatchSite:
    """One client status-set compare (``e.code in (...)``)."""

    relpath: str
    line: int
    klass: str            # "retry" | "fatal" | "resume"
    statuses: tuple


@dataclass(frozen=True)
class ErrorOverride:
    """A client ``status == N and doc.get("error") == X`` dispatch."""

    relpath: str
    line: int
    klass: str
    status: "int | None"
    error: "str | None"


@dataclass
class ProtocolGraph:
    """The cross-file protocol facts SL024–SL028 (and the ``sofa
    protocol`` inventory verb) consult.  ``ok`` is False when the
    linted set carries no vocabulary module — every protocol rule is
    then inert."""

    ok: bool = False
    vocab_relpath: str = ""
    status_errors: Dict[int, tuple] = field(default_factory=dict)
    status_lines: Dict[int, int] = field(default_factory=dict)
    error_lines: Dict[str, int] = field(default_factory=dict)
    retry_after_statuses: tuple = ()
    no_retry_after_statuses: tuple = ()
    client_retry_statuses_decl: tuple = ()
    client_fatal_statuses_decl: tuple = ()
    client_resume_statuses_decl: tuple = ()
    client_retry_floor_decl: "int | None" = None
    fatal_errors_decl: tuple = ()
    decl_lines: Dict[str, int] = field(default_factory=dict)
    routes: tuple = ()                   # (method, path, line)
    emissions: tuple = ()                # Emission
    raw_sends: tuple = ()                # (relpath, line, status)
    client_routes: tuple = ()            # (relpath, line, normalized)
    board_routes: tuple = ()             # (relpath, line, normalized)
    server_files: frozenset = frozenset()
    server_tokens: frozenset = frozenset()
    retry_sites: tuple = ()              # DispatchSite klass=retry
    fatal_sites: tuple = ()              # DispatchSite klass=fatal
    resume_sites: tuple = ()             # DispatchSite klass=resume
    floor_sites: tuple = ()              # (relpath, line, floor)
    error_overrides: tuple = ()          # ErrorOverride
    error_uses: Dict[str, tuple] = field(default_factory=dict)
    knob_reads: tuple = ()               # (relpath, line, token)
    docs_knobs: "Dict[str, int] | None" = None
    docs_relpath: str = ""
    liveness_text: str = ""
    ref_text: str = ""
    ref_text_present: bool = False
    kinds: Dict[str, tuple] = field(default_factory=dict)
    grammar_relpath: str = ""
    kind_consumes: tuple = ()            # (relpath, line, kind)

    # -- closure helpers (shared with `sofa protocol`) ---------------------
    def client_statuses(self) -> frozenset:
        out = set()
        for site in self.retry_sites + self.fatal_sites + \
                self.resume_sites:
            out.update(site.statuses)
        out.update(ov.status for ov in self.error_overrides
                   if ov.status is not None)
        return frozenset(out)

    def client_retryable(self, status: int) -> bool:
        if any(status in s.statuses for s in self.retry_sites):
            return True
        return any(status >= fl for _r, _l, fl in self.floor_sites)

    def route_match(self, path: str) -> bool:
        """True when a normalized client/board path shapes onto a
        declared route (placeholder segments match anything)."""
        segs = _route_segments(path)
        if segs is None:
            return True
        for _method, rpath, _line in self.routes:
            rsegs = _route_segments(rpath)
            if rsegs is None or len(rsegs) != len(segs):
                continue
            if all(r.startswith("<") or r == s
                   for r, s in zip(rsegs, segs)):
                return True
        return not self.routes


def _route_segments(path: str) -> "List[str] | None":
    """Path segments after the /v1/ head, or None for a bare prefix."""
    if "/v1/" in path:
        path = path[path.index("/v1/"):]
    segs = [s for s in path.split("?", 1)[0].split("/") if s]
    if segs[:1] == ["v1"]:
        segs = segs[1:]
    return segs or None


def _normalize_route(s: str) -> "str | None":
    """A /v1/ path literal normalized for shape matching (``<>`` marks
    interpolated segments), or None when the string is prose/non-route."""
    if "/v1/" not in s or not _PATH_OK_RE.match(s):
        return None
    segs = _route_segments(s)
    if segs is None:
        return None
    return "/v1/" + "/".join(
        "<>" if ("<" in seg or "{" in seg) else seg for seg in segs)


# ---------------------------------------------------------------------------
# Per-file extraction.
# ---------------------------------------------------------------------------

class _ProtoFacts:
    """Everything one parse of one .py file contributes to the graph."""

    def __init__(self, path: str, relpath: str):
        self.relpath = relpath
        self.src = ""
        self.emissions: List[Emission] = []
        self.raw_sends: List[tuple] = []
        self.client_routes: List[tuple] = []
        self.server_tokens: set = set()
        self.is_server = False
        self.retry_sites: List[DispatchSite] = []
        self.fatal_sites: List[DispatchSite] = []
        self.resume_sites: List[DispatchSite] = []
        self.floor_sites: List[tuple] = []
        self.error_overrides: List[ErrorOverride] = []
        self.error_uses: List[tuple] = []     # (error, line)
        self.knob_reads: List[tuple] = []     # (line, token)
        self.kind_tables: Dict[str, List[tuple]] = {}
        self.kind_consumes: List[tuple] = []  # (line, kind, base name)
        self.fault_tainted: set = set()       # names assigned from faults.*
        self.imports_of: set = set()          # module stems this imports
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                self.src = f.read()
            self.tree = ast.parse(self.src, filename=path)
        except (OSError, SyntaxError, ValueError):
            self.tree = None
            return
        self._imports()
        self._module_consts()
        self._scopes()
        self._knobs()
        self._taint()

    def _imports(self):
        self.import_alias: Dict[str, str] = {}
        self.from_import: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_alias[a.asname or a.name.split(".")[0]] = \
                        a.name
                    self.imports_of.add(a.name.rsplit(".", 1)[-1])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_import[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
                    self.imports_of.add(a.name)
                self.imports_of.add(node.module.rsplit(".", 1)[-1])

    def _module_consts(self):
        self.str_consts: Dict[str, str] = {}
        self.int_consts: Dict[str, int] = {}
        self.tuple_consts: Dict[str, tuple] = {}
        self._tuple_nodes: Dict[str, List[ast.expr]] = {}
        for node in self.tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            v = node.value
            if isinstance(v, ast.Constant):
                if isinstance(v.value, str):
                    self.str_consts[tgt.id] = v.value
                elif isinstance(v.value, int) and \
                        not isinstance(v.value, bool):
                    self.int_consts[tgt.id] = v.value
            elif isinstance(v, (ast.Tuple, ast.List, ast.BinOp)):
                elts = self._tuple_elts(v)
                if elts is None:
                    continue
                self._tuple_nodes[tgt.id] = elts
                vals = tuple(e.value for e in elts
                             if isinstance(e, ast.Constant))
                if len(vals) == len(elts):
                    self.tuple_consts[tgt.id] = vals
                if tgt.id == "KINDS" or tgt.id.endswith("_KINDS"):
                    self.kind_tables[tgt.id] = [
                        (e.value, e.lineno) for e in elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]

    def _tuple_elts(self, v) -> "List[ast.expr] | None":
        """The element nodes of a tuple literal, or of a ``+`` chain of
        tuple literals and earlier module tuples (``KINDS = (...) +
        TIER_KINDS + STREAM_KINDS``); None for anything else."""
        if isinstance(v, (ast.Tuple, ast.List)):
            return list(v.elts)
        if isinstance(v, ast.Name):
            return self._tuple_nodes.get(v.id)
        if isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add):
            left, right = self._tuple_elts(v.left), self._tuple_elts(v.right)
            if left is not None and right is not None:
                return left + right
        return None

    def _scopes(self):
        """Function-scope single-target assigns (name -> value expr) so
        a doc built locally and passed by name still resolves."""
        self.scope_assigns: Dict[tuple, ast.expr] = {}
        self.func_of: Dict[int, str] = {}

        def walk(node, func):
            for child in ast.iter_child_nodes(node):
                nf = func
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    nf = f"{func}.{child.name}" if func else child.name
                if isinstance(child, ast.Assign) and \
                        len(child.targets) == 1 and \
                        isinstance(child.targets[0], ast.Name):
                    key = (func, child.targets[0].id)
                    self.scope_assigns.setdefault(key, child.value)
                self.func_of[id(child)] = nf if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
                walk(child, nf)

        walk(self.tree, "")

    def _knobs(self):
        seen = set()
        for m in _KNOB_RE.finditer(self.src):
            tok = m.group(0)
            if tok in seen:
                continue
            seen.add(tok)
            self.knob_reads.append(
                (self.src.count("\n", 0, m.start()) + 1, tok))

    def _taint(self):
        """Names assigned from a call into the faults module — only
        these carry grammar kinds in consumer files (an _IngestTask's
        ``.kind`` is a different namespace entirely)."""
        aliases = {n for n, mod in self.import_alias.items()
                   if mod.rsplit(".", 1)[-1] == "faults"}
        aliases |= {n for n, origin in self.from_import.items()
                    if origin.rsplit(".", 1)[-1] == "faults"}
        fns = {n for n, origin in self.from_import.items()
               if ".faults." in "." + origin}
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            fn = node.value.func
            hit = (isinstance(fn, ast.Attribute)
                   and isinstance(fn.value, ast.Name)
                   and fn.value.id in aliases) or \
                  (isinstance(fn, ast.Name) and fn.id in fns)
            if hit:
                self.fault_tainted.add(node.targets[0].id)

    # -- resolution --------------------------------------------------------
    def _int_of(self, node, cross_int) -> "int | None":
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, int) and \
                not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.int_consts:
                return self.int_consts[node.id]
            origin = self.from_import.get(node.id)
            if origin:
                mod, _, attr = origin.rpartition(".")
                return cross_int.get((mod.rpartition(".")[-1], attr))
        return None

    def _str_of(self, node, cross_str) -> "str | None":
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.str_consts:
                return self.str_consts[node.id]
            origin = self.from_import.get(node.id)
            if origin:
                mod, _, attr = origin.rpartition(".")
                return cross_str.get((mod.rpartition(".")[-1], attr))
        return None

    def _tuple_of(self, node, cross_int, cross_tuple) -> "tuple | None":
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for e in node.elts:
                v = self._int_of(e, cross_int)
                if v is None:
                    return None
                out.append(v)
            return tuple(out)
        if isinstance(node, ast.Name):
            if node.id in self.tuple_consts:
                return self.tuple_consts[node.id]
            origin = self.from_import.get(node.id)
            if origin:
                mod, _, attr = origin.rpartition(".")
                return cross_tuple.get((mod.rpartition(".")[-1], attr))
        return None

    def _doc_info(self, node, func, cross_str):
        """(body_known, has_error, resolved error string) for a
        response-doc argument; names resolve through enclosing-scope
        assignments.  Spread entries (``**doc``) are skipped — the
        literal keys decide."""
        d = node if isinstance(node, ast.Dict) else None
        if d is None and isinstance(node, ast.Name):
            scope, hit = func, None
            while hit is None:
                hit = self.scope_assigns.get((scope, node.id))
                if not scope:
                    break
                scope = scope.rpartition(".")[0]
            if isinstance(hit, ast.Dict):
                d = hit
        if d is None:
            return False, False, None
        for k, v in zip(d.keys, d.values):
            if isinstance(k, ast.Constant) and k.value == "error":
                return True, True, self._str_of(v, cross_str)
        return True, False, None

    def _refuse_default_attach(self) -> bool:
        """Whether this file's ``_refuse`` helper attaches Retry-After
        when the call site does not say otherwise."""
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.FunctionDef) or \
                    node.name != "_refuse":
                continue
            args = node.args.args
            defaults = node.args.defaults
            offset = len(args) - len(defaults)
            for i, a in enumerate(args):
                if a.arg == "retry_after" and i >= offset:
                    d = defaults[i - offset]
                    return not (isinstance(d, ast.Constant)
                                and d.value is None)
            for a, d in zip(node.args.kwonlyargs, node.args.kw_defaults):
                if a.arg == "retry_after" and d is not None:
                    return not (isinstance(d, ast.Constant)
                                and d.value is None)
        return False

    # -- the walk ----------------------------------------------------------
    def harvest(self, cross_str, cross_int, cross_tuple):
        if self.tree is None:
            return
        refuse_attach = self._refuse_default_attach()
        route_seen: set = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                s = node.value
                if s == "v1" or s.startswith("/v1/"):
                    self.is_server = True
                if _SEGMENT_RE.match(s):
                    self.server_tokens.add(s)
                norm = _normalize_route(s)
                if norm is not None:
                    for seg in norm.split("/"):
                        if _SEGMENT_RE.match(seg):
                            self.server_tokens.add(seg)
                    if norm not in route_seen:
                        route_seen.add(norm)
                        self.client_routes.append((node.lineno, norm))
                continue
            if isinstance(node, ast.JoinedStr):
                parts = []
                for v in node.values:
                    if isinstance(v, ast.Constant):
                        parts.append(str(v.value))
                    else:
                        parts.append("<>")
                norm = _normalize_route("".join(parts))
                if norm is not None and norm not in route_seen:
                    route_seen.add(norm)
                    self.client_routes.append((node.lineno, norm))
                continue
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == "error":
                        err = self._str_of(v, cross_str)
                        if err is not None:
                            self.error_uses.append((err, k.lineno))
                continue
            if isinstance(node, ast.Compare):
                self._compare(node, cross_str, cross_int, cross_tuple)
                continue
            if isinstance(node, ast.If):
                self._dispatch_if(node, cross_str, cross_int, cross_tuple)
                continue
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            tail = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            func = self.func_of.get(id(node), "")
            if tail == "send_response" and node.args:
                status = self._int_of(node.args[0], cross_int)
                if status is not None:
                    self.raw_sends.append((node.lineno, status))
            elif tail == "_json" and len(node.args) >= 2:
                self._emission(node, node.args[0], node.args[1], func,
                               False, "json", cross_str, cross_int)
            elif tail == "_refuse" and len(node.args) >= 3:
                self._emission(node, node.args[1], node.args[2], func,
                               refuse_attach, "refuse", cross_str,
                               cross_int)
            elif tail == "find" and isinstance(fn, ast.Attribute) and \
                    len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Constant) and \
                    isinstance(node.args[1].value, str):
                self.kind_consumes.append(
                    (node.lineno, node.args[1].value, None))

    def _emission(self, call, status_node, doc_node, func,
                  default_attach, kind, cross_str, cross_int):
        status = self._int_of(status_node, cross_int)
        if status is None:
            return
        attach = default_attach
        for kw in call.keywords:
            if kw.arg == "retry_after":
                attach = not (isinstance(kw.value, ast.Constant)
                              and kw.value.value is None)
        body_known, has_error, error = self._doc_info(
            doc_node, func, cross_str)
        self.emissions.append(Emission(
            self.relpath, call.lineno, status, attach,
            body_known, has_error, error, kind))

    def _compare(self, node, cross_str, cross_int, cross_tuple):
        """Fault-kind consume sites: ``x.kind <op> <literal/tuple>``."""
        if not (isinstance(node.left, ast.Attribute)
                and node.left.attr == "kind" and node.comparators):
            return
        comp = node.comparators[0]
        kinds: List[str] = []
        if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
            kinds = [comp.value]
        elif isinstance(comp, (ast.Tuple, ast.List)):
            kinds = [e.value for e in comp.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
        elif isinstance(comp, ast.Name):
            vals = self._tuple_of(comp, cross_int, cross_tuple)
            if vals is not None:
                kinds = [v for v in vals if isinstance(v, str)]
        base = node.left.value
        base_name = base.id if isinstance(base, ast.Name) else None
        for kind in kinds:
            self.kind_consumes.append((node.lineno, kind, base_name))

    def _dispatch_if(self, node, cross_str, cross_int, cross_tuple):
        """Client status dispatch: an ``if`` over ``.code`` compares
        whose body raises a typed transport exception."""
        klass = ""
        for st in node.body:
            if isinstance(st, ast.Raise) and st.exc is not None:
                exc = st.exc
                fn = exc.func if isinstance(exc, ast.Call) else exc
                name = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else "")
                if "Unavailable" in name:
                    klass = "retry"
                elif "Incomplete" in name:
                    klass = "resume"
                elif "Rejected" in name:
                    klass = "fatal"
                break
        if not klass:
            return
        err_cmp = None
        code_cmps = []
        for c in ast.walk(node.test):
            if not isinstance(c, ast.Compare) or not c.comparators:
                continue
            if isinstance(c.left, ast.Attribute) and c.left.attr == "code":
                code_cmps.append(c)
            elif isinstance(c.left, ast.Call) and \
                    isinstance(c.left.func, ast.Attribute) and \
                    c.left.func.attr == "get" and c.left.args and \
                    isinstance(c.left.args[0], ast.Constant) and \
                    c.left.args[0].value == "error":
                err_cmp = c
        by_klass = {"retry": self.retry_sites, "fatal": self.fatal_sites,
                    "resume": self.resume_sites}
        for c in code_cmps:
            op = c.ops[0]
            comp = c.comparators[0]
            if isinstance(op, ast.In):
                vals = self._tuple_of(comp, cross_int, cross_tuple)
                if vals is not None:
                    by_klass[klass].append(DispatchSite(
                        self.relpath, c.lineno, klass,
                        tuple(v for v in vals if isinstance(v, int))))
            elif isinstance(op, ast.Eq):
                status = self._int_of(comp, cross_int)
                if err_cmp is not None:
                    self.error_overrides.append(ErrorOverride(
                        self.relpath, c.lineno, klass, status,
                        self._str_of(err_cmp.comparators[0], cross_str)))
                elif status is not None:
                    by_klass[klass].append(DispatchSite(
                        self.relpath, c.lineno, klass, (status,)))
            elif isinstance(op, (ast.Gt, ast.GtE)) and klass == "retry":
                floor = self._int_of(comp, cross_int)
                if floor is not None:
                    if isinstance(op, ast.Gt):
                        floor += 1
                    self.floor_sites.append((self.relpath, c.lineno,
                                             floor))


# ---------------------------------------------------------------------------
# Vocabulary + companion extraction.
# ---------------------------------------------------------------------------

def _vocab_decls(mf: _ProtoFacts):
    """The shared-vocabulary declarations out of the vocab module's AST,
    or None when the module declares no STATUS_ERRORS dict."""
    decls = {"status_errors": {}, "status_lines": {}, "error_lines": {},
             "decl_lines": {}, "routes": [], "fatal_errors": (),
             "floor": None}
    for name in _DECL_TUPLES:
        decls[name] = ()
    found = False
    for node in mf.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        v = node.value
        if tgt.id == "STATUS_ERRORS" and isinstance(v, ast.Dict):
            found = True
            decls["decl_lines"]["STATUS_ERRORS"] = node.lineno
            for k, val in zip(v.keys, v.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, int)):
                    continue
                errs = []
                if isinstance(val, (ast.Tuple, ast.List)):
                    for e in val.elts:
                        s = mf._str_of(e, {})
                        if s is not None:
                            errs.append(s)
                            decls["error_lines"].setdefault(s, e.lineno)
                decls["status_errors"][k.value] = tuple(errs)
                decls["status_lines"][k.value] = k.lineno
        elif tgt.id in _DECL_TUPLES and isinstance(v, (ast.Tuple,
                                                       ast.List)):
            decls[tgt.id] = tuple(
                e.value for e in v.elts if isinstance(e, ast.Constant)
                and isinstance(e.value, int))
            decls["decl_lines"][tgt.id] = node.lineno
        elif tgt.id == "CLIENT_RETRY_FLOOR" and \
                isinstance(v, ast.Constant) and isinstance(v.value, int):
            decls["floor"] = v.value
            decls["decl_lines"][tgt.id] = node.lineno
        elif tgt.id == "FATAL_ERRORS" and isinstance(v, (ast.Tuple,
                                                         ast.List)):
            decls["fatal_errors"] = tuple(
                s for s in (mf._str_of(e, {}) for e in v.elts)
                if s is not None)
            decls["decl_lines"]["FATAL_ERRORS"] = node.lineno
        elif tgt.id == "ROUTES" and isinstance(v, (ast.Tuple, ast.List)):
            decls["decl_lines"]["ROUTES"] = node.lineno
            for e in v.elts:
                if isinstance(e, ast.Constant) and \
                        isinstance(e.value, str) and " " in e.value:
                    method, _, path = e.value.partition(" ")
                    decls["routes"].append((method, path, e.lineno))
    return decls if found else None


def _board_routes(board_dir: str, base: str) -> List[tuple]:
    out = []
    for name in sorted(os.listdir(board_dir)):
        if not name.endswith((".html", ".js")):
            continue
        path = os.path.join(board_dir, name)
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError:
            continue
        rel = os.path.relpath(os.path.abspath(path), base)
        rel = rel.replace(os.sep, "/") if not rel.startswith("..") \
            else os.path.abspath(path)
        seen = set()
        for m in _BOARD_V1_RE.finditer(text):
            raw = m.group(1)
            if raw.split("?", 1)[0].endswith("/"):
                # an open prefix compose: ``"/v1/" + expr + "/rest..."``
                cont = _BOARD_CONT_RE.search(text, m.end(), m.end() + 300)
                raw = raw.split("?", 1)[0] + "<>" + \
                    (cont.group(1) if cont else "")
            norm = _normalize_route(raw)
            if norm is None or norm in seen:
                continue
            seen.add(norm)
            out.append((rel, text.count("\n", 0, m.start()) + 1, norm))
    return out


def _docs_knobs(path: str, base: str):
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            src = f.read()
    except OSError:
        return None, ""
    rel = os.path.relpath(os.path.abspath(path), base)
    rel = rel.replace(os.sep, "/") if not rel.startswith("..") \
        else os.path.abspath(path)
    rows: Dict[str, int] = {}
    for i, line in enumerate(src.splitlines(), 1):
        m = _DOCS_KNOB_RE.match(line.strip())
        if m:
            rows.setdefault(m.group(1), i)
    return (rows if rows else None), rel


#: The port's own tests, beside the JAX package's in the repo's tests/.
_TEST_PREFIX = "test_torch_"


def _companion_text(pkg: str, repo: str) -> Tuple[str, bool]:
    """Raw text of the package's tools/*.py, the repo's
    tests/test_torch_*.py and chip_smoke.py — the reference corpus for
    knob liveness and fault-kind chaos/test coverage.  The JAX package's
    tests, tools and bench.py are not in it: a port fault kind that only
    a JAX test names is untested here."""
    chunks: List[str] = []
    present = False
    for d, prefix in ((os.path.join(pkg, "tools"), ""),
                      (os.path.join(repo, "tests"), _TEST_PREFIX)):
        if not os.path.isdir(d):
            continue
        present = True
        for name in sorted(os.listdir(d)):
            if not (name.endswith(".py") and name.startswith(prefix)):
                continue
            try:
                with open(os.path.join(d, name), encoding="utf-8",
                          errors="replace") as f:
                    chunks.append(f.read())
            except OSError:
                pass
    smoke = os.path.join(repo, "chip_smoke.py")
    if os.path.isfile(smoke):
        present = True
        try:
            with open(smoke, encoding="utf-8", errors="replace") as f:
                chunks.append(f.read())
        except OSError:
            pass
    return "\n".join(chunks), present


def build_protocol_graph(files, base: str) -> ProtocolGraph:
    """Assemble the graph from the linted file set.  ``files`` must
    contain a STATUS_ERRORS-bearing vocabulary module for the graph to
    activate; board pages, the docs knob registry, and the tools/tests
    reference corpus are discovered relative to it: ``<pkg>/board/``,
    ``<pkg>/docs/OBSERVABILITY.md``, ``<pkg>/tools/``, and beside the
    package ``tests/test_torch_*.py`` and ``chip_smoke.py``."""
    base = os.path.abspath(base)

    def rel(p):
        ab = os.path.abspath(p)
        return (os.path.relpath(ab, base).replace(os.sep, "/")
                if ab.startswith(base + os.sep) else ab)

    vocab_path, vocab_facts, decls = None, None, None
    py_files, seen = [], set()
    for f in files:
        if not f.endswith(".py"):
            continue
        ab = os.path.abspath(f)
        if ab in seen:
            continue
        seen.add(ab)
        py_files.append(f)
    for f in py_files:
        try:
            with open(f, encoding="utf-8", errors="replace") as fh:
                if "STATUS_ERRORS" not in fh.read():
                    continue
        except OSError:
            continue
        mf = _ProtoFacts(f, rel(f))
        if mf.tree is None:
            continue
        d = _vocab_decls(mf)
        if d is not None:
            vocab_path, vocab_facts, decls = os.path.abspath(f), mf, d
            break
    if vocab_path is None:
        return ProtocolGraph(ok=False)

    vocab_dir = os.path.dirname(vocab_path)
    pkg = os.path.dirname(vocab_dir) \
        if os.path.basename(vocab_dir) == "archive" else vocab_dir
    repo = os.path.dirname(pkg)

    facts: List[_ProtoFacts] = [vocab_facts]
    for f in py_files:
        if os.path.abspath(f) == vocab_path:
            continue
        facts.append(_ProtoFacts(f, rel(f)))
    cross_str: Dict[tuple, str] = {}
    cross_int: Dict[tuple, int] = {}
    cross_tuple: Dict[tuple, tuple] = {}
    for mf in facts:
        if mf.tree is None:
            continue
        stem = os.path.splitext(os.path.basename(mf.relpath))[0]
        for name, value in mf.str_consts.items():
            cross_str.setdefault((stem, name), value)
        for name, value in mf.int_consts.items():
            cross_int.setdefault((stem, name), value)
        for name, value in mf.tuple_consts.items():
            cross_tuple.setdefault((stem, name), value)
    for mf in facts:
        mf.harvest(cross_str, cross_int, cross_tuple)

    # the fault grammar: the module declaring BOTH a base KINDS tuple
    # and a NET_KINDS tuple (whatif's scenario KINDS is a different
    # vocabulary and must not activate the closure)
    grammar = next((mf for mf in facts
                    if "KINDS" in mf.kind_tables
                    and "NET_KINDS" in mf.kind_tables), None)
    kinds: Dict[str, tuple] = {}
    grammar_rel = ""
    kind_consumes: List[tuple] = []
    if grammar is not None:
        grammar_rel = grammar.relpath
        grammar_stem = os.path.splitext(
            os.path.basename(grammar.relpath))[0]
        for table, entries in sorted(grammar.kind_tables.items()):
            for kind, line in entries:
                kinds.setdefault(kind, (table, line))
        for mf in facts:
            if mf is grammar:
                kind_consumes.extend(
                    (mf.relpath, line, kind)
                    for line, kind, _base in mf.kind_consumes)
                continue
            if grammar_stem not in mf.imports_of:
                continue
            kind_consumes.extend(
                (mf.relpath, line, kind)
                for line, kind, base in mf.kind_consumes
                if base is not None and base in mf.fault_tainted)

    emissions: List[Emission] = []
    raw_sends: List[tuple] = []
    server_files: set = set()
    server_tokens: set = set()
    client_routes: List[tuple] = []
    retry_sites: List[DispatchSite] = []
    fatal_sites: List[DispatchSite] = []
    resume_sites: List[DispatchSite] = []
    floor_sites: List[tuple] = []
    overrides: List[ErrorOverride] = []
    error_uses: Dict[str, tuple] = {}
    knob_reads: List[tuple] = []
    for mf in facts:
        if mf.tree is None:
            continue
        if "lint/" in mf.relpath:
            # the lint package talks ABOUT the protocol; its own "v1"
            # literals must not make it a protocol-server file
            mf.is_server = False
        if mf.is_server:
            server_files.add(mf.relpath)
            server_tokens |= mf.server_tokens
            emissions.extend(mf.emissions)
            raw_sends.extend((mf.relpath, line, status)
                             for line, status in mf.raw_sends)
        client_routes.extend((mf.relpath, line, norm)
                             for line, norm in mf.client_routes)
        retry_sites.extend(mf.retry_sites)
        fatal_sites.extend(mf.fatal_sites)
        resume_sites.extend(mf.resume_sites)
        floor_sites.extend(mf.floor_sites)
        overrides.extend(mf.error_overrides)
        for err, line in mf.error_uses:
            error_uses.setdefault(err, (mf.relpath, line))
        knob_reads.extend((mf.relpath, line, tok)
                          for line, tok in mf.knob_reads)

    board_dir = os.path.join(pkg, "board")
    board = _board_routes(board_dir, base) \
        if os.path.isdir(board_dir) else []

    docs_knobs, docs_rel = _docs_knobs(
        os.path.join(pkg, "docs", "OBSERVABILITY.md"), base)
    ref_text, ref_present = _companion_text(pkg, repo)
    liveness = "\n".join([mf.src for mf in facts] + [ref_text])

    return ProtocolGraph(
        ok=True,
        vocab_relpath=vocab_facts.relpath,
        status_errors=decls["status_errors"],
        status_lines=decls["status_lines"],
        error_lines=decls["error_lines"],
        retry_after_statuses=decls["RETRY_AFTER_STATUSES"],
        no_retry_after_statuses=decls["NO_RETRY_AFTER_STATUSES"],
        client_retry_statuses_decl=decls["CLIENT_RETRY_STATUSES"],
        client_fatal_statuses_decl=decls["CLIENT_FATAL_STATUSES"],
        client_resume_statuses_decl=decls["CLIENT_RESUME_STATUSES"],
        client_retry_floor_decl=decls["floor"],
        fatal_errors_decl=decls["fatal_errors"],
        decl_lines=decls["decl_lines"],
        routes=tuple(decls["routes"]),
        emissions=tuple(sorted(
            emissions, key=lambda e: (e.relpath, e.line, e.status))),
        raw_sends=tuple(sorted(raw_sends)),
        client_routes=tuple(sorted(client_routes)),
        board_routes=tuple(sorted(board)),
        server_files=frozenset(server_files),
        server_tokens=frozenset(server_tokens),
        retry_sites=tuple(sorted(
            retry_sites, key=lambda s: (s.relpath, s.line))),
        fatal_sites=tuple(sorted(
            fatal_sites, key=lambda s: (s.relpath, s.line))),
        resume_sites=tuple(sorted(
            resume_sites, key=lambda s: (s.relpath, s.line))),
        floor_sites=tuple(sorted(floor_sites)),
        error_overrides=tuple(sorted(
            overrides, key=lambda o: (o.relpath, o.line))),
        error_uses=error_uses,
        knob_reads=tuple(sorted(knob_reads)),
        docs_knobs=docs_knobs,
        docs_relpath=docs_rel,
        liveness_text=liveness,
        ref_text=ref_text,
        ref_text_present=ref_present,
        kinds=kinds,
        grammar_relpath=grammar_rel,
        kind_consumes=tuple(sorted(kind_consumes)),
    )


# ---------------------------------------------------------------------------
# The rules.
# ---------------------------------------------------------------------------

def _graph(ctx: FileContext) -> Optional[ProtocolGraph]:
    g = getattr(ctx.project, "protocol", None)
    return g if isinstance(g, ProtocolGraph) and g.ok else None


class _ProtocolRule(Rule):
    """Base: finish()-only rules over the shared protocol graph.
    Site-anchored findings (emissions, client compares, knob reads)
    are emitted from their own file; vocabulary/board/docs findings
    are emitted while visiting the vocab module so each appears
    exactly once."""

    node_types: tuple = ()


class RouteStatusClosure(_ProtocolRule):
    """SL024 — the route/status surface is closed over the shared
    vocabulary: every emitted status is declared, every client/board
    route shapes onto a declared route, every declared route has a
    server dispatch token, and no declared status or error string is
    dead on both sides."""

    rule_id = "SL024"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None:
            return
        for em in g.emissions:
            if em.relpath == ctx.relpath and \
                    em.status not in g.status_errors:
                yield Finding(
                    em.relpath, em.line, self.rule_id,
                    f"handler emits HTTP {em.status}, which "
                    "protocol.STATUS_ERRORS does not declare — the "
                    "client dispatch table cannot know it",
                    self.severity)
        for relpath, line, status in g.raw_sends:
            if relpath == ctx.relpath and status not in g.status_errors:
                yield Finding(
                    relpath, line, self.rule_id,
                    f"send_response({status}) emits a status "
                    "protocol.STATUS_ERRORS does not declare",
                    self.severity)
        for relpath, line, norm in g.client_routes:
            if relpath == ctx.relpath and not g.route_match(norm):
                yield Finding(
                    relpath, line, self.rule_id,
                    f"route {norm!r} matches no protocol.ROUTES entry "
                    "— the server answers it 404", self.severity)
        if ctx.relpath != g.vocab_relpath:
            return
        for relpath, line, norm in g.board_routes:
            if not g.route_match(norm):
                yield Finding(
                    relpath, line, self.rule_id,
                    f"board fetch {norm!r} matches no protocol.ROUTES "
                    "entry — the page fetches a 404", self.severity)
        if g.server_files:
            for method, path, line in g.routes:
                segs = _route_segments(path) or ()
                for seg in segs:
                    if seg.startswith("<"):
                        continue
                    if seg not in g.server_tokens:
                        yield Finding(
                            g.vocab_relpath, line, self.rule_id,
                            f"declared route {method} {path!r}: no "
                            f"handler dispatches segment {seg!r} — "
                            "dead route entry", self.severity)
        if g.emissions and (g.retry_sites or g.fatal_sites):
            emitted = {em.status for em in g.emissions} | \
                {status for _r, _l, status in g.raw_sends}
            referenced = set(g.client_statuses())
            floors = [fl for _r, _l, fl in g.floor_sites]
            for status in sorted(g.status_errors):
                if status in emitted or status in referenced:
                    continue
                if any(status >= fl for fl in floors):
                    continue
                yield Finding(
                    g.vocab_relpath, g.status_lines.get(status, 0),
                    self.rule_id,
                    f"STATUS_ERRORS declares {status} but no handler "
                    "emits it and no client dispatch handles it — "
                    "dead status", self.severity)
        for err in sorted(g.error_lines):
            if err not in g.error_uses:
                yield Finding(
                    g.vocab_relpath, g.error_lines[err], self.rule_id,
                    f"error string {err!r} is declared in "
                    "STATUS_ERRORS but never attached to any response "
                    "body — dead vocabulary", self.severity)


class RefusalDiscipline(_ProtocolRule):
    """SL025 — every refusal is typed and honest about retrying:
    RETRY_AFTER_STATUSES sends attach Retry-After, the deadline 504
    does NOT, every >=400 body carries a shared-vocabulary error
    string, and no raw send_response bypasses the helpers for a
    retryable status."""

    rule_id = "SL025"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None:
            return
        for em in g.emissions:
            if em.relpath != ctx.relpath:
                continue
            if em.status in g.retry_after_statuses and not em.attach:
                yield Finding(
                    em.relpath, em.line, self.rule_id,
                    f"HTTP {em.status} is a capacity refusal "
                    "(RETRY_AFTER_STATUSES) but this send attaches no "
                    "Retry-After — clients fall back to blind backoff",
                    self.severity)
            if em.status in g.no_retry_after_statuses and em.attach:
                yield Finding(
                    em.relpath, em.line, self.rule_id,
                    f"HTTP {em.status} is a deadline refusal "
                    "(NO_RETRY_AFTER_STATUSES) but this send attaches "
                    "Retry-After — it invites a retry nobody is "
                    "waiting for", self.severity)
            allowed = g.status_errors.get(em.status, ())
            if em.status >= 400 and allowed:
                if not em.body_known:
                    yield Finding(
                        em.relpath, em.line, self.rule_id,
                        f"HTTP {em.status} refusal body does not "
                        "resolve to a dict literal — the typed "
                        "{'error': ...} contract cannot be checked",
                        self.severity)
                elif not em.has_error:
                    yield Finding(
                        em.relpath, em.line, self.rule_id,
                        f"HTTP {em.status} refusal carries no typed "
                        "{'error': ...} body — clients cannot "
                        "dispatch on it", self.severity)
                elif em.error is None:
                    yield Finding(
                        em.relpath, em.line, self.rule_id,
                        f"HTTP {em.status} refusal's error value does "
                        "not resolve to a shared-vocabulary constant "
                        "(archive/protocol.py)", self.severity)
                elif em.error not in allowed:
                    yield Finding(
                        em.relpath, em.line, self.rule_id,
                        f"error {em.error!r} is not in "
                        f"STATUS_ERRORS[{em.status}] — undeclared "
                        "status/error pairing", self.severity)
        for relpath, line, status in g.raw_sends:
            if relpath == ctx.relpath and \
                    status in g.retry_after_statuses:
                yield Finding(
                    relpath, line, self.rule_id,
                    f"raw send_response({status}) bypasses the typed "
                    "refusal helpers — no Retry-After, no error body",
                    self.severity)


class EnvKnobRegistry(_ProtocolRule):
    """SL026 — every SOFA_* knob the package reads has a row in the
    package's docs/OBSERVABILITY.md env-knob registry, and every
    documented knob is still referenced somewhere (the package, its
    tests, chip_smoke.py).
    Both directions are drift: an undocumented knob is invisible to
    operators; a dead row documents a control nobody wired."""

    rule_id = "SL026"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None or g.docs_knobs is None:
            return
        for relpath, line, token in g.knob_reads:
            if relpath == ctx.relpath and token not in g.docs_knobs:
                yield Finding(
                    relpath, line, self.rule_id,
                    f"SOFA_* knob {token} is read here but "
                    "sofa_tpu_torch/docs/OBSERVABILITY.md's env-knob "
                    "registry has no row for it — undocumented control "
                    "surface",
                    self.severity)
        if ctx.relpath == g.vocab_relpath:
            for token in sorted(g.docs_knobs):
                if token not in g.liveness_text:
                    yield Finding(
                        g.docs_relpath, g.docs_knobs[token],
                        self.rule_id,
                        f"documented knob {token} is referenced "
                        "nowhere (package, tests/test_torch_*.py, "
                        "chip_smoke.py) — dead registry row",
                        self.severity)


class FaultKindClosure(_ProtocolRule):
    """SL027 — the fault-injection grammar and its consumers agree:
    every declared kind has a consume site (else injecting it is a
    silent no-op) and a chaos/test reference; every consumed kind
    literal is in the grammar (else the consume branch can never
    fire — a phantom)."""

    rule_id = "SL027"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None or not g.kinds:
            return
        for relpath, line, kind in g.kind_consumes:
            if relpath == ctx.relpath and kind not in g.kinds:
                yield Finding(
                    relpath, line, self.rule_id,
                    f"fault kind {kind!r} is consumed here but no "
                    "faults.py grammar tuple declares it — this "
                    "branch can never fire (phantom kind)",
                    self.severity)
        if ctx.relpath != g.grammar_relpath:
            return
        consumed = {kind for _r, _l, kind in g.kind_consumes}
        for kind in sorted(g.kinds):
            table, line = g.kinds[kind]
            if kind not in consumed:
                yield Finding(
                    g.grammar_relpath, line, self.rule_id,
                    f"fault kind {kind!r} is declared in {table} but "
                    "consumed nowhere — injecting it is a silent "
                    "no-op", self.severity)
            elif g.ref_text_present and kind not in g.ref_text:
                yield Finding(
                    g.grammar_relpath, line, self.rule_id,
                    f"fault kind {kind!r} has no chaos/test reference "
                    "(the package's tools/, tests/test_torch_*.py, "
                    "chip_smoke.py) — untested fault path",
                    self.severity)


class ClientRetrySoundness(_ProtocolRule):
    """SL028 — client dispatch and server Retry-After discipline tell
    one story: the client's extracted retry/fatal/resume sets match
    the declared CLIENT_* constants, every status the server marks
    retryable is client-retryable (and never client-fatal), and
    fatal-error overrides stay inside the declared FATAL_ERRORS."""

    rule_id = "SL028"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None:
            return
        checks = (
            (g.retry_sites, g.client_retry_statuses_decl,
             "CLIENT_RETRY_STATUSES"),
            (g.fatal_sites, g.client_fatal_statuses_decl,
             "CLIENT_FATAL_STATUSES"),
            (g.resume_sites, g.client_resume_statuses_decl,
             "CLIENT_RESUME_STATUSES"),
        )
        for sites, decl, name in checks:
            if not decl:
                continue
            for site in sites:
                if site.relpath == ctx.relpath and \
                        set(site.statuses) != set(decl):
                    yield Finding(
                        site.relpath, site.line, self.rule_id,
                        f"client {site.klass} statuses "
                        f"{sorted(set(site.statuses))} diverge from "
                        f"protocol.{name} {sorted(set(decl))}",
                        self.severity)
        if g.client_retry_floor_decl is not None:
            for relpath, line, floor in g.floor_sites:
                if relpath == ctx.relpath and \
                        floor != g.client_retry_floor_decl:
                    yield Finding(
                        relpath, line, self.rule_id,
                        f"client retry floor {floor} diverges from "
                        "protocol.CLIENT_RETRY_FLOOR "
                        f"{g.client_retry_floor_decl}", self.severity)
        for ov in g.error_overrides:
            if ov.relpath != ctx.relpath or ov.klass != "fatal":
                continue
            if ov.error is None:
                yield Finding(
                    ov.relpath, ov.line, self.rule_id,
                    "client fatal-error override does not resolve to "
                    "a shared-vocabulary string", self.severity)
                continue
            if g.fatal_errors_decl and \
                    ov.error not in g.fatal_errors_decl:
                yield Finding(
                    ov.relpath, ov.line, self.rule_id,
                    f"client treats error {ov.error!r} as fatal but "
                    "protocol.FATAL_ERRORS does not declare it",
                    self.severity)
            if ov.status is not None and \
                    g.status_errors.get(ov.status) and \
                    ov.error not in g.status_errors[ov.status]:
                yield Finding(
                    ov.relpath, ov.line, self.rule_id,
                    f"client dispatches on error {ov.error!r} for "
                    f"HTTP {ov.status}, but STATUS_ERRORS[{ov.status}] "
                    "never carries it", self.severity)
        if ctx.relpath != g.vocab_relpath:
            return
        has_client = bool(g.retry_sites or g.floor_sites)
        if has_client:
            fatal_union = {s for site in g.fatal_sites
                           for s in site.statuses}
            line = g.decl_lines.get("RETRY_AFTER_STATUSES", 0)
            for status in g.retry_after_statuses:
                if not g.client_retryable(status):
                    yield Finding(
                        g.vocab_relpath, line, self.rule_id,
                        f"server marks HTTP {status} retryable "
                        "(Retry-After) but the client never retries "
                        "it — the backpressure hint is wasted",
                        self.severity)
                if status in fatal_union:
                    yield Finding(
                        g.vocab_relpath, line, self.rule_id,
                        f"client treats HTTP {status} as fatal but "
                        "the server marks it retryable (Retry-After) "
                        "— contradictory contract", self.severity)
        if g.error_overrides:
            dispatched = {ov.error for ov in g.error_overrides
                          if ov.klass == "fatal" and ov.error}
            for err in g.fatal_errors_decl:
                if err not in dispatched:
                    yield Finding(
                        g.vocab_relpath,
                        g.decl_lines.get("FATAL_ERRORS", 0),
                        self.rule_id,
                        f"FATAL_ERRORS declares {err!r} but no client "
                        "fatal dispatch checks it — dead override",
                        self.severity)


PROTOCOL_RULES = (
    RouteStatusClosure,
    RefusalDiscipline,
    EnvKnobRegistry,
    FaultKindClosure,
    ClientRetrySoundness,
)
