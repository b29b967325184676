"""SL019–SL023 — concurrency & commit-ordering analysis.

`live` tail-ingest, the `agent` fleet daemon, the fleet tier's worker
pool and the chunked columnar engine turn the one-shot batch verbs into
concurrent, always-on code, beside the supervisor watchdog, collector
sampler threads, pool workers, ThreadingHTTPServer handlers, and the
injected sitecustomize's and tracer's watcher threads.  This module gives
that a machine-checked discipline: named guards with declared protected
state, and the commit ordering the crash journal depends on.

The analyzer extracts, statically and cross-file, an **execution-context
graph**: which functions run on the main verb flow, which are
thread targets (``threading.Thread(target=...)`` / ``Timer``), which are
pool workers (``pool.thread_map`` / ``executor.submit`` / ``pool.map``),
and which are request handlers (methods of ``*RequestHandler`` /
``*HTTPServer`` / ``*Servicer`` classes).  Contexts propagate along the
intra-file call graph and one hop across files (a function another
module calls from a thread context is itself thread-context).  On top of
that graph, five rules:

SL019  **declared-guard contracts.**  State a ``concurrency.Guard``
       declares in ``protects=`` must have every write under a
       ``with <that guard>:`` block; state written from ≥2 execution
       contexts with no declared guard at all is flagged (the cross-file
       generalization of the SL006 worker-global heuristic); and writes
       to another module's *class* attributes (process-global behavior
       changes, the old viz.py ThreadingHTTPServer mutation) are flagged.
SL020  **no blocking under a guard, no lock-order cycles.**  subprocess
       calls, ``time.sleep``, file ``open`` and ``.result()/.join()/
       .wait()`` inside a held lock/guard block serialize every other
       context on IO; nested acquisitions (lexical, plus one call hop)
       must form an acyclic lock order.
SL021  **commit-ordering.**  Inside a journaled verb function (one that
       calls ``Journal(...).begin``/``.commit``), derived-artifact writes
       must sit inside the begin→commit window, the digest refresh must
       precede the commit, and nothing may write after the commit — the
       class of bug a torn `diff` once showed dynamically, caught
       statically.  Lexical, same-function granularity: the begin/commit
       bracket and the direct writer calls between them.
SL022  **thread-context safety.**  ``signal.signal``/``os.chdir``/
       ``os.fork`` from a non-main execution context; daemon threads
       spawned at module import time (including inside the **embedded
       injection templates** — module-level string constants that parse
       as Python modules are linted as virtual modules, which is how the
       JAX package's old import-time watchers were caught); and check-then-act on the ``_derived.writing`` sentinel
       outside trace.py's own API (``derived_writing``/
       ``reap_stale_sentinel`` exist precisely so nobody races the raw
       file).
SL023  **shutdown liveness.**  Every ``threading.Thread`` spawned in the
       package must be reachable from a stop path: a ``.join()`` on its
       binding in the same class/function, or an ownership transfer
       (``return``) to a caller.  The invariant the fleet daemon will
       live or die by.  Scope: real modules only — the injection
       templates run inside the *profiled* process, whose watcher threads
       are daemon-by-contract and die with the host program.

Extraction is purely syntactic like the rest of sofa-lint; closure-variable
mutations and per-element dict aliasing (``st = self._state[...]``) are
out of reach by design — the guard declarations cover the containers, and
the race tests (tests/test_torch_concurrency_lint.py) cover what the AST
cannot see.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from sofa_tpu_torch.lint.core import (
    FileContext,
    Finding,
    Rule,
    SEV_ERROR,
    SEV_WARN,
    _scan_suppressions,
)

CTX_MAIN = "main"
CTX_THREAD = "thread"
CTX_WORKER = "worker"
CTX_HANDLER = "handler"

_THREAD_FACTORIES = frozenset({"threading.Thread", "threading.Timer"})
_LOCK_FACTORIES = frozenset({"threading.Lock", "threading.RLock",
                             "threading.Condition", "threading.Semaphore",
                             "threading.BoundedSemaphore"})
#: Guard construction, by dotted-origin tail (sofa_tpu_torch.concurrency.
#: Guard, a from-imported Guard, concurrency.Guard — all end the same way).
_GUARD_TAIL = "Guard"

_HANDLER_BASE_SUFFIXES = ("RequestHandler", "HTTPServer", "Servicer",
                          "BaseRequestHandler")

#: Blocking operations that must not run while holding a guard: every
#: other context that needs the guard stalls on this one's IO.
_BLOCKING_CALLS = frozenset({
    "subprocess.run", "subprocess.check_output", "subprocess.check_call",
    "subprocess.call", "time.sleep", "open", "io.open", "gzip.open",
})
_BLOCKING_METHODS = frozenset({"result", "join", "wait"})

#: Main-thread-only / fork-unsafe operations for SL022.
_THREAD_UNSAFE = frozenset({"signal.signal", "signal.setitimer",
                            "os.chdir", "os.fork", "os.forkpty"})

#: The mid-write sentinel and its owning module (trace.py's API is the
#: only sanctioned accessor).
_SENTINEL_LITERAL = "_derived.writing"
_SENTINEL_CHECKS = frozenset({"os.path.exists", "os.path.isfile",
                              "os.stat", "os.unlink", "os.remove",
                              "open", "io.open"})

#: Derived-artifact writer helpers (mirror of artifact_rules._WRITER_FNS
#: plus the DataFrame writer methods) for the SL021 window check.
_WRITER_TAILS = frozenset({"atomic_write", "atomic_replace",
                           "fsync_append", "write_csv", "write_frame",
                           "write_report_js_doc", "to_csv", "to_parquet"})

#: Container mutations that count as writes to the named object.
_MUTATORS = frozenset({"append", "add", "update", "setdefault", "pop",
                       "extend", "insert", "remove", "discard", "clear",
                       "popitem", "appendleft", "popleft"})

_PSEUDO_MODULE = "<module>"


# ---------------------------------------------------------------------------
# Per-file extraction.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GuardDecl:
    """One Guard(...) declaration: module-level or an instance attribute."""

    name: str                  # binding name ("_registry_lock" / "_lock")
    cls: str                   # owning class, "" for module guards
    protects: tuple
    line: int
    declared_in: str           # qualname of the declaring function ("" = module)


@dataclass(frozen=True)
class SpawnSite:
    line: int
    binding_kind: str          # "attr" | "local" | "loose"
    binding: str               # attr/var name ("" when loose)
    cls: str                   # enclosing class ("" outside classes)
    func: str                  # enclosing function qualname ("" = module level)
    factory: str               # "threading.Thread" / "threading.Timer"


@dataclass(frozen=True)
class _Write:
    name: str                  # attribute or module-global name
    cls: str                   # owning class for attr writes, "" for globals
    func: str                  # qualname of the writing function
    line: int
    held: tuple                # lock/guard keys lexically held at the write


class _FileModel:
    """Everything one parse of one (real or virtual) module contributes.

    ``line_offset`` shifts findings for virtual modules (embedded
    templates) back onto the real file's lines; ``suppressions`` for a
    virtual module are scanned from the template's own source, since the
    engine's comment scan cannot see inside a string literal.
    """

    def __init__(self, relpath: str, src: str, line_offset: int = 0,
                 virtual: bool = False):
        self.relpath = relpath
        self.line_offset = line_offset
        self.virtual = virtual
        self.ok = False
        try:
            self.tree = ast.parse(src)
        except (SyntaxError, ValueError):
            self.tree = None
            return
        self.ok = True
        self.suppressions = _scan_suppressions(src) if virtual else None

        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

        self.import_alias: Dict[str, str] = {}
        self.from_import: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_alias[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_import[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

        # function table: qualname -> node, plus per-node ownership
        self.functions: Dict[str, ast.AST] = {}
        self.func_of: Dict[int, str] = {}
        self.class_of: Dict[str, str] = {}      # qualname -> class name
        self.methods_by_name: Dict[str, List[str]] = {}
        self.module_globals: Set[str] = set()
        self.handler_classes: Set[str] = set()
        self._index_scopes()

        self.guards: List[GuardDecl] = []
        self.plain_locks: Set[Tuple[str, str]] = set()   # (cls, name)
        self.spawns: List[SpawnSite] = []
        self.seeds: Dict[str, Set[str]] = {}
        self.call_edges: Set[Tuple[str, str]] = set()
        self.external_calls: List[Tuple[str, str]] = []  # (func, origin)
        self.writes: List[_Write] = []
        self.imported_attr_writes: List[Tuple[int, str]] = []
        self.lock_block_calls: List[Tuple[tuple, str, str, int]] = []
        self.lock_nestings: List[Tuple[tuple, tuple, int]] = []
        self.locks_in_func: Dict[str, Set[tuple]] = {}
        self.calls_under_lock: List[Tuple[tuple, str, str, int]] = []
        self.journal_funcs: Dict[str, dict] = {}
        self.unsafe_calls: List[Tuple[str, str, int]] = []
        self.sentinel_races: List[Tuple[str, int]] = []
        self.templates: List[Tuple[str, int, str]] = []  # (name, line, src)
        self._harvest()
        self.contexts: Dict[str, Set[str]] = {}
        self._infer_contexts()

    # -- scope indexing ----------------------------------------------------
    def _index_scopes(self) -> None:
        def walk(node, func, cls):
            for child in ast.iter_child_nodes(node):
                nf, nc = func, cls
                if isinstance(child, ast.ClassDef):
                    nc = child.name
                    if any(_base_tail(b).endswith(_HANDLER_BASE_SUFFIXES)
                           for b in child.bases):
                        self.handler_classes.add(child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    # Methods qualify by CLASS as well as enclosing
                    # function: two classes with a same-named method
                    # (every pair of __init__s) must not alias in
                    # functions/class_of, or spawn sites in one class
                    # get attributed to the other and SL023's join
                    # matching breaks (found when supervisor.py grew a
                    # second class).
                    if func:
                        nf = f"{func}.{child.name}"
                    elif cls:
                        nf = f"{cls}.{child.name}"
                    else:
                        nf = child.name
                    self.functions[nf] = child
                    self.class_of[nf] = cls
                    if cls and not func:
                        self.methods_by_name.setdefault(
                            child.name, []).append(nf)
                elif not func and not cls and \
                        isinstance(child, (ast.Assign, ast.AnnAssign)):
                    tgts = (child.targets if isinstance(child, ast.Assign)
                            else [child.target])
                    for tgt in tgts:
                        if isinstance(tgt, ast.Name):
                            self.module_globals.add(tgt.id)
                self.func_of[id(child)] = nf
                walk(child, nf, nc)

        self.func_of[id(self.tree)] = ""
        walk(self.tree, "", "")

    # -- shared resolution helpers ----------------------------------------
    def resolve(self, expr) -> str:
        if isinstance(expr, ast.Name):
            return self.from_import.get(expr.id,
                                        self.import_alias.get(expr.id,
                                                              expr.id))
        if isinstance(expr, ast.Attribute):
            parts = [expr.attr]
            cur = expr.value
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                parts.append(self.import_alias.get(
                    cur.id, self.from_import.get(cur.id, cur.id)))
                return ".".join(reversed(parts))
        return ""

    def ancestors(self, node) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def _local_func(self, name: str, scope: str) -> "str | None":
        """Resolve a bare function name seen in ``scope`` to a qualname:
        nested definitions shadow module-level ones."""
        while True:
            cand = f"{scope}.{name}" if scope else name
            if cand in self.functions:
                return cand
            if not scope:
                return None
            scope = scope.rpartition(".")[0]

    def _callable_ref(self, expr, scope: str) -> "str | None":
        """The function a callable expression names, if it is local:
        a bare name, or ``self.method`` within a class."""
        if isinstance(expr, ast.Name):
            return self._local_func(expr.id, scope)
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            cls = self.class_of.get(scope) or self.class_of.get(
                scope.partition(".")[0], "")
            if cls:
                cand = expr.attr
                for qn in self.methods_by_name.get(cand, ()):
                    if self.class_of.get(qn) == cls:
                        return qn
        return None

    def _lock_key(self, expr, scope: str) -> "tuple | None":
        """(cls, name) key of a lock/guard a ``with`` item names, or None
        when the expression is not a known lock."""
        if isinstance(expr, ast.Name):
            key = ("", expr.id)
        elif isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            cls = self.class_of.get(scope, "")
            key = (cls, expr.attr)
        else:
            return None
        if key in self.plain_locks:
            return key
        for g in self.guards:
            if (g.cls, g.name) == key:
                return key
        return None

    def _held_at(self, node, scope: str) -> tuple:
        held = []
        for anc in self.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    key = self._lock_key(item.context_expr, scope)
                    if key is not None:
                        held.append(key)
        return tuple(held)

    # -- the harvest -------------------------------------------------------
    def _harvest(self) -> None:
        # Pass 1: lock/guard declarations (needed before _held_at works).
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt, val = node.targets[0], node.value
            if not isinstance(val, ast.Call):
                continue
            resolved = self.resolve(val.func)
            tail = resolved.rsplit(".", 1)[-1]
            func = self.func_of.get(id(node), "")
            if isinstance(tgt, ast.Name) and not func:
                cls, name = "", tgt.id
            elif isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self":
                cls, name = self.class_of.get(func, ""), tgt.attr
            else:
                continue
            if tail == _GUARD_TAIL:
                protects: tuple = ()
                for kw in val.keywords:
                    if kw.arg == "protects" and \
                            isinstance(kw.value, (ast.Tuple, ast.List)):
                        protects = tuple(
                            e.value for e in kw.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str))
                self.guards.append(GuardDecl(name, cls, protects,
                                             node.lineno, func))
            elif resolved in _LOCK_FACTORIES:
                self.plain_locks.add((cls, name))

        # Pass 2: everything else.
        for node in ast.walk(self.tree):
            func = self.func_of.get(id(node), "")
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and not self.virtual:
                self._maybe_template(node)
                continue
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                self._harvest_write(node, func)
                continue
            if not isinstance(node, ast.Call):
                continue
            resolved = self.resolve(node.func)
            tail = resolved.rsplit(".", 1)[-1]

            # call edges + external calls for context propagation
            ref = self._callable_ref(node.func, func)
            caller = func or _PSEUDO_MODULE
            if ref is not None:
                self.call_edges.add((caller, ref))
            elif isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name):
                # X.m() binding to the unique class defining m in this file
                cands = self.methods_by_name.get(node.func.attr, ())
                if len(cands) == 1 and node.func.value.id != "self":
                    self.call_edges.add((caller, cands[0]))
                elif "." in resolved:
                    self.external_calls.append((caller, resolved))
            elif "." in resolved:
                self.external_calls.append((caller, resolved))

            # thread spawns
            if resolved in _THREAD_FACTORIES:
                self._harvest_spawn(node, resolved, func)
            # worker dispatch
            self._maybe_worker_seed(node, tail, func)
            # blocking-under-lock + lock-order facts
            held = self._held_at(node, func)
            if held:
                is_blocking = (resolved in _BLOCKING_CALLS
                               or (isinstance(node.func, ast.Attribute)
                                   and node.func.attr in _BLOCKING_METHODS
                                   and self._lock_key(node.func.value, func)
                                   is None))
                if is_blocking:
                    self.lock_block_calls.append(
                        (held, resolved or node.func.attr, func,
                         node.lineno))
                if ref is not None:
                    self.calls_under_lock.append((held, ref, func,
                                                  node.lineno))
            # SL022 facts
            if resolved in _THREAD_UNSAFE:
                self.unsafe_calls.append((func, resolved, node.lineno))
            if resolved in _SENTINEL_CHECKS and \
                    self._names_sentinel(node):
                self.sentinel_races.append((resolved, node.lineno))
            # SL021 facts
            self._harvest_journal(node, resolved, tail, func)

        # lock nesting (lexical): every with-lock inside another with-lock
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.With):
                continue
            func = self.func_of.get(id(node), "")
            inner = [self._lock_key(i.context_expr, func)
                     for i in node.items]
            inner = [k for k in inner if k is not None]
            if not inner:
                continue
            self.locks_in_func.setdefault(func, set()).update(inner)
            outer = self._held_at(node, func)
            for o in outer:
                for i in inner:
                    if o != i:
                        self.lock_nestings.append((o, i, node.lineno))

    def _maybe_template(self, node: ast.Constant) -> None:
        """Module-level string constants that parse as Python modules with
        imports are embedded templates (the sitecustomize/sampler
        injection sources) — lint them as virtual modules."""
        parent = self.parents.get(node)
        if not (isinstance(parent, ast.Assign)
                and self.func_of.get(id(parent), "") == ""
                and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            return
        src = node.value
        if len(src) < 200 or "import " not in src:
            return
        try:
            sub = ast.parse(src)
        except (SyntaxError, ValueError):
            return
        if not any(isinstance(s, (ast.Import, ast.ImportFrom))
                   for s in sub.body):
            return
        self.templates.append((parent.targets[0].id, node.lineno, src))

    def _harvest_spawn(self, node: ast.Call, factory: str,
                       func: str) -> None:
        # seed the target's context
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and factory.endswith("Timer") and \
                len(node.args) > 1:
            target = node.args[1]
        if target is not None:
            ref = self._callable_ref(target, func)
            if ref is not None:
                self.seeds.setdefault(ref, set()).add(CTX_THREAD)
        # record the spawn site + its binding for SL022/SL023
        parent = self.parents.get(node)
        kind, binding = "loose", ""
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            tgt = parent.targets[0]
            if isinstance(tgt, ast.Name):
                kind, binding = "local", tgt.id
            elif isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self":
                kind, binding = "attr", tgt.attr
        self.spawns.append(SpawnSite(
            node.lineno, kind, binding, self.class_of.get(func, ""),
            func, factory))

    def _maybe_worker_seed(self, node: ast.Call, tail: str,
                           func: str) -> None:
        arg = None
        if tail == "thread_map" and node.args:
            arg = node.args[0]
        elif isinstance(node.func, ast.Attribute) and node.args:
            recv = node.func.value
            recv_name = recv.id if isinstance(recv, ast.Name) else ""
            if node.func.attr == "submit":
                arg = node.args[0]
            elif node.func.attr == "map" and any(
                    s in recv_name.lower()
                    for s in ("pool", "executor", "ex")):
                arg = node.args[0]
        if arg is None:
            return
        ref = self._callable_ref(arg, func)
        if ref is not None:
            self.seeds.setdefault(ref, set()).add(CTX_WORKER)

    def _names_sentinel(self, node: ast.Call) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and sub.value == \
                    _SENTINEL_LITERAL:
                return True
            if isinstance(sub, ast.Name) and self.from_import.get(
                    sub.id, "").endswith(".WRITING_SENTINEL"):
                return True
        return False

    def _harvest_journal(self, node: ast.Call, resolved: str, tail: str,
                         func: str) -> None:
        if not func:
            return
        ent = self.journal_funcs.setdefault(func, {
            "journal_names": set(), "begin": [], "commit": [],
            "digest": [], "writes": []})
        if tail == "Journal":
            parent = self.parents.get(node)
            if isinstance(parent, ast.Assign) and \
                    isinstance(parent.targets[0], ast.Name):
                ent["journal_names"].add(parent.targets[0].id)
        if isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in ent["journal_names"]:
            if node.func.attr == "begin":
                ent["begin"].append(node.lineno)
            elif node.func.attr == "commit":
                ent["commit"].append(node.lineno)
        if tail == "write_digests":
            ent["digest"].append(node.lineno)
        if tail in _WRITER_TAILS:
            names = [os.path.basename(s.value)
                     for s in ast.walk(node)
                     if isinstance(s, ast.Constant)
                     and isinstance(s.value, str)]
            ent["writes"].append((node.lineno,
                                  names[-1] if names else ""))

    def _harvest_write(self, node, func: str) -> None:
        if isinstance(node, ast.Assign):
            targets, line = node.targets, node.lineno
        else:
            targets, line = [node.target], node.lineno
        for tgt in targets:
            base = tgt
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Attribute):
                root = base.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if not isinstance(root, ast.Name):
                    continue
                if root.id == "self" and \
                        isinstance(base.value, ast.Name) and func:
                    cls = self.class_of.get(func, "")
                    if cls:
                        self.writes.append(_Write(
                            base.attr, cls, func, line,
                            self._held_at(node, func)))
                elif root.id != "self" and \
                        not isinstance(tgt, ast.Subscript):
                    # X[...].attr = ... where X is imported: mutating
                    # another module's namespace.  Flag only CLASS-
                    # attribute writes (the attr's owner resolves to an
                    # uppercase-named component) — module-level config
                    # vars like ``printing.verbose`` are the startup
                    # idiom.
                    owner = self.resolve(base.value)
                    is_import = (root.id in self.import_alias
                                 or root.id in self.from_import)
                    if is_import and owner and \
                            owner.rsplit(".", 1)[-1][:1].isupper():
                        self.imported_attr_writes.append(
                            (line, f"{owner}.{base.attr}"))
            elif isinstance(base, ast.Name) and func and \
                    base.id in self.module_globals and \
                    isinstance(tgt, ast.Subscript):
                self.writes.append(_Write(base.id, "", func, line,
                                          self._held_at(node, func)))

    # mutation calls count as writes too — second walk keyed off _harvest
    def harvest_mutations(self) -> None:
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS):
                continue
            func = self.func_of.get(id(node), "")
            recv = node.func.value
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id == "self" and func:
                cls = self.class_of.get(func, "")
                if cls:
                    self.writes.append(_Write(
                        recv.attr, cls, func, node.lineno,
                        self._held_at(node, func)))
            elif isinstance(recv, ast.Name) and func and \
                    recv.id in self.module_globals:
                self.writes.append(_Write(recv.id, "", func, node.lineno,
                                          self._held_at(node, func)))

    # -- contexts ----------------------------------------------------------
    def _infer_contexts(self) -> None:
        if not self.ok:
            return
        self.harvest_mutations()
        ctx: Dict[str, Set[str]] = {qn: set(self.seeds.get(qn, ()))
                                    for qn in self.functions}
        for cls in self.handler_classes:
            for qn, c in self.class_of.items():
                if c == cls:
                    ctx[qn].add(CTX_HANDLER)
        ctx[_PSEUDO_MODULE] = {CTX_MAIN}
        self._propagate(ctx)
        # Functions neither seeded nor called intra-file are entry points
        # (verbs, public API): main context.
        for qn, c in ctx.items():
            if not c:
                c.add(CTX_MAIN)
        self._propagate(ctx)
        self.contexts = ctx

    def _propagate(self, ctx: Dict[str, Set[str]]) -> None:
        changed = True
        while changed:
            changed = False
            for caller, callee in self.call_edges:
                src = ctx.get(caller)
                dst = ctx.get(callee)
                if src and dst is not None and not src <= dst:
                    dst |= src
                    changed = True

    def add_context(self, qualname: str, contexts: Set[str]) -> bool:
        """Cross-file propagation entry: returns True when it changed."""
        dst = self.contexts.get(qualname)
        if dst is None or contexts <= dst:
            return False
        dst |= contexts
        self._propagate(self.contexts)
        return True


def _base_tail(expr) -> str:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return ""


# ---------------------------------------------------------------------------
# Graph assembly.
# ---------------------------------------------------------------------------

@dataclass
class ConcurrencyGraph:
    """The cross-file concurrency facts SL019–SL023 consult.  ``ok`` is
    False when extraction was skipped (explicit ProjectContext without
    detection — fixture isolation), leaving every rule inert."""

    ok: bool = False
    models: Dict[str, _FileModel] = field(default_factory=dict)
    virtuals: Dict[str, List[Tuple[str, int, _FileModel]]] = \
        field(default_factory=dict)
    lock_cycles: List[Tuple[tuple, ...]] = field(default_factory=list)
    cycle_sites: Dict[tuple, Tuple[str, int]] = field(default_factory=dict)


def build_concurrency_graph(files, base: str) -> ConcurrencyGraph:
    base = os.path.abspath(base)
    models: Dict[str, _FileModel] = {}
    for f in files:
        if not f.endswith(".py"):
            continue
        ab = os.path.abspath(f)
        rel = (os.path.relpath(ab, base).replace(os.sep, "/")
               if ab.startswith(base + os.sep) else ab)
        try:
            with open(f, encoding="utf-8", errors="replace") as fh:
                src = fh.read()
        except OSError:
            continue
        m = _FileModel(rel, src)
        if m.ok:
            models[rel] = m
    graph = ConcurrencyGraph(ok=True, models=models)

    # virtual modules from embedded templates
    for rel, m in models.items():
        for name, line, src in m.templates:
            vm = _FileModel(rel, src, line_offset=line - 1, virtual=True)
            if vm.ok:
                graph.virtuals.setdefault(rel, []).append((name, line, vm))

    # one-hop cross-file context propagation: a function another module
    # calls from a thread/worker/handler context inherits that context.
    by_stem: Dict[str, List[_FileModel]] = {}
    for rel, m in models.items():
        by_stem.setdefault(
            os.path.splitext(os.path.basename(rel))[0], []).append(m)
    for _round in range(3):
        changed = False
        for m in models.values():
            for caller, origin in m.external_calls:
                src_ctx = m.contexts.get(caller) or set()
                extra = src_ctx - {CTX_MAIN}
                if not extra:
                    continue
                parts = origin.split(".")
                if len(parts) < 2:
                    continue
                stem, fname = parts[-2], parts[-1]
                for other in by_stem.get(stem, ()):
                    if other is m:
                        continue
                    changed |= other.add_context(fname, extra)
                    # ...and into the unique method of that name (the
                    # module-fn -> ledger-method forwarding idiom).
                    cands = other.methods_by_name.get(fname, ())
                    if len(cands) == 1:
                        changed |= other.add_context(cands[0], extra)
        if not changed:
            break

    _find_lock_cycles(graph)
    return graph


def _find_lock_cycles(graph: ConcurrencyGraph) -> None:
    """Build the acquisition-order graph (lexical nesting + one call hop,
    cross-file through from-imports) and record its cycles."""
    edges: Dict[tuple, Set[tuple]] = {}
    sites: Dict[Tuple[tuple, tuple], Tuple[str, int]] = {}

    def _add(outer, inner, rel, line):
        if outer == inner:
            return
        edges.setdefault(outer, set()).add(inner)
        sites.setdefault((outer, inner), (rel, line))

    def _qualify(rel, key):
        return (rel,) + key

    for rel, m in graph.models.items():
        for outer, inner, line in m.lock_nestings:
            _add(_qualify(rel, outer), _qualify(rel, inner), rel, line)
        for held, callee, _func, line in m.calls_under_lock:
            for inner in m.locks_in_func.get(callee, ()):
                for outer in held:
                    _add(_qualify(rel, outer), _qualify(rel, inner),
                         rel, line)

    # simple DFS cycle detection
    color: Dict[tuple, int] = {}
    stack: List[tuple] = []
    cycles: List[Tuple[tuple, ...]] = []

    def dfs(node):
        color[node] = 1
        stack.append(node)
        for nxt in sorted(edges.get(node, ())):
            if color.get(nxt, 0) == 1:
                i = stack.index(nxt)
                cyc = tuple(stack[i:])
                if cyc not in cycles:
                    cycles.append(cyc)
            elif color.get(nxt, 0) == 0:
                dfs(nxt)
        stack.pop()
        color[node] = 2

    for node in sorted(edges):
        if color.get(node, 0) == 0:
            dfs(node)
    graph.lock_cycles = cycles
    for cyc in cycles:
        pairs = list(zip(cyc, cyc[1:] + (cyc[0],)))
        for pair in pairs:
            if pair in sites:
                graph.cycle_sites[cyc] = sites[pair]
                break


# ---------------------------------------------------------------------------
# The rules.
# ---------------------------------------------------------------------------

def _graph(ctx: FileContext) -> Optional[ConcurrencyGraph]:
    g = getattr(ctx.project, "concurrency", None)
    return g if isinstance(g, ConcurrencyGraph) and g.ok else None


class _ConcRule(Rule):
    node_types: tuple = ()

    def _model(self, ctx: FileContext) -> "Optional[_FileModel]":
        g = _graph(ctx)
        if g is None:
            return None
        return g.models.get(ctx.relpath)


def _ctx_of(model: _FileModel, func: str) -> Set[str]:
    return model.contexts.get(func) or {CTX_MAIN}


class UndeclaredSharedState(_ConcRule):
    """SL019 — declared-guard contracts, three arms: (1) every write to a
    name some Guard's ``protects`` declares must happen inside a ``with
    <that guard>:`` block (initialization in the declaring function and
    ``__init__``/module level is exempt); (2) state written from two or
    more execution contexts with no declared guard at all is flagged once
    per name; (3) assignments to another module's class attributes are
    process-global mutations every context observes — subclass or config
    object instead."""

    rule_id = "SL019"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        model = self._model(ctx)
        if model is None:
            return
        guards_by_state: Dict[Tuple[str, str], GuardDecl] = {}
        for g in model.guards:
            for name in g.protects:
                guards_by_state[(g.cls, name)] = g
        # arm 1: guarded state written outside its guard
        for w in model.writes:
            g = guards_by_state.get((w.cls, w.name))
            if g is None:
                continue
            if w.func == g.declared_in or \
                    w.func.rpartition(".")[-1] == "__init__":
                continue
            if (g.cls, g.name) in w.held:
                continue
            where = f"{g.cls}.{g.name}" if g.cls else g.name
            yield Finding(
                ctx.relpath, w.line, self.rule_id,
                f"write to {w.name!r} outside its declared guard {where} "
                f"(which declares protects={list(g.protects)}) — every "
                "access to declared shared state must hold the guard",
                self.severity)
        # arm 2: multi-context writes with no declared guard
        by_name: Dict[Tuple[str, str], List[_Write]] = {}
        for w in model.writes:
            if (w.cls, w.name) in guards_by_state:
                continue
            by_name.setdefault((w.cls, w.name), []).append(w)
        for (cls, name), writes in sorted(by_name.items()):
            contexts = set()
            for w in writes:
                if w.func.rpartition(".")[-1] == "__init__":
                    continue
                contexts |= _ctx_of(model, w.func)
            if len(contexts) < 2:
                continue
            anchor = min((w for w in writes
                          if w.func.rpartition(".")[-1] != "__init__"),
                         key=lambda w: w.line)
            state = f"{cls}.{name}" if cls else name
            hint = ("held under an anonymous lock — name it: " if any(
                w.held for w in writes) else "")
            yield Finding(
                ctx.relpath, anchor.line, self.rule_id,
                f"{state!r} is written from multiple execution contexts "
                f"({'/'.join(sorted(contexts))}) with no declared guard — "
                f"{hint}declare a concurrency.Guard(protects=({name!r},)) "
                "and hold it at every write", self.severity)
        # arm 3: mutating an imported class's attributes
        for line, origin in model.imported_attr_writes:
            yield Finding(
                ctx.relpath, line, self.rule_id,
                f"assignment to imported class attribute {origin!r} "
                "mutates process-global state every execution context "
                "(and every other user of the class) observes — subclass "
                "it or pass configuration explicitly", self.severity)


class BlockingUnderGuard(_ConcRule):
    """SL020 — (a) blocking operations (subprocess, file IO, sleep,
    ``.result()/.join()/.wait()``) inside a held lock/guard block stall
    every context that needs the guard behind one call's IO — warn tier;
    (b) the lock acquisition-order graph (lexical nesting plus one intra-
    file call hop) must be acyclic — error tier."""

    rule_id = "SL020"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        model = self._model(ctx)
        if model is None:
            return
        for held, what, _func, line in model.lock_block_calls:
            locks = ", ".join(
                (f"{c}.{n}" if c else n) for c, n in held)
            yield Finding(
                ctx.relpath, line, self.rule_id,
                f"blocking call {what!r} while holding guard(s) {locks} — "
                "every other execution context needing the guard stalls "
                "behind this IO; move the call outside the with block",
                SEV_WARN)
        g = _graph(ctx)
        for cyc in g.lock_cycles:
            site = g.cycle_sites.get(cyc)
            if site is None or site[0] != ctx.relpath:
                continue
            names = " -> ".join(
                f"{rel}:{(cls + '.' if cls else '') + name}"
                for rel, cls, name in cyc)
            yield Finding(
                ctx.relpath, site[1], self.rule_id,
                f"lock acquisition-order cycle: {names} -> (back) — two "
                "contexts acquiring in opposite order deadlock; impose "
                "one global order", SEV_ERROR)


class CommitOrdering(_ConcRule):
    """SL021 — inside a journaled verb function (Journal().begin/.commit),
    derived writes must sit in the begin→commit window: no commit before
    begin, no writer call after the commit, no writer call between the
    digest refresh and the commit (fsck would read the rewrite as
    corruption) unless the artifact is digest-skip-listed, and a begin
    must be matched by a commit somewhere in the function."""

    rule_id = "SL021"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        model = self._model(ctx)
        if model is None:
            return
        artifacts = getattr(ctx.project, "artifacts", None)
        for func, ent in sorted(model.journal_funcs.items()):
            begins, commits = ent["begin"], ent["commit"]
            if not begins:
                continue
            begin = min(begins)
            if not commits:
                yield Finding(
                    ctx.relpath, begin, self.rule_id,
                    f"{func} journals begin() but never commit()s — every "
                    "run of this verb replays on `sofa resume` forever; "
                    "commit after the last artifact (and digests) land",
                    self.severity)
                continue
            commit = max(commits)
            for c in commits:
                if c < begin:
                    yield Finding(
                        ctx.relpath, c, self.rule_id,
                        f"{func} commit()s at line {c} before its begin() "
                        f"at line {begin} — the journal window is "
                        "inverted; a crash between them is unrecoverable",
                        self.severity)
            digest = max((d for d in ent["digest"] if d <= commit),
                         default=None)
            for line, name in ent["writes"]:
                if line < begin or line > commit:
                    where = "before begin()" if line < begin \
                        else "after commit()"
                    yield Finding(
                        ctx.relpath, line, self.rule_id,
                        f"derived write{f' of {name!r}' if name else ''} "
                        f"{where} in journaled verb {func} — it is "
                        "outside the begin/commit window, so a crash "
                        "here leaves committed state that does not match "
                        "disk (the `sofa diff` bug class)", self.severity)
                elif digest is not None and digest < line <= commit and \
                        not _skip_listed(artifacts, name):
                    yield Finding(
                        ctx.relpath, line, self.rule_id,
                        f"derived write{f' of {name!r}' if name else ''} "
                        "after the digest refresh but before commit() — "
                        "the committed digests do not cover it; move the "
                        "write before write_digests or skip-list the "
                        "artifact", self.severity)


def _skip_listed(artifacts, name: str) -> bool:
    if not name or artifacts is None or not getattr(artifacts, "ok", False):
        return False
    return name in artifacts.skip_files


class ThreadContextSafety(_ConcRule):
    """SL022 — (a) ``signal.signal``/``os.chdir``/``os.fork`` from a
    function that runs in a thread/worker/handler context (signal
    handlers can only be installed on the main thread; chdir/fork mutate
    or snapshot process state under every other context's feet); (b)
    threads spawned at module import time — in real modules AND in the
    embedded injection templates, linted as virtual modules; (c) check-
    then-act on the ``_derived.writing`` sentinel outside trace.py
    (``derived_writing``/``reap_stale_sentinel`` own the liveness and
    staleness logic a raw exists()/unlink() race skips)."""

    rule_id = "SL022"
    severity = SEV_ERROR
    # trace.py IS the sentinel API; durability's fsck repairs it.
    _SENTINEL_OWNERS = ("trace.py",)

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        model = self._model(ctx)
        if model is None:
            return
        yield from self._check(ctx, model, offset=0, sup=None)
        g = _graph(ctx)
        for name, _line, vm in g.virtuals.get(ctx.relpath, ()):
            yield from self._check(ctx, vm, offset=vm.line_offset,
                                   sup=vm.suppressions, template=name)

    def _check(self, ctx: FileContext, model: _FileModel, offset: int,
               sup, template: str = "") -> Iterable[Finding]:
        tag = f" (in embedded template {template})" if template else ""

        def emit(vline: int, msg: str) -> Iterable[Finding]:
            f = Finding(ctx.relpath, vline + offset, self.rule_id,
                        msg + tag, self.severity)
            if sup is not None:
                shifted = Finding(ctx.relpath, vline, self.rule_id, "")
                if sup.hides(shifted):
                    return
            yield f

        for func, resolved, line in model.unsafe_calls:
            contexts = _ctx_of(model, func) if func else {CTX_MAIN}
            off_main = contexts - {CTX_MAIN}
            if not off_main:
                continue
            yield from emit(
                line,
                f"{resolved}() can run on a non-main execution context "
                f"({'/'.join(sorted(off_main))}) — signal handlers "
                "install only on the main thread, and chdir/fork mutate "
                "process state under every other context")
        for s in model.spawns:
            if s.func == "":
                yield from emit(
                    s.line,
                    f"{s.factory} spawned at module import time — "
                    "importing a module must not start threads (SL022); "
                    "arm it lazily from first use")
        for resolved, line in model.sentinel_races:
            if any(ctx.relpath.endswith(own)
                   for own in self._SENTINEL_OWNERS):
                continue
            yield from emit(
                line,
                f"check-then-act on the {_SENTINEL_LITERAL!r} sentinel "
                f"via {resolved}() — use trace.derived_writing / "
                "reap_stale_sentinel, which own the pid-liveness and "
                "staleness logic a raw file check races")


class ShutdownLiveness(_ConcRule):
    """SL023 — every spawned thread must be reachable from a stop path:
    a ``.join()`` on its binding (attribute join anywhere in the class,
    local join in the spawning function), or ownership transfer by
    returning the thread to the caller.  A daemon flag is NOT a stop
    path — the fleet daemon's threads must be stoppable, not merely
    abandonable.  Real modules only: the injection templates run inside
    the profiled process, whose watchers are daemon-by-contract."""

    rule_id = "SL023"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        model = self._model(ctx)
        if model is None:
            return
        joined_attrs = self._joined_attrs(model)
        for s in model.spawns:
            if s.func == "":
                continue  # module-level spawns are SL022's finding
            if s.binding_kind == "attr":
                if (s.cls, s.binding) in joined_attrs:
                    continue
            elif s.binding_kind == "local":
                if self._local_has_stop(model, s):
                    continue
            where = (f"self.{s.binding}" if s.binding_kind == "attr"
                     else s.binding or "the spawned thread")
            yield Finding(
                ctx.relpath, s.line, self.rule_id,
                f"{s.factory} bound to {where} has no reachable stop "
                "path — no .join() on the binding and no ownership "
                "transfer; a shutdown leaves it running (the fleet-"
                "daemon liveness invariant)", self.severity)

    def _joined_attrs(self, model: _FileModel) -> Set[Tuple[str, str]]:
        out: Set[Tuple[str, str]] = set()
        for node in ast.walk(model.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "join":
                recv = node.func.value
                if isinstance(recv, ast.Attribute) and \
                        isinstance(recv.value, ast.Name) and \
                        recv.value.id == "self":
                    func = model.func_of.get(id(node), "")
                    out.add((model.class_of.get(func, ""), recv.attr))
        return out

    def _local_has_stop(self, model: _FileModel, s: SpawnSite) -> bool:
        funcdef = model.functions.get(s.func)
        if funcdef is None:
            return False
        for node in ast.walk(funcdef):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                if node.func.attr in ("join", "cancel") and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id == s.binding:
                    return True
                # registered into a module-level registry that some code
                # in this module cancels/joins (the faults._TIMERS idiom)
                if node.func.attr == "append" and \
                        isinstance(node.func.value, ast.Name) and \
                        node.func.value.id in model.module_globals and \
                        node.args and isinstance(node.args[0], ast.Name) \
                        and node.args[0].id == s.binding and \
                        self._module_cancels(model):
                    return True
            if isinstance(node, ast.Return) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == s.binding:
                return True  # ownership transferred to the caller
        return False

    @staticmethod
    def _module_cancels(model: _FileModel) -> bool:
        for node in ast.walk(model.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("cancel", "join"):
                return True
        return False


CONCURRENCY_RULES = (
    UndeclaredSharedState,
    BlockingUnderGuard,
    CommitOrdering,
    ThreadContextSafety,
    ShutdownLiveness,
)
