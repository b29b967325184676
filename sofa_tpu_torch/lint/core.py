"""The sofa-lint engine: one AST pass per file, rule dispatch by node type.

Design notes
------------

* **Single pass.**  Every rule declares the node types it cares about
  (``node_types``); the engine walks each module AST exactly once and
  dispatches nodes to interested rules.  Rules are stateless across files —
  per-file scratch state lives on the :class:`FileContext`.
* **Static only.**  The engine never imports the code it checks.  Project
  facts the rules need (the unified trace schema) are extracted from
  ``trace.py``'s AST, so linting works on a tree that does not even import
  (and costs no pandas/torch startup).
* **Suppressions.**  ``# sofa-lint: disable=SL001[,SL002]`` on the flagged
  line silences those rules for that line; ``# sofa-lint: disable-file=SL001``
  anywhere silences them for the whole file; ``all`` matches every rule.
  Comments are found with :mod:`tokenize`, so a string literal that merely
  *contains* the marker does not suppress anything.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type

SEV_ERROR = "error"
SEV_WARN = "warn"

#: Rule id reserved for files the engine itself cannot parse.
PARSE_RULE_ID = "SL000"

_DISABLE_RE = re.compile(
    r"sofa-lint:\s*(?P<scope>disable-file|disable)\s*=\s*"
    r"(?P<rules>(?:all|SL\d+)(?:\s*,\s*(?:all|SL\d+))*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file:line."""

    file: str
    line: int
    rule_id: str
    message: str
    severity: str = SEV_ERROR

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.rule_id} "
                f"[{self.severity}] {self.message}")

    def to_dict(self) -> dict:
        return {"file": self.file, "line": self.line, "rule": self.rule_id,
                "severity": self.severity, "message": self.message}


@dataclass(frozen=True)
class PassDecl:
    """One ``@analysis_pass(...)`` or ``@fleet_pass(...)`` declaration,
    read straight from the AST (never by importing): the cross-file facts
    SL010–SL013 verify pass bodies and the dependency graph against.
    ``domain`` separates the two registries — per-run analysis passes
    read trace frames, fleet passes read archive-index column families —
    and the graph rules refuse edges that cross it."""

    name: str
    func: str
    relpath: str
    line: int
    domain: str = "analysis"
    reads_frames: tuple = ()
    reads_columns: tuple = ()
    reads_features: tuple = ()
    provides_features: tuple = ()
    provides_artifacts: tuple = ()
    provides_series: bool = False
    after: tuple = ()
    enabled_when: tuple = ()


@dataclass
class ProjectContext:
    """Cross-file facts rules consult (kept deliberately small)."""

    #: The unified trace schema (trace.COLUMNS), extracted from the AST of
    #: trace.py — empty set disables the schema-drift rule.
    columns: frozenset = frozenset()
    #: Every @analysis_pass / @fleet_pass declaration in the linted tree
    #: (pass_rules.py) — PassDecl.domain tells them apart.
    passes: tuple = ()
    #: Pinned archive-index family schemas as "family.column" strings,
    #: extracted from the AST of archive/index.py — empty set disables
    #: the fleet-domain column checks.
    index_columns: frozenset = frozenset()
    #: AMBIENT_FEATURES from analysis/registry.py — features the analyze
    #: verb provides without a producing pass.
    ambient_features: tuple = ()
    #: The artifact-lifecycle flow graph (lint/artifact_rules.py) —
    #: None/inactive unless the linted set carries a registry-bearing
    #: record.py, so fixtures and single-file lints skip SL014–SL018.
    artifacts: object = None
    #: The concurrency/execution-context graph (lint/concurrency_rules.py)
    #: — None/inactive when the context is built by hand (fixture
    #: isolation), so SL019–SL023 only run under detect().
    concurrency: object = None
    #: The client<->server protocol graph (lint/protocol_rules.py) —
    #: None/inactive unless the linted set carries a STATUS_ERRORS
    #: vocabulary module, so SL024–SL028 only fire on protocol trees.
    protocol: object = None

    @classmethod
    def detect(cls, files: Sequence[str],
               base: Optional[str] = None) -> "ProjectContext":
        """Build the context from the tree being linted: find a trace.py
        declaring BASE_COLUMNS/EXTRA_COLUMNS and read the literals out of
        its AST (falling back to this package's own trace.py, never the
        JAX package's, so linting a single file still knows the schema), collect every
        ``@analysis_pass`` / ``@fleet_pass`` declaration, read
        AMBIENT_FEATURES from the registry module, and the index family
        schemas from archive/index.py.  ``base`` must match the relpath
        anchor the engine uses so declarations join up with
        FileContext.relpath."""
        candidates = [f for f in files if os.path.basename(f) == "trace.py"]
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        here = os.path.join(pkg, "trace.py")
        if os.path.isfile(here):
            candidates.append(here)
        columns: frozenset = frozenset()
        for cand in candidates:
            cols = _columns_from_trace(cand)
            if cols:
                columns = frozenset(cols)
                break
        passes: List[PassDecl] = []
        base = os.path.abspath(base or os.getcwd())
        for f in files:
            ab = os.path.abspath(f)
            rel = (os.path.relpath(ab, base)
                   if ab.startswith(base + os.sep) else ab)
            passes.extend(_pass_decls_from_file(f, rel.replace(os.sep, "/")))
        ambient = ()
        reg_candidates = [f for f in files
                          if os.path.basename(f) == "registry.py"]
        reg_candidates.append(os.path.join(pkg, "analysis", "registry.py"))
        for cand in reg_candidates:
            ambient = _ambient_from_registry(cand)
            if ambient:
                break
        index_columns: frozenset = frozenset()
        idx_candidates = [f for f in files
                          if os.path.basename(f) == "index.py"]
        idx_candidates.append(os.path.join(pkg, "archive", "index.py"))
        for cand in idx_candidates:
            cols = _index_columns_from_archive(cand)
            if cols:
                index_columns = frozenset(cols)
                break
        from sofa_tpu_torch.lint.artifact_rules import build_artifact_graph
        from sofa_tpu_torch.lint.concurrency_rules import build_concurrency_graph
        from sofa_tpu_torch.lint.protocol_rules import build_protocol_graph

        artifacts = build_artifact_graph(files, base=base,
                                         passes=tuple(passes))
        concurrency = build_concurrency_graph(files, base=base)
        protocol = build_protocol_graph(files, base=base)
        return cls(columns=columns, passes=tuple(passes),
                   ambient_features=ambient, index_columns=index_columns,
                   artifacts=artifacts, concurrency=concurrency,
                   protocol=protocol)


def _columns_from_trace(path: str) -> List[str]:
    try:
        with open(path, "rb") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError, ValueError):
        return []
    lists: Dict[str, List[str]] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if tgt.id in ("BASE_COLUMNS", "EXTRA_COLUMNS") and \
                isinstance(node.value, ast.List):
            vals = [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)]
            lists[tgt.id] = vals
    return lists.get("BASE_COLUMNS", []) + lists.get("EXTRA_COLUMNS", [])


def _ambient_from_registry(path: str) -> tuple:
    """AMBIENT_FEATURES literal out of analysis/registry.py's AST."""
    try:
        with open(path, "rb") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError, ValueError):
        return ()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "AMBIENT_FEATURES" \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return tuple(e.value for e in node.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str))
    return ()


#: Index schema constant -> family name (mirrors index.FAMILIES; kept as
#: a literal map so the extractor stays import-free like the rest).
_INDEX_FAMILY_CONSTS = {"CATALOG_COLUMNS": "catalog",
                        "RUNS_COLUMNS": "runs",
                        "FEATURE_COLUMNS": "features"}


def _index_columns_from_archive(path: str) -> List[str]:
    """Pinned "family.column" strings out of archive/index.py's AST."""
    try:
        with open(path, "rb") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError, ValueError):
        return []
    out: List[str] = []
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name) and tgt.id in _INDEX_FAMILY_CONSTS \
                and isinstance(node.value, ast.List):
            family = _INDEX_FAMILY_CONSTS[tgt.id]
            out.extend(f"{family}.{e.value}" for e in node.value.elts
                       if isinstance(e, ast.Constant)
                       and isinstance(e.value, str))
    return out


def _str_tuple(node) -> tuple:
    """String literals out of a tuple/list AST literal (non-literals and
    non-strings are dropped — the runtime registry rejects those loudly)."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
    return ()


#: Decorator name -> registry domain a declaration belongs to.
_PASS_DECORATORS = {"analysis_pass": "analysis", "fleet_pass": "fleet"}


def _pass_decls_from_file(path: str, relpath: str) -> List[PassDecl]:
    """Every ``@analysis_pass(...)`` / ``@fleet_pass(...)`` (bare or
    attribute-qualified) in one file, contracts read as literals.  Purely
    syntactic — a decorator of either name is treated as a pass
    declaration wherever it appears."""
    try:
        with open(path, "rb") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError, ValueError):
        return []
    out: List[PassDecl] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for deco in node.decorator_list:
            if not isinstance(deco, ast.Call):
                continue
            fn = deco.func
            deco_name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            if deco_name not in _PASS_DECORATORS:
                continue
            kw = {k.arg: k.value for k in deco.keywords if k.arg}
            name_node = kw.get("name")
            name = (name_node.value
                    if isinstance(name_node, ast.Constant)
                    and isinstance(name_node.value, str) else node.name)
            series_node = kw.get("provides_series")
            out.append(PassDecl(
                name=name, func=node.name, relpath=relpath,
                line=deco.lineno, domain=_PASS_DECORATORS[deco_name],
                reads_frames=_str_tuple(kw.get("reads_frames")),
                reads_columns=_str_tuple(kw.get("reads_columns")),
                reads_features=_str_tuple(kw.get("reads_features")),
                provides_features=_str_tuple(kw.get("provides_features")),
                provides_artifacts=_str_tuple(kw.get("provides_artifacts")),
                provides_series=bool(
                    isinstance(series_node, ast.Constant)
                    and series_node.value),
                after=_str_tuple(kw.get("after")),
                enabled_when=_str_tuple(kw.get("enabled_when")),
            ))
    return out


class FileContext:
    """Per-file state handed to rules: source, AST, parents, import map."""

    def __init__(self, relpath: str, src: str, tree: ast.Module,
                 project: ProjectContext):
        self.relpath = relpath.replace(os.sep, "/")
        self.src = src
        self.lines = src.splitlines()
        self.tree = tree
        self.project = project
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        # alias -> module ("sp" -> "subprocess"); name -> dotted origin
        # ("run" -> "subprocess.run") for from-imports.
        self.import_alias: Dict[str, str] = {}
        self.from_import: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.import_alias[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_import[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    # -- helpers rules lean on --------------------------------------------
    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_stmt(self, node: ast.AST) -> Optional[ast.stmt]:
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = self.parents.get(cur)
        return cur

    def stmt_source(self, node: ast.AST) -> str:
        stmt = self.enclosing_stmt(node)
        if stmt is None:
            return self.line_text(getattr(node, "lineno", 0))
        return ast.get_source_segment(self.src, stmt) or \
            self.line_text(stmt.lineno)

    def resolve_call(self, node: ast.Call) -> Optional[str]:
        """Dotted origin of a call through the file's import aliases:
        ``sp.run`` -> "subprocess.run", bare ``run`` (from-imported) ->
        "subprocess.run", plain builtins -> their own name."""
        return self.resolve_name(node.func)

    def resolve_name(self, func: ast.expr) -> Optional[str]:
        if isinstance(func, ast.Name):
            return self.from_import.get(func.id,
                                        self.import_alias.get(func.id,
                                                              func.id))
        if isinstance(func, ast.Attribute):
            parts: List[str] = [func.attr]
            cur = func.value
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                base = self.import_alias.get(cur.id,
                                             self.from_import.get(cur.id,
                                                                  cur.id))
                parts.append(base)
                return ".".join(reversed(parts))
        return None


class Rule:
    """Base rule.  Subclasses set ``rule_id``/``severity``/``node_types``
    and implement :meth:`visit`; optional :meth:`finish` runs once per file
    after the walk (for module-level checks)."""

    rule_id = ""
    severity = SEV_ERROR
    #: AST node classes this rule wants to see; () = finish()-only rule.
    node_types: Tuple[Type[ast.AST], ...] = ()
    #: relpath fragments (``/``-separated) exempting a whole file.
    exempt_files: Tuple[str, ...] = ()

    def applies(self, ctx: FileContext) -> bool:
        return not any(_path_matches(ctx.relpath, pat)
                       for pat in self.exempt_files)

    def visit(self, ctx: FileContext, node: ast.AST) -> Iterable[Finding]:
        return ()

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(ctx.relpath, getattr(node, "lineno", 0),
                       self.rule_id, message, self.severity)


def _path_matches(relpath: str, pat: str) -> bool:
    """True when ``pat`` names this file (suffix match on /-separated
    fragments: "collectors/base.py" matches
    "sofa_tpu_torch/collectors/base.py",
    "ingest/" matches any file under an ingest directory)."""
    if pat.endswith("/"):
        return f"/{pat}" in f"/{relpath}"
    return relpath == pat or relpath.endswith("/" + pat)


@dataclass
class _Suppressions:
    by_line: Dict[int, set] = field(default_factory=dict)
    whole_file: set = field(default_factory=set)

    def hides(self, f: Finding) -> bool:
        for scope in (self.whole_file, self.by_line.get(f.line, ())):
            if "all" in scope or f.rule_id in scope:
                return True
        return False


def _scan_suppressions(src: str) -> _Suppressions:
    sup = _Suppressions()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _DISABLE_RE.search(tok.string)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        if m.group("scope") == "disable-file":
            sup.whole_file |= rules
        else:
            sup.by_line.setdefault(tok.start[0], set()).update(rules)
    return sup


class LintEngine:
    """Run a rule set over files; one AST walk per file."""

    def __init__(self, rules: Sequence[Rule], project: ProjectContext):
        self.rules = list(rules)
        self.project = project
        self._by_type: Dict[Type[ast.AST], List[Rule]] = {}
        for rule in self.rules:
            for nt in rule.node_types:
                self._by_type.setdefault(nt, []).append(rule)

    def lint_file(self, path: str, relpath: str) -> List[Finding]:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                src = f.read()
        except OSError as e:
            return [Finding(relpath, 0, PARSE_RULE_ID,
                            f"cannot read file: {e}")]
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            return [Finding(relpath, e.lineno or 0, PARSE_RULE_ID,
                            f"syntax error: {e.msg}")]
        ctx = FileContext(relpath, src, tree, self.project)
        active = [r for r in self.rules if r.applies(ctx)]
        if not active:
            return []
        active_set = set(map(id, active))
        findings: List[Finding] = []
        for node in ast.walk(tree):
            for rule in self._by_type.get(type(node), ()):
                if id(rule) in active_set:
                    findings.extend(rule.visit(ctx, node))
        for rule in active:
            findings.extend(rule.finish(ctx))
        if findings:
            sup = _scan_suppressions(src)
            findings = [f for f in findings if not sup.hides(f)]
        return findings


def iter_python_files(paths: Sequence[str]) -> List[str]:
    """Expand files/dirs into a sorted .py file list (skips caches and
    hidden dirs; deterministic order keeps baselines reproducible)."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
    seen, uniq = set(), []
    for f in out:
        key = os.path.abspath(f)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


def lint_paths(paths: Sequence[str], rules: Sequence[Rule],
               project: Optional[ProjectContext] = None,
               base: Optional[str] = None, jobs: int = 1) -> List[Finding]:
    """Lint files/directories; findings sorted by (file, line, rule).

    ``base`` anchors the relpaths findings (and baseline fingerprints) are
    keyed on — defaults to the current directory, matching the
    ``python -m sofa_tpu_torch lint sofa_tpu_torch/`` invocation from the
    repo root.
    ``jobs`` > 1 fans the per-file walks across a thread pool (rules keep
    per-file scratch on the FileContext and read the project graphs
    read-only, so files are independent); results keep file order and the
    final sort makes the report byte-identical at any pool width.
    """
    files = iter_python_files(paths)
    base = os.path.abspath(base or os.getcwd())
    if project is None:
        project = ProjectContext.detect(files, base=base)
    engine = LintEngine(rules, project)

    def rel_of(f: str) -> str:
        ab = os.path.abspath(f)
        return os.path.relpath(ab, base) if ab.startswith(base + os.sep) \
            else ab

    findings: List[Finding] = []
    if jobs > 1 and len(files) > 1:
        from sofa_tpu_torch.pool import thread_map

        for per_file in thread_map(
                lambda f: engine.lint_file(f, rel_of(f)), files, jobs):
            findings.extend(per_file)
    else:
        for f in files:
            findings.extend(engine.lint_file(f, rel_of(f)))
    findings.sort(key=lambda f: (f.file, f.line, f.rule_id))
    return findings
