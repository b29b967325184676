"""SL014–SL018 — artifact-lifecycle flow analysis.

The port answers "what is a logdir artifact" in several hand-maintained
places: the registry in ``record.py`` (RAW_FILES, ANALYSIS_FILES,
VERB_FILES, DERIVED_DIRS and the digest skip-lists), the numbered raw
names and raw directories in ``durability.py`` (RAW_PATTERNS, RAW_DIRS),
the frames ``preprocess.py``'s ingest task table declares, the staged
board pages, ``clean``'s sweep, fsck's classification, and
``tools/manifest_check.py``'s validators — plus board pages that fetch
endpoints by string literal.  Every new artifact has to be threaded
through all of them; an omission is a silent fsck blind spot or a file
``clean`` never removes.

This module extracts the whole artifact flow graph statically — writers
(filename literals flowing into ``durability.atomic_write`` /
``atomic_replace`` / ``fsync_append`` / the frame-CSV writers), readers
(logdir ``open``/``read_csv`` sites), the registries, the meta.* keys the
manifest carries, schema-id/version literals, and the ``fetch()``
endpoints in ``board/*.html`` — and enforces closure:

SL014  artifact written but registered nowhere (not in ANALYSIS_FILES /
       VERB_FILES, not a frame CSV or board page, not under a
       DERIVED_DIRS directory): it leaks past ``clean``
SL015  digest skip-list closure: a skip entry naming nothing registered
       (typo'd blind spot), a skip dir outside DERIVED_DIRS, or an
       artifact rewritten by a verb that never refreshes digests yet is
       not skip-listed (fsck would flag every re-run as corrupt)
SL016  manifest ``meta.*`` key written but never validated by
       manifest_check — or validated but never written (both directions
       of schema drift)
SL017  board fetch endpoint with no producer or server route (error);
       registered machine-readable artifact with no reader anywhere
       (dead artifact, warn)
SL018  schema-id/version literal agreement between writers, the
       manifest_check validator, and docs/OBSERVABILITY.md's schema
       registry table

The frame names are read out of ``_ingest_tasks``'s ``T(...)``
declarations (a literal name, a name bound by a ``for`` over a literal
table, or ``frames=`` a ``*_FRAMES`` tuple): ``preprocess.frame_names()``
is a runtime call, and the checker imports nothing.  The graph is also the
data model behind the ``artifacts`` inventory verb
(sofa_tpu_torch/artifacts.py).  The companions live inside the package:
``tools/manifest_check.py``, ``board/`` and ``docs/OBSERVABILITY.md``
beside the registry's record.py; absent companions disable exactly the
rules that need them, so fixture trees opt in per rule.  Schema ids keep
the ``sofa_tpu/<name>`` form: the port writes the JAX package's ids, so
its documents stay readable by either side.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Dict, Iterable, List, Optional, Tuple

from sofa_tpu_torch.lint.core import (
    FileContext,
    Finding,
    Rule,
    SEV_ERROR,
    SEV_WARN,
)

# Path-taking writer helpers: dotted-origin tail -> index of the path arg.
_WRITER_FNS = {
    "atomic_write": 0,
    "atomic_replace": 0,
    "fsync_append": 0,
    "write_csv": 1,
    "write_frame": 1,
    "write_report_js_doc": 1,
}
# DataFrame writer methods whose first argument is the target path.
_WRITER_METHODS = frozenset({"to_csv", "to_parquet"})

_READER_FNS = frozenset({"open", "io.open", "gzip.open"})
_READER_METHODS = frozenset({"read_csv", "read_parquet", "read_json",
                             "read_frame", "DictReader", "loadtxt"})

_SCHEMA_ID_RE = re.compile(r"^sofa_tpu/[a-z_]+$")
_FILENAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*\.[A-Za-z0-9.]+$")
# Data-ish literals in board pages: fetch()/fetchCSV() args, script srcs,
# and the [id, "file.csv"] table idiom.
_BOARD_REF_RE = re.compile(
    r'["\']([A-Za-z0-9_][A-Za-z0-9_./-]*'
    r'\.(?:csv|json|jsonl|js|txt|json\.gz))["\']'
    r'|(?:fetch|fetchCSV)\(\s*["\']([^"\']+)["\']')
_DOCS_ROW_RE = re.compile(
    r"^\|\s*`?(sofa_tpu/[a-z_]+)`?\s*\|\s*(\d+)\s*\|")
# Suffixes SL017's dead-artifact check covers: machine-readable formats a
# reader should exist for.  Human reports (.txt) are end artifacts.
_MACHINE_SUFFIXES = (".js", ".json", ".jsonl", ".csv")


@dataclass(frozen=True)
class Writer:
    """One path-literal-carrying write site."""

    relpath: str
    line: int
    name: str            # the artifact filename literal
    fragments: tuple     # every path-fragment literal seen in the call


@dataclass(frozen=True)
class MetaKey:
    key: str
    relpath: str
    line: int


@dataclass(frozen=True)
class SchemaDecl:
    schema_id: str
    version: "int | None"
    relpath: str
    line: int


@dataclass
class ArtifactGraph:
    """The cross-file artifact flow facts SL014–SL018 (and the
    ``artifacts`` verb) consult.  ``ok`` is False when the linted file set
    carries no registry-bearing record.py — every artifact rule is then
    inert, which is what lets single-file lints and synthetic fixtures
    run the classic rules without artifact noise."""

    ok: bool = False
    registry_relpath: str = ""
    registry_lines: Dict[tuple, int] = field(default_factory=dict)
    raw_files: frozenset = frozenset()
    raw_patterns: tuple = ()
    raw_dirs: frozenset = frozenset()
    root_files: frozenset = frozenset()
    derived_files: frozenset = frozenset()
    derived_dirs: frozenset = frozenset()
    skip_files: frozenset = frozenset()
    skip_dirs: frozenset = frozenset()
    writers: tuple = ()
    reader_names: frozenset = frozenset()
    board_present: bool = False
    board_files: frozenset = frozenset()
    board_fetches: tuple = ()          # (relpath, line, endpoint)
    routes: frozenset = frozenset()    # route heads viz.py serves
    meta_writes: tuple = ()            # MetaKey
    meta_validated: "tuple | None" = None   # MetaKey; None = no validator
    schema_writers: tuple = ()         # SchemaDecl
    schema_validators: tuple = ()      # SchemaDecl (manifest_check)
    manifest_check_refs: frozenset = frozenset()
    docs_versions: "Dict[str, tuple] | None" = None  # id -> (ver, rel, line)
    docs_relpath: str = ""
    pass_artifacts: frozenset = frozenset()
    frame_names: frozenset = frozenset()
    loose_writer_names: frozenset = frozenset()
    digestless_verb_files: frozenset = frozenset()

    # -- coverage helpers (shared with `artifacts`) ------------------------
    def frame_files(self) -> frozenset:
        """The frame CSVs and Parquet files preprocess writes."""
        return frozenset({f"{n}.csv" for n in self.frame_names}
                         | {f"{n}.parquet" for n in self.frame_names})

    def clean_coverage(self, name: str, fragments: Tuple[str, ...] = ()) \
            -> "str | None":
        """How ``clean`` accounts for this artifact, or None if it would
        leak.  The same decision procedure record.sofa_clean runs at sweep
        time (record.derived_names() and DERIVED_DIRS), evaluated
        statically; raw files (RAW_FILES, durability's numbered
        RAW_PATTERNS, anything under a RAW_DIRS directory) are kept, and
        the roots' ledgers (ROOT_FILES) live where no sweep goes."""
        if name in self.raw_files or any(
                fnmatchcase(name, pat) for pat in self.raw_patterns):
            return "raw"
        if name in self.derived_files:
            return "registered"
        if name in self.frame_files():
            return "frame"
        if name in self.board_files:
            return "board"
        if name in self.root_files:
            return "root"
        for frag in fragments:
            parts = frag.replace(os.sep, "/").split("/")
            if parts and parts[0] in self.raw_dirs:
                return f"raw:{parts[0]}"
            for part in parts:
                if part in self.derived_dirs:
                    return f"dir:{part}"
                if part in self.skip_dirs:
                    return f"dir:{part}"
        return None

    def digest_coverage(self, name: str,
                        fragments: Tuple[str, ...] = ()) -> str:
        if name in self.skip_files:
            return "skip-list"
        for frag in fragments:
            for part in frag.replace(os.sep, "/").split("/"):
                if part in self.skip_dirs:
                    return f"skip-dir:{part}"
        return "digested"

    def endpoint_producers(self) -> frozenset:
        return frozenset(
            set(self.derived_files) | set(self.raw_files)
            | {w.name for w in self.writers} | set(self.pass_artifacts)
            | set(self.frame_files())
            | set(self.loose_writer_names) | set(self.board_files))

    def reader_set(self) -> frozenset:
        board = {os.path.basename(ep) for _f, _l, ep in self.board_fetches}
        return frozenset(set(self.reader_names) | board
                         | set(self.manifest_check_refs))


# ---------------------------------------------------------------------------
# Per-file extraction.
# ---------------------------------------------------------------------------

class _ModuleFacts:
    """Everything one parse of one .py file contributes to the graph."""

    def __init__(self, path: str, relpath: str):
        self.relpath = relpath
        self.writers: List[Writer] = []
        self.reader_names: set = set()
        self.meta_writes: List[MetaKey] = []
        self.schema_decls: List[SchemaDecl] = []
        self.str_consts: Dict[str, str] = {}
        self.int_consts: Dict[str, int] = {}
        self.has_verb = False
        self.has_dynamic_writer = False
        self.refreshes_digests = False
        self.verb_funcs: set = set()
        self.frame_names: set = set()
        self.route_heads: set = set()
        self.filename_literals: set = set()
        try:
            with open(path, "rb") as f:
                self.tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError, ValueError):
            self.tree = None
            return
        self._imports()
        self._module_consts()
        self._scopes()

    def _imports(self):
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

    def _module_consts(self):
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
            elif isinstance(v, (ast.Tuple, ast.List)) and \
                    tgt.id.endswith("_FRAMES"):
                # e.g. preprocess._XPLANE_FRAMES — frame-name vocabulary
                self.frame_names.update(
                    e.value for e in v.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))

    def _scopes(self):
        """function-scope single-target assigns: name -> value expression
        (resolves ``hints_dir = cfg.path("x")`` and ``path =
        os.path.join(logdir, JOURNAL_NAME)`` when the name later rides a
        writer's or reader's path argument)."""
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

    # -- resolution --------------------------------------------------------
    def resolve_call_name(self, node: ast.Call) -> str:
        fn = node.func
        if isinstance(fn, ast.Name):
            return self.from_import.get(fn.id,
                                        self.import_alias.get(fn.id, fn.id))
        if isinstance(fn, ast.Attribute):
            parts = [fn.attr]
            cur = fn.value
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                parts.append(self.import_alias.get(
                    cur.id, self.from_import.get(cur.id, cur.id)))
            return ".".join(reversed(parts))
        return ""

    def path_fragments(self, expr, func: str,
                       cross: Dict[tuple, str],
                       _depth: int = 0, _seen=None) -> List[str]:
        """Every string literal reachable from a path expression: direct
        constants, names resolved through enclosing-scope assignments
        (recursively, so ``a = join(b, CONST)`` chains resolve), module
        constants, and cross-module from-imports."""
        out: List[str] = []
        seen = _seen if _seen is not None else set()
        if _depth > 4:
            return out
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                out.append(sub.value)
            elif isinstance(sub, ast.Name):
                name = sub.id
                if name in seen:
                    continue
                seen.add(name)
                if name in self.str_consts:
                    out.append(self.str_consts[name])
                    continue
                scope, hit = func, None
                while hit is None:
                    hit = self.scope_assigns.get((scope, name))
                    if not scope:
                        break
                    scope = scope.rpartition(".")[0]
                if hit is not None:
                    out.extend(self.path_fragments(
                        hit, func, cross, _depth + 1, seen))
                elif name in self.from_import:
                    origin = self.from_import[name]
                    mod, _, attr = origin.rpartition(".")
                    val = cross.get((mod.rpartition(".")[-1], attr))
                    if val is not None:
                        out.append(val)
        return out

    # -- the walk ----------------------------------------------------------
    def _task_loop_names(self) -> Dict[str, set]:
        """Names a ``for`` inside ``_ingest_tasks`` binds from a literal
        table (``for name, raw, parser in (("mpstat", ...), ...)``): each
        name -> the string literals it takes, so ``T(name, ...)`` in the
        loop body declares every one of them."""
        out: Dict[str, set] = {}
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.For)
                    and "_ingest_tasks" in self.func_of.get(id(node), "")
                    and isinstance(node.iter, (ast.Tuple, ast.List))):
                continue
            tgt = node.target
            names = ([tgt] if isinstance(tgt, ast.Name) else
                     list(tgt.elts) if isinstance(tgt, ast.Tuple) else [])
            for i, n in enumerate(names):
                if not isinstance(n, ast.Name):
                    continue
                for row in node.iter.elts:
                    val = row if isinstance(tgt, ast.Name) else (
                        row.elts[i] if isinstance(row, ast.Tuple)
                        and len(row.elts) > i else None)
                    if isinstance(val, ast.Constant) and \
                            isinstance(val.value, str):
                        out.setdefault(n.id, set()).add(val.value)
        return out

    def harvest(self, cross: Dict[tuple, str]):
        if self.tree is None:
            return
        in_ingest_tasks = False
        loop_names = self._task_loop_names()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.FunctionDef) and \
                    node.name.startswith("sofa_") and \
                    self.func_of.get(id(node), "") == node.name:
                self.has_verb = True
                self.verb_funcs.add(node.name)
            if not isinstance(node, ast.Call):
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str) and \
                        _FILENAME_RE.match(node.value):
                    self.filename_literals.add(node.value)
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str) and \
                        re.match(r"^/[a-z_]+/$", node.value):
                    self.route_heads.add(node.value.strip("/"))
                continue
            func = self.func_of.get(id(node), "")
            resolved = self.resolve_call_name(node)
            tail = resolved.rsplit(".", 1)[-1]
            if tail == "write_digests":
                self.refreshes_digests = True
            # preprocess's ingest task table: T("source", ..., frames=...);
            # a task without frames= produces the frame of its own name
            if tail == "T" and "_ingest_tasks" in func and node.args:
                arg0 = node.args[0]
                names: set = set()
                if isinstance(arg0, ast.Constant) and \
                        isinstance(arg0.value, str):
                    names = {arg0.value}
                elif isinstance(arg0, ast.Name):
                    names = loop_names.get(arg0.id, set())
                frames_kw = [kw.value for kw in node.keywords
                             if kw.arg == "frames"]
                if frames_kw:
                    self.frame_names.update(
                        s.value for s in ast.walk(frames_kw[0])
                        if isinstance(s, ast.Constant)
                        and isinstance(s.value, str))
                else:
                    self.frame_names.update(names)
                in_ingest_tasks = True
            # meta.* writers
            if tail == "set_meta" and isinstance(node.func, ast.Attribute):
                for kw in node.keywords:
                    if kw.arg:
                        self.meta_writes.append(
                            MetaKey(kw.arg, self.relpath, node.lineno))
            if tail == "_patch_manifest":
                for kw in node.keywords:
                    if kw.arg == "meta" and isinstance(kw.value, ast.Dict):
                        for k in kw.value.keys:
                            if isinstance(k, ast.Constant) and \
                                    isinstance(k.value, str):
                                self.meta_writes.append(MetaKey(
                                    k.value, self.relpath, k.lineno))
            # writers
            arg_idx = _WRITER_FNS.get(tail)
            is_method_writer = (isinstance(node.func, ast.Attribute)
                                and node.func.attr in _WRITER_METHODS)
            if arg_idx is not None or is_method_writer:
                idx = 0 if is_method_writer else arg_idx
                if len(node.args) > idx:
                    frags = self.path_fragments(node.args[idx], func, cross)
                    names = [os.path.basename(f) for f in frags
                             if _FILENAME_RE.match(os.path.basename(f))]
                    if names:
                        self.writers.append(Writer(
                            self.relpath, node.lineno, names[-1],
                            tuple(frags)))
                    else:
                        # a write whose path arrives via a parameter (the
                        # diff movers-table helper): the module's own
                        # filename literals become producers-by-
                        # association for the endpoint check only
                        self.has_dynamic_writer = True
            # readers
            is_reader = resolved in _READER_FNS or tail in _READER_METHODS
            if resolved in _READER_FNS:
                mode = None
                if len(node.args) >= 2 and \
                        isinstance(node.args[1], ast.Constant):
                    mode = node.args[1].value
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value,
                                                       ast.Constant):
                        mode = kw.value.value
                if isinstance(mode, str) and any(m in mode for m in "wax"):
                    is_reader = False
            if is_reader and node.args:
                for f in self.path_fragments(node.args[0], func, cross):
                    base = os.path.basename(f)
                    if _FILENAME_RE.match(base):
                        self.reader_names.add(base)
        if in_ingest_tasks:
            self.frame_names.discard("")

    def schema_literals(self):
        for name, value in self.str_consts.items():
            if not _SCHEMA_ID_RE.match(value):
                continue
            version = None
            if name.endswith("_SCHEMA"):
                version = self.int_consts.get(name[:-7] + "_VERSION")
            line = 0
            for node in self.tree.body:
                if isinstance(node, ast.Assign) and \
                        isinstance(node.targets[0], ast.Name) and \
                        node.targets[0].id == name:
                    line = node.lineno
            self.schema_decls.append(
                SchemaDecl(value, version, self.relpath, line))


# ---------------------------------------------------------------------------
# Registry + companion extraction.
# ---------------------------------------------------------------------------

def _literal_tables(path: str) -> "Dict[str, List[tuple]] | None":
    """Every module-level string table (list, tuple, set, frozenset of
    literals) out of one file's AST, with per-entry line numbers."""
    try:
        with open(path, "rb") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError, ValueError):
        return None
    tables: Dict[str, List[tuple]] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        v = node.value
        elts = None
        if isinstance(v, (ast.List, ast.Tuple, ast.Set)):
            elts = v.elts
        elif isinstance(v, ast.Call) and isinstance(v.func, ast.Name) \
                and v.func.id == "frozenset" and v.args and \
                isinstance(v.args[0], (ast.Set, ast.List, ast.Tuple)):
            elts = v.args[0].elts
        if elts is None:
            continue
        tables[tgt.id] = [(e.value, e.lineno) for e in elts
                          if isinstance(e, ast.Constant)
                          and isinstance(e.value, str)]
    return tables


def _registry_from_record(path: str):
    """The lifecycle tables out of record.py's AST.  Returns None when the
    file does not declare ANALYSIS_FILES (not the registry-bearing
    record.py)."""
    tables = _literal_tables(path)
    if tables is None or "ANALYSIS_FILES" not in tables:
        return None
    return tables


def _board_facts(board_dir: str, base: str):
    files, fetches = set(), []
    for name in sorted(os.listdir(board_dir)):
        if not name.endswith((".html", ".js", ".css")):
            continue
        files.add(name)
        path = os.path.join(board_dir, name)
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                src = f.read()
        except OSError:
            continue
        rel = os.path.relpath(os.path.abspath(path), base)
        rel = rel.replace(os.sep, "/") if not rel.startswith("..") \
            else os.path.abspath(path)
        for i, line in enumerate(src.splitlines(), 1):
            for m in _BOARD_REF_RE.finditer(line):
                ep = m.group(1) or m.group(2)
                if ep:
                    fetches.append((rel, i, ep))
    # de-dup per (file, endpoint) keeping the first line
    seen, uniq = set(), []
    for rel, line, ep in fetches:
        if (rel, ep) not in seen:
            seen.add((rel, ep))
            uniq.append((rel, line, ep))
    return frozenset(files), tuple(uniq)


def _docs_versions(path: str, base: str):
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            src = f.read()
    except OSError:
        return None, ""
    rel = os.path.relpath(os.path.abspath(path), base)
    rel = rel.replace(os.sep, "/") if not rel.startswith("..") \
        else os.path.abspath(path)
    rows: Dict[str, tuple] = {}
    for i, line in enumerate(src.splitlines(), 1):
        m = _DOCS_ROW_RE.match(line.strip())
        if m:
            rows[m.group(1)] = (int(m.group(2)), rel, i)
    return rows, rel


def build_artifact_graph(files, base: str,
                         passes=()) -> ArtifactGraph:
    """Assemble the graph from the linted file set.  ``files`` must
    contain a registry-bearing record.py for the graph to activate; the
    raw patterns (durability.py), the validator (tools/manifest_check.py),
    the board and the docs table are discovered beside it, inside the
    package."""
    base = os.path.abspath(base)
    record_path = None
    tables = None
    for f in files:
        if os.path.basename(f) == "record.py":
            tables = _registry_from_record(f)
            if tables is not None:
                record_path = os.path.abspath(f)
                break
    if record_path is None:
        return ArtifactGraph(ok=False)

    def rel(p):
        ab = os.path.abspath(p)
        return (os.path.relpath(ab, base).replace(os.sep, "/")
                if ab.startswith(base + os.sep) else ab)

    registry_lines: Dict[tuple, int] = {}
    for table, prefix in (("RAW_FILES", "raw"), ("ANALYSIS_FILES", "derived"),
                          ("VERB_FILES", "derived"),
                          ("DERIVED_DIRS", "dir"),
                          ("DIGEST_SKIP_FILES", "skip"),
                          ("DIGEST_SKIP_DIRS", "skipdir")):
        for name, line in tables.get(table, []):
            registry_lines[(prefix, name)] = line

    pkg_dir = os.path.dirname(record_path)
    raw_tables = _literal_tables(os.path.join(pkg_dir, "durability.py")) \
        or {}

    # per-file facts + the cross-module constant tables
    facts: List[_ModuleFacts] = []
    mc_path = os.path.join(pkg_dir, "tools", "manifest_check.py")
    py_files = [f for f in files if f.endswith(".py")]
    if os.path.isfile(mc_path):
        py_files.append(mc_path)
    seen = set()
    for f in py_files:
        ab = os.path.abspath(f)
        if ab in seen:
            continue
        seen.add(ab)
        facts.append(_ModuleFacts(f, rel(f)))
    cross: Dict[tuple, str] = {}
    cross_int: Dict[tuple, int] = {}
    for mf in facts:
        stem = os.path.splitext(os.path.basename(mf.relpath))[0]
        if stem == "__init__":      # ``from pkg.archive import NAME``
            stem = os.path.basename(os.path.dirname(mf.relpath))
        for name, value in mf.str_consts.items():
            cross.setdefault((stem, name), value)
        for name, value in mf.int_consts.items():
            cross_int.setdefault((stem, name), value)
    for mf in facts:
        if mf.tree is not None:
            mf.harvest(cross)
            mf.schema_literals()

    mc_rel = rel(mc_path) if os.path.isfile(mc_path) else ""
    mc_facts = next((mf for mf in facts if mf.relpath == mc_rel), None)

    # Verb entry points = sofa_* functions the CLI dispatcher actually
    # from-imports (a sofa_* helper another module wraps is not a verb).
    # Lint's own cli.py is not the dispatcher.
    dispatched: set = set()
    for mf in facts:
        if os.path.basename(mf.relpath) == "cli.py" and \
                "/lint/" not in f"/{mf.relpath}" and mf.tree is not None:
            for origin in mf.from_import.values():
                tail = origin.rsplit(".", 1)[-1]
                if tail.startswith("sofa_") or tail == "cluster_record":
                    dispatched.add(tail)

    writers: List[Writer] = []
    reader_names: set = set()
    meta_writes: List[MetaKey] = []
    schema_writers: List[SchemaDecl] = []
    frame_names: set = set()
    route_heads: set = set()
    loose_names: set = set()
    digestless: set = set()
    for mf in facts:
        if mf is mc_facts:
            continue
        writers.extend(mf.writers)
        reader_names |= mf.reader_names
        meta_writes.extend(mf.meta_writes)
        schema_writers.extend(mf.schema_decls)
        frame_names |= mf.frame_names
        route_heads |= mf.route_heads
        if mf.has_dynamic_writer:
            loose_names |= mf.filename_literals
        if (mf.verb_funcs & dispatched) and not mf.refreshes_digests:
            digestless.add(mf.relpath)

    meta_validated = None
    schema_validators: tuple = ()
    mc_refs: frozenset = frozenset()
    if mc_facts is not None and mc_facts.tree is not None:
        keys: List[MetaKey] = []
        for node in ast.walk(mc_facts.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                recv = node.func.value
                receiver_consts = {
                    s.value for s in ast.walk(recv)
                    if isinstance(s, ast.Constant)
                    and isinstance(s.value, str)}
                # (doc.get("meta") or {}).get(k), or meta.get(k) on the
                # validator's ``meta`` mapping
                if "meta" in receiver_consts or (
                        isinstance(recv, ast.Name) and recv.id == "meta"):
                    keys.append(MetaKey(node.args[0].value, mc_rel,
                                        node.lineno))
        meta_validated = tuple(sorted(keys, key=lambda k: k.key))
        schema_validators = tuple(mc_facts.schema_decls) + \
            _imported_schemas(mc_facts, cross, cross_int)
        # ... and the file names it imports (OFFSETS_NAME, VERDICT_NAME)
        imported = (cross.get(_origin_key(o))
                    for o in mc_facts.from_import.values())
        mc_refs = frozenset(mc_facts.filename_literals) | frozenset(
            v for v in imported if v is not None and _FILENAME_RE.match(v))

    board_dir = os.path.join(pkg_dir, "board")
    board_present = os.path.isdir(board_dir)
    board_files: frozenset = frozenset()
    board_fetches: tuple = ()
    if board_present:
        board_files, board_fetches = _board_facts(board_dir, base)

    docs_path = os.path.join(pkg_dir, "docs", "OBSERVABILITY.md")
    docs_versions, docs_rel = (None, "")
    if os.path.isfile(docs_path):
        docs_versions, docs_rel = _docs_versions(docs_path, base)

    pass_artifacts = frozenset(
        a for d in passes for a in getattr(d, "provides_artifacts", ()))

    return ArtifactGraph(
        ok=True,
        registry_relpath=rel(record_path),
        registry_lines=registry_lines,
        raw_files=frozenset(n for n, _l in tables.get("RAW_FILES", [])),
        raw_patterns=tuple(n for n, _l in raw_tables.get("RAW_PATTERNS",
                                                         [])),
        raw_dirs=frozenset(n for n, _l in raw_tables.get("RAW_DIRS", [])),
        derived_files=frozenset(
            n for table in ("ANALYSIS_FILES", "VERB_FILES")
            for n, _l in tables.get(table, [])),
        derived_dirs=frozenset(n for n, _l in tables.get("DERIVED_DIRS", [])),
        root_files=frozenset(n for n, _l in tables.get("ROOT_FILES", [])),
        skip_files=frozenset(
            n for n, _l in tables.get("DIGEST_SKIP_FILES", [])),
        skip_dirs=frozenset(
            n for n, _l in tables.get("DIGEST_SKIP_DIRS", [])),
        writers=tuple(sorted(writers, key=lambda w: (w.relpath, w.line, w.name))),
        reader_names=frozenset(reader_names),
        board_present=board_present,
        board_files=board_files,
        board_fetches=board_fetches,
        routes=frozenset(route_heads),
        meta_writes=tuple(sorted(meta_writes, key=lambda k: (k.relpath, k.line, k.key))),
        meta_validated=meta_validated,
        schema_writers=tuple(sorted(schema_writers, key=lambda s: (s.relpath, s.line, s.schema_id))),
        schema_validators=schema_validators,
        manifest_check_refs=mc_refs,
        docs_versions=docs_versions,
        docs_relpath=docs_rel,
        pass_artifacts=pass_artifacts,
        frame_names=frozenset(frame_names),
        loose_writer_names=frozenset(loose_names),
        digestless_verb_files=frozenset(digestless),
    )


def _origin_key(origin: str) -> tuple:
    """``pkg.mod.NAME`` -> ``("mod", "NAME")``, the cross tables' key."""
    mod, _, attr = origin.rpartition(".")
    return mod.rpartition(".")[-1], attr


def _imported_schemas(mf: "_ModuleFacts", cross: Dict[tuple, str],
                      cross_int: Dict[tuple, int]) -> tuple:
    """The schema ids a validator pins by importing the writer's own
    ``<X>_SCHEMA`` / ``<X>_VERSION`` constants (the port's manifest_check
    imports most of them), resolved through the cross-module tables."""
    out: List[SchemaDecl] = []
    lines = {}
    for node in ast.walk(mf.tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                lines.setdefault(a.asname or a.name, node.lineno)
    for local, origin in sorted(mf.from_import.items()):
        mod, _, attr = origin.rpartition(".")
        if not attr.endswith("_SCHEMA"):
            continue
        stem = mod.rpartition(".")[-1]
        sid = cross.get((stem, attr))
        if sid is None or not _SCHEMA_ID_RE.match(sid):
            continue
        ver_attr = attr[:-7] + "_VERSION"
        version = None
        if any(o == f"{mod}.{ver_attr}" for o in mf.from_import.values()):
            version = cross_int.get((stem, ver_attr))
        out.append(SchemaDecl(sid, version, mf.relpath,
                              lines.get(local, 0)))
    return tuple(out)


# ---------------------------------------------------------------------------
# The rules.
# ---------------------------------------------------------------------------

def _graph(ctx: FileContext) -> Optional[ArtifactGraph]:
    g = getattr(ctx.project, "artifacts", None)
    return g if isinstance(g, ArtifactGraph) and g.ok else None


class _ArtifactRule(Rule):
    """Base: finish()-only rules over the shared flow graph.  Cross-file
    findings (board pages, manifest_check, the docs table) are emitted
    while visiting the registry's record.py so each appears exactly once;
    writer-anchored findings are emitted from the writer's own file (and
    are inline-suppressible there)."""

    node_types: tuple = ()


class UnregisteredArtifactWrite(_ArtifactRule):
    """SL014 — an artifact written into the logdir that neither the
    ANALYSIS_FILES/VERB_FILES/DERIVED_DIRS registry, the frame names, the
    board pages, the roots' ledgers (ROOT_FILES), nor the raw names account
    for: ``clean`` leaks it and
    ``record._clean_stale`` lets it bleed into the next run's trace."""

    rule_id = "SL014"
    severity = SEV_ERROR
    # the archive store writes into its own root (gc is its only deletion
    # path, archive_fsck its ledger) — logdir lifecycle does not apply
    exempt_files = ("archive/",)

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None:
            return
        for w in g.writers:
            if w.relpath != ctx.relpath:
                continue
            if g.clean_coverage(w.name, w.fragments) is None:
                yield Finding(
                    w.relpath, w.line, self.rule_id,
                    f"artifact {w.name!r} is written here but registered "
                    "nowhere — not in record.ANALYSIS_FILES/VERB_FILES, "
                    "not a frame or board file, not under a DERIVED_DIRS "
                    "directory: `clean` leaks it",
                    self.severity)


class DigestSkipClosure(_ArtifactRule):
    """SL015 — the digest skip-list agrees with the registry in both
    directions, so `sofa fsck` has no blind spots: every skip entry
    names a registered artifact (a rename leaves a typo'd entry that
    silently uncovers the renamed file), every skip dir is a registered
    scratch dir, and an artifact a non-digest-refreshing verb rewrites
    must be on the skip-list (else every re-run reads as corrupt)."""

    rule_id = "SL015"
    severity = SEV_ERROR
    exempt_files = ("archive/",)

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None:
            return
        if ctx.relpath == g.registry_relpath:
            known = g.derived_files | g.raw_files | g.frame_files()
            for name in sorted(g.skip_files - known):
                yield Finding(
                    g.registry_relpath,
                    g.registry_lines.get(("skip", name), 0), self.rule_id,
                    f"digest skip-list entry {name!r} names no registered "
                    "artifact (RAW_FILES/ANALYSIS_FILES/VERB_FILES) — a "
                    "rename left "
                    "the real file silently digest-covered or the entry "
                    "is dead", self.severity)
            allowed_dirs = g.derived_dirs | {"_inject", "__pycache__"}
            for name in sorted(g.skip_dirs - allowed_dirs):
                yield Finding(
                    g.registry_relpath,
                    g.registry_lines.get(("skipdir", name), 0),
                    self.rule_id,
                    f"digest skip dir {name!r} is not in DERIVED_DIRS — "
                    "`clean` does not know it, so its contents leak",
                    self.severity)
        if ctx.relpath in g.digestless_verb_files:
            for w in g.writers:
                if w.relpath != ctx.relpath:
                    continue
                if g.digest_coverage(w.name, w.fragments) == "digested":
                    yield Finding(
                        w.relpath, w.line, self.rule_id,
                        f"artifact {w.name!r} is written by a verb module "
                        "that never refreshes the digest ledger "
                        "(durability.write_digests) — the next `fsck` "
                        "reads the rewrite as corruption; add it to "
                        "record.DIGEST_SKIP_FILES or refresh digests",
                        self.severity)


class ManifestMetaClosure(_ArtifactRule):
    """SL016 — every manifest ``meta.*`` section written by the pipeline
    is validated by tools/manifest_check.py, and every key the validator
    checks is still written by someone.  Both directions are schema
    drift: an unvalidated key rots silently; a validated-but-unwritten
    key means the producer was renamed or dropped and CI checks air."""

    rule_id = "SL016"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None or g.meta_validated is None:
            return
        validated = {k.key for k in g.meta_validated}
        written = {k.key for k in g.meta_writes}
        seen_here = set()
        for mw in g.meta_writes:
            if mw.relpath != ctx.relpath or mw.key in seen_here:
                continue
            seen_here.add(mw.key)
            if mw.key not in validated:
                yield Finding(
                    mw.relpath, mw.line, self.rule_id,
                    f"manifest key meta.{mw.key} is written here but "
                    "tools/manifest_check.py never validates it — the "
                    "section can rot without CI noticing; add a "
                    "validator clause", self.severity)
        if ctx.relpath == g.registry_relpath:
            for mk in g.meta_validated:
                if mk.key not in written:
                    yield Finding(
                        mk.relpath, mk.line, self.rule_id,
                        f"manifest_check validates meta.{mk.key} but no "
                        "pipeline code writes that key — the producer "
                        "was renamed or dropped; fix the validator or "
                        "restore the writer", self.severity)


class BoardEndpointFlow(_ArtifactRule):
    """SL017 — board pages and the data they fetch stay connected:
    every literal ``fetch()`` endpoint needs a producer (a registered
    artifact, an extracted writer, a declared pass artifact, a frame
    file) or a server route (viz.py's /tiles/, /archive/); and every
    registered machine-readable artifact needs at least one reader
    somewhere (board or pipeline) — a writer nobody reads is a dead
    artifact (warn-tier: it may be an external-tool contract)."""

    rule_id = "SL017"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None or not g.board_present or \
                ctx.relpath != g.registry_relpath:
            return
        producers = g.endpoint_producers()
        for bfile, line, ep in g.board_fetches:
            clean = ep.lstrip("./")
            head, _, _rest = clean.partition("/")
            if "/" in clean and (head in g.routes
                                 or head in g.derived_dirs
                                 or head.lstrip("_") in g.routes):
                continue
            if os.path.basename(clean) in producers:
                continue
            yield Finding(
                bfile, line, self.rule_id,
                f"board endpoint {ep!r} has no producer in the tree (no "
                "registered artifact, writer, pass artifact, frame CSV, "
                "or viz route) — the page fetches a 404",
                self.severity)
        readers = g.reader_set()
        for name in sorted(g.derived_files):
            if not name.endswith(_MACHINE_SUFFIXES):
                continue
            if name not in readers:
                yield Finding(
                    g.registry_relpath,
                    g.registry_lines.get(("derived", name), 0),
                    self.rule_id,
                    f"registered artifact {name!r} has a writer but no "
                    "reader anywhere (board fetch, pipeline open, "
                    "manifest_check) — dead artifact?", SEV_WARN)


class SchemaVersionAgreement(_ArtifactRule):
    """SL018 — every ``sofa_tpu/*`` schema-id literal (the ids the port
    shares with the JAX package) tells one story:
    all writers of an id agree on its version, the manifest_check
    validator pins the same version, and docs/OBSERVABILITY.md's schema
    registry table carries a matching row.  A version bumped in one
    place but not the others is exactly the drift the versioning policy
    exists to prevent."""

    rule_id = "SL018"
    severity = SEV_ERROR

    def finish(self, ctx: FileContext) -> Iterable[Finding]:
        g = _graph(ctx)
        if g is None:
            return
        by_id: Dict[str, List[SchemaDecl]] = {}
        for sd in g.schema_writers:
            by_id.setdefault(sd.schema_id, []).append(sd)
        validators = {sd.schema_id: sd for sd in g.schema_validators}
        for sd in g.schema_writers:
            if sd.relpath != ctx.relpath:
                continue
            peers = by_id[sd.schema_id]
            versions = {p.version for p in peers if p.version is not None}
            if len(versions) > 1 and sd.version is not None and \
                    sd is min((p for p in peers if p.version is not None),
                              key=lambda p: (p.relpath, p.line)):
                yield Finding(
                    sd.relpath, sd.line, self.rule_id,
                    f"schema {sd.schema_id!r} is written with conflicting "
                    f"versions {sorted(versions)} across "
                    f"{sorted({p.relpath for p in peers})}",
                    self.severity)
            val = validators.get(sd.schema_id)
            if val is not None and sd.version is not None:
                if val.version is None:
                    yield Finding(
                        sd.relpath, sd.line, self.rule_id,
                        f"schema {sd.schema_id!r} v{sd.version}: "
                        "tools/manifest_check.py declares the id but pins "
                        "no *_VERSION constant — version drift passes "
                        "validation", self.severity)
                elif val.version != sd.version:
                    yield Finding(
                        sd.relpath, sd.line, self.rule_id,
                        f"schema {sd.schema_id!r}: writer says "
                        f"v{sd.version}, manifest_check pins "
                        f"v{val.version}", self.severity)
            if g.docs_versions is not None and sd.version is not None:
                row = g.docs_versions.get(sd.schema_id)
                if row is None:
                    yield Finding(
                        sd.relpath, sd.line, self.rule_id,
                        f"schema {sd.schema_id!r} v{sd.version} has no "
                        "row in docs/OBSERVABILITY.md's schema registry "
                        "table", self.severity)
                elif row[0] != sd.version:
                    yield Finding(
                        sd.relpath, sd.line, self.rule_id,
                        f"schema {sd.schema_id!r}: writer says "
                        f"v{sd.version}, docs/OBSERVABILITY.md's table "
                        f"says v{row[0]} — regenerate the table",
                        self.severity)
        if ctx.relpath == g.registry_relpath:
            writer_ids = set(by_id)
            for sd in g.schema_validators:
                if sd.schema_id not in writer_ids:
                    yield Finding(
                        sd.relpath, sd.line, self.rule_id,
                        f"manifest_check validates schema "
                        f"{sd.schema_id!r} that no writer in the tree "
                        "emits — stale validator", self.severity)
            if g.docs_versions is not None:
                for sid, (_ver, drel, dline) in sorted(
                        g.docs_versions.items()):
                    if sid not in writer_ids:
                        yield Finding(
                            drel, dline, self.rule_id,
                            f"docs/OBSERVABILITY.md lists schema {sid!r} "
                            "that no writer in the tree emits — stale "
                            "table row", self.severity)


ARTIFACT_RULES = (
    UnregisteredArtifactWrite,
    DigestSkipClosure,
    ManifestMetaClosure,
    BoardEndpointFlow,
    SchemaVersionAgreement,
)
