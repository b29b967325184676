"""``artifacts`` — the artifact-lifecycle inventory.

Renders the flow graph the checker's SL014–SL018 rules enforce
(sofa_tpu_torch/lint/artifact_rules.py): every artifact the tree can
produce, who writes it, who reads it, and how each lifecycle registry
accounts for it — ``clean`` (record.py's ANALYSIS_FILES, VERB_FILES, the
frame and board files, DERIVED_DIRS), the digest ledger ``fsck`` verifies
(skip-list vs digested), and the manifest_check validators.  With a logdir
the on-disk files are additionally audited against the graph, so "does
anything here leak past clean / blind-side fsck?" is one command:

    python -m sofa_tpu_torch artifacts               # static inventory
    python -m sofa_tpu_torch artifacts <logdir>      # + audit its files
    python -m sofa_tpu_torch artifacts --json        # machine-readable

The ``--json`` document is schema-versioned (``sofa_tpu/artifact_inventory``
v1, the JAX package's id) and validated by ``tools/manifest_check.py``
like every other emitted schema.  Exit codes: 0 full closure, 2 on
closure violations (any non-baselined SL014–SL018 finding, or an on-disk
file no registry accounts for) — the same "unschedulable graph" posture
as ``passes``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

INVENTORY_SCHEMA = "sofa_tpu/artifact_inventory"
INVENTORY_VERSION = 1

#: Roots never audited inside a logdir: an archive or a fleet root keeps
#: its own ledger (the markers durability.MARKED_ROOTS names).
_AUDIT_PRUNE_MARKERS = ("sofa_archive.json", "sofa_fleet.json")


def _package_root() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def build_graph():
    """(ProjectContext, base) over the shipped package — the same
    detection path ``lint`` runs, so the inventory and the rules can
    never disagree about the graph."""
    from sofa_tpu_torch.lint.core import ProjectContext, iter_python_files

    pkg = _package_root()
    base = os.path.dirname(pkg)
    files = iter_python_files([pkg])
    return ProjectContext.detect(files, base=base), base


def _violations(project, base: str) -> List[dict]:
    """Non-baselined SL014–SL018 findings over the shipped tree."""
    from sofa_tpu_torch.lint.artifact_rules import ARTIFACT_RULES
    from sofa_tpu_torch.lint.baseline import (Baseline, fingerprint_findings,
                                        locate_baseline)
    from sofa_tpu_torch.lint.core import iter_python_files, lint_paths

    pkg = _package_root()
    findings = lint_paths(iter_python_files([pkg]),
                          [cls() for cls in ARTIFACT_RULES],
                          project=project, base=base)

    def line_text_for(f):
        path = f.file if os.path.isabs(f.file) else os.path.join(base,
                                                                 f.file)
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                lines = fh.read().splitlines()
            return lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
        except OSError:
            return ""

    baseline = Baseline.load(locate_baseline(pkg))
    new, _old = baseline.split(fingerprint_findings(findings,
                                                    line_text_for))
    return [f.to_dict() for f in sorted(
        new, key=lambda f: (f.rule_id, f.file, f.line))]


def _artifact_rows(g) -> List[dict]:
    names: Dict[str, dict] = {}

    def row(name: str) -> dict:
        return names.setdefault(name, {
            "name": name, "writers": [], "readers": [], "endpoints": []})

    for n in g.derived_files | g.raw_files | g.pass_artifacts:
        row(n)
    for n in g.frame_names:
        row(f"{n}.csv")
    for n in g.board_files:
        row(n)
    for w in g.writers:
        row(w.name)["writers"].append(f"{w.relpath}:{w.line}")
    readers = g.reader_names
    for bfile, line, ep in g.board_fetches:
        base = os.path.basename(ep.lstrip("./"))
        if base in names:
            names[base]["endpoints"].append(f"{bfile}:{line}")
    out = []
    for name in sorted(names):
        r = names[name]
        kind = "raw" if name in g.raw_files else "derived"
        # writer fragments carry dir components, so dir coverage applies
        frags: tuple = ()
        for w in g.writers:
            if w.name == name:
                frags = frags + tuple(w.fragments)
        clean = g.clean_coverage(name, frags)
        r.update({
            "kind": kind,
            "clean": clean or "UNREGISTERED",
            "digest": ("raw" if kind == "raw"
                       else g.digest_coverage(name, frags)),
            "read": bool(r["endpoints"]) or name in readers
            or name in g.manifest_check_refs,
            "manifest_check": name in g.manifest_check_refs,
        })
        r["writers"] = sorted(set(r["writers"]))
        r["endpoints"] = sorted(set(r["endpoints"]))
        del r["readers"]
        out.append(r)
    return out


def _audit_logdir(g, logdir: str) -> dict:
    """Every on-disk file accounted for by the registries; the ones that
    are not would leak past ``clean`` (the violations).  The raw
    directories (kineto/, gpu_topo/) count as raw through the graph's
    RAW_DIRS, as they do for clean and the digests."""
    checked, unaccounted = 0, []
    top = os.path.normpath(logdir)
    for root, dirs, files in os.walk(logdir):
        dirs.sort()
        if os.path.normpath(root) != top and any(
                os.path.isfile(os.path.join(root, m))
                for m in _AUDIT_PRUNE_MARKERS):
            dirs[:] = []  # nested archive: its own fsck owns it
            continue
        rel_root = os.path.relpath(root, logdir)
        parts = [] if rel_root == "." else rel_root.split(os.sep)
        for name in sorted(files):
            if name.endswith(".tmp"):
                continue  # interrupted writes are fsck's orphan verdict
            checked += 1
            if g.clean_coverage(name, ("/".join(parts),)) is None:
                unaccounted.append(
                    "/".join(parts + [name]) if parts else name)
    return {"path": logdir, "files_checked": checked,
            "unaccounted": sorted(unaccounted)}


def build_inventory(logdir: "str | None" = None) -> dict:
    """The full inventory document (``artifacts --json``)."""
    project, base = build_graph()
    g = project.artifacts
    if g is None or not g.ok:
        raise RuntimeError(
            "artifact graph unavailable: the package's record.py carries "
            "no artifact registry")
    violations = _violations(project, base)
    doc = {
        "schema": INVENTORY_SCHEMA,
        "version": INVENTORY_VERSION,
        "generated_unix": round(time.time(), 3),
        "artifacts": _artifact_rows(g),
        "violations": violations,
        "counts": {
            "artifacts": 0,
            "writers": len(g.writers),
            "board_endpoints": len(g.board_fetches),
            "violations": len(violations),
        },
    }
    doc["counts"]["artifacts"] = len(doc["artifacts"])
    if logdir and os.path.isdir(logdir):
        doc["logdir"] = _audit_logdir(g, logdir)
    doc["ok"] = not violations and \
        not (doc.get("logdir") or {}).get("unaccounted")
    return doc


def render_inventory(doc: dict) -> List[str]:
    lines: List[str] = []
    lines.append(f"{'artifact':<28} {'kind':<8} {'clean':<16} "
                 f"{'digest':<14} {'read':<5} writers")
    for r in doc["artifacts"]:
        writers = ", ".join(r["writers"][:2]) + \
            (" …" if len(r["writers"]) > 2 else "")
        lines.append(
            f"{r['name']:<28} {r['kind']:<8} {r['clean']:<16} "
            f"{r['digest']:<14} {'yes' if r['read'] else '-':<5} "
            f"{writers}")
    c = doc["counts"]
    lines.append("")
    lines.append(f"{c['artifacts']} artifact(s), {c['writers']} extracted "
                 f"writer site(s), {c['board_endpoints']} board "
                 f"endpoint(s), {c['violations']} closure violation(s)")
    audit = doc.get("logdir")
    if audit:
        lines.append(
            f"logdir {audit['path']}: {audit['files_checked']} file(s) "
            f"audited, {len(audit['unaccounted'])} unaccounted")
        for rel in audit["unaccounted"]:
            lines.append(f"  LEAK {rel} — no registry accounts for it")
    for v in doc["violations"]:
        lines.append(f"  {v['file']}:{v['line']}: {v['rule']} "
                     f"{v['message']}")
    return lines


def sofa_artifacts(logdir: "str | None" = None,
                   as_json: bool = False) -> int:
    """``artifacts [logdir] [--json]`` — exit 0 on full closure, 2 on
    violations, like ``passes``' unschedulable-graph contract."""
    from sofa_tpu_torch.printing import print_error, print_progress, print_title

    try:
        doc = build_inventory(logdir)
    except Exception as e:  # sofa-lint: disable=SL002 — CLI boundary: the exit contract (rc 2 + stderr line) IS the routing
        print_error(f"artifacts: {type(e).__name__}: {e}")
        return 2
    if as_json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0 if doc["ok"] else 2
    print_title("Artifact lifecycle inventory")
    for line in render_inventory(doc):
        print(line)
    if doc["ok"]:
        print_progress(
            "artifacts: full closure — every artifact is covered by "
            "clean/digest/fsck and every endpoint has a producer")
        return 0
    print_error("artifacts: closure violations — see lines above "
                "(lint shows the same findings)")
    return 2
