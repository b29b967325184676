"""``protocol`` — the client↔server protocol inventory.

Renders the contract the checker's SL024–SL028 rules enforce
(sofa_tpu_torch/lint/protocol_rules.py): every route the fleet tier
serves, every HTTP status a handler can emit and the typed error bodies it
may carry, the Retry-After discipline, how the client layer dispatches
each status, the fault-kind grammar vs its consume sites, and the SOFA_*
env-knob registry vs sofa_tpu_torch/docs/OBSERVABILITY.md:

    python -m sofa_tpu_torch protocol            # human table
    python -m sofa_tpu_torch protocol --json     # machine-readable

The ``--json`` document is schema-versioned (``sofa_tpu/protocol_inventory``
v1, the JAX package's id) and validated by ``tools/manifest_check.py``
like every other emitted schema.  Exit codes: 0 full closure, 2 on
closure violations (any non-baselined SL024–SL028 finding) — the same
posture as ``artifacts``.
"""

from __future__ import annotations

import json
import os
import time
from typing import List

PROTOCOL_SCHEMA = "sofa_tpu/protocol_inventory"
PROTOCOL_VERSION = 1


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
    """Non-baselined SL024–SL028 findings over the shipped tree."""
    from sofa_tpu_torch.lint.baseline import (Baseline, fingerprint_findings,
                                        locate_baseline)
    from sofa_tpu_torch.lint.core import iter_python_files, lint_paths
    from sofa_tpu_torch.lint.protocol_rules import PROTOCOL_RULES

    pkg = _package_root()
    findings = lint_paths(iter_python_files([pkg]),
                          [cls() for cls in PROTOCOL_RULES],
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


def _client_handling(g, status: int) -> str:
    for site in g.fatal_sites:
        if status in site.statuses:
            return "fatal"
    for site in g.resume_sites:
        if status in site.statuses:
            return "resume"
    if g.client_retryable(status):
        return "retry"
    return "-"


def _route_rows(g) -> List[dict]:
    out = []
    for method, path, line in g.routes:
        clients = sorted({f"{r}:{ln}" for r, ln, norm in g.client_routes
                          if g.route_match(norm) and _same_shape(g, path,
                                                                 norm)})
        board = sorted({f"{r}:{ln}" for r, ln, norm in g.board_routes
                        if _same_shape(g, path, norm)})
        out.append({"method": method, "path": path,
                    "declared_at": line, "clients": clients,
                    "board": board})
    return out


def _same_shape(g, route_path: str, norm: str) -> bool:
    from sofa_tpu_torch.lint.protocol_rules import _route_segments

    rsegs = _route_segments(route_path)
    nsegs = _route_segments(norm)
    if rsegs is None or nsegs is None or len(rsegs) != len(nsegs):
        return False
    return all(r.startswith("<") or r == n
               for r, n in zip(rsegs, nsegs))


def _status_rows(g) -> List[dict]:
    out = []
    emitted = {}
    for em in g.emissions:
        emitted.setdefault(em.status, []).append(
            f"{em.relpath}:{em.line}")
    for relpath, line, status in g.raw_sends:
        emitted.setdefault(status, []).append(f"{relpath}:{line}")
    for status in sorted(g.status_errors):
        out.append({
            "status": status,
            "errors": list(g.status_errors[status]),
            "retry_after": status in g.retry_after_statuses,
            "no_retry_after": status in g.no_retry_after_statuses,
            "client": _client_handling(g, status),
            "emitted_by": sorted(set(emitted.get(status, []))),
        })
    return out


def _error_rows(g) -> List[dict]:
    out = []
    for err in sorted(g.error_lines):
        statuses = sorted(s for s, errs in g.status_errors.items()
                          if err in errs)
        use = g.error_uses.get(err)
        out.append({
            "error": err,
            "statuses": statuses,
            "fatal_override": err in g.fatal_errors_decl,
            "attached_at": f"{use[0]}:{use[1]}" if use else "",
        })
    return out


def _knob_rows(g) -> List[dict]:
    reads = {}
    for relpath, line, token in g.knob_reads:
        reads.setdefault(token, []).append(f"{relpath}:{line}")
    docs = g.docs_knobs or {}
    out = []
    for token in sorted(set(reads) | set(docs)):
        out.append({
            "knob": token,
            "documented": token in docs,
            "read_by": sorted(reads.get(token, [])),
        })
    return out


def _fault_rows(g) -> List[dict]:
    consumed = {}
    for relpath, line, kind in g.kind_consumes:
        consumed.setdefault(kind, []).append(f"{relpath}:{line}")
    out = []
    for kind in sorted(g.kinds):
        table, line = g.kinds[kind]
        out.append({
            "kind": kind,
            "table": table,
            "declared_at": line,
            "consumed_by": sorted(set(consumed.get(kind, []))),
            "referenced": kind in g.ref_text,
        })
    return out


def build_inventory() -> dict:
    """The full inventory document (``protocol --json``)."""
    project, base = build_graph()
    g = project.protocol
    if g is None or not getattr(g, "ok", False):
        raise RuntimeError(
            "protocol graph unavailable: the package carries no "
            "STATUS_ERRORS vocabulary module (archive/protocol.py)")
    violations = _violations(project, base)
    doc = {
        "schema": PROTOCOL_SCHEMA,
        "version": PROTOCOL_VERSION,
        "generated_unix": round(time.time(), 3),
        "vocabulary": g.vocab_relpath,
        "routes": _route_rows(g),
        "statuses": _status_rows(g),
        "errors": _error_rows(g),
        "knobs": _knob_rows(g),
        "fault_kinds": _fault_rows(g),
        "client": {
            "fatal_statuses": sorted(g.client_fatal_statuses_decl),
            "resume_statuses": sorted(g.client_resume_statuses_decl),
            "retry_statuses": sorted(g.client_retry_statuses_decl),
            "retry_floor": g.client_retry_floor_decl,
            "fatal_errors": sorted(g.fatal_errors_decl),
        },
        "violations": violations,
        "counts": {
            "routes": len(g.routes),
            "statuses": len(g.status_errors),
            "errors": len(g.error_lines),
            "knobs": len({t for _r, _l, t in g.knob_reads}),
            "fault_kinds": len(g.kinds),
            "violations": len(violations),
        },
    }
    doc["ok"] = not violations
    return doc


def render_inventory(doc: dict) -> List[str]:
    lines: List[str] = []
    lines.append(f"{'route':<40} clients/board")
    for r in doc["routes"]:
        users = len(r["clients"]) + len(r["board"])
        lines.append(f"{r['method'] + ' ' + r['path']:<40} "
                     f"{users or '-'}")
    lines.append("")
    lines.append(f"{'status':<7} {'client':<7} {'retry-after':<12} "
                 "error bodies")
    for s in doc["statuses"]:
        ra = ("attach" if s["retry_after"]
              else "forbid" if s["no_retry_after"] else "-")
        lines.append(f"{s['status']:<7} {s['client']:<7} {ra:<12} "
                     f"{', '.join(s['errors']) or '-'}")
    c = doc["counts"]
    lines.append("")
    lines.append(
        f"{c['routes']} route(s), {c['statuses']} status(es), "
        f"{c['errors']} typed error(s), {c['knobs']} env knob(s), "
        f"{c['fault_kinds']} fault kind(s), "
        f"{c['violations']} closure violation(s)")
    undocumented = [k["knob"] for k in doc["knobs"]
                    if not k["documented"] and k["read_by"]]
    if undocumented:
        lines.append("undocumented knobs: " + ", ".join(undocumented))
    for v in doc["violations"]:
        lines.append(f"  {v['file']}:{v['line']}: {v['rule']} "
                     f"{v['message']}")
    return lines


def sofa_protocol(as_json: bool = False) -> int:
    """``protocol [--json]`` — exit 0 on full closure, 2 on violations,
    like ``artifacts``' contract."""
    from sofa_tpu_torch.printing import print_error, print_progress, print_title

    try:
        doc = build_inventory()
    except Exception as e:  # sofa-lint: disable=SL002 — CLI boundary: the exit contract (rc 2 + stderr line) IS the routing
        print_error(f"protocol: {type(e).__name__}: {e}")
        return 2
    if as_json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0 if doc["ok"] else 2
    print_title("Protocol contract inventory")
    for line in render_inventory(doc):
        print(line)
    if doc["ok"]:
        print_progress(
            "protocol: full closure — every route, status, error body, "
            "fault kind, and env knob is accounted for on both sides")
        return 0
    print_error("protocol: closure violations — see lines above "
                "(lint shows the same findings)")
    return 2
