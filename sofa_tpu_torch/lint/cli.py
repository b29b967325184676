"""sofa-lint command line (backs ``python -m sofa_tpu_torch lint`` and
``python -m sofa_tpu_torch.tools.sofa_lint``).

Exit-code contract (stable for CI):

  0  clean — no findings outside the baseline
  1  new findings (printed one per line as ``file:line: RULE [sev] msg``)
  2  internal error (bad baseline file, engine crash)

With no path it lints this package against its own baseline,
``sofa_tpu_torch/lint_baseline.json``, with findings anchored at the repo
root (``sofa_tpu_torch/...``).  ``--update-baseline`` regenerates the
baseline from the current findings (expired entries drop out); ``--json``
emits the machine-readable report.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import textwrap
from typing import List, Optional

from sofa_tpu_torch.lint.baseline import (
    Baseline,
    anchor_of,
    fingerprint_findings,
    locate_baseline,
)
from sofa_tpu_torch.lint.core import lint_paths
from sofa_tpu_torch.lint.rules import default_rules

_RULE_ID_RE = re.compile(r"^SL\d{3}$")


def _default_paths() -> List[str]:
    """The sofa_tpu_torch package of THIS checkout (works from any cwd)."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sofa-lint",
        description="AST-based checker for sofa_tpu_torch's own runtime "
                    "contracts (see sofa_tpu_torch/docs/STATIC_ANALYSIS.md)")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the "
                        "sofa_tpu_torch package)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: nearest lint_baseline.json "
                        "up from the first path, never the JAX package's "
                        "at the repo root; else "
                        "sofa_tpu_torch/lint_baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, grandfathered or not")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from the current findings "
                        "(expired entries drop out) and exit 0")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--base", default=None,
                   help="directory findings' relative paths (and baseline "
                        "fingerprints) are anchored to (default: the "
                        "directory containing the baseline file, or its "
                        "parent when that is a package)")
    p.add_argument("--rule", default=None, metavar="SLxxx[,SLyyy]",
                   help="only report findings of these rule id(s); output "
                        "order and the 0/1/2 exit contract are unchanged")
    p.add_argument("--explain", default=None, metavar="SLxxx",
                   help="print the rule's catalog row "
                        "(sofa_tpu_torch/docs/STATIC_ANALYSIS.md, falling "
                        "back to the rule docstring) and exit without "
                        "linting")
    p.add_argument("--jobs", type=int, default=1,
                   help="per-file lint fan-out width (output is byte-"
                        "identical at any width); 1 = serial")
    return p


def run_lint(argv: Optional[List[str]] = None) -> int:
    try:
        return _run(build_parser().parse_args(argv))
    except SystemExit:
        raise
    except Exception as e:  # sofa-lint: disable=SL002 — exit-code contract: internal errors become rc 2 on stderr
        print(f"sofa-lint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2


def _parse_rule_filter(spec: str) -> List[str]:
    rules = [r.strip().upper() for r in spec.split(",") if r.strip()]
    bad = [r for r in rules if not _RULE_ID_RE.match(r)]
    if bad:
        raise ValueError(f"--rule expects SLnnn ids, got {bad}")
    return rules


def _explain(rule_id: str) -> int:
    """Print the rule's doc-catalog row (the one source of truth for what
    each rule guards), or its class docstring when the docs file is not
    beside this checkout.  rc 0 on success, 2 for an unknown rule."""
    rule_id = rule_id.strip().upper()
    if not _RULE_ID_RE.match(rule_id):
        print(f"sofa-lint: {rule_id!r} is not a rule id (SLnnn)",
              file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    docs = os.path.join(pkg, "docs", "STATIC_ANALYSIS.md")
    try:
        with open(docs, encoding="utf-8") as f:
            for line in f:
                row = line.strip()
                if row.startswith(f"| {rule_id} "):
                    cells = [c.strip() for c in row.strip("|").split("|")]
                    if len(cells) >= 4:
                        print(f"{cells[0]} [{cells[1]}] — guards: "
                              f"{cells[2]}")
                        print(textwrap.fill(cells[3], width=78))
                        return 0
    except OSError:
        pass
    for rule in default_rules():
        if rule.rule_id == rule_id:
            doc = (type(rule).__doc__ or "").strip()
            print(f"{rule_id} [{rule.severity}]")
            print(textwrap.fill(" ".join(doc.split()), width=78))
            return 0
    known = sorted({r.rule_id for r in default_rules()} | {"SL000"})
    print(f"sofa-lint: unknown rule {rule_id!r} (known: "
          f"{known[0]}..{known[-1]})", file=sys.stderr)
    return 2


def _run(args: argparse.Namespace) -> int:
    if args.explain:
        return _explain(args.explain)
    paths = args.paths or _default_paths()
    baseline_path = args.baseline or locate_baseline(paths[0])
    base = args.base or anchor_of(baseline_path)
    findings = lint_paths(paths, default_rules(), base=base,
                          jobs=max(int(args.jobs or 1), 1))
    if args.rule:
        wanted = set(_parse_rule_filter(args.rule))
        findings = [f for f in findings if f.rule_id in wanted]

    def line_text_for(f):
        path = f.file if os.path.isabs(f.file) else os.path.join(base, f.file)
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                lines = fh.read().splitlines()
            return lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
        except OSError:
            return ""

    fingerprinted = fingerprint_findings(findings, line_text_for)

    if args.update_baseline:
        Baseline.write(baseline_path, fingerprinted)
        print(f"sofa-lint: baseline rewritten with {len(fingerprinted)} "
              f"entr{'y' if len(fingerprinted) == 1 else 'ies'} "
              f"-> {baseline_path}")
        return 0

    if args.no_baseline:
        new, old = findings, []
    else:
        baseline = Baseline.load(baseline_path)
        new, old = baseline.split(fingerprinted)
    # Deterministic report order — (rule, file, line) in BOTH output
    # modes, so CI diffs of findings are stable across runs and sort
    # tweaks in the engine can never churn a committed report.
    new = sorted(new, key=lambda f: (f.rule_id, f.file, f.line,
                                     f.message))

    if args.as_json:
        by_rule: dict = {}
        for f in findings:
            by_rule[f.rule_id] = by_rule.get(f.rule_id, 0) + 1
        print(json.dumps({
            "new": [f.to_dict() for f in new],
            "baselined": len(old),
            "total": len(findings),
            "by_rule": dict(sorted(by_rule.items())),
            "baseline": baseline_path if not args.no_baseline else None,
        }, indent=1))
        return 1 if new else 0

    for f in new:
        print(f.render())
    tail = f", {len(old)} baselined" if old else ""
    if new:
        print(f"sofa-lint: {len(new)} new finding(s){tail} — fix, suppress "
              "inline with a justification, or (pre-existing only) "
              "--update-baseline")
        return 1
    print(f"sofa-lint: clean ({len(findings)} finding(s) total{tail})")
    return 0


if __name__ == "__main__":
    sys.exit(run_lint())
