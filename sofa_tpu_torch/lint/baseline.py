"""Finding baseline: grandfather existing violations, fail only new ones.

The checked-in ``sofa_tpu_torch/lint_baseline.json`` is a ratchet — it
records the findings the port carries over from its counterpart's own
baseline, keyed by a content fingerprint, so the tree lints clean today
while any NEW violation fails immediately.  The workflow contract
(sofa_tpu_torch/docs/STATIC_ANALYSIS.md):

* the baseline only ever **shrinks**: fix a grandfathered finding
  and ``--update-baseline`` expires its entry; adding entries for new code
  is a review smell (suppress inline with a justification instead, or fix);
* fingerprints key on (rule, file, normalized source line, occurrence
  index) — NOT the line number — so unrelated edits above a grandfathered
  site do not churn the file, while any edit to the flagged line itself
  (e.g. deleting its ``timeout=``) produces a fresh fingerprint and fails.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

from sofa_tpu_torch.lint.core import Finding

BASELINE_NAME = "lint_baseline.json"
_WS = re.compile(r"\s+")


def fingerprint(f: Finding, line_text: str, occurrence: int) -> str:
    norm = _WS.sub(" ", line_text.strip())
    raw = f"{f.rule_id}|{f.file}|{norm}|{occurrence}"
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def fingerprint_findings(findings: Sequence[Finding],
                         line_text_for) -> List[Tuple[str, Finding]]:
    """[(fingerprint, finding)] with duplicate (rule, file, text) sites
    disambiguated by an occurrence counter in file order.  ``line_text_for``
    maps a Finding to its source line's text."""
    counts: Dict[Tuple[str, str, str], int] = {}
    out: List[Tuple[str, Finding]] = []
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule_id)):
        text = _WS.sub(" ", line_text_for(f).strip())
        key = (f.rule_id, f.file, text)
        occ = counts.get(key, 0)
        counts[key] = occ + 1
        out.append((fingerprint(f, text, occ), f))
    return out


class Baseline:
    """Load/compare/write the grandfather ledger."""

    def __init__(self, entries: Dict[str, dict], path: str = ""):
        self.entries = entries
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return cls({}, path)
        if not isinstance(doc, dict) or \
                not isinstance(doc.get("entries"), list):
            raise ValueError(f"{path}: not a sofa-lint baseline")
        entries = {e["fingerprint"]: e for e in doc["entries"]
                   if isinstance(e, dict) and "fingerprint" in e}
        return cls(entries, path)

    def split(self, fingerprinted: Sequence[Tuple[str, Finding]]
              ) -> Tuple[List[Finding], List[Finding]]:
        """(new, grandfathered) partition of the current findings."""
        new, old = [], []
        for fp, f in fingerprinted:
            (old if fp in self.entries else new).append(f)
        return new, old

    @staticmethod
    def write(path: str,
              fingerprinted: Sequence[Tuple[str, Finding]]) -> dict:
        """Regenerate the baseline from the current findings: entries for
        findings that disappeared expire, current ones are (re)recorded.
        The review contract that the file never grows lives in code review
        and the self-run test, not here — --update-baseline must be able
        to seed the initial ledger."""
        entries = [
            {"fingerprint": fp, "rule": f.rule_id, "file": f.file,
             "line": f.line, "message": f.message[:120]}
            for fp, f in sorted(fingerprinted,
                                key=lambda p: (p[1].file, p[1].line,
                                               p[1].rule_id))
        ]
        doc = {"tool": "sofa-lint", "version": 1, "entries": entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return doc


def _repo_root() -> str:
    """The directory holding this package (the repo root)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def package_baseline() -> str:
    """``sofa_tpu_torch/lint_baseline.json``: the port's own ledger."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), BASELINE_NAME)


def locate_baseline(start: str) -> str:
    """Walk up from ``start`` to find the checked-in baseline; falls back
    to the port's own ``sofa_tpu_torch/lint_baseline.json`` so the tool
    works from any cwd.  The repo root's ``lint_baseline.json`` is the
    JAX package's ledger: the walk never takes it."""
    foreign = os.path.join(_repo_root(), BASELINE_NAME)
    cur = os.path.abspath(start if os.path.isdir(start)
                          else os.path.dirname(start) or ".")
    while True:
        cand = os.path.join(cur, BASELINE_NAME)
        if cand == foreign:
            break
        if os.path.isfile(cand):
            return cand
        nxt = os.path.dirname(cur)
        if nxt == cur:
            break
        cur = nxt
    return package_baseline()


def anchor_of(baseline_path: str) -> str:
    """The directory findings' paths are relative to: the baseline's own
    directory, or its parent when the baseline sits inside a package
    (``sofa_tpu_torch/lint_baseline.json`` anchors at the repo root, so
    findings read ``sofa_tpu_torch/...``)."""
    d = os.path.dirname(os.path.abspath(baseline_path))
    if os.path.isfile(os.path.join(d, "__init__.py")):
        return os.path.dirname(d)
    return d
