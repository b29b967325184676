"""The what-if scenario vocabulary (the JAX package's
``sofa_tpu/whatif/scenarios.py``).

A scenario is a small typed edit to the step-timeline model
(``whatif/model.py``) that the replayer (``whatif/replay.py``) applies
analytically, with no run on the card.  The kinds, parsed from
``whatif --apply <spec>[,<spec>...]`` (or a TOML ``whatif_apply``):

  overlap:<pattern>          hide the exposed collectives whose class
                             matches <pattern> behind the step's compute
                             (bounded by the compute actually there)
  scale:<pattern>=<factor>   rescale the matching compute classes' time by
                             <factor> (0.5 = twice as fast)
  scale:<pattern>=sol        rescale the matching compute classes to
                             their speed-of-light time (per device, from
                             the ``sol_roofline`` pass's sol_roofline.csv)
  link:<factor>              an interconnect <factor>x faster: every
                             exposed collective shrinks by 1/<factor>
  batch:<factor>             rescale every compute term by <factor> while
                             the communication stays (weak scaling)

Patterns are case-insensitive fnmatch over the model's component classes:
on a CUDA trace, the op that launched a kernel (``aten::mm``,
``aten::cudnn_convolution``) or a flash kernel's cost range
(``sofa_flash_fwd``), lowercased.  An unknown or malformed spec is kept
with kind ``unknown`` and reported with its reason, never aborting the
replay of the others.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union

#: The scenario kinds the replayer knows how to apply.
KINDS = ("overlap", "scale", "link", "batch")

#: The factor spelling that pulls measured roofline headroom instead of a
#: literal number (``scale:<pattern>=sol``).
SOL = "sol"


@dataclass(frozen=True)
class Scenario:
    """One parsed scenario.  ``kind == "unknown"`` marks a spec the
    parser could not type — carried through so the report can state it."""

    kind: str
    spec: str
    pattern: str = "*"
    factor: Union[float, str] = 1.0
    problem: str = ""

    @property
    def known(self) -> bool:
        return self.kind in KINDS


def _unknown(spec: str, why: str) -> Scenario:
    return Scenario(kind="unknown", spec=spec, problem=why)


def _parse_factor(text: str, spec: str) -> "Tuple[float, str]":
    try:
        f = float(text)
    except ValueError:
        return 1.0, (f"{spec!r}: factor {text!r} is not a number")
    if not (f > 0):
        return 1.0, (f"{spec!r}: factor must be > 0, got {f:g}")
    return f, ""


def parse_scenario(spec: str) -> Scenario:
    """One ``kind:args`` spec -> a Scenario (possibly ``unknown``)."""
    spec = spec.strip()
    kind, sep, rest = spec.partition(":")
    kind = kind.strip().lower()
    rest = rest.strip()
    if kind not in KINDS:
        return _unknown(spec, f"unknown scenario kind {kind or spec!r} "
                              f"(known: {', '.join(KINDS)})")
    if not sep or not rest:
        return _unknown(spec, f"{spec!r}: missing arguments after "
                              f"{kind!r}:")
    if kind == "overlap":
        return Scenario(kind=kind, spec=spec, pattern=rest)
    if kind == "scale":
        pattern, eq, factor_s = rest.partition("=")
        pattern = pattern.strip()
        factor_s = factor_s.strip().lower()
        if not eq or not pattern or not factor_s:
            return _unknown(
                spec, f"{spec!r}: scale needs <pattern>=<factor|sol>")
        if factor_s == SOL:
            return Scenario(kind=kind, spec=spec, pattern=pattern,
                            factor=SOL)
        f, err = _parse_factor(factor_s, spec)
        if err:
            return _unknown(spec, err)
        return Scenario(kind=kind, spec=spec, pattern=pattern, factor=f)
    # link / batch: a bare factor
    f, err = _parse_factor(rest, spec)
    if err:
        return _unknown(spec, err)
    return Scenario(kind=kind, spec=spec, factor=f)


def parse_scenarios(spec: str) -> "Tuple[List[Scenario], List[str]]":
    """Comma-joined spec -> (scenarios in declared order, problems).

    Unknown/malformed entries ride along with ``kind == "unknown"`` AND
    contribute a problem line — degradation with a stated reason, the
    collector-failure contract applied to scenario parsing."""
    scenarios: List[Scenario] = []
    problems: List[str] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        s = parse_scenario(part)
        scenarios.append(s)
        if s.problem:
            problems.append(s.problem)
    return scenarios, problems
