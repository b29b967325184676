"""Rolling-baseline math for the regression engine (the JAX package's
``sofa_tpu/archive/baseline.py``; the same functions, regexes and
limits, so that both packages give one verdict on one catalog).

A verdict needs a defensible interval, and the one a catalog of run
samples gives without assuming a distribution is the nonparametric 95 %
CI of the median from binomial order statistics.  Below 6 samples there
is none (a sample range is not a 95 % CI), so a rolling comparison
against a short history is ``noise``, with the reason stated.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

# Minimum rolling samples for an order-statistic 95 % CI (the same floor
# overhead_budget._median_ci enforces).
MIN_CI_SAMPLES = 6


def median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


def median_ci(xs: List[float],
              conf: float = 0.95) -> "Optional[Tuple[float, float]]":
    """Nonparametric CI for the median via binomial order statistics
    (normal approximation to the rank) — distribution-free, so fat-tailed
    run-to-run jitter can't fake a tight bound.  None below
    MIN_CI_SAMPLES."""
    n = len(xs)
    if n < MIN_CI_SAMPLES:
        return None
    s = sorted(xs)
    z = 1.959964 if conf >= 0.95 else 1.644854
    delta = z * math.sqrt(n) / 2.0
    lo = max(0, int(math.floor(n / 2.0 - delta)))
    hi = min(n - 1, int(math.ceil(n / 2.0 + delta)) - 1)
    return s[lo], s[hi]


def percentile(xs: List[float], pct: float) -> float:
    """Linear-interpolated percentile (pct in [0, 100])."""
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = max(0.0, min(100.0, pct)) / 100.0 * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1 - frac) + s[hi] * frac


# ---------------------------------------------------------------------------
# Feature polarity: which direction is a regression?
# ---------------------------------------------------------------------------

# Higher is worse: durations, latencies, skew, overhead, model error,
# peak memory (the out-of-core frame store's analyze_peak_rss_mb),
# speed-of-light distance (sol_roofline: how far measured kernels sit
# from the hardware's attainable peak — the fleet board's ranking key),
# millisecond latencies (the fleet tier's push/query p50/p99), and the
# observability plane's own cost pair (tier_metrics_overhead_pct /
# tier_scrape_wall_time_s — `_overhead_pct$`/`_wall_time_s$` are pinned
# explicitly; a blanket `_pct$` would flip the higher-is-better payoff
# percentages like whatif_overlap_payoff_pct).  The self-healing tier's
# admission-control pair follows the same rule: tier_recovery_wall_time_s
# rides `_wall_time_s$`, and tier_refusal_rate_pct gets its own
# `_refusal_rate_pct$` pin — more typed refusals under the same load is
# a regression, even though refusing *correctly* is the feature.
_WORSE_HIGH = re.compile(
    r"(^elapsed_time$|_time$|_time_|_wall|latency|overhead|_skew_|ttft"
    r"|_idle|_error_pct$|_rss_mb$|_sol_distance$|_ms$|_overhead_pct$"
    r"|_wall_time_s$|_refusal_rate_pct$)")
# Lower is worse: rates and utilization (including the fleet tier's
# saturation throughput, fleet_saturation_rps).
_WORSE_LOW = re.compile(
    r"(bandwidth|_gbps|per_sec|throughput|flops|images_per_sec|_util$"
    r"|_rps$)")


def polarity(name: str) -> int:
    """+1 = higher is worse (time-like), -1 = lower is worse (rate-like),
    0 = no defensible polarity (counts, ids, coordinates) — a feature
    with no polarity can never earn a regressed/improved verdict."""
    n = name.lower()
    if _WORSE_HIGH.search(n):
        return 1
    if _WORSE_LOW.search(n):
        return -1
    return 0


# ---------------------------------------------------------------------------
# Rolling baselines over the catalog.
# ---------------------------------------------------------------------------

def rolling_samples(store, rolling: int,
                    exclude_run: "str | None" = None
                    ) -> Dict[str, List[float]]:
    """Per-feature sample lists from the newest ``rolling`` archived runs
    (catalog order, the run under test excluded so it cannot vouch for
    itself).

    Index-fed when the archive carries a CURRENT columnar index
    (archive/index.py: the same selection rules, no run-doc open and no
    catalog parse, and the same verdict bytes); the linear catalog scan
    otherwise.  ``SOFA_ARCHIVE_INDEX=0`` forces the scan."""
    import os

    from sofa_tpu_torch.archive import catalog

    if os.environ.get("SOFA_ARCHIVE_INDEX", "1") != "0":
        from sofa_tpu_torch.archive import index as aindex

        hit = aindex.rolling_samples(store.root, rolling,
                                     exclude_run=exclude_run)
        if hit is not None:
            return hit
    entries = catalog.ingest_entries(catalog.read_catalog(store.root))
    out: Dict[str, List[float]] = {}
    taken = 0
    for e in reversed(entries):          # newest first
        if taken >= rolling:
            break
        run_id = e.get("run")
        if run_id == exclude_run:
            continue
        doc = store.load_run(run_id)
        if doc is None:
            continue
        feats = doc.get("features") or {}
        if not feats:
            continue
        taken += 1
        for name, value in feats.items():
            if isinstance(value, (int, float)):
                out.setdefault(name, []).append(float(value))
    for name in out:
        out[name].reverse()              # oldest first, for readers
    return out


def rolling_verdict(value: float, samples: List[float], pct: float,
                    threshold_pct: float, pol: int) -> dict:
    """Verdict of one value against a rolling sample history.

    The reported baseline is the ``pct``-th percentile of the samples;
    the *verdict* requires the value to fall outside the nonparametric
    95 % median CI in the polarity's bad (or good) direction AND to move
    more than ``threshold_pct`` percent relative to that baseline —
    no CI (too few samples) or no polarity means ``noise``, stated."""
    base = percentile(samples, pct) if samples else 0.0
    out = {"baseline": base, "n_samples": len(samples),
           "ratio": _ratio(value, base)}
    if pol == 0:
        out.update(verdict="noise", reason="no polarity for this feature")
        return out
    ci = median_ci(samples)
    if ci is None:
        out.update(verdict="noise",
                   reason=f"only {len(samples)} baseline sample(s) — no "
                          f"defensible 95% CI (need >= {MIN_CI_SAMPLES})")
        return out
    lo, hi = ci
    out["ci"] = [lo, hi]
    moved_pct = abs(value - base) / base * 100.0 if base else (
        0.0 if value == 0 else float("inf"))
    if moved_pct <= threshold_pct:
        out.update(verdict="noise",
                   reason=f"moved {moved_pct:.2f}% <= threshold "
                          f"{threshold_pct:g}%")
        return out
    worse = value > hi if pol > 0 else value < lo
    better = value < lo if pol > 0 else value > hi
    if worse:
        out.update(verdict="regressed",
                   reason=f"outside the 95% median CI [{lo:g}, {hi:g}] "
                          f"in the bad direction ({moved_pct:.1f}% vs the "
                          f"p{pct:g} baseline)")
    elif better:
        out.update(verdict="improved",
                   reason=f"outside the 95% median CI [{lo:g}, {hi:g}] "
                          f"in the good direction ({moved_pct:.1f}%)")
    else:
        out.update(verdict="noise",
                   reason=f"inside the 95% median CI [{lo:g}, {hi:g}]")
    return out


def pairwise_verdict(value: float, base: float, threshold_pct: float,
                     pol: int) -> dict:
    """Verdict of one value against a single explicit baseline value.

    With one sample a CI is impossible, so the defensible interval here
    is the user-supplied relative threshold (``--regress_threshold``,
    default 10 %): inside it everything is ``noise``; polarity-less
    features are always ``noise``.  ``ratio`` keeps ml/diff.py's inf
    convention: a key with zero baseline and nonzero value is
    ratio=inf — visible, never silently dropped."""
    ratio = _ratio(value, base)
    out = {"baseline": base, "ratio": ratio}
    if pol == 0:
        out.update(verdict="noise", reason="no polarity for this feature")
        return out
    if base == 0 and value == 0:
        out.update(verdict="noise", reason="zero in both runs")
        return out
    moved_pct = (abs(value - base) / base * 100.0 if base
                 else float("inf"))
    if moved_pct <= threshold_pct:
        out.update(verdict="noise",
                   reason=f"moved {moved_pct:.2f}% <= threshold "
                          f"{threshold_pct:g}%")
        return out
    worse = (value > base) if pol > 0 else (value < base)
    out.update(
        verdict="regressed" if worse else "improved",
        reason=(f"moved {'+' if value >= base else '-'}"
                f"{moved_pct if moved_pct != float('inf') else 0:.1f}% "
                f"(ratio {ratio:g}) beyond the {threshold_pct:g}% "
                "threshold" if moved_pct != float("inf") else
                "new in this run (ratio inf) with a bad polarity"
                if worse else
                "new in this run (ratio inf) with a good polarity"))
    return out


def _ratio(value: float, base: float) -> float:
    """ml/diff.py's convention: base 0 & value > 0 -> inf (a mover that
    only exists in the new run must be visible); 0/0 -> 1 (unchanged)."""
    if base > 0:
        return value / base
    return float("inf") if value > 0 else 1.0
