"""Calibration: what makes a what-if prediction honest (the JAX
package's ``sofa_tpu/whatif/calibrate.py``).

* **Error bars from the run's own variance.**  The measured per-step
  times give a nonparametric 95 % CI of the median by binomial order
  statistics; its half-widths, moved onto the predicted mean, are the
  prediction's error bars.  Below ``MIN_CI_SAMPLES`` steps there is no
  such interval (a sample range is not a 95 % CI), so the verdict is
  ``uncalibrated``, with the reason.
* **The identity gate.**  Replaying the model with no scenario must
  reproduce the measured mean step time within that interval (moved onto
  the measured mean).  The model sums to each step by construction, so a
  failure means a damaged model, and every prediction built on it would
  carry the damage: ``whatif`` then exits 1.

``MIN_CI_SAMPLES``, ``median`` and ``median_ci`` are the JAX package's
``archive/baseline.py`` ones, kept here until the archive is ported.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

#: Fewest samples for an order-statistic 95 % CI of the median.
MIN_CI_SAMPLES = 6


def median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


def median_ci(xs: List[float],
              conf: float = 0.95) -> "Optional[Tuple[float, float]]":
    """Nonparametric CI of the median by binomial order statistics (the
    normal approximation to the rank); None below MIN_CI_SAMPLES."""
    n = len(xs)
    if n < MIN_CI_SAMPLES:
        return None
    s = sorted(xs)
    z = 1.959964 if conf >= 0.95 else 1.644854
    delta = z * math.sqrt(n) / 2.0
    lo = max(0, int(math.floor(n / 2.0 - delta)))
    hi = min(n - 1, int(math.ceil(n / 2.0 + delta)) - 1)
    return s[lo], s[hi]


#: Calibration verdict vocabulary (report + meta.whatif).
CALIBRATION_VERDICTS = ("calibrated", "uncalibrated")


def calibration(measured: List[float], identity_mean: float) -> dict:
    """The report's ``calibration`` section from the measured per-step
    times and the zero-scenario replayed mean."""
    n = len(measured)
    out: dict = {"n_steps": n}
    if n == 0:
        out.update(verdict="uncalibrated",
                   reason="no step spans in the trace — nothing to "
                          "calibrate against (is gpusteps captured?)")
        return out
    mean = sum(measured) / n
    med = median(measured)
    out.update(measured_mean_s=round(mean, 9),
               measured_median_s=round(med, 9),
               identity_mean_s=round(identity_mean, 9),
               identity_error_pct=round(
                   100.0 * abs(identity_mean - mean) / mean, 6)
                   if mean > 0 else 0.0)
    ci = median_ci(measured)
    if ci is None:
        out.update(ci=None, verdict="uncalibrated",
                   reason=f"only {n} step sample(s) — no defensible 95% "
                          f"CI (need >= {MIN_CI_SAMPLES})")
        return out
    lo, hi = ci
    out["ci"] = [round(lo, 9), round(hi, 9)]
    # The gate interval is the median CI translated to the measured mean:
    # same variance scale, centered on the quantity the replay reproduces.
    gate_lo = mean - (med - lo)
    gate_hi = mean + (hi - med)
    if gate_lo <= identity_mean <= gate_hi:
        out.update(verdict="calibrated",
                   reason=f"zero-scenario replay reproduces the measured "
                          f"mean within [{gate_lo:g}, {gate_hi:g}]")
    else:
        out.update(verdict="uncalibrated",
                   reason=f"zero-scenario replay ({identity_mean:g}s) "
                          f"falls outside [{gate_lo:g}, {gate_hi:g}] — "
                          "the timeline model does not reproduce this "
                          "run; scenario predictions would inherit the "
                          "error")
    return out


def error_bars(calib: dict, predicted_mean: float) -> "Optional[list]":
    """``[lo, hi]`` around a predicted mean: the measured median CI's
    half-widths translated to the prediction; None when the run was too
    short for a defensible interval."""
    ci = calib.get("ci")
    med = calib.get("measured_median_s")
    if not ci or med is None:
        return None
    lo = predicted_mean - (med - ci[0])
    hi = predicted_mean + (ci[1] - med)
    return [round(max(lo, 0.0), 9), round(max(hi, 0.0), 9)]
