"""Bjøntegaard delta-rate computation.

Copied from `diffcodec_tpu/eval/bd_rate.py` (numpy and scipy only).

Parity target: `BD_rate_eval.py:6-80`: sort by quality (sign-flipped for
lower-is-better metrics), clamp to the overlapping quality range
(`bd_rate`) or extend the union range by 5% (`bd_rate_safe`), PCHIP (or
linear for <3 points) interpolation of log-rate over quality, trapezoid
integration on 100 points, (exp(Δ)−1)·100%.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.interpolate import PchipInterpolator, interp1d


def _dedupe(Q, logR):
    """Collapse duplicate quality values by averaging log-rate (PCHIP needs
    strictly increasing x; the reference would crash on ties)."""
    uq, inv = np.unique(Q, return_inverse=True)
    if len(uq) == len(Q):
        return Q, logR
    means = np.zeros(len(uq))
    for i in range(len(uq)):
        means[i] = logR[inv == i].mean()
    return uq, means


def _interp(Q, logR, extrapolate=False):
    Q, logR = _dedupe(np.asarray(Q), np.asarray(logR))
    if len(Q) >= 3:
        return PchipInterpolator(Q, logR, extrapolate=extrapolate or None)
    return interp1d(Q, logR, fill_value="extrapolate")


def bd_rate(R1: Sequence[float], Q1: Sequence[float], R2: Sequence[float],
            Q2: Sequence[float], higher_better: bool = True) -> float:
    """BD-rate % of (R2, Q2) vs anchor (R1, Q1); NaN when no quality
    overlap."""
    R1, Q1, R2, Q2 = map(np.asarray, (R1, Q1, R2, Q2))
    if not higher_better:
        Q1, Q2 = -Q1, -Q2
    s1, s2 = np.argsort(Q1), np.argsort(Q2)
    Q1, R1 = Q1[s1], R1[s1]
    Q2, R2 = Q2[s2], R2[s2]
    minQ = max(Q1.min(), Q2.min())
    maxQ = min(Q1.max(), Q2.max())
    if maxQ <= minQ:
        return float("nan")
    f1 = _interp(Q1, np.log(R1))
    f2 = _interp(Q2, np.log(R2))
    Qs = np.linspace(minQ, maxQ, 100)
    int1 = np.trapezoid(f1(Qs), Qs)
    int2 = np.trapezoid(f2(Qs), Qs)
    avg_diff = (int2 - int1) / (maxQ - minQ)
    return float((np.exp(avg_diff) - 1) * 100)


def bd_rate_safe(R1, Q1, R2, Q2, higher_better: bool = True) -> float:
    """Extended-range variant (`BD_rate_eval.py:51-80`): integrates over the
    union quality range stretched by ±5%, extrapolating both curves."""
    R1, Q1, R2, Q2 = map(np.asarray, (R1, Q1, R2, Q2))
    if not higher_better:
        Q1, Q2 = -Q1, -Q2
    s1, s2 = np.argsort(Q1), np.argsort(Q2)
    Q1, R1 = Q1[s1], R1[s1]
    Q2, R2 = Q2[s2], R2[s2]
    minQ = min(Q1.min(), Q2.min()) * 0.95
    maxQ = max(Q1.max(), Q2.max()) * 1.05
    f1 = _interp(Q1, np.log(R1), extrapolate=True)
    f2 = _interp(Q2, np.log(R2), extrapolate=True)
    Qs = np.linspace(minQ, maxQ, 100)
    int1 = np.trapezoid(f1(Qs), Qs)
    int2 = np.trapezoid(f2(Qs), Qs)
    avg_diff = (int2 - int1) / (maxQ - minQ)
    return float((np.exp(avg_diff) - 1) * 100)


def extrapolate_rd_curve(bpp, quality, n_points: int = 7,
                         extend_factor: float = 0.1):
    """Linear RD-curve extrapolation + monotonicity forcing
    (`bd_test.py:56-78`): resample onto a bpp grid extended by
    +-extend_factor (min clamped to 0.001), cumulative enforcement matching
    the original curve's direction.  Divergence (bug fix): the reference's
    decreasing branch (`bd_test.py:76`,
    `np.minimum.accumulate(q[::-1])[::-1]`) collapses every decreasing
    curve to a constant; the correct enforcement is a left-to-right
    cumulative minimum."""
    bpp = np.asarray(bpp, np.float64)
    quality = np.asarray(quality, np.float64)
    order = np.argsort(bpp)
    bpp, quality = bpp[order], quality[order]
    f = interp1d(bpp, quality, kind="linear", fill_value="extrapolate")
    min_bpp = max(bpp.min() * (1 - extend_factor), 0.001)
    max_bpp = bpp.max() * (1 + extend_factor)
    new_bpp = np.linspace(min_bpp, max_bpp, n_points)
    new_q = f(new_bpp)
    if np.all(np.diff(quality) > 0):
        new_q = np.maximum.accumulate(new_q)
    elif np.all(np.diff(quality) < 0):
        new_q = np.minimum.accumulate(new_q)
    return new_bpp, new_q


def bd_rate_pchip_exact(R1, Q1, R2, Q2, higher_better: bool = True
                        ) -> float:
    """BD-rate with *exact* PCHIP integration over the quality overlap —
    the `bjontegaard` pip package's `method='pchip', min_overlap=0` math
    (`bd_test.py` computes through that library, not through
    `BD_rate_eval.py`'s 100-point trapezoid)."""
    R1, Q1, R2, Q2 = map(np.asarray, (R1, Q1, R2, Q2))
    if not higher_better:
        Q1, Q2 = -Q1, -Q2
    s1, s2 = np.argsort(Q1), np.argsort(Q2)
    Q1, R1 = Q1[s1], R1[s1]
    Q2, R2 = Q2[s2], R2[s2]
    minQ = max(Q1.min(), Q2.min())
    maxQ = min(Q1.max(), Q2.max())
    if maxQ <= minQ:
        return float("nan")
    f1 = _interp(Q1, np.log(R1))
    f2 = _interp(Q2, np.log(R2))
    if hasattr(f1, "integrate") and hasattr(f2, "integrate"):
        int1 = float(f1.integrate(minQ, maxQ))
        int2 = float(f2.integrate(minQ, maxQ))
    else:  # <3-point linear fallback: trapezoid is exact for linear
        Qs = np.linspace(minQ, maxQ, 100)
        int1 = np.trapezoid(f1(Qs), Qs)
        int2 = np.trapezoid(f2(Qs), Qs)
    avg_diff = (int2 - int1) / (maxQ - minQ)
    return float((np.exp(avg_diff) - 1) * 100)


def bd_rate_extrapolated(R1, Q1, R2, Q2, higher_better: bool = True,
                         sanity_threshold: float = 1000.0) -> float:
    """`bd_test.py:81-108` variant: extrapolate both curves, sign-flip
    lower-is-better metrics, exact-integration PCHIP BD-rate (the
    `bjontegaard` library's math), NaN on non-increasing rates /
    non-positive rates / unstable (>threshold %) results."""
    R1e, Q1e = extrapolate_rd_curve(np.asarray(R1), np.asarray(Q1))
    R2e, Q2e = extrapolate_rd_curve(np.asarray(R2), np.asarray(Q2))
    if not (np.all(np.diff(R1e) > 0) and np.all(np.diff(R2e) > 0)):
        return float("nan")
    if np.any(R1e <= 0) or np.any(R2e <= 0):
        return float("nan")
    out = bd_rate_pchip_exact(R1e, Q1e, R2e, Q2e,
                              higher_better=higher_better)
    if not np.isfinite(out) or abs(out) > sanity_threshold:
        return float("nan")
    return out


def bd_quality(R1, Q1, R2, Q2, higher_better: bool = True) -> float:
    """BD-quality (e.g. BD-PSNR): average quality difference at equal rate.
    Companion metric (standard Bjøntegaard definition, same interpolation
    style as bd_rate but with axes swapped)."""
    R1, Q1, R2, Q2 = map(np.asarray, (R1, Q1, R2, Q2))
    sign = 1.0 if higher_better else -1.0
    Q1, Q2 = sign * Q1, sign * Q2
    lR1, lR2 = np.log(R1), np.log(R2)
    s1, s2 = np.argsort(lR1), np.argsort(lR2)
    lR1, Q1 = lR1[s1], Q1[s1]
    lR2, Q2 = lR2[s2], Q2[s2]
    minR = max(lR1.min(), lR2.min())
    maxR = min(lR1.max(), lR2.max())
    if maxR <= minR:
        return float("nan")
    f1 = _interp(lR1, Q1)
    f2 = _interp(lR2, Q2)
    Rs = np.linspace(minR, maxR, 100)
    int1 = np.trapezoid(f1(Rs), Rs)
    int2 = np.trapezoid(f2(Rs), Rs)
    return float(sign * (int2 - int1) / (maxR - minR))
