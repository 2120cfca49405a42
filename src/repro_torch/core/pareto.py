"""Technology-cost trade-off analysis (paper §IV-I, Fig. 9, Table 7);
counterpart of ``repro/core/pareto.py``, host numpy like it.

``pareto_front`` is one (N, N, D) strict/weak dominance broadcast (the
fronts here are final GA populations across seeds, a few hundred points
at most); ``hypervolume_2d`` and ``front_coverage`` (Zitzler's C-metric)
measure fronts; ``edap_cost_front`` builds Fig. 9's front.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated (minimize-all) points of (N, D).

    Point j dominates point i iff j <= i in every dimension and j < i
    in at least one; duplicates do not dominate each other, so every
    copy of a non-dominated point is kept (matching the original loop's
    semantics — domination is transitive, so testing against all points
    equals testing against surviving points)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.shape[0] == 0:
        return np.zeros((0,), dtype=np.intp)
    le = np.all(pts[:, None, :] <= pts[None, :, :], axis=2)  # j <= i
    lt = np.any(pts[:, None, :] < pts[None, :, :], axis=2)   # j < i some dim
    dominated = np.any(le & lt, axis=0)  # any j dominates i
    return np.nonzero(~dominated)[0]


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Hypervolume (minimize-both) of a 2-D point set wrt ``ref``.

    The Lebesgue measure of the region dominated by the set and bounded
    by the reference point — the searched-vs-post-hoc front comparison
    metric in the experiment reports (larger = better front). Points at
    or beyond ``ref`` in either dimension contribute nothing. O(n log n):
    reduce to the non-dominated subset, sweep by x ascending
    (y then strictly descends), sum the (ref_x - x) × (y_prev - y)
    slabs."""
    pts = np.asarray(points, np.float64)
    ref = np.asarray(ref, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"hypervolume_2d needs (N, 2) points, "
                         f"got {pts.shape}")
    pts = pts[np.all(pts < ref[None, :], axis=1)]
    if pts.shape[0] == 0:
        return 0.0
    pts = pts[pareto_front(pts)]
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    hv = 0.0
    y_prev = ref[1]
    for x, y in pts:
        if y < y_prev:  # duplicates / x-ties add no area
            hv += (ref[0] - x) * (y_prev - y)
            y_prev = y
    return float(hv)


def front_coverage(a: np.ndarray, b: np.ndarray) -> float:
    """Zitzler's C-metric C(A, B): the fraction of points in ``b``
    weakly dominated by (<= everywhere) some point of ``a``. C = 1
    means A covers B entirely; C(A, B) and C(B, A) are independent."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if b.shape[0] == 0:
        return 0.0
    if a.shape[0] == 0:
        return 0.0
    covered = np.any(np.all(a[:, None, :] <= b[None, :, :], axis=2),
                     axis=0)
    return float(np.mean(covered))


def edap_cost_front(edap: np.ndarray, cost: np.ndarray,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pareto front over (EDAP, fabrication cost); returns (idx, edap, cost)
    sorted by cost, mirroring Fig. 9's front construction."""
    idx = pareto_front(np.stack([edap, cost], axis=1))
    order = np.argsort(cost[idx])
    idx = idx[order]
    return idx, edap[idx], cost[idx]
