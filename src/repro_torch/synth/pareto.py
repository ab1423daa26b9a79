"""Pareto-front utilities for the synthesis engine (DESIGN.md §11).

Small, dependency-free multi-objective helpers over an [M, K] matrix
of objective values with per-column directions (True = maximize).
`eps` relaxation is multiplicative ε-efficiency (the ε-approximate
Pareto set of Papadimitriou & Yannakakis): a point is *within eps of
the front* iff no rival is better by more than a factor (1+eps) in
EVERY objective — equivalently, boosting all its objectives by (1+eps)
toward the good direction makes it non-dominated.  Note the
consequence: a candidate that ties the front's best value in one
objective is ε-efficient regardless of the others (it holds an edge of
the front), which is the intended "on or within 5 %" reading.
"""
from __future__ import annotations

import numpy as np


def _boost(points: np.ndarray, maximize, eps: float) -> np.ndarray:
    pts = np.asarray(points, np.float64).copy()
    for k, mx in enumerate(maximize):
        pts[:, k] = pts[:, k] * (1.0 + eps) if mx \
            else pts[:, k] / (1.0 + eps)
    return pts


def dominates(a, b, maximize) -> bool:
    """True if `a` weakly improves on `b` everywhere, strictly once."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ge = np.where(maximize, a >= b, a <= b)
    gt = np.where(maximize, a > b, a < b)
    return bool(ge.all() and gt.any())


def pareto_mask(points, maximize, eps: float = 0.0) -> np.ndarray:
    """[M] bool: point m is on (eps=0) or within eps of the front.

    NaN rows (unevaluated candidates) are never on the front and never
    dominate anyone.  One broadcast dominance check — this runs over
    the whole pool every search generation, so no per-pair Python.
    """
    pts = np.asarray(points, np.float64)
    m = len(pts)
    maximize = np.asarray(maximize, bool)
    if m == 0:
        return np.zeros(0, dtype=bool)
    boosted = _boost(pts, maximize, eps)
    valid = ~np.isnan(pts).any(axis=1)
    # orient so every objective is "bigger is better"
    sign = np.where(maximize, 1.0, -1.0)
    a = pts * sign                       # [M, K] candidates as dominators
    b = boosted * sign                   # [M, K] candidates as targets
    ge = a[:, None, :] >= b[None, :, :]  # [j, i, k]
    gt = a[:, None, :] > b[None, :, :]
    dom = ge.all(-1) & gt.any(-1) & valid[:, None]   # j dominates i
    np.fill_diagonal(dom, False)
    return valid & ~dom.any(axis=0)


def pareto_front(points, maximize) -> np.ndarray:
    """Indices of the exact Pareto front, in input order."""
    return np.flatnonzero(pareto_mask(points, maximize, eps=0.0))
