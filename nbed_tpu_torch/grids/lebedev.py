"""Lebedev angular quadrature: expand orbit parameters into points/weights
(port of ``nbed_tpu/grids/lebedev.py``, host numpy).

The orbit parameters are the port's copy of the reference's table
(``data_lebedev.py``). This module expands them into unit-sphere points and
weights (weights sum to 1).
"""

import itertools
import math
from functools import lru_cache

import numpy as np

from .data_lebedev import LEBEDEV_PARAMS

__all__ = ["lebedev_grid", "LEBEDEV_PARAMS", "available_orders", "DEGREE_TO_N",
           "order_for_degree"]

_SQ2 = 1.0 / math.sqrt(2.0)
_SQ3 = 1.0 / math.sqrt(3.0)


def _orbit_a1():
    pts = []
    for ax in range(3):
        for sg in (1.0, -1.0):
            p = [0.0, 0.0, 0.0]
            p[ax] = sg
            pts.append(p)
    return np.array(pts)


def _orbit_a2():
    pts = []
    for ax in range(3):
        i, j = [k for k in range(3) if k != ax]
        for si in (1.0, -1.0):
            for sj in (1.0, -1.0):
                p = [0.0, 0.0, 0.0]
                p[i], p[j] = si * _SQ2, sj * _SQ2
                pts.append(p)
    return np.array(pts)


def _orbit_a3():
    return np.array([
        [sx * _SQ3, sy * _SQ3, sz * _SQ3]
        for sx in (1.0, -1.0) for sy in (1.0, -1.0) for sz in (1.0, -1.0)
    ])


def _orbit_b(l):
    m = math.sqrt(max(1.0 - 2.0 * l * l, 0.0))
    pts = []
    for ax in range(3):
        for sx in (1.0, -1.0):
            for sy in (1.0, -1.0):
                for sz in (1.0, -1.0):
                    p = [l, l, l]
                    p[ax] = m
                    pts.append([p[0] * sx, p[1] * sy, p[2] * sz])
    return np.array(pts)


def _orbit_c(q):
    r = math.sqrt(max(1.0 - q * q, 0.0))
    pts = []
    for ax in range(3):
        i, j = [k for k in range(3) if k != ax]
        for (u, v) in ((q, r), (r, q)):
            for si in (1.0, -1.0):
                for sj in (1.0, -1.0):
                    p = [0.0, 0.0, 0.0]
                    p[i], p[j] = si * u, sj * v
                    pts.append(p)
    return np.array(pts)


def _orbit_d(r, s):
    t = math.sqrt(max(1.0 - r * r - s * s, 0.0))
    pts = []
    for perm in itertools.permutations((r, s, t)):
        for sx in (1.0, -1.0):
            for sy in (1.0, -1.0):
                for sz in (1.0, -1.0):
                    pts.append([perm[0] * sx, perm[1] * sy, perm[2] * sz])
    return np.array(pts)


@lru_cache(maxsize=None)
def lebedev_grid(n: int):
    """Return (points (n, 3), weights (n,)) for the n-point Lebedev rule."""
    if n == 1:  # degenerate rule used for the innermost pruned shells
        return np.zeros((1, 3)), np.ones(1)
    try:
        _, spec, params = LEBEDEV_PARAMS[n]
    except KeyError as exc:
        raise KeyError(
            f"No Lebedev rule with {n} points; have {sorted(LEBEDEV_PARAMS)}"
        ) from exc
    pts, wts = [], []
    i = 0
    for key, fn in (("a1", _orbit_a1), ("a2", _orbit_a2), ("a3", _orbit_a3)):
        if spec.get(key):
            o = fn()
            pts.append(o)
            wts.append(np.full(len(o), params[i]))
            i += 1
    for _ in range(spec.get("nb", 0)):
        o = _orbit_b(params[i])
        pts.append(o)
        wts.append(np.full(len(o), params[i + 1]))
        i += 2
    for _ in range(spec.get("nc", 0)):
        o = _orbit_c(params[i])
        pts.append(o)
        wts.append(np.full(len(o), params[i + 1]))
        i += 2
    for _ in range(spec.get("nd", 0)):
        o = _orbit_d(params[i], params[i + 1])
        pts.append(o)
        wts.append(np.full(len(o), params[i + 2]))
        i += 3
    pts = np.concatenate(pts)
    wts = np.concatenate(wts)
    if len(pts) != n:
        raise ValueError(f"Lebedev rule {n} expanded to {len(pts)} points")
    return pts, wts


def available_orders():
    """The point counts of the tabulated rules, ascending."""
    return sorted(LEBEDEV_PARAMS)


# algebraic degree -> point count for the standard rule sequence
DEGREE_TO_N = {deg: n for n, (deg, _, _) in LEBEDEV_PARAMS.items()}


def order_for_degree(degree: int) -> int:
    """Point count of the smallest rule with algebraic degree >= ``degree``
    (the largest rule when none reaches it)."""
    for deg in sorted(DEGREE_TO_N):
        if deg >= degree:
            return DEGREE_TO_N[deg]
    return DEGREE_TO_N[max(DEGREE_TO_N)]
