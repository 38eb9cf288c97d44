"""Arithmetic of the end-to-end metrics (percentiles, rates) and of poses."""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of all values: the smallest value with at
    least q% of the values at or below it."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def rate(count: int, seconds: float) -> float:
    """Work over the whole window: a total count over the total seconds."""
    if seconds <= 0:
        raise ValueError("rate over a window of no length")
    return count / seconds


def rodrigues(w: np.ndarray) -> np.ndarray:
    t = float(np.linalg.norm(w))
    if t < 1e-15:
        return np.eye(3)
    k = w / t
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(t) * K + (1 - math.cos(t)) * K @ K


def pose_matrix(pose6) -> np.ndarray:
    """4x4 of a [w, t] 6-vector (x_new = R(w) x + t)."""
    p = np.asarray(pose6, np.float64)
    T = np.eye(4)
    T[:3, :3] = rodrigues(p[:3])
    T[:3, 3] = p[3:]
    return T
