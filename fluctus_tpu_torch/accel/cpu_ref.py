"""Brute-force intersector in NumPy, the correctness oracle every
traversal is checked against (counterpart of `fluctus_tpu/accel/cpu_ref.py`,
copied: Moller-Trumbore against every triangle, in float64 where the
inputs are, O(rays x triangles)).
"""
from __future__ import annotations

import numpy as np


def intersect_closest(v0, v1, v2, orig, dir, t_max=np.inf):
    """Moller-Trumbore against every triangle; returns (t, prim, u, v)
    with prim -1 on a miss. orig/dir: (B, 3); triangles: (M, 3)."""
    eps = 1e-12
    e1 = (v1 - v0)[None]          # (1, M, 3)
    e2 = (v2 - v0)[None]
    d = dir[:, None, :]           # (B, 1, 3)
    o = orig[:, None, :]
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, axis=-1)
    valid = np.abs(det) >= eps
    inv_det = np.where(valid, 1.0 / np.where(valid, det, 1.0), 0.0)
    tvec = o - v0[None]
    u = np.sum(tvec * pvec, axis=-1) * inv_det
    qvec = np.cross(tvec, e1)
    v = np.sum(d * qvec, axis=-1) * inv_det
    t = np.sum(e2 * qvec, axis=-1) * inv_det
    valid &= ((u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
              & (t < t_max))
    t = np.where(valid, t, np.inf)
    prim = np.argmin(t, axis=1)
    rows = np.arange(len(orig))
    tt = t[rows, prim]
    hit = np.isfinite(tt)
    return (np.where(hit, tt, t_max).astype(np.float32),
            np.where(hit, prim, -1).astype(np.int32),
            u[rows, prim].astype(np.float32),
            v[rows, prim].astype(np.float32))


def intersect_any(v0, v1, v2, orig, dir, t_max):
    """Occlusion oracle: True where any triangle is hit before t_max."""
    t, prim, _, _ = intersect_closest(v0, v1, v2, orig, dir)
    return (prim >= 0) & (t < t_max)
