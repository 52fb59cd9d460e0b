"""Host-side environment map: HDR load and importance-sampling tables
(counterpart of `fluctus_tpu/scene/envmap.py`; reference:
src/envmap.cpp:31-114).

The luminance x sin(theta) map, one flat pdf over the whole image (mean 1)
and Vose's alias tables, with the JAX package's NumPy arithmetic and
worklist order, so the tables are bit-equal to its.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fluctus_tpu_torch.io.hdr import read_hdr


@dataclass
class HostEnvMap:
    image: np.ndarray        # (H, W, 3) float32
    pdf_table: np.ndarray    # (H*W,) float32
    prob_table: np.ndarray   # (H*W,) float32
    alias_table: np.ndarray  # (H*W,) int32


def build_alias_tables(pdf: np.ndarray):
    """Vose's algorithm over a pdf normalized so mean == 1
    (reference: src/envmap.cpp:67-113). O(n), array-based worklists."""
    n = len(pdf)
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    p = pdf.astype(np.float64).copy()

    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        l = small.pop()
        g = large.pop()
        prob[l] = p[l]
        alias[l] = g
        p[g] = (p[g] + p[l]) - 1.0
        (small if p[g] < 1.0 else large).append(g)
    # leftovers get probability 1 (already initialized)
    return prob, alias


def compute_tables(image: np.ndarray) -> HostEnvMap:
    """pdf/prob/alias construction (reference: src/envmap.cpp:31-114)."""
    h, w = image.shape[:2]
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    sin_th = np.sin(np.pi * v)[:, None]
    lum = (0.212671 * image[..., 0] + 0.715160 * image[..., 1]
           + 0.072169 * image[..., 2])
    scalars = (lum * sin_th).reshape(-1).astype(np.float64)

    integral = scalars.sum() / (w * h)
    if integral == 0.0:
        pdf = np.full(w * h, 1.0, np.float64)
    else:
        pdf = scalars / integral  # mean(pdf) == 1 (step-function pdf × n)
    prob, alias = build_alias_tables(pdf)
    return HostEnvMap(
        image=np.ascontiguousarray(image, np.float32),
        pdf_table=pdf.astype(np.float32),
        prob_table=prob,
        alias_table=alias,
    )


def load(path: str) -> HostEnvMap:
    return compute_tables(read_hdr(path))


def dummy() -> HostEnvMap:
    """1×1 black env map so shapes stay static when no map is loaded
    (reference: src/clcontext.cpp:513-519 createEnvMap dummy)."""
    return compute_tables(np.zeros((1, 1, 3), np.float32))
