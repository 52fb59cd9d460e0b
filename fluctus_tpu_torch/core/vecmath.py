"""Batched 3-vector math on (..., 3) float32 tensors
(counterpart of `fluctus_tpu/core/vecmath.py`).

Dot products are written out as ((x + y) + z) so that the sum order is
fixed: the same order the CUDA kernels use, and the order XLA gives the
JAX package's three-element reductions.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) x (..., 3) -> (...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product keeping the last axis, for broadcasting against (..., 3)."""
    return dot(a, b)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize; zero vectors stay zero."""
    n2 = dot3(a, a)
    inv = torch.where(n2 > 0.0, 1.0 / torch.sqrt(torch.clamp(n2, min=EPS)),
                      0.0)
    return a * inv


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror `d` (pointing toward the surface) about `n`
    (reference: src/utils.cl:30-33)."""
    return d - 2.0 * dot3(d, n) * n


def refract(wi: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Un-normalized refracted direction, eta = n1/n2
    (reference: src/utils.cl:36-43)."""
    if eta.dim() < wi.dim():
        eta = eta[..., None]
    i_dot_n = dot3(-wi, n)
    sin2_t = eta * eta * torch.clamp(1.0 - i_dot_n * i_dot_n, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return wi * eta + n * (eta * i_dot_n - cos_t)


def ortho_basis(n: torch.Tensor):
    """Branchless orthonormal (t, b) around unit `n` (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def luminance(c: torch.Tensor) -> torch.Tensor:
    """sRGB luminance (reference: src/utils.cl:237-240)."""
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def is_zero(v: torch.Tensor) -> torch.Tensor:
    return (v == 0.0).all(dim=-1)


def where3(mask: torch.Tensor, a, b) -> torch.Tensor:
    return torch.where(mask[..., None], a, b)
