"""Batched sampling routines on pre-drawn uniforms
(counterpart of `fluctus_tpu/core/samplers.py`; reference:
src/utils.cl:62-112).
"""
from __future__ import annotations

import math

import torch

from fluctus_tpu_torch.core import vecmath as vm

PI = float(torch.tensor(math.pi, dtype=torch.float32))
TWO_PI = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))
INV_PI = float(torch.tensor(1.0 / math.pi, dtype=torch.float32))


def cos_sin(x: torch.Tensor):
    """cos and sin of a float32 tensor, each correctly rounded to float32
    (evaluated in float64): the same values on every device."""
    xd = x.double()
    return torch.cos(xd).float(), torch.sin(xd).float()


def uniform_disk(u1, u2):
    """Uniform point on the unit disk (reference: src/utils.cl:75-80)."""
    r = torch.sqrt(u1)
    c, s = cos_sin(TWO_PI * u2)
    return r * c, r * s


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted direction around unit `n`; returns (dir, pdf)."""
    t, b = vm.ortho_basis(n)
    c, s = cos_sin(TWO_PI * u1)
    r2s = torch.sqrt(u2)
    x = c * r2s
    y = s * r2s
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    d = t * x[..., None] + b * y[..., None] + n * z[..., None]
    pdf = torch.clamp(vm.dot(n, d), min=0.0) * INV_PI
    return d, pdf


def ggx_sample_half_vector(alpha, n, u1, u2):
    """GGX half-vector sample (Walter et al. 2007 eq. 35-36)."""
    a2 = alpha * alpha
    denom = 1.0 + (a2 - 1.0) * u1
    cos_t = torch.sqrt(torch.clamp(
        (1.0 - u1) / torch.clamp(denom, min=1e-20), min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    c, s = cos_sin(TWO_PI * u2)
    t, b = vm.ortho_basis(n)
    h = (t * (sin_t * c)[..., None] + b * (sin_t * s)[..., None]
         + n * cos_t[..., None])
    return vm.normalize(h)


def sample_area_light(pos, right, up, half_size, u1, u2):
    """Uniform point on the rectangular light; returns (point, pdf_area)."""
    pdf_a = 1.0 / (4.0 * half_size[..., 0] * half_size[..., 1])
    r1 = 2.0 * u1 - 1.0
    r2 = 2.0 * u2 - 1.0
    p = (pos + (r1 * half_size[..., 0])[..., None] * right
         + (r2 * half_size[..., 1])[..., None] * up)
    return p, pdf_a


def pdf_area_to_solid_angle(pdf_a, dist, cos_there):
    return pdf_a * dist * dist / torch.clamp(torch.abs(cos_there), min=1e-12)
