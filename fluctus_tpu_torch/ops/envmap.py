"""Env-map ops: direction mapping, bilinear lookup, alias-method sampling
and pdf queries (counterpart of `fluctus_tpu/ops/envmap.py`; reference:
src/env_map.cl).

The lat-long convention is the USC HighResProbes mapping of the
reference: u = (1 + atan2(x, -z) / pi) / 2, v = acos(y / |d|) / pi. Every
expression follows the JAX package's order; atan2, acos, sin and cos are
PyTorch's, which may differ from XLA's by a few ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from fluctus_tpu_torch.core import vecmath as vm
from fluctus_tpu_torch.core.types import EnvMap

PI = float(np.float32(np.pi))
TWO_PI2 = float(np.float32(2.0 * np.pi * np.pi))


def direction_to_uv(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 2) uv in [0, 1]^2 (reference: src/env_map.cl:14-25);
    a zero direction maps to (0, 0)."""
    u = (1.0 + torch.atan2(d[..., 0], -d[..., 2]) / PI) * 0.5
    r = torch.clamp(d[..., 1] / torch.clamp(vm.length(d), min=1e-20),
                    -1.0, 1.0)
    v = torch.arccos(r) / PI
    zero = vm.is_zero(d)
    return torch.stack([torch.where(zero, 0.0, u),
                        torch.where(zero, 0.0, v)], dim=-1)


def uv_to_direction(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(...,) uv -> (..., 3) unit direction (reference: src/env_map.cl:29-38)."""
    phi = v * PI
    theta = (u * 2.0 - 1.0) * PI
    sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
    sin_th, cos_th = torch.sin(theta), torch.cos(theta)
    return torch.stack([sin_phi * sin_th, cos_phi, -sin_phi * cos_th],
                       dim=-1)


def eval_uv(env: EnvMap, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup at float uv with clamp-to-edge addressing
    (reference: src/env_map.cl:7-10,45-48)."""
    h, w = env.image.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.clamp(torch.floor(x), 0, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 1).to(torch.int64)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    img = env.image
    c00 = img[y0, x0]
    c01 = img[y0, x1]
    c10 = img[y1, x0]
    c11 = img[y1, x1]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def eval_dir(env: EnvMap, d: torch.Tensor) -> torch.Tensor:
    """Radiance arriving from direction d (reference: src/env_map.cl:39-43)."""
    uv = direction_to_uv(d)
    return eval_uv(env, uv[..., 0], uv[..., 1])


def _alias_draw(env: EnvMap, u_rnd: torch.Tensor):
    """Texel index of an alias-method draw of the flat image distribution,
    its pdf_table entry and its direction's solid-angle pdf and unit
    direction (reference: src/env_map.cl:65-92)."""
    h, w = env.image.shape[:2]
    n = w * h
    r = u_rnd * n
    i = torch.clamp(torch.floor(r).to(torch.int64), max=n - 1)
    frac = r - i
    take_self = frac < env.prob_table[i]
    uv_ind = torch.where(take_self, i, env.alias_table[i].to(torch.int64))
    pdf_uv = env.pdf_table[uv_ind]

    u_ind = uv_ind % w
    v_ind = uv_ind // w
    u = (u_ind.to(torch.float32) + 0.5) / w
    v = (v_ind.to(torch.float32) + 0.5) / h
    L = uv_to_direction(u, v)
    sin_th = torch.sin(PI * v)
    pdf_w = torch.where(sin_th != 0.0,
                        pdf_uv / (TWO_PI2 * torch.clamp(sin_th, min=1e-20)),
                        0.0)
    return uv_ind, L, pdf_w


def sample_alias(env: EnvMap, u_rnd: torch.Tensor):
    """O(1) alias-method sample of the image distribution: (L (..., 3)
    unit, pdf_w (...,)) (reference: src/env_map.cl:65-92)."""
    _, L, pdf_w = _alias_draw(env, u_rnd)
    return L, pdf_w


def sample_alias_radiance(env: EnvMap, u_rnd: torch.Tensor):
    """sample_alias and the sampled texel's radiance: (L, pdf_w, radiance
    (..., 3)). A bilinear lookup at a texel centre is the texel itself, and
    that texel is what the pdf was built from."""
    uv_ind, L, pdf_w = _alias_draw(env, u_rnd)
    rad = env.image.reshape(-1, 3)[uv_ind]
    return L, pdf_w, rad


def pdf_dir(env: EnvMap, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of sampling direction d, for MIS
    (reference: src/env_map.cl:95-107)."""
    h, w = env.image.shape[:2]
    uv = direction_to_uv(d)
    sin_th = torch.sin(uv[..., 1] * PI)
    iu = torch.clamp(torch.floor(uv[..., 0] * w).to(torch.int64), max=w - 1)
    iv = torch.clamp(torch.floor(uv[..., 1] * h).to(torch.int64), max=h - 1)
    pdf = env.pdf_table[iv * w + iu] / (TWO_PI2 * torch.clamp(sin_th,
                                                               min=1e-20))
    return torch.where(sin_th == 0.0, 0.0, pdf)
