"""Fresnel terms (counterpart of `fluctus_tpu/ops/fresnel.py`; reference:
src/fresnel.cl:5-63): the exact dielectric term the BSDFs use, Schlick's
approximation and the RGB conductor term."""
from __future__ import annotations

import torch


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel; 1 on total internal
    reflection."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = eta_i / eta_t * sin_i
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    parl = ((eta_t * cos_i) - (eta_i * cos_t)) / \
        torch.clamp((eta_t * cos_i) + (eta_i * cos_t), min=1e-12)
    perp = ((eta_i * cos_i) - (eta_t * cos_t)) / \
        torch.clamp((eta_i * cos_i) + (eta_t * cos_t), min=1e-12)
    f = 0.5 * (parl * parl + perp * perp)
    return torch.where(sin_t >= 1.0, 1.0, f)



def _sqrt(x):
    """float32 square root rounded correctly, as XLA's is (through float64,
    whose root rounds to the nearest float32): PyTorch's vectorised CPU
    root can be an ulp off, which the conductor term's cancellations
    magnify a hundredfold."""
    return torch.sqrt(x.double()).float()


def schlick_dielectric(cos_i, eta_i, eta_t):
    """Schlick's approximation (reference: src/fresnel.cl:23-34); 1 on
    total internal reflection. The fifth power is c * (c^2)^2, the
    product XLA forms for `c ** 5`."""
    eta = eta_i / eta_t
    sin_i = _sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    r0 = ((1.0 - eta) * (1.0 - eta)) / ((1.0 + eta) * (1.0 + eta))
    c = 1.0 - torch.abs(cos_i)
    c2 = c * c
    f = r0 + (1.0 - r0) * (c * (c2 * c2))
    return torch.where(eta * sin_i >= 1.0, 1.0, f)


def fresnel_conductor(cos_i, eta_i, eta_t, k):
    """RGB conductor Fresnel (PBRT eq. 8.3/8.4; reference:
    src/fresnel.cl:40-63); eta_i, eta_t and k are (..., 3)."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)[..., None]
    eta = eta_t / eta_i
    etak = k / eta_i
    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - sin2
    a2b2 = _sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * etak2, min=0.0))
    t1 = a2b2 + cos2
    a = _sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * cos_i * a
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)
