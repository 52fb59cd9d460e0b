"""Edge-avoiding A-trous wavelet denoiser (counterpart of
`fluctus_tpu/ops/denoise.py`; Dammertz et al., HPG 2010, in place of the
reference's OptiX denoiser, src/denoiser/OptixDenoiser.cpp:86-159).

`iterations` passes of a 5x5 B3-spline filter whose hole size doubles each
pass; every tap is weighted by its colour, normal and depth distance to
the centre pixel, so edges survive. The colour is divided by the albedo
first (demodulation, as the OptiX denoiser takes albedo as a guide) and
multiplied back after. In the JAX package this is XLA work, not a Pallas
kernel; here it is plain tensor ops on (H, W, C), on the tensors' device.
"""
from __future__ import annotations

import torch

# 1D B3-spline taps; the 5x5 filter is their outer product (exact in f32)
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[y + dy, x + dx] with the indices clamped to the image (the
    border replicated), as the JAX package's `_shift2d`."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def atrous_denoise(color: torch.Tensor, albedo: torch.Tensor,
                   normal: torch.Tensor, depth: torch.Tensor,
                   iterations: int = 4, sigma_color: float = 1.0,
                   sigma_normal: float = 0.25, sigma_depth: float = 0.05,
                   blend: float = 1.0) -> torch.Tensor:
    """Denoise a linear-radiance image.

    color, albedo: (H, W, 3); normal: (H, W, 3) unit vectors, zero on a
    miss; depth: (H, W), normalised by the caller. blend: 0 returns the
    input, 1 the filtered image (the reference's denoiser blend slider,
    tracer_ui.cpp)."""
    alb = torch.clamp(albedo, min=1e-3)
    out = color / alb
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype,
                           device=out.device)
        for j in range(5):
            for i in range(5):
                dy = (j - 2) * step
                dx = (i - 2) * step
                c = _shift2d(out, dy, dx)
                n = _shift2d(normal, dy, dx)
                d = _shift2d(depth, dy, dx)
                w_c = torch.exp(-((c - out) ** 2).sum(-1)
                                / (sigma_color ** 2 * step))
                w_n = torch.exp(-torch.clamp(
                    1.0 - (n * normal).sum(-1), min=0.0) / sigma_normal)
                w_d = torch.exp(-torch.abs(d - depth) / sigma_depth)
                w = (_B3[j] * _B3[i] * w_c * w_n * w_d)[..., None]
                acc = acc + w * c
                wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-8)
    out = out * alb
    return blend * out + (1.0 - blend) * color
