"""Counter-based PCG4D random numbers, bit-exact with
`fluctus_tpu/core/rng.py`.

Each draw hashes the counter (pixel, sample, bounce, stream) with PCG4D
(Jarzynski & Olano, JCGT 2020), so any stage can be replayed exactly.
PyTorch's CPU build has no uint32 arithmetic, so the hash runs in int32:
two's-complement multiply and add wrap exactly like uint32, and every right
shift is masked to a logical shift.
"""
from __future__ import annotations

import torch

_INV_2_24 = 1.0 / (1 << 24)


class Streams:
    """Decision-point stream ids per bounce (same ids as the JAX package)."""
    AA_X = 0
    AA_Y = 1
    LENS_R = 2
    LENS_TH = 3
    LIGHT_PICK = 4
    LIGHT_U = 5
    LIGHT_V = 6
    BSDF_U = 7
    BSDF_V = 8
    BSDF_LOBE = 9
    ROULETTE = 10
    LIGHT_AREA_U = 11
    LIGHT_AREA_V = 12
    NUM = 16


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _pcg4d(x, y, z, w):
    x = x * 1664525 + 1013904223
    y = y * 1664525 + 1013904223
    z = z * 1664525 + 1013904223
    w = w * 1664525 + 1013904223
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ _shr(x, 16)
    y = y ^ _shr(y, 16)
    z = z ^ _shr(z, 16)
    w = w ^ _shr(w, 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _as_i32(v, device) -> torch.Tensor:
    """Counter -> int32 tensor holding the uint32 bit pattern."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64).bitwise_and(
            0xFFFFFFFF).to(torch.int32) if v.dtype != torch.int32 \
            else v.to(device)
    v = int(v) & 0xFFFFFFFF
    return torch.tensor(v - (1 << 32) if v >= 1 << 31 else v,
                        dtype=torch.int32, device=device)


def _device_of(*vals):
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def hash4(pixel, sample, bounce, stream) -> tuple:
    """Raw PCG4D of broadcastable uint32 counters: four int32 tensors that
    hold the uint32 output bits."""
    dev = _device_of(pixel, sample, bounce, stream)
    p, s, b, st = torch.broadcast_tensors(
        *(_as_i32(v, dev) for v in (pixel, sample, bounce, stream)))
    return _pcg4d(p, s, b, st)


def to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniform in [0, 1) from the top 24 bits."""
    return _shr(bits, 8).to(torch.float32) * _INV_2_24


def uniform(pixel, sample, bounce, stream) -> torch.Tensor:
    return to_unit_float(hash4(pixel, sample, bounce, stream)[0])


def uniform2(pixel, sample, bounce, stream) -> tuple:
    """Two independent uniforms per counter tuple (one hash)."""
    h = hash4(pixel, sample, bounce, stream)
    return to_unit_float(h[0]), to_unit_float(h[1])


def uniform4(pixel, sample, bounce, stream) -> tuple:
    """Four independent uniforms per counter tuple (one hash)."""
    return tuple(to_unit_float(x) for x in hash4(pixel, sample, bounce,
                                                  stream))
