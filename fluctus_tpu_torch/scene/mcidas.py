"""A McIdas area decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's McIdasImagePlugin).

A 256-byte directory of 64 big-endian int32 words (w[1..64]): w[11]
bytes a sample (1: "L"; 2: "I;16B"; 4: "I" from big-endian words), the
width w[10] and height w[9], the data at w[34] + w[15] with a row every
w[15] + w[10] * w[11] * w[14] bytes, top row first. The 16- and 32-bit
samples convert to RGBA clipped to 0..255. PIL maps 8- and 16-bit files
into memory, so a stride shorter than a row reads overlapping rows
there; for 32-bit samples, and for a stride of 0, it fails.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import rows, to_rgba

_TYPES = {1: None, 2: ">u2", 4: ">i4"}


def decode_mcidas(data: bytes) -> np.ndarray:
    """McIdas area bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 256:
        raise ValueError("McIdas: short directory")
    w = (0,) + struct.unpack(">64i", data[:256])
    if w[11] not in _TYPES:
        raise ValueError("McIdas: unsupported format")
    width, height, b = w[10], w[9], w[11]
    if width <= 0 or height <= 0:
        raise ValueError("McIdas: empty image")
    offset, stride = w[34] + w[15], w[15] + width * b * w[14]
    if stride <= 0 or (stride < width * b and b == 4):
        raise ValueError("McIdas: bad row stride")
    r = rows(data, offset, height, width * b, stride=stride)
    if b == 1:
        return to_rgba("L", r)
    v = np.ascontiguousarray(r).view(_TYPES[b]).reshape(height, width)
    return to_rgba("I", v)
