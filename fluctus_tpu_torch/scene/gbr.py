"""A GIMP brush (GBR) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's GbrImagePlugin).

A big-endian header: its size, the version (1, or 2 with "GIMP" and the
spacing after the colour depth), width, height and colour depth (1: a
grey "L" brush, 4: RGBA); the pixels start where the header ends.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import rows, to_rgba


def decode_gbr(data: bytes) -> np.ndarray:
    """GBR bytes -> (H, W, 4) uint8 RGBA, top row first."""
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if version == 2 and size < 28:
        raise ValueError("GBR: the comment's length is negative")
    px = rows(data, size, h, w * depth)
    if depth == 1:
        return to_rgba("L", px)
    return to_rgba("RGBA", px.reshape(h, w, 4))
