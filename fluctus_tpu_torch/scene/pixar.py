"""A PIXAR raster decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's PixarImagePlugin).

A 512-byte header: the width at byte 418 and the height at 416
(little-endian 16-bit), the channel and depth codes at 424 and 426. PIL
reads only codes (14, 2), 8-bit RGB, whose rows follow from byte 1024,
top row first, unpadded; any other codes leave the image without a mode,
which PIL does not open.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import rows, to_rgba


def decode_pixar(data: bytes) -> np.ndarray:
    """PIXAR bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 428:
        raise ValueError("PIXAR: short header")
    h, w = struct.unpack_from("<HH", data, 416)
    if struct.unpack_from("<HH", data, 424) != (14, 2) or not w or not h:
        raise ValueError("PIXAR: PIL reads no such image")
    return to_rgba("RGB", rows(data, 1024, h, 3 * w).reshape(h, w, 3))
