"""A FTEX (Independence War 2 texture) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's FtexImagePlugin).

Little-endian: "FTEX", the version, width and height, the mipmap and
format counts (one format), then the format (0: DXT1, 1: raw RGB) and
where the first mipmap's size word is; that mipmap's bytes follow it.
DXT1 blocks decode through dds.py's BC1 decoder (PIL's "bcn" decoder);
raw RGB rows are top row first.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import rows, to_rgba


def decode_ftex(data: bytes) -> np.ndarray:
    """FTEX bytes -> (H, W, 4) uint8 RGBA, top row first."""
    _, w, h, _, formats, fmt, where = struct.unpack_from("<7i", data, 4)
    if formats != 1:
        raise ValueError("FTEX: more than one format")
    (size,) = struct.unpack_from("<i", data, where)
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if w <= 0 or h <= 0:
        raise ValueError("FTEX: empty image")
    if fmt == 0:
        from fluctus_tpu_torch.scene.dds import decode_bcn
        return decode_bcn(mip, 1, w, h)
    if fmt == 1:
        return to_rgba("RGB", rows(mip, 0, h, 3 * w).reshape(h, w, 3))
    raise ValueError(f"FTEX: invalid format {fmt}")
