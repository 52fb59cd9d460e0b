"""A SPIDER 2D image decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's SpiderImagePlugin).

The header is float32 words, big-endian if they pass PIL's header test
read so, else little-endian: word 5 (1-based) the form (1: a 2D image),
12 the width, 2 the height, 13 the records in the header, 22 its bytes
and 23 a record's bytes, 24 the stack flag and 27 the image number. A
plain image's float32 pixels start after the header, a stack's first
image after two headers; top row first. PIL's "F" image converts by
clipping to 0..255 and truncating.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import rows, to_rgba

_FORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _header_bytes(t) -> int:
    """PIL's isSpiderHeader: the header's bytes, or 0."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _FORMS:
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def decode_spider(data: bytes) -> np.ndarray:
    """SPIDER bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 27 * 4:
        raise ValueError("SPIDER: short header")
    for order in (">", "<"):
        t = struct.unpack(order + "27f", data[:27 * 4])
        hdrlen = _header_bytes(t)
        if hdrlen:
            break
    else:
        raise ValueError("SPIDER: not a valid file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise ValueError("SPIDER: not a 2D image")
    w, ht = int(h[12]), int(h[2])
    try:
        stack, number = int(h[24]), int(h[27])
    except (ValueError, OverflowError):
        raise ValueError("SPIDER: bad stack header") from None
    if stack == 0 and number == 0:
        offset = hdrlen
    elif stack > 0 and number == 0:
        offset = 2 * hdrlen
    else:
        raise ValueError("SPIDER: inconsistent stack header")
    if w <= 0 or ht <= 0:
        raise ValueError("SPIDER: empty image")
    r = rows(data, offset, ht, 4 * w)
    v = np.ascontiguousarray(r).view(order + "f4").reshape(ht, w)
    return to_rgba("F", v)
