"""A QOI decoder that gives what PIL's `Image.open(...).convert("RGBA")`
gives (PIL's QoiImagePlugin rules).

A 14-byte header (magic, big-endian width and height, channels, colour
space), then the op stream: RGB, RGBA, INDEX, DIFF, LUMA and RUN over a
previous pixel that starts as (0, 0, 0, 255) and a 64-entry table of
seen pixels hashed as (3r + 5g + 7b + 11a) % 64. PIL's decoder, copied:
an INDEX op into an empty slot reads (0, 0, 0, 0); a RUN neither enters
the table nor ends within the image (pixels past its end are dropped);
any channel count but 3 is RGBA; a 3-channel image keeps its alpha in
the ops and drops it from the pixels (alpha 255).
"""
from __future__ import annotations

import struct

import numpy as np


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 14 or not data.startswith(b"qoif"):
        raise ValueError("QOI: bad header")
    w, h = struct.unpack_from(">II", data, 4)
    rgb_only = data[12] == 3
    n = w * h
    out = bytearray(4 * n)
    seen = {}
    prev = (0, 0, 0, 255)
    pos, end, i = 14, len(data), 0
    while i < n:
        if pos >= end:
            raise ValueError("QOI: truncated data")
        b = data[pos]
        pos += 1
        if b == 0xFE:
            r, g, bl = data[pos:pos + 3]
            pos += 3
            value = (r, g, bl, prev[3])
        elif b == 0xFF:
            value = tuple(data[pos:pos + 4])
            pos += 4
            if len(value) != 4:
                raise ValueError("QOI: truncated data")
        elif b >> 6 == 0:
            value = seen.get(b & 0x3F, (0, 0, 0, 0))
        elif b >> 6 == 1:
            value = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                     (prev[1] + ((b >> 2) & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
        elif b >> 6 == 2:
            if pos >= end:
                raise ValueError("QOI: truncated data")
            b2 = data[pos]
            pos += 1
            dg = (b & 0x3F) - 32
            value = ((prev[0] + dg + (b2 >> 4) - 8) % 256,
                     (prev[1] + dg) % 256,
                     (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
        else:
            run = min((b & 0x3F) + 1, n - i)
            out[4 * i:4 * (i + run)] = bytes(prev) * run
            i += run
            continue
        prev = value
        seen[(value[0] * 3 + value[1] * 5 + value[2] * 7
              + value[3] * 11) % 64] = value
        out[4 * i:4 * i + 4] = bytes(value)
        i += 1
    rgba = np.frombuffer(bytes(out), np.uint8).reshape(h, w, 4).copy()
    if rgb_only:
        rgba[..., 3] = 255
    return rgba
