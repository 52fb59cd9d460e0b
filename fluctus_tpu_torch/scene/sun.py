"""A Sun raster decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's SunImagePlugin and
SunRleDecode rules).

A 32-byte big-endian header (magic, width, height, depth, length, type,
colour-map type, colour-map length), an optional RGB colour map (all
reds, then greens, then blues; at most 1024 bytes), then the rows. Depth
1 (a set bit black), 4 (grey v * 17, or palette indices with a map),
8 (grey, or indices with a map), 24 (BGR, or RGB for type 3) and 32
(read as PIL reads it: B, G, R, then a pad byte, or R, G, B, pad for
type 3). Types 0, 1, 3, 4 and
5 are raw rows padded to 16 bits; type 2 is RLE (0x80 n v repeats v
n + 1 times, 0x80 0 is a literal 0x80), whose rows PIL takes unpadded,
(width * depth + 7) // 8 bytes, a run carrying on into the next rows. A
palette index past the map reads black.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x59A66A95


def _rle(data: bytes, pos: int, row_bytes: int, n_rows: int) -> bytes:
    """PIL's SunRleDecode: n_rows * row_bytes bytes from `pos`."""
    out = bytearray()
    need = row_bytes * n_rows
    end = len(data)
    while len(out) < need:
        if pos >= end:
            raise ValueError("Sun raster: truncated RLE data")
        b = data[pos]
        if b == 0x80:
            if pos + 1 >= end:
                raise ValueError("Sun raster: truncated RLE data")
            n = data[pos + 1]
            if n == 0:
                out.append(0x80)
                pos += 2
            else:
                if pos + 2 >= end:
                    raise ValueError("Sun raster: truncated RLE data")
                out += bytes([data[pos + 2]]) * (n + 1)
                pos += 3
        else:
            out.append(b)
            pos += 1
    return bytes(out[:need])


def decode_sun(data: bytes) -> np.ndarray:
    """Sun raster bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 32 or struct.unpack_from(">I", data)[0] != MAGIC:
        raise ValueError("Sun raster: bad header")
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", data, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise ValueError(f"Sun raster: PIL reads no depth {depth}")
    offset = 32
    pal = None
    if plen:
        if plen > 1024 or ptype != 1:
            raise ValueError("Sun raster: unsupported colour map")
        raw = data[32:32 + plen]
        n = len(raw) // 3
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = np.frombuffer(raw[:3 * n], np.uint8).reshape(3, n).T
        offset += plen
    if ftype in (0, 1, 3, 4, 5):
        stride = ((w * depth + 15) // 16) * 2
        px = data[offset:offset + stride * h]
        if len(px) != stride * h:
            raise ValueError("Sun raster: truncated image data")
    elif ftype == 2:
        stride = (w * depth + 7) // 8
        px = _rle(data, offset, stride, h)
    else:
        raise ValueError(f"Sun raster: type {ftype}")
    rows = np.frombuffer(px, np.uint8).reshape(h, stride)
    rgba = np.full((h, w, 4), 255, np.uint8)
    if depth == 1:
        rgba[..., :3] = ((1 - np.unpackbits(rows, axis=1)[:, :w])
                         * 255)[..., None]
    elif depth in (4, 8):
        if depth == 4:
            v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        else:
            v = rows[:, :w]
        if pal is not None:
            rgba[..., :3] = pal[v]
        else:
            rgba[..., :3] = (v * (17 if depth == 4 else 1))[..., None]
    else:
        b = depth // 8
        p = rows[:, :w * b].reshape(h, w, b)
        order = (0, 1, 2) if ftype == 3 else (2, 1, 0)
        for c, k in enumerate(order):
            rgba[..., c] = p[..., k]
    return rgba
