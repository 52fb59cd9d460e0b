"""An SGI image decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's SgiImagePlugin and its
SgiRleDecode rules).

A 512-byte header (magic 474, compression, bytes a sample, dimension,
width, height, channels), then the samples bottom row first: raw, one
plane a channel, or RLE through tables of row offsets and lengths (one
a row and channel). Grey, RGB and RGBA at 8 or 16 bits a sample; a 16-bit
sample reads as its high byte. PIL's RLE rules, copied: a row ends at a
zero count, which its last byte must be (a row that ends otherwise stops
the image there, the rows after it left zero); a run or copy that passes
the row's width, or an offset before the tables' end, is damage; a short
row keeps the previous row's samples past its end.
"""
from __future__ import annotations

import struct

import numpy as np

MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1,
         (1, 3, 3): 3, (2, 3, 3): 3, (1, 3, 4): 4, (2, 3, 4): 4}


def _expand(body: bytes, pos: int, n: int, bpc: int, xsize: int,
            last: int, out: np.ndarray) -> int:
    """SgiRleDecode's expandrow (bpc 1) and expandrow2 (bpc 2): one row
    of one channel into `out` (its high bytes), with PIL's bounds tests
    against `last`, the body's last byte. Returns 0 (the row ended at a
    zero count) or 1 (its last byte was no zero count: the image stops
    there); raises on damage."""
    x = 0
    for left in range(n, 0, -1):
        if pos + bpc - 1 > last:
            raise ValueError("SGI: RLE row passes the data")
        pixel = body[pos + bpc - 1]
        pos += bpc
        if left == 1 and pixel:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            raise ValueError("SGI: RLE row passes the width")
        if pixel & 0x80:
            if pos + bpc * count > last:
                raise ValueError("SGI: RLE copy passes the data")
            out[x:x + count] = np.frombuffer(body, np.uint8, bpc * count,
                                             pos)[::bpc]
            pos += bpc * count
        else:
            if pos + (2 if bpc == 2 else 0) > last:
                raise ValueError("SGI: RLE run passes the data")
            out[x:x + count] = body[pos]
            pos += bpc
        x += count
    return 0


def decode_sgi(data: bytes) -> np.ndarray:
    """SGI bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 512 or struct.unpack_from(">H", data)[0] != 474:
        raise ValueError("SGI: bad header")
    comp, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">HHHH", data, 4)
    bands = MODES.get((bpc, dim, z))
    if bands is None:
        raise ValueError("SGI: PIL reads no such mode")
    rows = np.zeros((h, w, bands), np.uint8)     # bottom row first
    if comp == 0:
        page = w * h * bpc
        px = data[512:512 + page * bands]
        if len(px) != page * bands:
            raise ValueError("SGI: truncated image data")
        planes = np.frombuffer(px, np.uint8).reshape(bands, h, w * bpc)
        rows = planes[:, :, ::bpc].transpose(1, 2, 0)
    elif comp == 1:
        body = data[512:]
        tab = bands * h
        if len(body) < 8 * tab:
            raise ValueError("SGI: truncated RLE tables")
        starts = struct.unpack_from(f">{tab}I", body, 0)
        lengths = struct.unpack_from(f">{tab}I", body, 4 * tab)
        row = np.zeros((w, bands), np.uint8)
        stop = False
        for y in range(h):
            for c in range(bands):
                off, n = starts[y + c * h], lengths[y + c * h]
                if off < 512 or off - 512 + n > len(body):
                    raise ValueError("SGI: RLE row outside the data")
                if _expand(body, off - 512, n, bpc, w, len(body) - 1,
                           row[:, c]):
                    stop = True
                    break
            if stop:
                break
            rows[y] = row
    else:
        raise ValueError("SGI: unknown compression")
    rgba = np.full((h, w, 4), 255, np.uint8)
    if bands == 1:
        rgba[..., :3] = rows[..., :1]
    else:
        rgba[..., :bands] = rows
    return np.ascontiguousarray(rgba[::-1])
