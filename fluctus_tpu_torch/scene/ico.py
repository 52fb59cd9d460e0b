"""Windows icon (ICO) and cursor (CUR) decoders in NumPy that give what
PIL's `Image.open(...).convert("RGBA")` gives (PIL 12's IcoImagePlugin and
CurImagePlugin rules).

ICO: the directory's entries are sorted by colour depth, then by area,
largest first (both sorts stable), and the first is loaded: a PNG frame
through scene/png.py, without its tRNS chunk (PIL's icon image does not
take over the frame's transparency), or a BMP frame (a DIB whose height counts the AND
mask too) through scene/bmp.py, whose alpha is then the AND mask (1-bit
rows padded to 32 bits, ending at the entry's offset + size; a set bit is
transparent), or, where the entry says 32 bits, the fourth byte of each
pixel. CUR: the first entry, replaced by any later one larger in both
directory dimensions; its DIB is read as a BMP of half the stored height
with no mask (a 32-bit bitmap that starts at byte 22 keeps its fourth
byte as alpha, PIL's rule).
"""
from __future__ import annotations

import math
import struct

import numpy as np

from fluctus_tpu_torch.scene.bmp import decode_dib
from fluctus_tpu_torch.scene.png import decode_png

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _entry(data: bytes, i: int) -> dict:
    s = data[6 + 16 * i:22 + 16 * i]
    if len(s) != 16:
        raise ValueError("ICO: truncated directory")
    width, height = s[0] or 256, s[1] or 256
    nb_color = s[2]
    bpp, size, offset = struct.unpack("<HII", s[6:16])
    depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) \
        or 256
    return dict(square=width * height, bpp=bpp, size=size, offset=offset,
                depth=depth)


def decode_ico(data: bytes) -> np.ndarray:
    """ICO bytes -> (H, W, 4) uint8 RGBA, top row first."""
    n = struct.unpack("<H", data[4:6])[0]
    entries = sorted((_entry(data, i) for i in range(n)),
                     key=lambda e: e["depth"])
    e = sorted(entries, key=lambda e: e["square"], reverse=True)[0]
    if data[e["offset"]:e["offset"] + 8] == PNG_MAGIC:
        return decode_png(data[e["offset"]:], transparency=False)
    rgba, o = decode_dib(data, e["offset"], halve=True)
    rgba = rgba.copy()
    h, w = rgba.shape[:2]
    if e["bpp"] == 32:
        alpha = np.frombuffer(data[o:o + w * h * 4][3::4], np.uint8)
        if alpha.size < w * h:
            raise ValueError("ICO: not enough alpha data")
        alpha = alpha[:w * h].reshape(h, w)[::-1]
    else:
        wpad = w + (32 - w % 32) % 32
        total = wpad * h // 8
        start = e["offset"] + e["size"] - total
        mask = data[max(start, 0):start + total]
        if start < 0 or len(mask) < total:
            raise ValueError("ICO: not enough AND-mask data")
        bits = np.unpackbits(np.frombuffer(mask, np.uint8).reshape(
            h, wpad // 8), axis=1)[:, :w]
        alpha = np.where(bits[::-1], 0, 255).astype(np.uint8)
    rgba[..., 3] = alpha
    return rgba


def decode_cur(data: bytes) -> np.ndarray:
    """CUR bytes -> (H, W, 4) uint8 RGBA, top row first."""
    n = struct.unpack("<H", data[4:6])[0]
    m = b""
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise ValueError("CUR: no cursors")
    start = struct.unpack("<I", m[12:16])[0]
    return decode_dib(data, start, halve=True, raw_alpha=start == 22)[0]
