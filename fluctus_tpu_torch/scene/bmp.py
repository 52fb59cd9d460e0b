"""A Windows BMP decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's BmpImagePlugin rules).

8-bit palette images, 24-bit BGR and 32-bit images, BI_RGB and
BI_BITFIELDS, bottom-up (positive height) and top-down (negative height),
with the BITMAPINFOHEADER and its V2-V5 extensions. As in PIL, a 32-bit
BI_RGB image has no alpha (its fourth byte is ignored), a BI_BITFIELDS one
takes the masks PIL knows, and a palette of grey ramp entries reads the
index itself. Other depths, RLE compression and OS/2 headers raise
UnsupportedImage.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage

# 32-bit BI_BITFIELDS masks (r, g, b, a) PIL reads, and the byte of each
# channel in a little-endian pixel (-1: none)
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0, -1),
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1, -1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0, -1),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),
    (0x0, 0x0, 0x0, 0x0): (2, 1, 0, 3),
}


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize not in (40, 52, 56, 64, 108, 124):
        raise UnsupportedImage(f"BMP: a {hsize}-byte header is not decoded "
                               "by the port")
    hd = data[18:14 + hsize]
    if len(hd) != hsize - 4:
        raise ValueError("BMP: truncated header")
    w, h_raw, _, bits, comp = struct.unpack("<iIHHI", hd[:16])
    top_down = hd[7] == 0xFF
    h = 2 ** 32 - h_raw if top_down else h_raw
    colors = struct.unpack("<I", hd[28:32])[0]
    pos = 14 + hsize
    if bits not in (8, 24, 32):
        raise UnsupportedImage(f"BMP: {bits}-bit images are not decoded by "
                               "the port")
    order = (2, 1, 0, -1)
    if comp == 3:                                  # BI_BITFIELDS
        if len(hd) >= 48:
            masks = list(struct.unpack("<III", hd[36:48]))
            masks.append(struct.unpack("<I", hd[48:52])[0]
                         if len(hd) >= 52 else 0)
        else:
            masks = list(struct.unpack("<III", data[pos:pos + 12])) + [0]
            pos += 12
        masks = tuple(masks)
        if bits == 32 and masks in _MASKS32:
            order = _MASKS32[masks]
        elif not (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)):
            raise UnsupportedImage("BMP: this bitfields layout is not "
                                   "decoded by the port")
    elif comp != 0:
        raise UnsupportedImage(f"BMP: compression {comp} is not decoded by "
                               "the port")
    if w <= 0 or h <= 0:
        raise ValueError("BMP: bad size")
    rgba = None
    if bits == 8:
        colors = colors or 256
        if offset == 14 + hsize:
            offset += 4 * colors
        raw = data[pos:pos + 4 * colors]
        if len(raw) != 4 * colors or colors > 65536:
            raise ValueError("BMP: truncated palette")
        ent = np.frombuffer(raw, np.uint8).reshape(-1, 4)
        grey = all(bytes(ent[i, :3]) == bytes([v & 0xFF]) * 3 for i, v in
                   enumerate((0, 255) if colors == 2 else range(colors)))
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        if grey and colors == 2:
            pal[1, :3] = 255
        elif grey:
            pal[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
        else:
            n = min(256, colors)
            pal[:n, :3] = ent[:n, 2::-1]
    stride = ((w * bits + 31) >> 3) & ~3
    px = data[offset:offset + stride * h]
    if len(px) != stride * h:
        raise ValueError("BMP: truncated image data")
    rows = np.frombuffer(px, np.uint8).reshape(h, stride)
    if bits == 8:
        rgba = pal[rows[:, :w]]
    else:
        b = bits // 8
        p = rows[:, :w * b].reshape(h, w, b)
        rgba = np.full((h, w, 4), 255, np.uint8)
        for c, k in enumerate(order):
            if k >= 0:
                rgba[..., c] = p[..., k]
    if not top_down:
        rgba = rgba[::-1]
    return np.ascontiguousarray(rgba)
