"""A Truevision TGA decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's TgaImagePlugin rules).

Uncompressed and RLE images: true colour at 24 bits (BGR) and 32 bits
(BGRA, alpha as stored), grey at 8 bits, colour-mapped 8-bit indices with
a 24- or 32-bit map (entries before the map's first index are black). The
origin bits are honoured: bottom-up unless bit 5 is set, right-to-left
when bit 4 is. An RLE packet may not run past its row (PIL's decoder
refuses one, so the file reads as damaged). TGA has no signature: `accept` is PIL's header check. 16-bit colour, 1-bit and
16-bit grey and 16-bit maps raise UnsupportedImage.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage


def accept(data: bytes) -> bool:
    """PIL's test of a TGA header: colour-map type 0 or 1, a known image
    type, a positive size and a known depth."""
    if len(data) < 18:
        return False
    cmt, itype = data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    return (cmt in (0, 1) and itype in (1, 2, 3, 9, 10, 11) and w > 0
            and h > 0 and data[16] in (1, 8, 16, 24, 32))


def _unrle(data: bytes, pos: int, w: int, h: int, bpp: int) -> bytes:
    """RLE packets to w * h pixels. A packet that runs past its row is
    damage to PIL (its decoder reports a buffer overrun), so here too."""
    out = bytearray()
    for _ in range(h):
        x = 0
        while x < w:
            head = data[pos]
            pos += 1
            count = (head & 0x7F) + 1
            if x + count > w:
                raise ValueError("TGA: an RLE packet runs past its row")
            if head & 0x80:
                px = data[pos:pos + bpp]
                if len(px) != bpp:
                    raise ValueError("TGA: truncated RLE data")
                out += px * count
                pos += bpp
            else:
                chunk = data[pos:pos + count * bpp]
                if len(chunk) != count * bpp:
                    raise ValueError("TGA: truncated RLE data")
                out += chunk
                pos += count * bpp
            x += count
    return bytes(out)


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if not accept(data):
        raise ValueError("not a TGA file")
    id_len, cmt, itype = data[0], data[1], data[2]
    map_start, map_len, map_depth = struct.unpack("<HHB", data[3:8])
    w, h = struct.unpack("<HH", data[12:16])
    depth, flags = data[16], data[17]
    kind = itype & 7
    if kind == 3 and depth != 8:
        raise UnsupportedImage(f"TGA: {depth}-bit grey is not decoded by "
                               "the port")
    if kind == 2 and depth not in (24, 32):
        raise UnsupportedImage(f"TGA: {depth}-bit colour is not decoded by "
                               "the port")
    if kind == 1 and depth != 8:
        raise UnsupportedImage(f"TGA: {depth}-bit colour-mapped is not "
                               "decoded by the port")
    pos = 18 + id_len
    pal = None
    if cmt:
        if map_depth not in (24, 32):
            raise UnsupportedImage(f"TGA: a {map_depth}-bit colour map is "
                                   "not decoded by the port")
        eb = map_depth // 8
        raw = data[pos:pos + eb * map_len]
        if len(raw) != eb * map_len:
            raise ValueError("TGA: truncated colour map")
        pos += eb * map_len
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        ent = np.frombuffer(raw, np.uint8).reshape(-1, eb)
        n = max(0, min(256 - map_start, len(ent)))
        pal[map_start:map_start + n, 0] = ent[:n, 2]
        pal[map_start:map_start + n, 1] = ent[:n, 1]
        pal[map_start:map_start + n, 2] = ent[:n, 0]
        if eb == 4:
            pal[map_start:map_start + n, 3] = ent[:n, 3]
    bpp = depth // 8
    if itype & 8:
        px = _unrle(data, pos, w, h, bpp)
    else:
        px = data[pos:pos + w * h * bpp]
        if len(px) != w * h * bpp:
            raise ValueError("TGA: truncated image data")
    px = np.frombuffer(px, np.uint8).reshape(h, w, bpp)
    rgba = np.full((h, w, 4), 255, np.uint8)
    if kind == 2:
        rgba[..., 0] = px[..., 2]
        rgba[..., 1] = px[..., 1]
        rgba[..., 2] = px[..., 0]
        if bpp == 4:
            rgba[..., 3] = px[..., 3]
    elif kind == 1 and pal is not None:
        rgba = pal[px[..., 0]]
    else:                                   # grey, or indices with no map
        rgba[..., :3] = px[..., :1]
    if not flags & 0x20:                    # bottom-up rows
        rgba = rgba[::-1]
    if flags & 0x10:                        # right-to-left columns
        rgba = rgba[:, ::-1]
    return np.ascontiguousarray(rgba)
