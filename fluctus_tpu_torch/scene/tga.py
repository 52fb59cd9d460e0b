"""A Truevision TGA decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's TgaImagePlugin rules).

Uncompressed and RLE images: true colour at 16 bits (5-5-5 with PIL's
inverted attribute bit as alpha: set is transparent), 24 bits (BGR) and
32 bits (BGRA, alpha as stored); grey at 8 and 16 bits (grey, alpha) and
uncompressed at 1 bit; colour-mapped 8-bit indices with a 16- or 24-bit
map, whose entries before the map's first index are zero bytes and past
its end black (PIL 12 fails on a 32-bit map and on a map beside other
pixels: damage here). The origin bits
are honoured: bottom-up unless bit 5 is set, right-to-left when bit 4 is.
An RLE packet may not run past its row (PIL's decoder refuses one, so the
file reads as damaged). TGA has no signature: `accept` is PIL's header
check. A header PIL refuses (another map depth, an image type and depth
it has no mode for) is damage, and so is a 1-bit RLE image: PIL 12's RLE
decoder moves depth // 8 = 0 bytes a pixel there, never fills the image
and reports it truncated, whatever the data.
"""
from __future__ import annotations

import struct

import numpy as np


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


def _bgra15z(v: np.ndarray) -> np.ndarray:
    """PIL's BGRA;15Z: 5-bit channels to floor(v * 255 / 31), alpha 255
    when bit 15 is clear."""
    v = v.astype(np.uint32)
    out = np.empty(v.shape + (4,), np.uint8)
    for c, shift in enumerate((10, 5, 0)):
        out[..., c] = ((v >> shift) & 31) * 255 // 31
    out[..., 3] = np.where(v & 0x8000, 0, 255)
    return out


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if not accept(data):
        raise ValueError("not a TGA file")
    id_len, cmt, itype = data[0], data[1], data[2]
    map_start, map_len, map_depth = struct.unpack("<HHB", data[3:8])
    w, h = struct.unpack("<HH", data[12:16])
    depth, flags = data[16], data[17]
    kind = itype & 7
    if (kind, depth) not in ((1, 8), (3, 1), (3, 8), (3, 16), (2, 16),
                             (2, 24), (2, 32)):
        raise ValueError(f"TGA: PIL has no mode for type {itype} at "
                         f"{depth} bits")
    if depth == 1 and itype & 8:
        raise ValueError("TGA: PIL's RLE decoder reads no 1-bit image")
    pos = 18 + id_len
    pal = None
    if cmt:
        # PIL 12 loads no 32-bit map ("unrecognized raw mode") and no map
        # beside true-colour or grey pixels
        if map_depth not in (16, 24) or kind != 1:
            raise ValueError(f"TGA: PIL reads no {map_depth}-bit map on "
                             f"image type {itype}")
        eb = map_depth // 8
        raw = data[pos:pos + eb * map_len]
        if len(raw) != eb * map_len:
            raise ValueError("TGA: truncated colour map")
        pos += eb * map_len
        raw = bytes(eb * map_start) + raw          # PIL's zero prefix
        if eb == 2:
            ent = _bgra15z(np.frombuffer(raw, "<u2"))
        else:
            e = np.frombuffer(raw, np.uint8).reshape(-1, eb)
            ent = np.full((len(e), 4), 255, np.uint8)
            ent[:, :3] = e[:, 2::-1]
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        n = min(256, len(ent))
        pal[:n] = ent[:n]
    if depth == 1:
        stride = (w + 7) // 8
        raw = data[pos:pos + stride * h]
        if len(raw) != stride * h:
            raise ValueError("TGA: truncated image data")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride),
                             axis=1)[:, :w]
        rgba = np.full((h, w, 4), 255, np.uint8)
        rgba[..., :3] = (bits * 255)[..., None]
    else:
        bpp = depth // 8
        if itype & 8:
            px = _unrle(data, pos, w, h, bpp)
        else:
            px = data[pos:pos + w * h * bpp]
            if len(px) != w * h * bpp:
                raise ValueError("TGA: truncated image data")
        px = np.frombuffer(px, np.uint8).reshape(h, w, bpp)
        rgba = np.full((h, w, 4), 255, np.uint8)
        if kind == 2 and bpp == 2:
            rgba = _bgra15z(px.copy().view("<u2")[..., 0])
        elif kind == 2:
            rgba[..., 0] = px[..., 2]
            rgba[..., 1] = px[..., 1]
            rgba[..., 2] = px[..., 0]
            if bpp == 4:
                rgba[..., 3] = px[..., 3]
        elif kind == 1 and pal is not None:
            rgba = pal[px[..., 0]]
        else:                       # grey (and its alpha), or bare indices
            rgba[..., :3] = px[..., :1]
            if bpp == 2:
                rgba[..., 3] = px[..., 1]
    if not flags & 0x20:                    # bottom-up rows
        rgba = rgba[::-1]
    if flags & 0x10:                        # right-to-left columns
        rgba = rgba[:, ::-1]
    return np.ascontiguousarray(rgba)
