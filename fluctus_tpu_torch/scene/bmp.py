"""A Windows BMP decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's BmpImagePlugin rules).

1-, 4- and 8-bit palette images, 16-bit (5-5-5, and 5-6-5 by bitfields),
24-bit BGR and 32-bit images; BI_RGB, BI_BITFIELDS, RLE8 and RLE4;
bottom-up (positive height) and top-down (negative height); the
BITMAPINFOHEADER with its V2-V5 extensions and the OS/2 headers (12-byte
core header, 3-byte palette entries; the 64-byte one). As in PIL: a
32-bit BI_RGB image has no alpha (its fourth byte is ignored), a
BI_BITFIELDS one takes the masks PIL knows, a 5- or 6-bit channel reads
floor(v * 255 / (2^n - 1)), an index past the palette is black, a palette
of grey ramp entries reads the index itself, and the RLE packets are read
by PIL's own decoder's rules (its delta escape reads four bytes, an odd
absolute run of RLE4 drops its last pixel, and absolute runs pad to an
even file offset). Depths, compressions and bitfields PIL does not read
are damage (-1 in the pool, as in the JAX package). A 4-bit palette that
is the grey ramp makes PIL read the packed rows as 8-bit grey through a
memory map of the file (the JAX pool opens a path): row y is the `width`
bytes from the row's start, running on into the next row when the width
passes the padded row, and zeros past the file's end; RLE4 under such a
palette gives the indices as grey values.
"""
from __future__ import annotations

import struct

import numpy as np

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


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """PIL's BmpRleDecoder: w * h indices in file row order."""
    out = bytearray()
    x = 0
    n = w * h
    end = len(data)
    while len(out) < n:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                              # end of line
            while len(out) % w:
                out.append(0)
            x = 0
        elif byte == 1:                              # end of bitmap
            break
        elif byte == 2:                              # delta: PIL reads 4
            if pos + 2 > end:
                break
            if pos + 4 > end:
                raise ValueError("BMP: truncated RLE delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                        # absolute run
            nb = byte // 2 if rle4 else byte
            raw = data[pos:pos + nb]
            pos += len(raw)
            if rle4:
                out += bytes(v for b in raw for v in (b >> 4, b & 15))
            else:
                out += raw
            if len(raw) < nb:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < n:
        raise ValueError("BMP: not enough RLE image data")
    return np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError("not a BMP file")
    return _decode(data, 14, struct.unpack("<I", data[10:14])[0])[0]


def decode_dib_file(data: bytes) -> np.ndarray:
    """A DIB file (a BMP without its file header, PIL's DibImageFile) ->
    (H, W, 4) uint8 RGBA, top row first."""
    return _decode(data, 0, None)[0]


def decode_dib(data: bytes, start: int, halve: bool = False,
               raw_alpha: bool = False) -> tuple[np.ndarray, int]:
    """The device-independent bitmap at `start` (a header, bitfield masks,
    a palette, then the pixels, with no file header), as PIL's
    DibImageFile reads it inside an ICO or CUR file -> (H, W, 4) uint8
    RGBA, top row first. halve: the header's height counts an AND mask
    too, so only its first half is the image. raw_alpha: a 32-bit BI_RGB
    image keeps its fourth byte as alpha (PIL's rule for a cursor whose
    bitmap starts at byte 22). Returns (RGBA, the offset of the pixels)."""
    return _decode(data, start, None, halve, raw_alpha)


def _decode(data: bytes, start: int, offset, halve: bool = False,
            raw_alpha: bool = False) -> tuple[np.ndarray, int]:
    """The bitmap whose header starts at `start`; its pixels at `offset`,
    or (None) right after its palette. Returns (RGBA, pixel offset)."""
    if len(data) < start + 4:
        raise ValueError("BMP: truncated header")
    hsize = struct.unpack("<I", data[start:start + 4])[0]
    if hsize not in (12, 40, 52, 56, 64, 108, 124):
        raise ValueError(f"BMP: unknown {hsize}-byte header")
    hd = data[start + 4:start + hsize]
    if len(hd) != hsize - 4:
        raise ValueError("BMP: truncated header")
    pos = start + hsize
    if hsize == 12:                                # OS/2 core header
        w, h, _, bits = struct.unpack("<HHHH", hd[:8])
        comp, colors, top_down, entry = 0, 0, False, 3
    else:
        w, h_raw, _, bits, comp = struct.unpack("<iIHHI", hd[:16])
        top_down = hd[7] == 0xFF
        h = 2 ** 32 - h_raw if top_down else h_raw
        colors = struct.unpack("<I", hd[28:32])[0]
        entry = 4
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP: PIL reads no {bits}-bit images")
    colors = colors or (1 << bits)
    if halve:
        h = h // 2
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    order = (2, 1, 0, 3) if raw_alpha and bits == 32 else (2, 1, 0, -1)
    bits16 = 5                                     # 5-5-5 unless masked
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
        elif bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                          (0x7C00, 0x3E0, 0x1F)):
            bits16 = 6 if masks[0] == 0xF800 else 5
        elif not (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)):
            raise ValueError("BMP: PIL reads no such bitfields layout")
    elif comp in (1, 2):
        if bits != (8 if comp == 1 else 4):
            raise ValueError(f"BMP: RLE at {bits} bits")
    elif comp != 0:
        raise ValueError(f"BMP: PIL reads no compression {comp}")
    if w <= 0 or h <= 0:
        raise ValueError("BMP: bad size")
    pal = None
    grey_bytes = False      # PIL's mode L over sub-byte rows
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError("BMP: bad palette size")
        raw = data[pos:pos + entry * colors]
        if len(raw) != entry * colors:
            raise ValueError("BMP: truncated palette")
        ent = np.frombuffer(raw, np.uint8).reshape(-1, entry)
        grey = all(bytes(ent[i, :3]) == bytes([v & 0xFF]) * 3 for i, v in
                   enumerate((0, 255) if colors == 2 else range(colors)))
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        if grey and colors == 2:
            pal[1, :3] = 255
        elif grey:
            pal[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
            grey_bytes = bits < 8
        else:
            n = min(256, colors)
            pal[:n, :3] = ent[:n, 2::-1]
    if offset is None:          # a DIB: the pixels follow the palette
        offset = pos + (entry * colors if bits <= 8 else 0)
    if comp in (1, 2):
        idx = _rle(data, offset, w, h, comp == 2)
        rgba = pal[idx]
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        px = data[offset:offset + stride * h]
        if len(px) != stride * h:
            raise ValueError("BMP: truncated image data")
        rows = np.frombuffer(px, np.uint8).reshape(h, stride)
        if grey_bytes:
            # PIL maps the file and reads row y's first `width` bytes from
            # offset + y * stride, into the next row when the width passes
            # the padded row; past the file's end the mapped page reads 0
            buf = np.frombuffer(data[offset:] + bytes(w), np.uint8)
            at = np.arange(h)[:, None] * stride + np.arange(w)[None, :]
            rgba = pal[buf[at]]
        elif bits < 8:
            idx = np.unpackbits(rows, axis=1)
            if bits == 4:
                idx = idx.reshape(h, -1, 4) @ np.array([8, 4, 2, 1],
                                                       np.uint8)
            rgba = pal[idx[:, :w].astype(np.uint8)]
        elif bits == 8:
            rgba = pal[rows[:, :w]]
        elif bits == 16:
            v = rows[:, :w * 2].copy().view("<u2").astype(np.uint32)
            g_bits = bits16
            r = (v >> (5 + g_bits)) & 31
            g = (v >> 5) & ((1 << g_bits) - 1)
            b = v & 31
            rgba = np.full((h, w, 4), 255, np.uint8)
            for c, (ch, n) in enumerate(((r, 5), (g, g_bits), (b, 5))):
                rgba[..., c] = ch * 255 // ((1 << n) - 1)
        else:
            b = bits // 8
            p = rows[:, :w * b].reshape(h, w, b)
            rgba = np.full((h, w, 4), 255, np.uint8)
            for c, k in enumerate(order):
                if k >= 0:
                    rgba[..., c] = p[..., k]
    if not top_down:
        rgba = rgba[::-1]
    return np.ascontiguousarray(rgba), offset
