"""A baseline TIFF decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's TiffImagePlugin rules) for
the first image of the file.

Little- and big-endian classic TIFF; strips and tiles; no compression,
PackBits, LZW (MSB-first codes with the early change) and Deflate (both
tags, through zlib); the horizontal predictor (2) at 8 and 16 bits;
chunky samples of unsigned integers. PIL's modes, copied: bilevel at 1
bit; grey at 2, 4, 8 (min-is-white inverted) and 16 bits (PIL's I;16,
which its RGBA conversion clamps to 255, min-is-white not inverted, and
no mode for it big-endian); grey with unassociated alpha;
RGB and RGBA at 8 and 16 bits (16-bit samples keep their high byte), with
an extra sample of unassociated alpha (or none), or associated alpha,
which PIL divides out as v * 255 // a; and palette images at 1, 2, 4 and
8 bits, whose 16-bit colour map entries become entry // 256.

Raises UnsupportedImage for what PIL reads and the port does not: JPEG,
CCITT and other compressions, planar samples, fill order 2, signed or
float samples, other predictors and other photometric interpretations,
BigTIFF. Damaged or truncated data raises ValueError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q"}


def _ifd(data: bytes, bo: str) -> dict:
    """The first IFD: {tag: tuple of values}."""
    (off,) = struct.unpack_from(bo + "I", data, 4)
    if off + 2 > len(data):
        raise ValueError("TIFF: bad IFD offset")
    (n,) = struct.unpack_from(bo + "H", data, off)
    tags = {}
    for i in range(n):
        e = off + 2 + 12 * i
        if e + 12 > len(data):
            raise ValueError("TIFF: truncated IFD")
        tag, typ, count = struct.unpack_from(bo + "HHI", data, e)
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(bo + fmt) * count
        pos = e + 8 if size <= 4 else struct.unpack_from(bo + "I", data,
                                                         e + 8)[0]
        if pos + size > len(data):
            raise ValueError("TIFF: truncated tag data")
        vals = struct.unpack_from(bo + fmt * count, data, pos)
        tags[tag] = vals
    return tags


def _packbits(src: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            out += bytes([src[i]]) * (257 - c)
            i += 1
    return bytes(out)


def _lzw(src: bytes, want: int) -> bytes:
    """TIFF LZW: MSB-first codes, 9 to 12 bits, the early change."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        raise UnsupportedImage("TIFF: old-style LZW is not decoded by the "
                               "port")
    clear, eoi = 256, 257
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    width = 9
    acc = nbits = 0
    pos = 0
    prev = None
    while len(out) < want:
        while nbits < width:
            if pos >= len(src):
                return bytes(out)
            acc = (acc << 8) | src[pos]
            pos += 1
            nbits += 8
        code = (acc >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        acc &= (1 << nbits) - 1
        if code == clear:
            table = table[:258]
            width = 9
            prev = None
            continue
        if code == eoi:
            break
        if prev is None:
            if code >= 256:
                raise ValueError("TIFF: bad LZW code")
            s = table[code]
        elif code < len(table):
            s = table[code]
            table.append(prev + s[:1])
        elif code == len(table):
            s = prev + prev[:1]
            table.append(s)
        else:
            raise ValueError("TIFF: bad LZW code")
        out += s
        prev = s
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _chunk(data: bytes, off: int, count: int, comp: int, want: int) -> bytes:
    raw = data[off:off + count]
    if len(raw) != count:
        raise ValueError("TIFF: truncated image data")
    if comp == 1:
        out = raw
    elif comp == 32773:
        out = _packbits(raw)
    elif comp == 5:
        out = _lzw(raw, want)
    else:                                   # 8, 32946: Deflate
        out = zlib.decompress(raw)
    if len(out) < want:
        raise ValueError("TIFF: short image data")
    return out[:want]


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if data[:4] not in (b"MM\x00*", b"II*\x00"):
        if data[:4] in (b"MM\x00+", b"II+\x00", b"MM*\x00", b"II\x00*"):
            raise UnsupportedImage("TIFF: BigTIFF and mixed byte-order "
                                   "headers are not decoded by the port")
        raise ValueError("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    t = _ifd(data, bo)

    def one(tag, default=None):
        v = t.get(tag)
        return default if v is None else v[0]

    w, h = one(256), one(257)
    if not w or not h:
        raise ValueError("TIFF: no size")
    bits = t.get(258, (1,))
    spp = one(277, 1)
    if len(bits) != spp:
        bits = bits[:1] * spp
    comp = one(259, 1)
    photo = one(262, None)
    planar = one(284, 1)
    pred = one(317, 1)
    fill = one(266, 1)
    fmt = t.get(339, (1,))
    extra = t.get(338, ())
    if comp not in (1, 5, 8, 32946, 32773):
        raise UnsupportedImage(f"TIFF: compression {comp} is not decoded by "
                               "the port")
    if planar != 1 and spp > 1:
        raise UnsupportedImage("TIFF: planar samples are not decoded by the "
                               "port")
    if fill != 1 or any(f != 1 for f in fmt):
        raise UnsupportedImage("TIFF: fill order 2 and signed or float "
                               "samples are not decoded by the port")
    if pred not in (1, 2) or len(set(bits)) != 1:
        raise UnsupportedImage("TIFF: this predictor or sample layout is "
                               "not decoded by the port")
    b = bits[0]
    if photo is None:
        photo = 2 if spp >= 3 else 1
    kinds = {(0, 1): b in (1, 2, 4, 8, 16), (1, 1): b in (1, 2, 4, 8, 16),
             (1, 2): b == 8, (3, 1): b in (1, 2, 4, 8),
             (2, 3): b in (8, 16), (2, 4): b in (8, 16)}
    if not kinds.get((photo, spp)) or (spp == 2 and extra[:1] != (2,)) or \
            (spp == 4 and extra[:1] not in ((), (0,), (1,), (2,))):
        raise UnsupportedImage(f"TIFF: photometric {photo} with {spp} x "
                               f"{b}-bit samples is not decoded by the port")
    if b == 16 and photo == 0 and bo == ">":
        raise ValueError("TIFF: PIL has no mode for big-endian 16-bit "
                         "min-is-white")
    if b < 8 and 322 in t:
        raise UnsupportedImage("TIFF: tiles below 8 bits are not decoded "
                               "by the port")
    if pred == 2 and b not in (8, 16):
        raise UnsupportedImage("TIFF: the predictor at this depth is not "
                               "decoded by the port")

    # the chunks: strips (full width) or tiles
    if 322 in t:
        cw, ch = one(322), one(323)
        offs, counts = t.get(324, ()), t.get(325, ())
        grid = ((w + cw - 1) // cw, (h + ch - 1) // ch)
    else:
        cw, ch = w, min(one(278, 2 ** 32 - 1), h)
        offs, counts = t.get(273, ()), t.get(279, ())
        grid = (1, (h + ch - 1) // ch)
    if len(offs) < grid[0] * grid[1] or len(counts) < len(offs):
        raise ValueError("TIFF: missing chunk offsets")
    row_bytes = (cw * spp * b + 7) // 8
    dt = np.dtype(bo + ("u2" if b == 16 else "u1"))
    full_row = (w * spp * b + 7) // 8
    img = np.zeros((h, full_row), np.uint8) if b < 8 else \
        np.zeros((h, w * spp), dt)
    k = 0
    for ty in range(grid[1]):
        for tx in range(grid[0]):
            rows = ch if 322 in t else min(ch, h - ty * ch)
            raw = _chunk(data, offs[k], counts[k], comp, row_bytes * rows)
            k += 1
            if b < 8:
                img[ty * ch:ty * ch + rows] = np.frombuffer(
                    raw, np.uint8).reshape(rows, row_bytes)[:h - ty * ch]
                continue
            c = np.frombuffer(raw, dt).reshape(rows, cw * spp)
            if pred == 2:
                mod = np.uint16 if b == 16 else np.uint8
                c = np.cumsum(c.reshape(rows, cw, spp).astype(mod), axis=1,
                              dtype=mod).reshape(rows, cw * spp)
            y1 = min(h, ty * ch + rows)
            x0 = tx * cw * spp
            x1 = min(w * spp, x0 + cw * spp)
            img[ty * ch:y1, x0:x1] = c[:y1 - ty * ch, :x1 - x0]
    return _rgba(img, w, h, spp, b, photo, extra, t, bo)


def _rgba(img, w, h, spp, b, photo, extra, t, bo) -> np.ndarray:
    out = np.full((h, w, 4), 255, np.uint8)
    if b < 8:
        v = np.unpackbits(img, axis=1).reshape(h, -1, b)[:, :w]
        v = (v * (1 << np.arange(b - 1, -1, -1))).sum(-1).astype(np.uint8)
        if photo == 3:
            return _palette(v, b, t)
        top = (1 << b) - 1
        v = (v * (255 // top)).astype(np.uint8)
        if photo == 0:
            v = 255 - v
        out[..., :3] = v[..., None]
        return out
    if b == 16:                 # PIL keeps the high byte, I;16 clamps
        v = img.astype(np.uint32)
        if spp == 1:            # min-is-white too: PIL does not invert
            g = np.minimum(v, 255)
            out[..., :3] = g.reshape(h, w, 1).astype(np.uint8)
            return out
        img = (v >> 8).astype(np.uint8)
    p = img.reshape(h, w, spp)
    if photo == 3:
        return _palette(p[..., 0], b, t)
    if spp <= 2:
        out[..., :3] = (255 - p[..., :1]) if photo == 0 else p[..., :1]
        if spp == 2:
            out[..., 3] = p[..., 1]
        return out
    out[..., :3] = p[..., :3]
    if spp == 4 and extra[:1] != (0,):
        a = p[..., 3].astype(np.int64)
        out[..., 3] = a
        if extra[:1] == (1,):   # associated alpha, divided out
            rgb = p[..., :3].astype(np.int64)
            q = np.where(a[..., None] > 0,
                         np.minimum(rgb * 255 // np.maximum(a, 1)[..., None],
                                    255), 0)
            out[..., :3] = q
    return out


def _palette(v: np.ndarray, b: int, t: dict) -> np.ndarray:
    cmap = t.get(320)
    if cmap is None or len(cmap) < 3 << b:
        raise ValueError("TIFF: palette image without a colour map")
    n = 1 << b
    pal = np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T // 256
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    table[:n, :3] = pal
    return table[v]
