"""A TIFF decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's TiffImagePlugin rules) for
the first image of the file.

Classic TIFF in either byte order and little-endian BigTIFF (version 43:
8-byte offsets and counts; PIL fails on big-endian BigTIFF); strips and
tiles; chunky and planar samples (PlanarConfiguration 2); FillOrder 2
(each stored byte bit-reversed); no compression, PackBits, LZW (MSB-
first codes with the early change), Deflate (both tags, through zlib)
and new-style JPEG (7, through scene/jpeg.py with the JPEGTables stream
prepended, as libtiff feeds libjpeg: RGB photometric passes its
components through, YCbCr converts with its own subsampling); the
horizontal predictor (2) at 8, 16 and 32 bits and the floating-point
predictor (3). PIL's pixel modes come from `OPEN_INFO`, a copy of PIL
12's table: bilevel and grey at 1, 2, 4 and 8 bits (min-is-white
inverted); grey at 16 bits (PIL's I;16, which its RGBA conversion clamps
to 255), signed 16 and 32 bits and unsigned 32 bits (PIL's I, clamped to
0-255), 32-bit float (PIL's F: NaN and negatives 0, truncated, clamped
to 255); grey with alpha; RGB and RGBA at 8 and 16 bits (16-bit samples
keep their high byte) with extra samples unused, unassociated or
associated alpha (divided out as v * 255 // a); palette images at 1, 2,
4 and 8 bits (16-bit colour map entries become entry // 256); CMYK at 8
and 16 bits (PIL's conversion: with nk = 255 - k, each channel nk - c *
nk / 255, rounded as PIL's MULDIV255); CIELAB at 8 bits (PIL's LittleCMS
conversion, scene/lab.py).

PIL's own quirks are kept where they decide the bytes: compressed
big-endian signed and float samples come out byte-swapped (libtiff hands
PIL native-order samples, which PIL reads as big-endian); planar
uncompressed images read each plane with one letter of the chunky raw
mode (8-bit planes are exact, min-is-white is not inverted, 16-bit RGB
planes read their first bytes as 8-bit samples); a compressed planar
grey-with-alpha image loses its alpha (0); uncompressed data ignores the
predictor.

Raises UnsupportedImage for what PIL reads and the port does not: CCITT,
old-style JPEG and the other compressions, uncompressed YCbCr, 12-bit
grey, palette images with extra samples, JPEG of other than grey,
RGB or YCbCr samples and planar layouts beyond 8/16-bit grey, RGB and
RGBA. Layouts PIL cannot read, and damaged or truncated data, raise
ValueError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.lab import lab_to_rgb

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q",
          18: "Q"}
_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _open_info() -> dict:
    """PIL 12's TiffImagePlugin.OPEN_INFO: (byte order, photometric,
    sample format, fill order, bits per sample, extra samples) -> (mode,
    raw mode). Rows list the byte orders they hold for ("<" little, ">"
    big)."""
    rows = [
        ("<>", 0, (1,), 1, (1,), (), "1", "1;I"),
        ("<>", 0, (1,), 2, (1,), (), "1", "1;IR"),
        ("<>", 1, (1,), 1, (1,), (), "1", "1"),
        ("<>", 1, (1,), 2, (1,), (), "1", "1;R"),
        ("<>", 0, (1,), 1, (2,), (), "L", "L;2I"),
        ("<>", 0, (1,), 2, (2,), (), "L", "L;2IR"),
        ("<>", 1, (1,), 1, (2,), (), "L", "L;2"),
        ("<>", 1, (1,), 2, (2,), (), "L", "L;2R"),
        ("<>", 0, (1,), 1, (4,), (), "L", "L;4I"),
        ("<>", 0, (1,), 2, (4,), (), "L", "L;4IR"),
        ("<>", 1, (1,), 1, (4,), (), "L", "L;4"),
        ("<>", 1, (1,), 2, (4,), (), "L", "L;4R"),
        ("<>", 0, (1,), 1, (8,), (), "L", "L;I"),
        ("<>", 0, (1,), 2, (8,), (), "L", "L;IR"),
        ("<>", 1, (1,), 1, (8,), (), "L", "L"),
        ("<>", 1, (2,), 1, (8,), (), "L", "L"),
        ("<>", 1, (1,), 2, (8,), (), "L", "L;R"),
        ("<", 1, (1,), 1, (12,), (), "I;16", "I;12"),
        ("<", 0, (1,), 1, (16,), (), "I;16", "I;16"),
        ("<", 1, (1,), 1, (16,), (), "I;16", "I;16"),
        (">", 1, (1,), 1, (16,), (), "I;16B", "I;16B"),
        ("<", 1, (1,), 2, (16,), (), "I;16", "I;16R"),
        ("<", 1, (2,), 1, (16,), (), "I", "I;16S"),
        (">", 1, (2,), 1, (16,), (), "I", "I;16BS"),
        ("<", 0, (3,), 1, (32,), (), "F", "F;32F"),
        (">", 0, (3,), 1, (32,), (), "F", "F;32BF"),
        ("<", 1, (1,), 1, (32,), (), "I", "I;32N"),
        ("<", 1, (2,), 1, (32,), (), "I", "I;32S"),
        (">", 1, (2,), 1, (32,), (), "I", "I;32BS"),
        ("<", 1, (3,), 1, (32,), (), "F", "F;32F"),
        (">", 1, (3,), 1, (32,), (), "F", "F;32BF"),
        ("<>", 1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        ("<>", 2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"),
        ("<>", 2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        ("<>", 2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
        ("<>", 2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
        ("<>", 2, (1,), 1, (8,) * 5, (0, 0), "RGB", "RGBXX"),
        ("<>", 2, (1,), 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
        ("<>", 2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"),
        ("<>", 2, (1,), 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
        ("<>", 2, (1,), 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"),
        ("<>", 2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
        ("<>", 2, (1,), 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"),
        ("<>", 2, (1,), 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
        ("<>", 2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
        ("<", 2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16L"),
        (">", 2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16B"),
        ("<", 2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16L"),
        (">", 2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16B"),
        ("<", 2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16L"),
        (">", 2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16B"),
        ("<", 2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16L"),
        (">", 2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16B"),
        ("<", 2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16L"),
        (">", 2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16B"),
        ("<>", 3, (1,), 1, (1,), (), "P", "P;1"),
        ("<>", 3, (1,), 2, (1,), (), "P", "P;1R"),
        ("<>", 3, (1,), 1, (2,), (), "P", "P;2"),
        ("<>", 3, (1,), 2, (2,), (), "P", "P;2R"),
        ("<>", 3, (1,), 1, (4,), (), "P", "P;4"),
        ("<>", 3, (1,), 2, (4,), (), "P", "P;4R"),
        ("<>", 3, (1,), 1, (8,), (), "P", "P"),
        ("<>", 3, (1,), 1, (8, 8), (0,), "P", "PX"),
        ("<>", 3, (1,), 1, (8, 8), (2,), "PA", "PA"),
        ("<>", 3, (1,), 2, (8,), (), "P", "P;R"),
        ("<>", 5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK"),
        ("<>", 5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
        ("<>", 5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
        ("<", 5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16L"),
        (">", 5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16B"),
        ("<>", 6, (1,), 1, (8,), (), "L", "L"),
        ("<>", 6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
        ("<>", 8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
    ]
    return {(bo,) + r[1:6]: r[6:] for r in rows for bo in r[0]}


OPEN_INFO = _open_info()
# raw modes PIL's own (uncompressed) decoder has no unpacker for
_RAW_REFUSED = {"L;IR", "P;1R", "P;2R", "P;4R"}


def _ifd(data: bytes, bo: str, big: bool) -> dict:
    """The first IFD: {tag: tuple of values}."""
    if big:
        (off,) = struct.unpack_from(bo + "Q", data, 8)
        count_f, entry, inline, cnt = "Q", 20, 8, "Q"
    else:
        (off,) = struct.unpack_from(bo + "I", data, 4)
        count_f, entry, inline, cnt = "H", 12, 4, "I"
    head = struct.calcsize(count_f)
    if off + head > len(data):
        raise ValueError("TIFF: bad IFD offset")
    (n,) = struct.unpack_from(bo + count_f, data, off)
    tags = {}
    for i in range(n):
        e = off + head + entry * i
        if e + entry > len(data):
            raise ValueError("TIFF: truncated IFD")
        tag, typ, count = struct.unpack_from(bo + "HH" + cnt, data, e)
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(bo + fmt) * count
        val = e + 4 + struct.calcsize(cnt)
        pos = val if size <= inline else struct.unpack_from(
            bo + cnt, data, val)[0]
        if pos + size > len(data):
            raise ValueError("TIFF: truncated tag data")
        tags[tag] = struct.unpack_from(bo + fmt * count, data, pos)
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


def _chunk(data: bytes, off: int, count: int, comp: int, want: int,
           fill: int) -> bytes:
    raw = data[off:off + count]
    if len(raw) != count:
        raise ValueError("TIFF: truncated image data")
    if fill == 2:
        raw = _REV[np.frombuffer(raw, np.uint8)].tobytes()
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


def _jpeg_chunk(raw: bytes, tables, photo: int) -> np.ndarray:
    """One strip or tile of new-style JPEG: the JPEGTables stream (less
    its EOI) before the chunk's (less its SOI), and an Adobe marker that
    names the colour transform libtiff sets (none for RGB, YCbCr for
    YCbCr). Returns (rows, cols, 4) RGBA."""
    from fluctus_tpu_torch.scene.jpeg import decode_jpeg
    if raw[:2] != b"\xff\xd8":
        raise ValueError("TIFF: JPEG chunk without SOI")
    head = bytes(tables[:-2]) if tables else b"\xff\xd8"
    if photo in (2, 6):
        head = head[:2] + b"\xff\xee" + struct.pack(
            ">H5sHHHB", 14, b"Adobe", 100, 0, 0, 0 if photo == 2 else 1) \
            + head[2:]
    return decode_jpeg(head + raw[2:])


def _fp_predictor(c: np.ndarray, spp: int) -> np.ndarray:
    """Undo libtiff's floating-point predictor on rows of bytes: a byte
    sum along each row with stride spp, then each value's bytes gathered
    from the row's byte planes (most significant plane first); returns
    little-endian float32 values (rows, row_values)."""
    rows, nbytes = c.shape
    acc = np.cumsum(c.reshape(rows, nbytes // spp, spp).astype(np.uint8),
                    axis=1, dtype=np.uint8).reshape(rows, nbytes)
    wc = nbytes // 4
    planes = acc.reshape(rows, 4, wc)
    return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)).view(
        "<f4").reshape(rows, wc)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W, 4) uint8 RGBA, top row first."""
    head = data[:4]
    if head in (b"MM*\x00", b"II\x00*"):
        raise UnsupportedImage("TIFF: mixed byte-order headers are not "
                               "decoded by the port")
    if head not in (b"MM\x00*", b"II*\x00", b"MM\x00+", b"II+\x00"):
        raise ValueError("not a TIFF file")
    bo = "<" if head[:2] == b"II" else ">"
    big = head in (b"MM\x00+", b"II+\x00")
    if big and (bo == ">" or struct.unpack_from(bo + "HH", data, 4)
                != (8, 0)):
        # PIL tests the third header byte for 43, so it reads a big-endian
        # BigTIFF as a classic TIFF and fails
        raise ValueError("TIFF: bad or big-endian BigTIFF header")
    t = _ifd(data, bo, big)

    def one(tag, default=None):
        v = t.get(tag)
        return default if v is None else v[0]

    w, h = one(256), one(257)
    if not w or not h:
        raise ValueError("TIFF: no size")
    comp = one(259, 1)
    photo = one(262, 0)
    planar = one(284, 1)
    pred = one(317, 1)
    fill = one(266, 1)
    extra = t.get(338, ())
    fmt = t.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    if comp not in (1, 5, 7, 8, 32946, 32773):
        raise UnsupportedImage(f"TIFF: compression {comp} is not decoded by "
                               "the port")
    spp = one(277, 1)
    bits = t.get(258, (1,))
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("TIFF: unknown data organization")
    key = (bo, photo, tuple(fmt), fill, tuple(bits), tuple(extra))
    if key not in OPEN_INFO:
        raise ValueError(f"TIFF: PIL has no mode for {key}")
    mode, rawmode = OPEN_INFO[key]
    raw_path = comp == 1
    b = bits[0]
    if mode == "PA" or rawmode in ("I;12", "PX") or (
            photo == 6 and comp != 7):
        raise UnsupportedImage(f"TIFF: mode {mode} ({rawmode}) is not "
                               "decoded by the port")
    if raw_path and rawmode in _RAW_REFUSED:
        raise ValueError(f"TIFF: PIL has no unpacker for {rawmode}")
    if comp == 7 and (planar != 1 or photo not in (1, 2, 6) or fill != 1):
        raise UnsupportedImage("TIFF: this JPEG layout is not decoded by "
                               "the port")
    quirk16 = False
    if planar == 2 and spp > 1:
        letters = rawmode.split(";")[0][:spp]   # one letter a plane
        if mode == "LA" and raw_path or "X" in letters or (
                raw_path and "a" in letters):
            raise ValueError(f"TIFF: PIL cannot read {rawmode} planes")
        if mode not in (("RGB", "RGBA", "CMYK") if raw_path
                        else ("LA", "RGB", "RGBA")) or (
                mode == "CMYK" and b != 8):
            raise UnsupportedImage(f"TIFF: planar {mode} is not decoded by "
                                   "the port")
        quirk16 = raw_path and b == 16
    elif planar == 2 and raw_path:
        if rawmode in ("I;16", "I;16B"):
            raise ValueError("TIFF: PIL has no planar unpacker for I;16")
        if b != 8:
            raise UnsupportedImage(f"TIFF: planar {rawmode} is not decoded "
                                   "by the port")
        rawmode = "L"                          # its first letter
    if b < 8 and 322 in t:
        raise UnsupportedImage("TIFF: tiles below 8 bits are not decoded "
                               "by the port")
    if not raw_path and pred != 1:
        if pred == 2 and b not in (8, 16, 32):
            raise UnsupportedImage("TIFF: the predictor at this depth is "
                                   "not decoded by the port")
        if pred == 3 and mode != "F" or pred not in (2, 3):
            raise ValueError(f"TIFF: predictor {pred} does not apply")
    if quirk16 and 322 in t:
        raise UnsupportedImage("TIFF: planar 16-bit tiles are not decoded "
                               "by the port")

    samples = _samples(data, t, w, h, spp, b, fmt, bo, comp, planar,
                       pred if not raw_path else 1, fill, photo, quirk16)
    if not raw_path and bo == ">" and mode in ("I", "F"):
        # libtiff hands PIL native-order samples, read as big-endian
        samples = samples.astype(samples.dtype.newbyteorder("<")).view(
            samples.dtype.newbyteorder(">"))
    rgba = _rgba(samples, w, h, spp, 8 if quirk16 else b, mode, rawmode,
                 t)
    if planar == 2 and not raw_path and mode == "LA":
        rgba[..., 3] = 0                       # PIL's planar LA decode
    return rgba


def _samples(data, t, w, h, spp, b, fmt, bo, comp, planar, pred, fill,
             photo, quirk16):
    """The image's samples: (h, w, spp) in the sample type (uint8 for
    JPEG chunks and for the 16-bit planar quirk), or (h, w) values for
    depths below 8."""
    def one(tag, default=None):
        v = t.get(tag)
        return default if v is None else v[0]

    tiled = 322 in t
    if tiled:
        cw, ch = one(322), one(323)
        offs, counts = t.get(324, ()), t.get(325, ())
        grid = ((w + cw - 1) // cw, (h + ch - 1) // ch)
    else:
        cw, ch = w, min(one(278, 2 ** 32 - 1), h)
        offs, counts = t.get(273, ()), t.get(279, ())
        grid = (1, (h + ch - 1) // ch)
    planes = spp if planar == 2 else 1
    per = spp // planes                         # samples in each chunk
    if len(offs) < grid[0] * grid[1] * planes or len(counts) < len(offs):
        raise ValueError("TIFF: missing chunk offsets")
    if b < 8:
        row_bytes = (cw * b + 7) // 8
        img = np.zeros((h, (w * b + 7) // 8), np.uint8)
    else:
        kind = {1: "u", 2: "i", 3: "f"}[fmt[0]]
        if b == 32 and kind == "u":
            kind = "i"                          # PIL's I;32N is signed
        dt = np.dtype(bo + kind + str(b // 8))
        if comp == 7 or quirk16:
            dt = np.dtype(np.uint8)
        img = np.zeros((h, w, spp), dt)
        row_bytes = cw * per * b // 8
    k = 0
    for plane in range(planes):
        for ty in range(grid[1]):
            for tx in range(grid[0]):
                rows = ch if tiled else min(ch, h - ty * ch)
                y0, x0 = ty * ch, tx * cw
                y1, x1 = min(h, y0 + rows), min(w, x0 + cw)
                if comp == 7:
                    raw = data[offs[k]:offs[k] + counts[k]]
                    px = _jpeg_chunk(raw, t.get(347), photo)
                    k += 1
                    if px.shape[0] < y1 - y0 or px.shape[1] < x1 - x0:
                        raise ValueError("TIFF: short JPEG chunk")
                    img[y0:y1, x0:x1] = px[:y1 - y0, :x1 - x0, :spp]
                    continue
                want = (rows * cw if quirk16 else row_bytes * rows)
                raw = _chunk(data, offs[k], counts[k], comp, want, fill)
                k += 1
                if b < 8:
                    img[y0:y1] = np.frombuffer(raw, np.uint8).reshape(
                        rows, row_bytes)[:y1 - y0]
                    continue
                if quirk16:                     # PIL reads the plane's
                    c = np.frombuffer(raw, np.uint8).reshape(rows, cw, 1)
                    img[y0:y1, x0:x1, plane:plane + 1] = c[:y1 - y0]
                    continue
                if pred == 3:
                    c = _fp_predictor(np.frombuffer(raw, np.uint8).reshape(
                        rows, row_bytes), per).reshape(rows, cw, per)
                else:
                    c = np.frombuffer(raw, dt).reshape(rows, cw, per)
                    if pred == 2:
                        u = np.dtype(f"u{b // 8}")
                        c = np.cumsum(c.astype(dt.newbyteorder("=")).view(u),
                                      axis=1, dtype=u).view(
                                          dt.newbyteorder("="))
                sl = slice(plane, plane + per)
                img[y0:y1, x0:x1, sl] = c[:y1 - y0, :x1 - x0]
    if b < 8:
        v = np.unpackbits(img, axis=1).reshape(h, -1, b)[:, :w]
        return (v * (1 << np.arange(b - 1, -1, -1))).sum(-1).astype(np.uint8)
    return img


def _rgba(img, w, h, spp, b, mode, rawmode, t) -> np.ndarray:
    """PIL's convert("RGBA") of the samples in `mode`."""
    out = np.full((h, w, 4), 255, np.uint8)
    inverted = rawmode.startswith(("1;I", "L;I", "L;2I", "L;4I"))
    if b < 8:
        if mode == "P":
            return _palette(img, b, t)
        v = (img * (255 // ((1 << b) - 1))).astype(np.uint8)
        out[..., :3] = (255 - v if inverted else v)[..., None]
        return out
    if mode == "P":
        return _palette(img[..., 0], b, t)
    if mode in ("I;16", "I;16B"):    # min-is-white too: PIL does not invert
        out[..., :3] = np.minimum(img[..., :1].astype(np.uint32),
                                  255).astype(np.uint8)
        return out
    if mode == "I":
        out[..., :3] = np.clip(img[..., :1].astype(np.int64), 0, 255)
        return out
    if mode == "F":
        x = img[..., :1].astype(np.float32)
        out[..., :3] = np.where(x >= 255, 255,
                                np.where(x > 0, x, 0)).astype(np.uint8)
        return out
    if b == 16:                      # PIL keeps the high byte
        img = (img.astype(np.uint32) >> 8).astype(np.uint8)
    p = img.astype(np.uint8)
    if mode == "L":
        out[..., :3] = 255 - p[..., :1] if inverted else p[..., :1]
        return out
    if mode == "LA":
        out[..., :3] = p[..., :1]
        out[..., 3] = p[..., 1]
        return out
    if mode == "LAB":               # PIL's unpacker XORs a and b with 128
        out[..., :3] = lab_to_rgb(p[..., :3] ^ np.array([0, 128, 128],
                                                          np.uint8))
        return out
    if mode == "CMYK":
        c = p[..., :4].astype(np.int64)
        nk = 255 - c[..., 3:4]
        t_ = c[..., :3] * nk + 128
        out[..., :3] = np.clip(nk - ((t_ + (t_ >> 8)) >> 8), 0, 255)
        return out
    out[..., :3] = p[..., :3]
    if mode == "RGBA":
        a = p[..., 3].astype(np.int64)
        out[..., 3] = a
        if rawmode.startswith("RGBa"):   # associated alpha, divided out
            rgb = p[..., :3].astype(np.int64)
            out[..., :3] = np.where(
                a[..., None] > 0,
                np.minimum(rgb * 255 // np.maximum(a, 1)[..., None], 255), 0)
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
