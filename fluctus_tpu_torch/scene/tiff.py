"""A TIFF decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's TiffImagePlugin rules,
and libtiff 4.7's for every compressed file, which PIL reads through
libtiff) for the first image of the file.

Classic TIFF in either byte order, the mixed byte-order headers "MM*\\0"
and "II\\0*" (PIL's own reader takes them; libtiff refuses their version,
so only uncompressed ones load) and little-endian BigTIFF (version 43:
8-byte offsets and counts; PIL fails on big-endian BigTIFF); strips and
tiles; chunky and planar samples (PlanarConfiguration 2); FillOrder 2
(each stored byte bit-reversed).

Compressions, each as libtiff decodes it: none; PackBits; LZW (MSB-first
codes with the early change, and old-style LZW: LSB-first codes without
it); Deflate (both tags, through zlib); LZMA (an .xz stream, through the
standard library's lzma); Zstandard (scene/zstd.py); CCITT modified
Huffman (2, and 32771 with word-aligned rows), T.4 (3, 1D and 2D) and
T.6 (4) through scene/native/ccitt.cpp, which copies libtiff's fax
decoder, damaged rows included; ThunderScan (4 bits); new-style JPEG (7,
through scene/jpeg.py with the JPEGTables stream prepended, as libtiff
feeds libjpeg: RGB, CMYK and planar planes pass their components
through, YCbCr converts with its own subsampling); old-style JPEG (6,
libtiff's OJPEG reading of a JPEG stream at JPEGInterchangeFormat or of
the strips' entropy-coded data with the JPEGQTables / DCTables / ACTables
tables). Compressions PIL names and this libtiff cannot decode (SGILog,
WebP) and layouts libtiff's codecs refuse (CCITT at other than 1 bit,
ThunderScan at other than 4 bits) fail as in PIL. The horizontal
predictor (2) at 8, 16 and 32 bits and the floating-point predictor (3);
libtiff refuses the horizontal one at other depths.

PIL's pixel modes come from `OPEN_INFO`, a copy of PIL 12's table:
bilevel and grey at 1, 2, 4 and 8 bits (min-is-white inverted); grey at
12 bits (PIL's I;12 unpacker: two pixels in three bytes, kept as I;16,
which its RGBA conversion clamps to 255) and 16 bits (I;16), signed 16
and 32 bits and unsigned 32 bits (PIL's I, clamped to 0-255), 32-bit
float (PIL's F: NaN and negatives 0, truncated, clamped to 255); grey
with alpha; RGB and RGBA at 8 and 16 bits (16-bit samples keep their
high byte) with extra samples unused, unassociated or associated alpha
(divided out as v * 255 // a); palette images at 1, 2, 4 and 8 bits
(16-bit colour map entries become entry // 256), with an unused or an
alpha extra sample (PX, PA); CMYK at 8 and 16 bits (PIL's conversion:
with nk = 255 - k, each channel nk - c * nk / 255, rounded as PIL's
MULDIV255); CIELAB at 8 bits (PIL's LittleCMS conversion,
scene/lab.py); YCbCr, which PIL reads through libtiff's RGBA interface
(libtiff's YCbCr -> RGB tables from YCbCrCoefficients and
ReferenceBlackWhite, its subsampling blocks) except for new-style JPEG
of chunky samples, and which fails uncompressed (PIL's own reader wants
four bytes a pixel).

PIL's own quirks are kept where they decide the bytes: compressed
big-endian signed and float samples come out byte-swapped (libtiff hands
PIL native-order samples, which PIL reads as big-endian); planar
uncompressed images read each plane with one letter of the raw mode
(8-bit planes are exact, min-is-white is not inverted, 16-bit RGB and
CMYK planes read their first bytes as 8-bit samples, a 4-bit grey plane
reads 8-bit samples on into the file, and LAB planes skip the unpacker's
XOR of a and b with 128); a compressed planar grey-with-alpha or palette-
with-alpha image loses its alpha (0), and planar LAB its alpha too;
uncompressed data ignores the predictor and the strip byte counts.

Layouts PIL cannot read, and damaged or truncated data, raise
ValueError. This module refuses no layout PIL reads; the codecs it calls
refuse, as unsupported, only what PIL's pixels do not follow from the
file alone (T.6 data that ends before its last row, old-style JPEG of
other photometric interpretations).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import lzma
import struct

import numpy as np

from fluctus_tpu_torch.scene.lab import lab_to_rgb
from fluctus_tpu_torch.scene.pilmodes import to_rgba

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q",
          18: "Q"}
_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# PIL 12's TiffImagePlugin.COMPRESSION_INFO: the compressions it names
COMPRESSION_INFO = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                    5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                    8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                    32773: "packbits", 32809: "tiff_thunderscan",
                    32946: "tiff_deflate", 34676: "tiff_sgilog",
                    34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                    50001: "webp"}
_FAX = (2, 3, 4, 32771)
PREFIXES = (b"MM\x00*", b"II*\x00", b"MM*\x00", b"II\x00*", b"MM\x00+",
            b"II+\x00")


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
    """TIFF LZW: MSB-first codes, 9 to 12 bits, the early change; or, when
    the data starts 0x00 0x01-ish as libtiff tests, old-style LZW
    (LSB-first codes, the width growing one code later)."""
    compat = len(src) >= 2 and src[0] == 0 and src[1] & 1
    clear, eoi = 256, 257
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    width = 9
    acc = nbits = 0
    pos = 0
    prev = None
    early = 0 if compat else 1
    while len(out) < want:
        while nbits < width:
            if pos >= len(src):
                return bytes(out)
            if compat:
                acc |= src[pos] << nbits
            else:
                acc = (acc << 8) | src[pos]
            pos += 1
            nbits += 8
        if compat:
            code = acc & ((1 << width) - 1)
            acc >>= width
        else:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            acc &= (1 << (nbits - width)) - 1
        nbits -= width
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
        if len(table) + early >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _thunder(src: bytes, rows: int, width: int) -> bytes:
    """libtiff's ThunderDecode: 4-bit pixels from 2-bit codes (a run of
    the last pixel, three 2-bit or two 3-bit deltas, a raw pixel), row by
    row; a row that ends short or long fails."""
    two = (0, 1, 0, -1)
    three = (0, 1, 2, 3, 0, -3, -2, -1)
    rb = (width + 1) // 2
    out = bytearray(rb * rows + rb + 64)
    bp = 0
    for r in range(rows):
        op = r * rb
        last = n_px = 0

        def put(v):
            nonlocal last, n_px, op
            last = v & 0xF
            if n_px < width:
                if n_px & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                n_px += 1

        while bp < len(src) and n_px < width:
            n = src[bp]
            bp += 1
            code = n & 0xC0
            if code == 0x00:                       # a run
                n &= 0x3F
                if n_px & 1:
                    out[op] |= last
                    last = out[op]
                    op += 1
                    n_px += 1
                    n -= 1
                else:
                    last |= last << 4
                n_px += n
                if n_px <= width:
                    while n > 0:
                        if op < len(out):
                            out[op] = last & 0xFF
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 0xF
            elif code == 0x40:                     # 2-bit deltas
                for sh in (4, 2, 0):
                    d = (n >> sh) & 3
                    if d != 2:
                        put(last + two[d])
            elif code == 0x80:                     # 3-bit deltas
                for sh in (3, 0):
                    d = (n >> sh) & 7
                    if d != 4:
                        put(last + three[d])
            else:                                  # raw
                put(n)
        if n_px != width:
            raise ValueError("TIFF: ThunderScan row of the wrong length")
    return bytes(out[:rb * rows])


def _unxz(raw: bytes, want: int) -> bytes:
    """libtiff's LZMA codec: an .xz stream decoded until the strip is
    full; an error after that is only reported, so the input is fed in
    small pieces to keep what came out before one."""
    d = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
    out = bytearray()
    for i in range(0, len(raw), 64):
        try:
            out += d.decompress(raw[i:i + 64], max_length=want - len(out))
        except lzma.LZMAError:
            if len(out) >= want:
                break
            raise
        if len(out) >= want or d.eof:
            break
    return bytes(out)


def _ccitt(raw: bytes, comp: int, width: int, rows: int, t_opts: int,
           odd: int, state: dict | None = None) -> bytes:
    from fluctus_tpu_torch.scene.ccitt import decode
    return decode(raw, comp, width, rows, t_opts, odd, state)


class PartialData(ValueError):
    """A codec failed part way; `partial` holds what it had written into
    libtiff's strip buffer (which libtiff's RGBA reader keeps)."""

    def __init__(self, msg: str, partial: bytes = b""):
        super().__init__(msg)
        self.partial = partial


class _ZStream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint),
                ("total_in", ctypes.c_ulong), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_uint), ("total_out", ctypes.c_ulong),
                ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p),
                ("zalloc", ctypes.c_void_p), ("zfree", ctypes.c_void_p),
                ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
                ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong)]


_libz = None


def _zlib():
    """The zlib the interpreter's own zlib module loads (its inflate keeps
    what it wrote before an error, which Python's module drops)."""
    global _libz
    if _libz is None:
        lib = ctypes.CDLL(ctypes.util.find_library("z") or "libz.so.1")
        lib.zlibVersion.restype = ctypes.c_char_p
        lib.inflateInit_.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.inflate.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.inflateEnd.argtypes = [ctypes.c_void_p]
        _libz = lib
    return _libz


def _inflate(raw: bytes, want: int) -> bytes:
    """libtiff's Deflate codec (tif_zip.c ZIPDecode): inflate with
    Z_PARTIAL_FLUSH into the strip buffer until the stream ends or the
    buffer is full; a data error (the checksum too, where inflate reaches
    it) or too little data fails with PartialData, holding what inflate
    had written."""
    lib = _zlib()
    out = ctypes.create_string_buffer(max(want, 1))
    src = ctypes.create_string_buffer(raw, len(raw))
    z = _ZStream()
    if lib.inflateInit_(ctypes.byref(z), lib.zlibVersion(),
                        ctypes.sizeof(z)) != 0:
        raise ValueError("TIFF: zlib refuses to start")
    z.next_in = ctypes.cast(src, ctypes.c_void_p)
    z.avail_in = len(raw)
    z.next_out = ctypes.cast(out, ctypes.c_void_p)
    z.avail_out = want
    try:
        while True:
            state = lib.inflate(ctypes.byref(z), 1)
            if state == 1:                     # Z_STREAM_END
                break
            if state != 0:                     # data, buffer or other error
                raise PartialData("TIFF: Deflate data error",
                                  out.raw[:want - z.avail_out])
            if z.avail_out == 0:
                break
    finally:
        lib.inflateEnd(ctypes.byref(z))
    return out.raw[:want - z.avail_out]


def _decompress(raw: bytes, comp: int, want: int, geom) -> bytes:
    """One strip's or tile's bytes through libtiff's codec for `comp`:
    at least `want` bytes (what libtiff's strip or tile buffer holds), or
    ValueError where libtiff's read fails. `geom` = (row width in pixels,
    rows, T4Options, file offset parity[, the fax codec's state]) for the
    codecs that need it."""
    if comp == 32773:
        out = _packbits(raw)
    elif comp == 5:
        out = _lzw(raw, want)
    elif comp in (8, 32946):
        out = _inflate(raw, want)
    elif comp == 34925:
        out = _unxz(raw, want)
    elif comp == 50000:
        from fluctus_tpu_torch.scene.zstd import decompress
        out = decompress(raw, want)
    elif comp in _FAX:
        out = _ccitt(raw, comp, *geom)
    elif comp == 32809:
        out = _thunder(raw, geom[1], geom[0])
    else:                                       # 1: none
        out = raw
    if len(out) < want:
        raise PartialData("TIFF: short image data", out)
    return out[:want]


def _tables_as_read(tables: bytes) -> bytes:
    """The JPEGTables stream as libjpeg reads it through libtiff's source,
    up to its EOI: past the field's last byte the source gives a fake EOI
    (FF D9) at every refill, so a segment the field's count cuts is read
    on through those bytes to its declared length."""
    def at(i):
        return tables[i] if i < len(tables) else (0xFF, 0xD9)[
            (i - len(tables)) & 1]
    if tables[:2] != b"\xff\xd8":
        return tables
    out, i = bytearray(b"\xff\xd8"), 2
    while i < len(tables) + 4:
        while at(i) != 0xFF:                 # libjpeg skips stray bytes
            i += 1
        while at(i) == 0xFF:
            i += 1
        m = at(i)
        i += 1
        if m == 0xD9:
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            out += bytes((0xFF, m))
            continue
        n = at(i) << 8 | at(i + 1)
        out += bytes((0xFF, m)) + bytes(at(i + k) for k in range(max(n, 2)))
        i += max(n, 2)
    return bytes(out)


def _jpeg_sampling(data: bytes, t, offs, counts, spp: int, photo: int,
                   planar: int) -> tuple:
    """The sampling factors libtiff's JPEG codec asks of the first
    component: YCbCrSubsampling for chunky YCbCr (where the tag is absent,
    JPEGFixupTagsSubsampling takes them from the first chunk's SOF, or
    keeps the default 2x2), 1x1 for every other layout."""
    if photo != 6 or planar != 1:
        return 1, 1
    if 530 in t:
        return tuple(t[530][:2]) if len(t[530]) >= 2 else (2, 2)
    if spp != 3 or not offs or not offs[0]:
        return 2, 2
    raw = data[offs[0]:offs[0] + (counts[0] if counts else 0)]
    i = 0
    while True:                         # JPEGFixupTagsSubsamplingSec
        while i < len(raw) and raw[i] != 0xFF:
            i += 1
        while i < len(raw) and raw[i] == 0xFF:
            i += 1
        if i >= len(raw):
            return 2, 2
        m = raw[i]
        i += 1
        if m == 0xD8:
            continue
        if i + 2 > len(raw):
            return 2, 2
        n = raw[i] << 8 | raw[i + 1]
        i += 2
        if m in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            if n != 8 + spp * 3 or i + 3 * spp + 6 > len(raw):
                return 2, 2
            ph, pv = raw[i + 7] >> 4, raw[i + 7] & 15
            if any(raw[i + 7 + 3 * o] != 0x11 for o in range(1, spp)) or \
                    ph not in (1, 2, 4) or pv not in (1, 2, 4):
                return 2, 2
            return ph, pv
        if not (m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF) \
                or n < 2:
            return 2, 2
        i += n - 2


def _jpeg_chunk(raw: bytes, tables, photo: int, planar: int,
                sampling: tuple) -> np.ndarray:
    """One strip or tile of new-style JPEG: the JPEGTables stream (less
    its EOI) before the chunk's (less its SOI), decoded with the colour
    spaces libtiff's JPEGPreDecode sets (YCbCr to RGB for chunky YCbCr;
    every other layout passed through, whatever JFIF or Adobe markers the
    stream carries). Where the first component's sampling factors are not
    `sampling`, or another component's not 1x1, libtiff fails the chunk.
    Returns (rows, cols, components) uint8."""
    from fluctus_tpu_torch.scene.jpeg import (decode_jpeg_samples,
                                              sampling_factors)
    if raw[:2] != b"\xff\xd8":
        raise ValueError("TIFF: JPEG chunk without SOI")
    # libtiff reads the tables as a stream of their own, ended by their EOI
    # or by the fake EOI its source gives past their last byte
    head = _tables_as_read(bytes(tables)) if tables else b"\xff\xd8"
    stream = head + raw[2:]
    factors = sampling_factors(stream, "libtiff")
    if factors[0] != tuple(sampling) or any(f != (1, 1)
                                            for f in factors[1:]):
        raise ValueError("TIFF: improper JPEG sampling factors")
    ycc = photo == 6 and planar == 1
    return decode_jpeg_samples(stream, "libtiff", "ycc" if ycc else "none")


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


def _setup(data: bytes):
    """PIL's _open and _setup: (tags, byte order, mode, raw mode, key and
    the values decode_tiff needs), or ValueError where PIL fails."""
    head = data[:4]
    if head not in PREFIXES:
        raise ValueError("not a TIFF file")
    bo = "<" if head[:2] == b"II" else ">"
    big = head in (b"MM\x00+", b"II+\x00")
    if big and (bo == ">" or struct.unpack_from(bo + "HH", data, 4)
                != (8, 0)):
        # PIL tests the third header byte for 43, so it reads a big-endian
        # BigTIFF as a classic TIFF and fails
        raise ValueError("TIFF: bad or big-endian BigTIFF header")
    t = _ifd(data, bo, big)
    if 0xBC01 in t:
        raise ValueError("TIFF: Windows Media Photo")

    def one(tag, default=None):
        v = t.get(tag)
        return default if v is None else v[0]

    comp = one(259, 1)
    if comp not in COMPRESSION_INFO:
        raise ValueError(f"TIFF: PIL names no compression {comp}")
    photo = one(262, 0)
    if comp == 6:
        photo = 6                    # old-style JPEG is YCbCr to PIL
    w, h = one(256), one(257)
    if not w or not h:
        raise ValueError("TIFF: no size")
    fmt = t.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    extra = t.get(338, ())
    spp = one(277, 3 if comp == 6 and photo in (2, 6) else 1)
    bits = t.get(258, (1,))
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        raise ValueError("TIFF: unknown data organization")
    fill = one(266, 1)
    key = (bo, photo, tuple(fmt), fill, tuple(bits), tuple(extra))
    if key not in OPEN_INFO:
        raise ValueError(f"TIFF: PIL has no mode for {key}")
    mode, rawmode = OPEN_INFO[key]
    return dict(t=t, bo=bo, w=w, h=h, comp=comp, photo=photo, spp=spp,
                bits=tuple(bits), fmt=tuple(fmt), fill=fill, extra=extra,
                mode=mode, rawmode=rawmode, key=key,
                planar=one(284, 1), pred=one(317, 1),
                mixed=head in (b"MM*\x00", b"II\x00*"))


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> (H, W, 4) uint8 RGBA, top row first."""
    s = _setup(data)
    t, comp, photo, planar = s["t"], s["comp"], s["photo"], s["planar"]
    mode, rawmode, b, spp = s["mode"], s["rawmode"], s["bits"][0], s["spp"]
    raw_path = comp == 1
    if not raw_path:
        if s["mixed"]:
            raise ValueError("TIFF: libtiff refuses this header's version")
        if s["fill"] == 2:                 # libtiff undoes the fill order
            mode, rawmode = OPEN_INFO[s["key"][:3] + (1,) + s["key"][4:]]
        if comp in (34676, 34677, 50001):
            raise ValueError("TIFF: this libtiff has no codec for "
                             f"compression {comp}")
        if comp in _FAX and b != 1:
            raise ValueError("TIFF: CCITT needs 1 bit a sample")
        if comp == 32809 and b != 4:
            raise ValueError("TIFF: ThunderScan needs 4 bits a sample")
        pred = s["pred"]
        if pred == 2 and b not in (8, 16, 32, 64):
            raise ValueError(f"TIFF: no horizontal predictor at {b} bits")
        if pred == 3 and mode != "F" or pred not in (1, 2, 3):
            raise ValueError(f"TIFF: predictor {pred} does not apply")
        if comp == 7 and (photo not in (1, 2, 5, 6) or spp > 4):
            raise ValueError("TIFF: libtiff's JPEG codec refuses this "
                             "layout")
        if comp == 6:
            from fluctus_tpu_torch.scene.ojpeg import decode_ojpeg
            return decode_ojpeg(data, s)
        if photo == 6 and not (comp == 7 and planar == 1):
            return _ycbcr(data, s)
        if photo == 6:
            rawmode = "RGB"                # libjpeg converts to RGB
    elif photo == 6:
        rawmode = "RGBX"                   # four bytes a pixel: PIL fails
    if raw_path and rawmode in _RAW_REFUSED:
        raise ValueError(f"TIFF: PIL has no unpacker for {rawmode}")
    quirk16 = lab_plain = False
    if planar == 2 and spp > 1:
        letters = rawmode.split(";")[0][:spp]   # one letter a plane
        if mode in ("LA", "PA") and raw_path or "X" in letters or (
                raw_path and "a" in letters) or rawmode == "PX":
            raise ValueError(f"TIFF: PIL cannot read {rawmode} planes")
        quirk16 = raw_path and b == 16
        lab_plain = mode == "LAB"
    elif planar == 2 and raw_path:
        if rawmode in ("I;16", "I;16B"):
            raise ValueError("TIFF: PIL has no planar unpacker for I;16")
        return _raw_planar_single(data, s, rawmode[0])

    samples = _samples(data, s, comp, 1 if raw_path else s["pred"],
                       quirk16, rawmode)
    if not raw_path and s["bo"] == ">" and mode in ("I", "F"):
        # libtiff hands PIL native-order samples, read as big-endian
        samples = samples.astype(samples.dtype.newbyteorder("<")).view(
            samples.dtype.newbyteorder(">"))
    if rawmode == "I;12":
        return to_rgba("I;16", _unpack12(samples, s["w"]))
    if lab_plain:                            # the planes as they are
        out = np.zeros((s["h"], s["w"], 4), np.uint8)
        out[..., :3] = lab_to_rgb(samples[..., :3])
        return out
    rgba = _rgba(samples, s["w"], s["h"], spp, 8 if quirk16 else b, mode,
                 rawmode, t)
    if planar == 2 and not raw_path and mode in ("LA", "PA"):
        rgba[..., 3] = 0                   # PIL's planar decode
    return rgba


def _unpack12(rows: np.ndarray, w: int) -> np.ndarray:
    """PIL's I;12 unpacker over packed rows: (h, w) uint16."""
    r = rows.astype(np.uint16)
    n = (w + 1) // 2
    need = 3 * n
    if r.shape[1] < need:
        r = np.pad(r, ((0, 0), (0, need - r.shape[1])))
    t = r[:, :need].reshape(r.shape[0], n, 3)
    a = (t[..., 0] << 4) | (t[..., 1] >> 4)
    c = ((t[..., 1] & 0x0F) << 8) | t[..., 2]
    return np.stack([a, c], -1).reshape(r.shape[0], -1)[:, :w]


def _chunks(s):
    """(chunk grid, chunk width, chunk height, offsets, counts, tiled)."""
    t, w, h = s["t"], s["w"], s["h"]

    def one(tag, default=None):
        v = t.get(tag)
        return default if v is None else v[0]

    tiled = 322 in t
    if tiled:
        cw, ch = one(322), one(323)
        if not cw or not ch:
            raise ValueError("TIFF: invalid tile dimensions")
        offs, counts = t.get(324, ()), t.get(325, ())
        grid = ((w + cw - 1) // cw, (h + ch - 1) // ch)
    else:
        if 273 not in t:
            raise ValueError("TIFF: unknown data organization")
        cw, ch = w, min(one(278, 2 ** 32 - 1), h)
        offs, counts = t.get(273, ()), t.get(279, ())
        grid = (1, (h + ch - 1) // ch)
    return grid, cw, ch, offs, counts, tiled


def _raw_planar_single(data, s, letter):
    """PIL's raw decoder on a planar single-sample image: the plane read
    with one letter of the raw mode ('1' 1 bit, 'L' and 'P' 8 bits, 'I'
    and 'F' 32-bit native), on into the file past the strip's bytes."""
    grid, cw, ch, offs, counts, tiled = _chunks(s)
    w, h, mode = s["w"], s["h"], s["mode"]
    bits = {"1": 1, "L": 8, "P": 8, "I": 32, "F": 32}[letter]
    if letter not in mode:
        raise ValueError("TIFF: PIL has no unpacker for this plane")
    if len(offs) < grid[0] * grid[1]:
        raise ValueError("TIFF: missing chunk offsets")
    rb = (cw * bits + 7) // 8
    img = np.zeros((h, (w * bits + 7) // 8), np.uint8)
    k = 0
    for ty in range(grid[1]):
        for tx in range(grid[0]):
            y0, x0 = ty * ch, tx * cw
            rows = min(ch, h - y0)
            px = _file_rows(data, offs[k], rows, rb)
            k += 1
            xb = x0 * bits // 8
            n = min(rb, img.shape[1] - xb)
            img[y0:y0 + rows, xb:xb + n] = px[:, :n]
    if letter == "1":
        v = np.unpackbits(img, axis=1)[:, :w]
        return to_rgba("1", v)
    if letter in "LP":
        v = img[:, :w]
        return (_palette(v, s["bits"][0], s["t"]) if letter == "P"
                else to_rgba("L", v))
    v = img[:, :4 * w].copy().view("<f4" if letter == "F" else "<i4")
    return to_rgba(mode, v)


def _file_rows(data: bytes, off: int, rows: int, rb: int) -> np.ndarray:
    """PIL's raw decoder: `rows` rows of `rb` bytes from `off`, however
    many bytes the strip declares; a file that ends first is truncated."""
    raw = data[off:off + rows * rb]
    if len(raw) < rows * rb:
        raise ValueError("TIFF: image file is truncated")
    return np.frombuffer(raw, np.uint8).reshape(rows, rb)


def _samples(data, s, comp, pred, quirk16, rawmode):
    """The image's samples: (h, w, spp) in the sample type (uint8 for
    JPEG chunks and for the 16-bit planar quirk), or (h, row bytes)
    packed rows for depths below 8 and 12-bit grey."""
    t, w, h, spp, bo = s["t"], s["w"], s["h"], s["spp"], s["bo"]
    b, fmt, planar, photo = s["bits"][0], s["fmt"], s["planar"], s["photo"]
    grid, cw, ch, offs, counts, tiled = _chunks(s)
    planes = spp if planar == 2 else 1
    per = spp // planes                         # samples in each chunk
    if len(offs) < grid[0] * grid[1] * planes or (
            comp != 1 and len(counts) < len(offs)):
        raise ValueError("TIFF: missing chunk offsets")
    packed = b < 8 or b == 12
    if rawmode == "RGBX":                       # uncompressed YCbCr
        per, spp = 4, 4
    if packed:
        row_bytes = (cw * b * per + 7) // 8
        img = np.zeros((h, (w * b * per + 7) // 8), np.uint8)
    else:
        kind = {1: "u", 2: "i", 3: "f"}[fmt[0]]
        if b == 32 and kind == "u":
            kind = "i"                          # PIL's I;32N is signed
        dt = np.dtype(bo + kind + str(b // 8))
        if comp == 7 or quirk16 or rawmode == "RGBX":
            dt = np.dtype(np.uint8)
        img = np.zeros((h, w, spp), dt)
        row_bytes = cw * per * b // 8
    t4 = (t.get(292) or t.get(293) or (0,))[0]
    if comp == 7:
        sampling = _jpeg_sampling(data, t, offs, counts, spp, photo, planar)
    fax: dict = {}    # libtiff's fax codec mode, kept from chunk to chunk
    fill = s["fill"]
    k = 0
    for plane in range(planes):
        for ty in range(grid[1]):
            for tx in range(grid[0]):
                rows = ch if tiled else min(ch, h - ty * ch)
                y0, x0 = ty * ch, tx * cw
                y1, x1 = min(h, y0 + rows), min(w, x0 + cw)
                off = offs[k]
                if comp == 7:
                    raw = data[off:off + counts[k]]
                    px = _jpeg_chunk(raw, t.get(347), photo, planar,
                                     sampling)
                    k += 1
                    if px.shape[0] < y1 - y0 or px.shape[1] < x1 - x0 or \
                            px.shape[2] != per:
                        raise ValueError("TIFF: JPEG chunk of the wrong "
                                         "size")
                    img[y0:y1, x0:x1, plane:plane + per] = \
                        px[:y1 - y0, :x1 - x0]
                    continue
                want = rows * cw if quirk16 else row_bytes * rows
                if comp == 1:
                    if grid == (1, 1) and planes == 1:
                        off = offs[-1]          # PIL: the last offset
                    raw = _file_rows(data, off, 1, want)[0].tobytes()
                    if fill == 2:
                        raw = _REV[np.frombuffer(raw, np.uint8)].tobytes()
                else:
                    raw = data[off:off + counts[k]]
                    if len(raw) != counts[k]:
                        raise ValueError("TIFF: truncated image data")
                    if fill == 2:
                        raw = _REV[np.frombuffer(raw, np.uint8)].tobytes()
                    raw = _decompress(raw, comp, want,
                                      (cw, rows, t4, off & 1, fax))
                k += 1
                if packed:
                    xb = x0 * b * per // 8
                    n = min(row_bytes, img.shape[1] - xb)
                    img[y0:y1, xb:xb + n] = np.frombuffer(
                        raw, np.uint8).reshape(rows, row_bytes)[:y1 - y0, :n]
                    continue
                if quirk16:                     # PIL reads the plane's
                    c = np.frombuffer(raw, np.uint8).reshape(rows, cw, 1)
                    img[y0:y1, x0:x1, plane:plane + 1] = c[:y1 - y0,
                                                           :x1 - x0]
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


def _rational(t, tag, default):
    """A RATIONAL tag as libtiff reads it: float32 num / float32 den."""
    v = t.get(tag)
    if v is None:
        return [np.float32(x) for x in default]
    pairs = np.asarray(v, np.float64).reshape(-1, 2)
    return [np.float32(0) if d == 0 else np.float32(n) / np.float32(d)
            for n, d in pairs]


def ycbcr_tables(luma, rbw):
    """libtiff's TIFFYCbCrToRGBInit: (Y, Cr_r, Cb_b, Cr_g, Cb_g) int64
    tables of 256 entries, in its float32 and fixed-point arithmetic."""
    f = np.float32
    lr, lg, lb = luma[:3]

    def clamp(x, lo, hi):
        return lo if not x >= lo else hi if x > hi else x

    def fix(x):
        return int(np.float64(f(x) * f(65536)) + 0.5)

    f1 = f(2) - f(2) * lr
    d1 = fix(clamp(f1, f(0), f(2)))
    f2 = lr * f1 / lg
    d2 = -fix(clamp(f2, f(0), f(2)))
    f3 = f(2) - f(2) * lb
    d3 = fix(clamp(f3, f(0), f(2)))
    f4 = lb * f3 / lg
    d4 = -fix(clamp(f4, f(0), f(2)))

    def code2v(c, rb, rw, cr):
        den = rw - rb
        den = den if den != 0 else f(1)
        return f(f(c - int(rb)) * f(cr)) / f(den)

    tabs = np.zeros((5, 256), np.int64)
    lim = f(128.0 * 32)
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127),
                       -lim, lim))
        cb = int(clamp(code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127),
                       -lim, lim))
        tabs[1, i] = (d1 * cr + (1 << 15)) >> 16
        tabs[2, i] = (d3 * cb + (1 << 15)) >> 16
        tabs[3, i] = d2 * cr
        tabs[4, i] = d4 * cb + (1 << 15)
        tabs[0, i] = int(clamp(code2v(x + 128, rbw[0], rbw[1], 255), -lim,
                               lim))
    return tabs


def ycbcr_to_rgb_libtiff(y, cb, cr, tabs) -> np.ndarray:
    """TIFFYCbCrtoRGB on uint8 arrays: (..., 3) uint8."""
    yt = tabs[0][y]
    r = yt + tabs[1][cr]
    g = yt + ((tabs[4][cb] + tabs[3][cr]) >> 16)
    b = yt + tabs[2][cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _ycbcr(data: bytes, s) -> np.ndarray:
    """PIL's read of YCbCr through libtiff's RGBA interface
    (TIFFRGBAImage): 8-bit, 3 samples; chunky samples in libtiff's
    subsampling blocks (hs * vs Y values, then Cb and Cr, for each block
    of a strip or tile, the blocks cut at the chunk's edge), or planar
    planes without subsampling; libtiff's conversion tables from
    YCbCrCoefficients and ReferenceBlackWhite."""
    t, w, h, comp = s["t"], s["w"], s["h"], s["comp"]
    if s["spp"] != 3 or s["bits"] != (8, 8, 8):
        raise ValueError("TIFF: libtiff's RGBA reader cannot handle this "
                         "YCbCr layout")
    hs, vs = (tuple(t[530][:2]) if 530 in t and len(t[530]) >= 2
              else (2, 2))
    luma = _rational(t, 529, (0.299, 0.587, 0.114))
    rbw = _rational(t, 532, (0, 255, 128, 255, 128, 255))
    if not luma[1] or any(np.isnan(v) for v in luma):
        raise ValueError("TIFF: invalid YCbCrCoefficients")
    tabs = ycbcr_tables(luma, rbw)
    planar = s["planar"]
    if planar == 2:
        if (hs, vs) != (1, 1):
            raise ValueError("TIFF: libtiff reads planar YCbCr only without "
                             "subsampling")
        p = _samples(data, dict(s, bits=(8, 8, 8)), comp, s["pred"], False,
                     "YCbCr")
        return _to_rgba(ycbcr_to_rgb_libtiff(p[..., 0], p[..., 1],
                                             p[..., 2], tabs))
    if (hs, vs) not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2),
                        (1, 1)):
        raise ValueError("TIFF: libtiff cannot handle this subsampling")
    grid, cw, ch, offs, counts, tiled = _chunks(s)
    if len(offs) < grid[0] * grid[1] or len(counts) < len(offs):
        raise ValueError("TIFF: missing chunk offsets")
    bw = (cw + hs - 1) // hs
    unit = hs * vs + 2
    y = np.zeros((h, w), np.uint8)
    cb = np.zeros((h, w), np.uint8)
    cr = np.zeros((h, w), np.uint8)
    t4 = 0
    k = 0
    for ty in range(grid[1]):
        for tx in range(grid[0]):
            rows = ch if tiled else min(ch, h - ty * ch)
            y0, x0 = ty * ch, tx * cw
            y1, x1 = min(h, y0 + rows), min(w, x0 + cw)
            bh = (rows + vs - 1) // vs
            raw = data[offs[k]:offs[k] + counts[k]]
            if len(raw) != counts[k]:
                raise ValueError("TIFF: truncated image data")
            if s["fill"] == 2:
                raw = _REV[np.frombuffer(raw, np.uint8)].tobytes()
            try:
                raw = _decompress(raw, comp, bh * bw * unit,
                                  (cw, rows, t4, offs[k] & 1))
            except PartialData as e:
                # libtiff's RGBA reader ignores the failed read and converts
                # the buffer it zeroed for the chunk, as far as the codec
                # filled it
                raw = e.partial[:bh * bw * unit].ljust(bh * bw * unit, b"\0")
            k += 1
            blocks = np.frombuffer(raw, np.uint8).reshape(bh, bw, unit)
            yy = blocks[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(
                0, 2, 1, 3).reshape(bh * vs, bw * hs)
            cbb = np.repeat(np.repeat(blocks[..., -2], vs, 0), hs, 1)
            crb = np.repeat(np.repeat(blocks[..., -1], vs, 0), hs, 1)
            y[y0:y1, x0:x1] = yy[:y1 - y0, :x1 - x0]
            cb[y0:y1, x0:x1] = cbb[:y1 - y0, :x1 - x0]
            cr[y0:y1, x0:x1] = crb[:y1 - y0, :x1 - x0]
    return _to_rgba(ycbcr_to_rgb_libtiff(y, cb, cr, tabs))


def _to_rgba(rgb: np.ndarray) -> np.ndarray:
    out = np.full(rgb.shape[:2] + (4,), 255, np.uint8)
    out[..., :3] = rgb
    return out


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
    if mode in ("P", "PA"):
        out = _palette(img[..., 0], b, t)
        if mode == "PA":
            out[..., 3] = img[..., 1]
        return out
    if mode in ("I;16", "I;16B", "I", "F"):  # min-is-white: PIL does not
        return to_rgba(mode, img[..., 0])    # invert 16-bit grey either
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
        return to_rgba("CMYK", p)
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
    """PIL's palette from the colour map ("RGB;L": every red, then every
    green, then every blue, each entry // 256) over index values `v`."""
    cmap = t.get(320)
    if cmap is None or len(cmap) < 3 << b:
        raise ValueError("TIFF: palette image without a colour map")
    n = min(len(cmap) // 3, 256)
    pal = np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T // 256
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    table[:n, :3] = pal
    return table[v]
