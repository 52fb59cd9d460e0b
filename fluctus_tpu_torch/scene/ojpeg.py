"""Old-style JPEG in TIFF (compression 6) as libtiff's OJPEG codec reads
it for PIL, in the two layouts libtiff takes:

- a whole JPEG stream at JPEGInterchangeFormat (513, its length in 514):
  decoded with its own tables, frame and sampling;
- the tables form: JPEGQTables (519), JPEGDCTables (520) and
  JPEGACTables (521) give one 64-byte quantization table and one pair of
  Huffman tables (16 counts, then the values) a component, at offsets in
  the file; JPEGRestartInterval (515) the restart interval; the frame is
  the TIFF's (its width and height, component 0 sampled by
  YCbCrSubSampling, default 2 x 2, the others 1 x 1), and the strips hold
  the entropy-coded data, read as one stream.

libtiff hands the components after the IDCT, not upsampled ("raw data"),
in its YCbCr sampling blocks, and PIL converts a YCbCr file through
libtiff's RGBA reader (tiff.ycbcr_tables from YCbCrCoefficients and
ReferenceBlackWhite, the chroma of a block shared by its pixels); a grey
file is its one component as it is. Other photometric interpretations
are not decoded (UnsupportedImage).
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _tables_stream(data: bytes, s) -> bytes:
    """libtiff's JPEG stream for the tables form."""
    t, spp, w, h = s["t"], s["spp"], s["w"], s["h"]
    q, dc, ac = t.get(519, ()), t.get(520, ()), t.get(521, ())
    if not (len(q) == len(dc) == len(ac) == spp):
        raise ValueError("OJPEG: a table offset a component is needed")
    hs, vs = (tuple(t[530][:2]) if 530 in t and len(t[530]) >= 2
              else (2, 2))
    out = b"\xff\xd8"
    for k in range(spp):
        table = data[q[k]:q[k] + 64]
        if len(table) != 64:
            raise ValueError("OJPEG: truncated quantization table")
        out += _segment(0xDB, bytes([k]) + table)
    for cls, offs in ((0, dc), (1, ac)):
        for k in range(spp):
            counts = data[offs[k]:offs[k] + 16]
            n = sum(counts)
            vals = data[offs[k] + 16:offs[k] + 16 + n]
            if len(counts) != 16 or len(vals) != n:
                raise ValueError("OJPEG: truncated Huffman table")
            out += _segment(0xC4, bytes([cls << 4 | k]) + counts + vals)
    sof = struct.pack(">BHHB", 8, h, w, spp)
    for k in range(spp):
        sof += bytes([k + 1, (hs << 4 | vs) if k == 0 else 0x11, k])
    out += _segment(0xC0, sof)
    restart = (t.get(515) or (0,))[0]
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    out += _segment(0xDA, bytes([spp]) + b"".join(
        bytes([k + 1, k << 4 | k]) for k in range(spp)) + b"\x00\x3f\x00")
    offs, counts = t.get(273, ()), t.get(279, ())
    if not offs or len(counts) < len(offs):
        raise ValueError("OJPEG: no strips")
    for o, n in zip(offs, counts):
        out += data[o:o + n]
    return out + b"\xff\xd9"


# the markers libtiff's own reading of the stream's header takes
# (OJPEGReadHeaderInfoSec): SOI, APPn, COM, DRI, DQT, DHT, SOF0/1/3, SOS
_HEADER_MARKERS = {0xD8, 0xFE, 0xDD, 0xDB, 0xC4, 0xC0, 0xC1, 0xC3} | set(
    range(0xE0, 0xF0))


def _check_markers(j: bytes, s) -> None:
    """libtiff parses the header of the stream at JPEGInterchangeFormat
    itself, up to SOS, and fails where a marker does not follow the last
    segment at once or is one it does not know, and where the frame is
    not 8-bit, narrower or shorter than the image, wider than the strip,
    or of another sample count (OJPEGReadHeaderInfoSecStreamSof)."""
    pos = 2
    while True:
        if pos >= len(j) or j[pos] != 0xFF:
            raise ValueError("OJPEG: missing SOF or SOS marker")
        while pos < len(j) and j[pos] == 0xFF:
            pos += 1
        if pos + 2 >= len(j):
            raise ValueError("OJPEG: truncated JPEG header")
        m = j[pos]
        pos += 1
        if m == 0xDA:
            return
        if m not in _HEADER_MARKERS:
            raise ValueError(f"OJPEG: unknown marker type {m} in JPEG data")
        if m in (0xC0, 0xC1, 0xC3):
            if len(j) < pos + 8:
                raise ValueError("OJPEG: truncated SOF marker")
            bits, fh, fw, nc = struct.unpack(">BHHB", j[pos + 2:pos + 8])
            if bits != 8 or fh < s["h"] or fw < s["w"] or fw > s["w"] or \
                    nc != s["spp"]:
                raise ValueError("OJPEG: the JPEG frame disagrees with the "
                                 "image")
        if m != 0xD8:
            pos += struct.unpack(">H", j[pos:pos + 2])[0]


def _stream(data: bytes, s) -> tuple[bytes, bool]:
    """(the JPEG stream libjpeg reads, whether it is the file's own)."""
    t = s["t"]
    if 513 in t and t[513][0]:
        off = t[513][0]
        n = t[514][0] if 514 in t else len(data) - off
        j = data[off:off + n]
        if j[:2] != b"\xff\xd8":
            raise ValueError("OJPEG: no JPEG stream at JPEGInterchangeFormat")
        _check_markers(j, s)
        return j, True
    return _tables_stream(data, s), False


def decode_ojpeg(data: bytes, s) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of an old-style JPEG TIFF, `s` being
    tiff._setup's reading of it."""
    from fluctus_tpu_torch.scene.jpeg import JpegDataError, decode_jpeg_planes
    from fluctus_tpu_torch.scene import tiff
    t, w, h = s["t"], s["w"], s["h"]
    photo = (t.get(262) or (0,))[0]
    if s["bits"][0] != 8:
        raise ValueError("OJPEG: 8-bit samples only")
    stream, own = _stream(data, s)
    try:
        planes = decode_jpeg_planes(stream)
    except JpegDataError:
        if photo != 6:
            raise
        # libtiff's RGBA reader, PIL's path for YCbCr, ignores a strip that
        # fails to read and converts the buffer it zeroed
        zero = np.zeros((h, w), np.uint8)
        return tiff._to_rgba(tiff.ycbcr_to_rgb_libtiff(
            zero, zero, zero, _ycbcr_tables(t)))
    if photo in (0, 1) and s["spp"] == 1:
        y = planes[0][2]
        if y.shape[0] < h or y.shape[1] < w:
            raise ValueError("OJPEG: the stream is smaller than the image")
        return tiff._to_rgba(np.repeat(y[:h, :w, None], 3, -1))
    if photo != 6:
        raise UnsupportedImage("TIFF: old-style JPEG of photometric "
                               f"{photo} is not decoded by the port")
    if s["spp"] != 3 or len(planes) != 3:
        raise ValueError("OJPEG: libtiff's RGBA reader wants 3 components")
    (h0, v0, y), (h1, v1, cb), (_, _, cr) = planes
    if h0 % h1 or v0 % v1:
        raise ValueError("OJPEG: fractional sampling")
    hs, vs = h0 // h1, v0 // v1
    if y.shape[0] < h or y.shape[1] < w:
        raise ValueError("OJPEG: the stream is smaller than the image")
    yy = np.arange(h)[:, None] // vs
    xx = np.arange(w)[None] // hs
    return tiff._to_rgba(tiff.ycbcr_to_rgb_libtiff(
        y[:h, :w], cb[yy, xx], cr[yy, xx], _ycbcr_tables(t)))


def _ycbcr_tables(t):
    from fluctus_tpu_torch.scene import tiff
    return tiff.ycbcr_tables(tiff._rational(t, 529, (0.299, 0.587, 0.114)),
                             tiff._rational(t, 532, (0, 255, 128, 255, 128,
                                                     255)))
