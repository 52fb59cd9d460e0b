"""PCX and DCX decoders in NumPy that give what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's PcxImagePlugin and
DcxImagePlugin rules; a DCX file is read as its first frame).

Modes: 1-bit (a set bit white), 2 or 4 one-bit planes with the header's
16-colour palette, 8-bit grey, or 8-bit with the 256-colour palette that
ends the file (marker 12, read from the end of the whole file, as PIL
does for a DCX frame too; a palette that is the grey ramp reads as
grey), and 24-bit as three 8-bit planes. PIL's rules, copied: the row
stride is (width * bits + 7) // 8, made even when the header states
another; rows are RLE-coded (a byte >= 0xC0 repeats the next one
byte & 0x3F times), a run that passes the end of a row is damage; a
row's planes are moved together when the stride between them is longer
than a plane (`_rle_rows`).
"""
from __future__ import annotations

import struct

import numpy as np

DCX_MAGIC = 0x3ADE68B1


def _rle_rows(data: bytes, pos: int, row_bytes: int, n_rows: int,
              width: int, planes: int) -> np.ndarray:
    """PIL's PcxDecode: n_rows rows of row_bytes from the RLE stream at
    `pos`, each compacted as PIL compacts a row: its `planes` bands of
    (width + 7) // 8 bytes for bit planes (planes > 1), else its
    row_bytes // width bands of `width` bytes, moved together when the
    stride between them is longer."""
    if planes > 1:
        band, n_bands = (width + 7) // 8, planes
    else:
        band, n_bands = width, row_bytes // width
    stride = row_bytes // n_bands if n_bands else 0
    out = np.zeros((n_rows, row_bytes), np.uint8)
    row = bytearray(row_bytes)
    x = y = 0
    end = len(data)
    while y < n_rows:
        if pos >= end:
            raise ValueError("PCX: truncated image data")
        b = data[pos]
        if (b & 0xC0) == 0xC0:
            if pos + 1 >= end:
                raise ValueError("PCX: truncated image data")
            n = b & 0x3F
            if x + n > row_bytes:
                raise ValueError("PCX: a run passes the end of a row")
            row[x:x + n] = bytes([data[pos + 1]]) * n
            x += n
            pos += 2
        else:
            row[x] = b
            x += 1
            pos += 1
        if x >= row_bytes:
            if stride > band:
                for i in range(1, n_bands):
                    row[i * band:(i + 1) * band] = \
                        row[i * stride:i * stride + band]
            out[y] = np.frombuffer(bytes(row), np.uint8)
            x = 0
            y += 1
    return out


def _bits(rows: np.ndarray, width: int) -> np.ndarray:
    return np.unpackbits(rows, axis=1)[:, :width]


def decode_pcx(data: bytes, start: int = 0) -> np.ndarray:
    """The PCX image whose 128-byte header starts at `start` -> (H, W, 4)
    uint8 RGBA, top row first."""
    s = data[start:start + 68]
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        raise ValueError("PCX: bad header")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise ValueError("PCX: bad image size")
    version, bits, planes = s[1], s[3], s[65]
    provided = struct.unpack_from("<H", s, 66)[0]
    pal = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "planes"
        pal = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            ent = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (ent == np.arange(256)[:, None]).all():
                mode, pal = "P", ent
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError("PCX: unknown mode")
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    rows = _rle_rows(data, start + 128, planes * stride, h, w,
                     planes if mode == "planes" else 1)
    rgba = np.full((h, w, 4), 255, np.uint8)
    if mode == "1":
        rgba[..., :3] = (_bits(rows, w) * 255)[..., None]
    elif mode == "planes":
        s8 = (w + 7) // 8
        idx = np.zeros((h, w), np.uint8)
        for k in range(planes):
            idx |= _bits(rows[:, k * s8:(k + 1) * s8], w) << k
        rgba[..., :3] = pal[idx]
    elif mode == "L":
        rgba[..., :3] = rows[:, :w, None]
    elif mode == "P":
        rgba[..., :3] = pal[rows[:, :w]]
    else:
        for c in range(3):
            rgba[..., c] = rows[:, c * w:(c + 1) * w]
    return rgba


def decode_dcx(data: bytes) -> np.ndarray:
    """A DCX file's first frame (PIL's DcxImageFile after open)."""
    if len(data) < 8 or struct.unpack_from("<I", data)[0] != DCX_MAGIC:
        raise ValueError("DCX: bad header")
    first = struct.unpack_from("<I", data, 4)[0]
    if not first:
        raise ValueError("DCX: no frames")
    return decode_pcx(data, first)
