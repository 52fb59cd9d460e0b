"""A PBM/PGM/PPM and PFM decoder in NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's PpmImagePlugin rules).

P1-P6 at any maxval from 1 to 65535, and greyscale PFM (`Pf`). PIL's
mapping, copied: a sample is scaled to round(v / maxval * out) with
Python's round-half-even, out being 255, or 65535 for a grey image whose
maxval passes 255 (PIL's mode I, which its RGBA conversion clamps to 255;
maxval 65535 takes the 16-bit value itself). Bitmaps read 1 as black. A
PFM's floats (little-endian when the scale is negative) are stored bottom
row first; the conversion truncates them into 0..255, NaN to 0. A colour
PFM (`PF`) is no PIL format (the pool leaves it at -1); PIL's own test
formats (P0CMYK, PyP, PyRGBA, PyCMYK) raise UnsupportedImage.
"""
from __future__ import annotations

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage

_WS = b"\x20\x09\x0a\x0b\x0c\x0d"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}


def magic(data: bytes) -> bytes:
    """PIL's magic: up to 6 bytes before the first whitespace."""
    out = b""
    for c in data[:6]:
        if c in _WS:
            break
        out += bytes([c])
    return out


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """PIL's header token at `pos`: leading whitespace and '#' comments
    skipped, then up to 10 bytes to the next whitespace, which is read
    too. Returns (token, position after it)."""
    tok = b""
    while len(tok) <= 10:
        if pos >= len(data):
            break
        c = data[pos]
        pos += 1
        if c in _WS:
            if not tok:
                continue
            break
        if c == 0x23:                     # '#': skip to CR, LF or the end
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        tok += bytes([c])
    if not tok or len(tok) > 10:
        raise ValueError("PNM: bad header token")
    return tok, pos


def _drop_comments(block: bytes) -> bytes:
    """PIL's PpmPlainDecoder._ignore_comments on one block: each '#' to
    the end of its line is cut out, the line end with it."""
    while True:
        start = block.find(b"#")
        if start < 0:
            return block
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        end = min(a, b) if a * b > 0 else max(a, b)
        if end < 0:
            return block[:start]
        block = block[:start] + block[end + 1:]


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """min(out_max, round(v / maxval * out_max)), round half to even."""
    return np.minimum(np.round(v.astype(np.float64) / maxval * out_max),
                      out_max)


def decode_pnm(data: bytes) -> np.ndarray:
    """PNM or PFM bytes -> (H, W, 4) uint8 RGBA, top row first."""
    m = magic(data)
    mode = MODES.get(m)
    if mode is None:
        raise ValueError("not a PNM file")
    if mode not in ("1", "L", "RGB", "F"):
        raise UnsupportedImage(f"PPM: PIL's {m.decode()} test format is not "
                               "decoded by the port")
    pos = len(m) + 1
    tok, pos = _token(data, pos)
    w = int(tok)
    tok, pos = _token(data, pos)
    h = int(tok)
    if w <= 0 or h <= 0:
        raise ValueError("PNM: bad size")
    plain = m in (b"P1", b"P2", b"P3")
    if mode == "F":
        tok, pos = _token(data, pos)
        scale = float(tok)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("PFM: bad scale")
        raw = data[pos:pos + 4 * w * h]
        if len(raw) != 4 * w * h:
            raise ValueError("PFM: truncated data")
        f = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(h, w)
        f = f[::-1]                          # bottom row first
        with np.errstate(invalid="ignore"):
            v = np.where(f >= 255.0, 255.0, np.where(f > 0.0, f, 0.0))
        v = np.nan_to_num(v, nan=0.0).astype(np.uint8)
        return _grey(v)
    maxval = 1
    if mode != "1":
        tok, pos = _token(data, pos)
        maxval = int(tok)
        if not 0 < maxval < 65536:
            raise ValueError("PNM: bad maxval")
    bands = 3 if mode == "RGB" else 1
    n = w * h * bands
    # the grey image of a maxval over 255 is PIL's mode I (to 65535)
    out_max = 65535 if mode == "L" and maxval > 255 else 255
    if mode == "1":
        if plain:
            bits = b"".join(_drop_comments(data[pos:]).split())
            if bits.strip(b"01"):
                raise ValueError("PBM: bad token")
            bits = bits[:w * h]
            if len(bits) != w * h:
                raise ValueError("PBM: truncated data")
            v = np.where(np.frombuffer(bits, np.uint8) == 0x31, 0, 255)
            return _grey(v.reshape(h, w).astype(np.uint8))
        stride = (w + 7) // 8
        raw = data[pos:pos + stride * h]
        if len(raw) != stride * h:
            raise ValueError("PBM: truncated data")
        b = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride),
                          axis=1)[:, :w]
        return _grey(np.where(b == 1, 0, 255).astype(np.uint8))
    if plain:
        toks = _drop_comments(data[pos:]).split()
        if any(len(t) > 10 for t in toks[:n]):
            raise ValueError("PNM: token too long")
        vals = np.asarray([int(t) for t in toks[:n]], np.int64)
        if len(vals) != n:
            raise ValueError("PNM: truncated data")
        if (vals < 0).any() or (vals > maxval).any():
            raise ValueError("PNM: sample out of range")
        v = _scale(vals, maxval, out_max)
    else:
        width = 1 if maxval < 256 else 2
        raw = data[pos:pos + n * width]
        if len(raw) != n * width:
            raise ValueError("PNM: truncated data")
        vals = np.frombuffer(raw, np.uint8 if width == 1 else ">u2")
        if maxval == 255 or (mode == "L" and maxval == 65535):
            v = vals            # PIL's raw decoders: no scaling
        else:
            v = _scale(vals, maxval, out_max)
    v = np.minimum(v, 255).astype(np.uint8)   # mode I clamps to 255
    if bands == 1:
        return _grey(v.reshape(h, w))
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = v.reshape(h, w, 3)
    return rgba


def _grey(v: np.ndarray) -> np.ndarray:
    rgba = np.full(v.shape + (4,), 255, np.uint8)
    rgba[..., :3] = v[..., None]
    return rgba
