"""A PNG decoder on zlib + NumPy that gives what PIL's
`Image.open(...).convert("RGBA")` gives, quirks included, since that is
what the JAX package's TexturePool loads.

Every colour type (grey 0, RGB 2, palette 3, grey+alpha 4, RGBA 6), every
bit depth the standard allows for it (1, 2, 4, 8, 16), Adam7 interlace and
all five row filters; tRNS for grey, RGB and palette images. PIL's
mapping to 8 bits, read off its conversions:

- grey at depth 1 is 0 or 255, at depth 2 and 4 the value times 85 or 17;
- 16-bit grey (PIL's "I;16") is clamped to 255, not scaled;
- 16-bit RGB, grey+alpha and RGBA keep the high byte of each sample;
- a tRNS key makes alpha 0 where the 8-bit value equals the key's low byte
  (per channel for RGB); at depth 1 any nonzero key is the value 255;
- a palette index past the PLTE entries is black; alpha comes from tRNS
  where it covers the index, else 255.
Chunk CRCs are checked, as PIL checks them.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth_row(filt: bytes, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(filt))
    up = prior.tolist()
    for i, x in enumerate(filt):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(filt: bytes, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(filt))
    up = prior.tolist()
    for i, x in enumerate(filt):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (x + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: bytes, pos: int, h: int, stride: int, bpp: int):
    """Undo the row filters of h rows of `stride` bytes from raw[pos:].
    bpp is the filter's byte step (at least 1). Returns (rows, end)."""
    img = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[pos]
        filt = raw[pos + 1:pos + 1 + stride]
        if len(filt) != stride:
            raise ValueError("PNG: image data is truncated")
        pos += 1 + stride
        cur = np.frombuffer(filt, np.uint8)
        if ftype == 0:
            row = cur
        elif ftype == 1:   # Sub: running sum along the row, per channel
            pad = (-stride) % bpp
            c = np.concatenate([cur, np.zeros(pad, np.uint8)])
            row = (np.cumsum(c.reshape(-1, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(-1)[:stride]
        elif ftype == 2:   # Up
            row = cur + prior
        elif ftype == 3:
            row = _average_row(filt, prior, bpp)
        elif ftype == 4:
            row = _paeth_row(filt, prior, bpp)
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        img[y] = row
        prior = img[y]
    return img, pos


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Filtered-free rows -> (h, w, ch) integer samples."""
    h = rows.shape[0]
    if depth == 16:
        b = rows[:, :2 * w * ch].reshape(h, w, ch, 2).astype(np.uint16)
        return (b[..., 0] << 8) | b[..., 1]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth]     # ch == 1 here
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return bits.reshape(h, w, depth).dot(weights).astype(np.uint8)[..., None]


def _read_chunks(data: bytes):
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    hdr = None
    plte = trns = None
    idat = []
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG: truncated chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG: bad CRC in {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            return hdr, plte, trns, b"".join(idat)


def decode_png(data: bytes, transparency: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA, top row first. With
    `transparency` False a tRNS chunk is ignored, as in a PNG frame of an
    ICO file (PIL's icon image does not take over the frame's info)."""
    hdr, plte, trns, idat = _read_chunks(data)
    if not transparency:
        trns = None
    if hdr is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] \
            or comp != 0 or filt != 0 or interlace not in (0, 1):
        raise UnsupportedImage(f"PNG: colour type {ctype}, depth {depth}, "
                               f"interlace {interlace} is not a PNG variant")
    if ctype == 3 and plte is None:
        raise ValueError("PNG: palette image without PLTE")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    raw = zlib.decompress(idat)
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, h, (w * ch * depth + 7) // 8, bpp)
        px = _samples(rows, w, ch, depth)
    else:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            rows, pos = _unfilter(raw, pos, ph, (pw * ch * depth + 7) // 8,
                                  bpp)
            px[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    return _to_rgba(px, ctype, depth, plte, trns)


def _to_rgba(px, ctype, depth, plte, trns) -> np.ndarray:
    h, w = px.shape[:2]
    rgba = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        n = len(plte)
        pal = np.zeros((256, 4), np.uint8)
        pal[:n, :3] = plte[:256]
        pal[:, 3] = 255
        if trns:
            a = np.frombuffer(trns[:256], np.uint8)
            pal[:len(a), 3] = a
        return pal[px[..., 0]]
    if depth == 16:
        if ctype == 0:
            v8 = np.minimum(px, 255).astype(np.uint8)      # "I;16" clamps
        else:
            v8 = (px >> 8).astype(np.uint8)                # the high byte
    elif depth < 8:
        v8 = px * {1: 255, 2: 85, 4: 17}[depth]
        v8 = v8.astype(np.uint8)
    else:
        v8 = px.astype(np.uint8)
    if ctype in (0, 4):
        rgba[..., :3] = v8[..., :1]
        if ctype == 4:
            rgba[..., 3] = v8[..., 1]
    else:
        rgba[..., :v8.shape[-1]] = v8
    if trns and ctype == 0 and len(trns) >= 2:
        key = struct.unpack(">H", trns[:2])[0]
        key8 = (255 if key else 0) if depth == 1 else key & 0xFF
        rgba[..., 3] = np.where(v8[..., 0] == key8, 0, 255)
    elif trns and ctype == 2 and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6])) & 0xFF
        rgba[..., 3] = np.where((v8 == key).all(-1), 0, 255)
    return rgba


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
