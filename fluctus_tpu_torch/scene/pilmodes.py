"""PIL's raw rows and its `convert("RGBA")` for the image modes the
simple raster decoders give (xpm.py, xvthumb.py, im.py, imt.py,
spider.py, pixar.py, mcidas.py, ftex.py, gbr.py, fits.py, blp.py).

`rows` reads what PIL's "raw" decoder reads: `h` rows of `row_bytes`
bytes from `offset`, one every `stride` bytes (the last row needs no
padding after it), bottom row first where the tile's orientation is -1;
a file that ends early is damage, as PIL's "image file is truncated".

`to_rgba` copies PIL's conversions to RGBA: "1" as 0 or 255; "I;16",
"I;16B" and "I" clipped to 0..255; "F" clipped and truncated (NaN and
-inf to 0, +inf to 255); "P" and "PA" through a palette; "CMYK" by PIL's
cmyk2rgb (TIFF and PSD convert through it too); "YCbCr" by `ycbcr_to_rgb`.

`ycbcr_to_rgb` is PIL's own YCbCr -> RGB (ConvertYCbCr.c: 6-bit
fixed-point tables, not libjpeg's), which IM's YCC type converts through;
`photoycc_to_rgb` is its unpacker of Kodak PhotoYCC ("YCC;P",
UnpackYCC.c), which Photo CD images go through. Both tables are built
from the formulas below, which give PIL's entry for entry (checked on
all 2^24 inputs).
"""
from __future__ import annotations

import numpy as np


def rows(data: bytes, offset: int, h: int, row_bytes: int,
         stride: int | None = None, bottom_up: bool = False) -> np.ndarray:
    """(h, row_bytes) uint8, top row first."""
    stride = row_bytes if stride is None else stride
    if offset < 0 or h < 0 or row_bytes < 0:
        raise ValueError("raw rows: bad layout")
    need = offset + (h - 1) * stride + row_bytes if h else offset
    if len(data) < need:
        raise ValueError("image file is truncated")
    buf = np.frombuffer(data, np.uint8)
    idx = offset + np.arange(h)[:, None] * stride + np.arange(row_bytes)
    out = buf[idx] if h and row_bytes else np.zeros((h, row_bytes),
                                                    np.uint8)
    return out[::-1] if bottom_up else out


def readline(data: bytes, pos: int) -> tuple[bytes, int]:
    """A file object's readline over `data` from `pos`: the bytes up to
    and with the next LF, or to the end; and the position after them."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.clip(v.astype(np.int64), 0, 255).astype(np.uint8)


def to_rgba(mode: str, px: np.ndarray,
            palette: np.ndarray | None = None) -> np.ndarray:
    """PIL's convert("RGBA") of (h, w) or (h, w, bands) samples in
    `mode`. `palette` is (n, 3) or (n, 4) uint8 for "P" and "PA" (an
    index past it reads black, opaque)."""
    h, w = px.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "1":
        out[..., :3] = np.where(px, 255, 0).astype(np.uint8)[..., None]
    elif mode in ("L", "LA"):
        out[..., :3] = (px[..., :1] if px.ndim == 3 else px[..., None])
        if mode == "LA":
            out[..., 3] = px[..., 1]
    elif mode in ("I;16", "I;16B", "I"):
        out[..., :3] = _clip8(px)[..., None]
    elif mode == "F":
        x = px.astype(np.float32)
        out[..., :3] = np.where(x >= 255, 255, np.where(x > 0, x, 0)) \
            .astype(np.uint8)[..., None]
    elif mode in ("P", "PA"):
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        pal = np.asarray(palette, np.uint8)[:256]
        table[:len(pal), :pal.shape[1]] = pal
        idx = px[..., 0] if px.ndim == 3 else px
        out[:] = table[idx]
        if mode == "PA":
            out[..., 3] = px[..., 1]
    elif mode in ("RGB", "RGBA"):
        out[..., :px.shape[2] if mode == "RGBA" else 3] = \
            px[..., :4 if mode == "RGBA" else 3]
    elif mode == "YCbCr":
        out[..., :3] = ycbcr_to_rgb(px[..., :3])
    elif mode == "CMYK":
        c = px[..., :4].astype(np.int64)
        nk = 255 - c[..., 3:4]
        t = c[..., :3] * nk + 128
        out[..., :3] = np.clip(nk - ((t + (t >> 8)) >> 8), 0, 255)
    else:
        raise ValueError(f"no RGBA conversion for mode {mode}")
    return out


def _table(c: float, centre: int) -> np.ndarray:
    """PIL's fixed-point table: trunc(c * (i - centre) + 0.5) as C
    rounds, the truncation toward zero included."""
    return np.trunc(c * (np.arange(256) - centre) + 0.5).astype(np.int64)


# ConvertYCbCr.c (SCALE 6): R = Y + R_Cr >> 6, G = Y + (G_Cb + G_Cr) >> 6,
# B = Y + B_Cb >> 6
_R_CR = _table(1.40200 * 64, 128)
_G_CB = _table(-0.34414 * 64, 128)
_G_CR = _table(-0.71414 * 64, 128)
_B_CB = _table(1.77200 * 64, 128)
# UnpackYCC.c: R = L + CR, G = L + GB + GR, B = L + CB
_L = _table(1.3584, 0)
_CB = _table(2.2179, 156)
_GB = _table(-0.4303, 156)
_CR = _table(1.8215, 137)
_GR = _table(-0.9271, 137)


def ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 Y, Cb, Cr -> (..., 3) uint8 RGB as PIL converts."""
    y = px[..., 0].astype(np.int64)
    cb, cr = px[..., 1], px[..., 2]
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def photoycc_to_rgb(px: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 PhotoYCC Y, C1, C2 -> (..., 3) uint8 RGB as PIL's
    "YCC;P" unpacker gives."""
    lum = _L[px[..., 0]]
    c1, c2 = px[..., 1], px[..., 2]
    rgb = np.stack([lum + _CR[c2], lum + _GR[c2] + _GB[c1], lum + _CB[c1]],
                   -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
