"""libavif 1.3.0's YUV to RGB step at 8 bits, as PIL 12 calls it
(`avifImageYUVToRGB` with its default automatic chroma upsampling), on
the planes of an AV1 frame.

libavif hands the conversion to libyuv (1909) when libyuv has constants
for the frame's matrix and range: BT.601 (and BT.470BG, and unspecified),
BT.709 and BT.2020 non-constant luminance, full or limited (a 4:0:0 frame
at full range only). libyuv's
fixed-point conversion is copied here with its rounding: the luma scaled
by `(y * 0x0101 * YG) >> 16`, the chroma terms in 6-bit coefficients, one
arithmetic shift by 6 and a clamp. Subsampled chroma is first upsampled
as libyuv's bilinear filter does it (`ScaleRowUp2_Linear` for rows and
for 4:2:2, `ScaleRowUp2_Bilinear`'s 9-3-3-1 kernel between two chroma
rows for 4:2:0, with its edge rules). The other matrices go through
libavif's own float conversion with bilinear chroma (identity and YCgCo
exactly); those libavif refuses give ValueError, as PIL fails on them.
The alpha plane (brought to full range by avif.py where it is coded in
limited range) is un-premultiplied as libavif does for a `prem` file.
"""
from __future__ import annotations

import numpy as np


# libyuv's (YG, YB, UB, UG, VG, VR)
_LIMITED = {
    "601": (18997, -1160, 128, 25, 52, 102),
    "709": (18997, -1160, 128, 14, 34, 115),
    "2020": (19003, -1160, 128, 12, 42, 107),
}
_FULL = {
    "601": (16320, 32, 113, 22, 46, 90),
    "709": (16320, 32, 119, 12, 30, 101),
    "2020": (16320, 32, 120, 11, 37, 94),
}


def _libyuv_constants(mc: int, cp: int, full: bool, mono: bool):
    """libavif's getLibYUVConstants: libyuv's constants for the matrix and
    range, or None where libavif falls back to its own code (as it does
    for every 4:0:0 frame in limited range)."""
    if mono and not full:
        return None
    if mono and mc == 0:
        mc = 6
    key = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}.get(mc)
    if mc == 12:   # chroma-derived: by the primaries
        key = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}.get(cp)
    return None if key is None else (_FULL if full else _LIMITED)[key]


# libavif's avifMatrixCoefficientsTables: (kr, kb); others take BT.601's
_KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
          6: (0.299, 0.114), 7: (0.212, 1 - 0.701 - 0.212),
          9: (0.2627, 0.0593)}


def _up_row(c: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear (Any wrapper) along the last axis."""
    c = c.astype(np.int32)
    out = np.empty(c.shape[:-1] + (width,), np.int32)
    out[..., 0] = c[..., 0]
    work = (width - 1) & ~1
    if work > 0:
        a, b = c[..., :work // 2], c[..., 1:work // 2 + 1]
        out[..., 1:work + 1:2] = (3 * a + b + 2) >> 2
        out[..., 2:work + 1:2] = (a + 3 * b + 2) >> 2
    out[..., width - 1] = c[..., (width - 1) // 2]
    return out


def _up_2rows(s: np.ndarray, t: np.ndarray, width: int):
    """libyuv's ScaleRowUp2_Bilinear (Any wrapper): two chroma rows to
    two output rows."""
    s = s.astype(np.int32)
    t = t.astype(np.int32)
    d = np.empty(width, np.int32)
    e = np.empty(width, np.int32)
    d[0] = (3 * s[0] + t[0] + 2) >> 2
    e[0] = (s[0] + 3 * t[0] + 2) >> 2
    work = (width - 1) & ~1
    if work > 0:
        n = work // 2
        s0, s1, t0, t1 = s[:n], s[1:n + 1], t[:n], t[1:n + 1]
        d[1:work + 1:2] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
        d[2:work + 1:2] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
        e[1:work + 1:2] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
        e[2:work + 1:2] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
    k = (width - 1) // 2
    d[width - 1] = (3 * s[k] + t[k] + 2) >> 2
    e[width - 1] = (s[k] + 3 * t[k] + 2) >> 2
    return d, e


def upsample(c: np.ndarray, width: int, height: int, ss_x: int, ss_y: int):
    """A chroma plane at full size, as libyuv's bilinear filter gives it."""
    if not ss_x and not ss_y:
        return c.astype(np.int32)
    if not ss_y:
        return _up_row(c, width)
    out = np.empty((height, width), np.int32)
    out[0] = _up_row(c[0], width)
    y = 1
    for r in range(0, height - 2, 2):
        out[y], out[y + 1] = _up_2rows(c[r // 2], c[r // 2 + 1], width)
        y += 2
    if not height & 1:
        out[height - 1] = _up_row(c[(height - 1) // 2], width)
    return out


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate as libavif calls it at 8 bits: each channel
    times the 8.8 fixed-point 65536 / alpha of libyuv's table, the channel
    byte doubled into 16 bits and the high word packed back with signed
    saturation as its SIMD code does; opaque pixels pass."""
    a32 = a.astype(np.int64)[..., None]
    inv = np.array([0, 0xffff] + [0x10000 // k for k in range(2, 256)],
                   np.int64)[a32]
    c = rgb.astype(np.int64)
    out = ((c | (c << 8)) * inv) >> 16
    # packed back with signed saturation: words of 32768 and up are < 0
    out = np.where(out >= 32768, 0, np.minimum(255, out))
    return np.where(a32 == 255, c, out).astype(np.uint8)


def _primaries_kr_kb(cp: int):
    """libavif's avifColorPrimariesComputeYCoeffs, in float32."""
    f = np.float32
    rx, ry, gx, gy, bx, by, wx, wy = (f(v) for v in _PRIMARIES.get(
        cp, _PRIMARIES[1]))
    rz, gz, bz, wz = (f(1) - (rx + ry), f(1) - (gx + gy), f(1) - (bx + by),
                      f(1) - (wx + wy))
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                + wz * (rx * gy - gx * ry))) / den
    return kr, kb


# libavif's avifColorPrimariesTables: red, green, blue and white x, y
_PRIMARIES = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    2: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}


def _builtin(frame, mc: int, cp: int, full: bool) -> np.ndarray:
    """libavif's own conversion (its 8-bit fast paths, and the any-format
    path with bilinear chroma for subsampled planes), in float32 as
    libavif computes it."""
    f32 = np.float32
    h, w = frame.height, frame.width
    mode = {0: "identity", 8: "ycgco"}.get(mc, "yuv")
    if mode == "identity" and not frame.mono and (frame.ss_x or frame.ss_y):
        raise ValueError("AVIF: the identity matrix needs 4:4:4")
    if mode == "ycgco" and not full:
        raise ValueError("AVIF: limited-range YCgCo is not converted")
    if mode == "identity" and full and not frame.mono:
        y, u, v = frame.planes
        return np.stack([v, y, u], -1)
    if mc == 12:
        kr, kb = _primaries_kr_kb(cp)
    else:
        kr, kb = (f32(k) for k in _KR_KB.get(mc, (0.299, 0.114)))
    kg = f32(1) - kr - kb
    code = np.arange(256, dtype=f32)
    if full:
        tab_y = (code - f32(0)) / f32(255)
        tab_uv = (code - f32(128)) / f32(255)
    else:
        tab_y = (code - f32(16)) / f32(219)
        tab_uv = (code - f32(128)) / f32(224)
    if mode == "identity":
        tab_uv = tab_y
    yf = tab_y[frame.planes[0]]
    if frame.mono:
        r = g = b = yf
    else:
        uu, vv = frame.planes[1], frame.planes[2]
        if not frame.ss_x and not frame.ss_y:
            cb, cr = tab_uv[uu], tab_uv[vv]
        else:
            cb, cr = _bilinear(tab_uv, uu, w, h, frame), \
                _bilinear(tab_uv, vv, w, h, frame)
        if mode == "identity":
            g, b, r = yf, cb, cr
        elif mode == "ycgco":
            t = yf - cb
            g, b, r = yf + cb, t - cr, t + cr
        else:
            r = yf + (f32(2) * (f32(1) - kr)) * cr
            b = yf + (f32(2) * (f32(1) - kb)) * cb
            g = yf - ((f32(2) * ((kr * (f32(1) - kr) * cr) +
                                 (kb * (f32(1) - kb) * cb))) / kg)
    out = [(f32(0.5) + np.clip(c, f32(0), f32(1)).astype(f32) * f32(255))
           .astype(np.uint8) for c in (r, g, b)]
    return np.stack(out, -1)


def _bilinear(tab, c, w, h, frame):
    """avifImageYUVAnyToRGBAnySlow's chroma: the closest sample and its
    column, row and diagonal neighbours weighted 9, 3, 3, 1 (/16)."""
    f32 = np.float32
    i = np.arange(w)
    j = np.arange(h)
    ci, cj = i >> frame.ss_x, j >> frame.ss_y
    if frame.ss_x:
        adj_c = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), 0,
                         np.where(i % 2 != 0, 1, -1))
    else:
        adj_c = np.zeros(w, np.int64)
    if frame.ss_y:
        adj_r = np.where((j == 0) | ((j == h - 1) & (j % 2 != 0)), 0,
                         np.where(j % 2 != 0, 1, -1))
    else:
        adj_r = np.zeros(h, np.int64)
    r0, c0 = cj[:, None], ci[None, :]
    r1, c1 = (cj + adj_r)[:, None], (ci + adj_c)[None, :]
    return (tab[c[r0, c0]] * f32(9 / 16) + tab[c[r0, c1]] * f32(3 / 16)
            + tab[c[r1, c0]] * f32(3 / 16) + tab[c[r1, c1]] * f32(1 / 16))


def to_rgb(frame, colr, alpha, premultiplied) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a decoded frame; alpha None gives 255. The
    `colr` nclx property, where there is one, sets the matrix, the
    primaries and the range; else the AV1 sequence header does."""
    if colr is not None and colr[0] == "nclx":
        cp, mc, full = colr[1], colr[3], bool(colr[4])
    else:
        cp, mc, full = frame.cp, frame.mc, bool(frame.full_range)
    if mc in (3, 10, 11, 13, 14, 16, 17) or mc > 17:
        raise ValueError(f"AVIF: libavif does not convert matrix {mc}")
    h, w = frame.height, frame.width
    out = np.empty((h, w, 4), np.uint8)
    consts = _libyuv_constants(mc, cp, full, frame.mono)
    if consts is None:
        out[..., :3] = _builtin(frame, mc, cp, full)
    else:
        yg, yb, ub, ug, vg, vr = consts
        y1 = (frame.planes[0].astype(np.int64) * 0x0101 * yg) >> 16
        if frame.mono:
            u = v = np.zeros((h, w), np.int64)
        else:
            u = upsample(frame.planes[1], w, h, frame.ss_x, frame.ss_y)
            v = upsample(frame.planes[2], w, h, frame.ss_x, frame.ss_y)
            u = u.astype(np.int64) - 128
            v = v.astype(np.int64) - 128
        base = y1 + yb
        out[..., 0] = np.clip((base + vr * v) >> 6, 0, 255)
        out[..., 1] = np.clip((base - (ug * u + vg * v)) >> 6, 0, 255)
        out[..., 2] = np.clip((base + ub * u) >> 6, 0, 255)
    if alpha is None:
        out[..., 3] = 255
    else:
        out[..., 3] = alpha
        if premultiplied:
            out[..., :3] = _unpremultiply(out[..., :3], alpha)
    return out
