"""libavif 1.3.0's YUV to 8-bit RGB step, as PIL 12 calls it
(`avifImageYUVToRGB` with its default automatic chroma upsampling), on
the planes of an AV1 frame at 8, 10 or 12 bits.

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
limited range) is un-premultiplied as libavif does for a `prem` file:
libyuv's ARGBUnattenuate after libyuv's conversion and libavif's fast
paths, a float division inside libavif's bilinear (slow) path.

Deeper frames take the routes libavif 1.3.0 takes for them, found by
calling its `avifImageYUVToRGB` through ctypes on every depth, subsampling,
range, matrix and alpha case (tests/test_torch_avif_deep.py does so):
- colour with libyuv constants and no alpha: every plane cut to its top 8
  bits (libyuv's Convert16To8Plane), then the 8-bit route;
- with alpha at 10 bits: libyuv's 10-bit rows (I410/I210/I010 with alpha,
  the luma's top bits repeated below it, `(y << 6) | (y >> 4)`, the
  chroma upsampled at 10 bits then cut to 8) and the alpha cut to 8 bits;
  at 12 bits 4:2:0, libyuv's 12-bit rows with the nearest chroma sample
  and libavif's rounded alpha; at 12 bits otherwise the 8-bit route on
  the cut planes, alpha cut too;
- grey with alpha and libyuv constants (in either range, as at 8 bits):
  the cut luma through libyuv's constants of the matrix, chroma at its
  centre, and libavif's rounded alpha;
- everything else, grey without alpha among it: libavif's float path with
  tables over every code of the depth, the alpha rounded.
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


def _libyuv_constants(mc: int, cp: int, full: bool, mono: bool,
                      any_range: bool = False):
    """libavif's getLibYUVConstants: libyuv's constants for the matrix and
    range, or None where libavif falls back to its own code (as it does
    for every 4:0:0 frame in limited range, unless `any_range`)."""
    if mono and not full and not any_range:
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


def _builtin(frame, mc: int, cp: int, full: bool,
             prem=None) -> np.ndarray:
    """libavif's own conversion (its fast paths, and the any-format path
    with bilinear chroma for subsampled planes), in float32 as libavif
    computes it, over tables of every code of the frame's depth. For a
    premultiplied image, `prem` is (alpha at the frame's depth, its 8-bit
    values): the fast paths leave the un-premultiplying to libyuv's
    ARGBUnattenuate afterwards, the bilinear path divides in float."""
    f32 = np.float32
    h, w, d = frame.height, frame.width, frame.bitdepth
    mode = {0: "identity", 8: "ycgco"}.get(mc, "yuv")
    if mode == "identity" and not frame.mono and (frame.ss_x or frame.ss_y):
        raise ValueError("AVIF: the identity matrix needs 4:4:4")
    if mode == "ycgco" and not full:
        raise ValueError("AVIF: limited-range YCgCo is not converted")
    if mode == "identity" and full and not frame.mono and d == 8:
        y, u, v = frame.planes
        out = np.stack([v, y, u], -1)
        return _unpremultiply(out, prem[1]) if prem else out
    if mc == 12:
        kr, kb = _primaries_kr_kb(cp)
    else:
        kr, kb = (f32(k) for k in _KR_KB.get(mc, (0.299, 0.114)))
    kg = f32(1) - kr - kb
    code = np.arange(1 << d, dtype=f32)
    top, s = f32((1 << d) - 1), 1 << (d - 8)
    if full:
        tab_y = (code - f32(0)) / top
        tab_uv = (code - f32(1 << (d - 1))) / top
    else:
        tab_y = (code - f32(16 * s)) / f32(219 * s)
        tab_uv = (code - f32(1 << (d - 1))) / f32(224 * s)
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
    fast = mode == "yuv" and (frame.mono or not (frame.ss_x or frame.ss_y))
    if prem and not fast:
        a = prem[0].astype(f32) / top
        r, g, b = (np.where(a > 0, np.minimum(np.clip(c, f32(0), f32(1)) /
                                              np.where(a > 0, a, f32(1)),
                                              f32(1)), f32(0))
                   for c in (r, g, b))
    out = np.stack([(f32(0.5) + np.clip(c, f32(0), f32(1)).astype(f32)
                     * f32(255)).astype(np.uint8) for c in (r, g, b)], -1)
    return _unpremultiply(out, prem[1]) if prem and fast else out


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


def _yuv_rgb(y1, u, v, consts) -> np.ndarray:
    """libyuv's fixed-point YUV to RGB of one picture: `y1` the luma term
    (`(y32 * YG) >> 16`), `u` and `v` the 8-bit chroma less 128."""
    yg, yb, ub, ug, vg, vr = consts
    base = y1 + yb
    out = np.empty(y1.shape + (3,), np.uint8)
    out[..., 0] = np.clip((base + vr * v) >> 6, 0, 255)
    out[..., 1] = np.clip((base - (ug * u + vg * v)) >> 6, 0, 255)
    out[..., 2] = np.clip((base + ub * u) >> 6, 0, 255)
    return out


def _cut(plane: np.ndarray, depth: int) -> np.ndarray:
    """libyuv's Convert16To8Plane as libavif calls it (scale 1 << (24 -
    depth)): a sample's top 8 bits."""
    return np.minimum(255, plane.astype(np.int64) >> (depth - 8))


def _libyuv8(frame, planes, consts) -> np.ndarray:
    """libyuv's 8-bit route on 8-bit planes (grey: chroma at its centre)."""
    h, w = frame.height, frame.width
    y1 = (planes[0].astype(np.int64) * 0x0101 * consts[0]) >> 16
    if frame.mono:
        u = v = np.zeros((h, w), np.int64)
    else:
        u = upsample(planes[1], w, h, frame.ss_x, frame.ss_y)
        v = upsample(planes[2], w, h, frame.ss_x, frame.ss_y)
        u = u.astype(np.int64) - 128
        v = v.astype(np.int64) - 128
    return _yuv_rgb(y1, u, v, consts)


def _nearest(c, w, h, ss_x, ss_y):
    return c[(np.arange(h) >> ss_y)[:, None], (np.arange(w) >> ss_x)[None, :]]


def _libyuv16(frame, consts, bilinear: bool) -> np.ndarray:
    """libyuv's 10- and 12-bit rows (YuvPixel10/12): the luma's top bits
    repeated below it, the chroma upsampled at its depth (bilinear, or the
    nearest sample) and cut to 8 bits."""
    d, h, w = frame.bitdepth, frame.height, frame.width
    y = frame.planes[0].astype(np.int64)
    y1 = (((y << (16 - d)) | (y >> (2 * d - 16))) * consts[0]) >> 16
    up = upsample if bilinear else _nearest
    u, v = (np.minimum(255, up(c, w, h, frame.ss_x, frame.ss_y)
                       .astype(np.int64) >> (d - 8)) - 128
            for c in frame.planes[1:])
    return _yuv_rgb(y1, u, v, consts)


def _rounded_alpha(alpha: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifReformatAlpha to 8 bits, in float."""
    f32 = np.float32
    return (f32(0.5) + (alpha.astype(f32) / f32((1 << depth) - 1))
            * f32(255)).astype(np.uint8)


def to_rgb(frame, colr, alpha, premultiplied) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a decoded frame; `alpha` (full range, at
    the frame's depth) None gives 255. The `colr` nclx property, where
    there is one, sets the matrix, the primaries and the range; else the
    AV1 sequence header does."""
    if colr is not None and colr[0] == "nclx":
        cp, mc, full = colr[1], colr[3], bool(colr[4])
    else:
        cp, mc, full = frame.cp, frame.mc, bool(frame.full_range)
    if mc in (3, 10, 11, 13, 14, 16, 17) or mc > 17:
        raise ValueError(f"AVIF: libavif does not convert matrix {mc}")
    h, w, d = frame.height, frame.width, frame.bitdepth
    out = np.empty((h, w, 4), np.uint8)
    has_a = alpha is not None
    a8 = None
    rgb = None
    if d == 8:
        a8 = alpha
        consts = _libyuv_constants(mc, cp, full, frame.mono, any_range=has_a)
        if consts is not None:
            rgb = _libyuv8(frame, frame.planes, consts)
    elif frame.mono:
        consts = _libyuv_constants(mc, cp, full, True, any_range=True) \
            if has_a else None
        if consts is not None:
            rgb = _libyuv8(frame, (_cut(frame.planes[0], d),), consts)
            a8 = _rounded_alpha(alpha, d)
    else:
        consts = _libyuv_constants(mc, cp, full, False)
        if consts is not None:
            if not has_a or (d == 12 and not (frame.ss_x and frame.ss_y)):
                rgb = _libyuv8(frame, [_cut(p, d) for p in frame.planes],
                               consts)
                a8 = _cut(alpha, d).astype(np.uint8) if has_a else None
            else:
                rgb = _libyuv16(frame, consts, bilinear=d == 10)
                a8 = _cut(alpha, d).astype(np.uint8) if d == 10 else \
                    _rounded_alpha(alpha, d)
    if rgb is None:       # libavif's own code
        if has_a and d > 8:
            a8 = _rounded_alpha(alpha, d)
        out[..., :3] = _builtin(frame, mc, cp, full,
                                (alpha, a8) if premultiplied and has_a
                                else None)
    elif premultiplied and has_a:
        out[..., :3] = _unpremultiply(rgb, a8)
    else:
        out[..., :3] = rgb
    out[..., 3] = 255 if a8 is None else a8
    return out
