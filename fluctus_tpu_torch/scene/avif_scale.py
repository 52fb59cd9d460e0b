"""libavif 1.3.0's avifImageScaleWithLimit, which scales a decoded AV1
frame to the size its item (ispe) or track (tkhd) states, with the libyuv
1909 paths it reaches: ScalePlane at 8 bits and ScalePlane_12 deeper, each
plane to its own size with kFilterBox.

libyuv picks row functions by CPU flag. The port follows the x86-64 path
of a CPU with SSSE3 and AVX2, as PIL's libavif takes it there; where that
path gives other values than libyuv's C code, the function says so:
- ScaleFilterCols blends 8-bit samples with 7-bit fractions (the SSSE3
  code, and the C code built for x86; libyuv's ARM C code takes 16 bits);
- the 3/4 and 3/8 box rows average rows with pavgb in blocks of 24 and 6
  outputs, and the C code finishes each row (ScaleRowDown34_*_Box_Any_SSSE3,
  ScaleRowDown38_2_Box_Any_SSSE3);
- ScalePlaneBox adds 8-bit rows into 16 bits saturating in blocks of 32
  columns (vpaddusw) and wrapping in the C code's remainder.
Every other path equals libyuv's C code.
"""
from __future__ import annotations

import numpy as np

NONE, LINEAR, BILINEAR, BOX = 0, 1, 2, 3


def _fixed_div(num: int, div: int) -> int:
    return (num << 16) // div


def _fixed_div1(num: int, div: int) -> int:
    return ((num << 16) - 0x00010001) // (div - 1)


def _center(d: int, s: int) -> int:
    return (d >> 1) + s


def filter_reduce(sw: int, sh: int, dw: int, dh: int, f: int) -> int:
    """ScaleFilterReduce: box becomes bilinear where either axis keeps at
    least half its size, bilinear linear where rows are not scaled (or cut
    to a third, or a single row), and linear none where columns are not."""
    if f == BOX and (dw * 2 >= sw or dh * 2 >= sh):
        f = BILINEAR
    if f == BILINEAR:
        if sh == 1 or dh == sh or dh * 3 == sh:
            f = LINEAR
        if sw == 1:
            f = NONE
    if f == LINEAR and (sw == 1 or dw == sw or dw * 3 == sw):
        f = NONE
    return f


def _slope(sw, sh, dw, dh, f):
    """ScaleSlope: (x, y, dx, dy) in 16.16 fixed point (for sources of
    at most 16384 samples a side, which libavif ensures)."""
    x = y = dx = dy = 0
    if f == BOX:
        return 0, 0, _fixed_div(sw, dw), _fixed_div(sh, dh)
    if f in (BILINEAR, LINEAR):
        if dw <= sw:
            dx = _fixed_div(sw, dw)
            x = _center(dx, -32768)
        elif sw > 1 and dw > 1:
            dx = _fixed_div1(sw, dw)
        if f == LINEAR:
            dy = _fixed_div(sh, dh)
            y = dy >> 1
        elif dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _center(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        return x, y, dx, dy
    dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    return _center(dx, 0), _center(dy, 0), dx, dy


def _interpolate(a, b, frac):
    """InterpolateRow: rows a and b blended by frac/256 (a alone at 0)."""
    frac = np.asarray(frac, np.int64)
    out = (a.astype(np.int64) * (256 - frac) + b.astype(np.int64) * frac
           + 128) >> 8
    return np.where(frac == 0, a, out)


def _filter_cols(rows, x0, dx, dw, deep):
    """ScaleFilterCols over the last axis of `rows` (8 bits: 7-bit
    fractions; deeper: 16-bit, as ScaleFilterCols_16_C)."""
    xs = x0 + np.arange(dw, dtype=np.int64) * dx
    xi = xs >> 16
    n = rows.shape[-1]
    a = rows[..., xi].astype(np.int64)
    b = rows[..., np.minimum(xi + 1, n - 1)].astype(np.int64)
    f = xs & 0xFFFF
    if deep:
        return a + ((f * (b - a) + 0x8000) >> 16)
    return a + (((f >> 9) * (b - a) + 0x40) >> 7)


def _cols(rows, x0, dx, dw):
    """ScaleCols: point sampling."""
    return rows[..., (x0 + np.arange(dw, dtype=np.int64) * dx) >> 16]


def _vertical(src, dh, y, dy, f):
    """ScalePlaneVertical: columns as they are, rows blended."""
    sh = src.shape[0]
    max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
    ys = np.minimum(y + np.arange(dh, dtype=np.int64) * dy, max_y)
    yi = ys >> 16
    frac = ((ys >> 8) & 255) if f else np.zeros_like(ys)
    a = src[yi].astype(np.int64)
    b = src[np.minimum(yi + 1, sh - 1)].astype(np.int64)
    return _interpolate(a, b, frac[:, None])


def _bilinear_up(src, dw, dh, f, deep):
    """ScalePlaneBilinearUp: each source row filtered across, then rows
    blended (a single source row where linear)."""
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    ys = np.minimum(y + np.arange(dh, dtype=np.int64) * dy, max_y)
    yi = ys >> 16
    cols = (_filter_cols(src, x, dx, dw, deep) if f
            else _cols(src, x, dx, dw)).astype(np.int64)
    if f == LINEAR:
        return cols[yi]
    return _interpolate(cols[yi], cols[np.minimum(yi + 1, sh - 1)],
                        ((ys >> 8) & 255)[:, None])


def _bilinear_down(src, dw, dh, f, deep):
    """ScalePlaneBilinearDown: rows blended first, then filtered across."""
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    ys = np.minimum(min(y, max_y) + np.arange(dh, dtype=np.int64) * dy,
                    max_y)
    yi = ys >> 16
    if f == LINEAR:
        rows = src[yi]
    else:
        rows = _interpolate(src[yi].astype(np.int64),
                            src[np.minimum(yi + 1, sh - 1)].astype(np.int64),
                            ((ys >> 8) & 255)[:, None])
    return _filter_cols(rows, x, dx, dw, deep)


def _simple(src, dw, dh):
    """ScalePlaneSimple: point sampling both ways."""
    sh, sw = src.shape
    x, y, dx, dy = _slope(sw, sh, dw, dh, NONE)
    ys = (y + np.arange(dh, dtype=np.int64) * dy) >> 16
    return _cols(src[ys], x, dx, dw)


def _box(src, dw, dh, deep):
    """ScalePlaneBox: each output the mean of its box of rows and columns,
    by 65536 / area in fixed point. 8-bit rows add into 16 bits (see the
    module docstring), deeper ones into 32."""
    sh, sw = src.shape
    _, _, dx, dy = _slope(sw, sh, dw, dh, BOX)
    max_y = sh << 16
    out = np.empty((dh, dw), np.int64)
    s = src.astype(np.int64)
    sat = (sw & ~31) if not deep else 0
    y = 0
    for j in range(dh):
        iy = y >> 16
        y = min(y + dy, max_y)
        bh = max((y >> 16) - iy, 1)
        rows = s[iy:iy + bh]
        if deep:
            row = rows.sum(0)
        else:
            row = np.zeros(sw, np.int64)
            for r in rows:      # saturating columns, then wrapping ones
                row[:sat] = np.minimum(row[:sat] + r[:sat], 65535)
                row[sat:] = (row[sat:] + r[sat:]) & 0xFFFF
        out[j] = _add_cols(row, dw, bh, dx)
    return out


def _add_cols(row, dw, bh, dx):
    """ScaleAddCols2 / ScaleAddCols1 of one summed row."""
    xs = np.arange(dw + 1, dtype=np.int64) * dx
    starts = xs[:-1] >> 16
    if dx & 0xFFFF:
        minw = dx >> 16
        widths = np.maximum((xs[1:] >> 16) - starts, 1)
        tbl = np.array([65536 // (max(minw, 1) * bh),
                        65536 // (max(minw + 1, 1) * bh)], np.int64)
        scale = tbl[widths - minw]
    else:
        widths = np.full(dw, max(dx >> 16, 1), np.int64)
        starts = np.arange(dw, dtype=np.int64) * widths[0]
        scale = 65536 // (widths[0] * bh)
    csum = np.concatenate([[0], np.cumsum(row)])
    sums = csum[starts + widths] - csum[starts]
    return (sums * scale) >> 16


def _down2(src):
    """ScaleRowDown2Box: 2x2 means, rounded."""
    s = src.astype(np.int64)
    return (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
            + 2) >> 2


def _down4(src):
    """ScaleRowDown4Box: 4x4 means, rounded."""
    s = src.astype(np.int64)
    h, w = s.shape
    return (s.reshape(h // 4, 4, w // 4, 4).sum((1, 3)) + 8) >> 4


def _avg(a, b):
    return (a + b + 1) >> 1


def _down34_row(s, t, weight, simd):
    """ScaleRowDown34_0_Box (weight 3: rows 3 : 1) or _1_Box (weight 1:
    1 : 1) over rows s, t, every 4 columns to 3. `simd` outputs (a
    multiple of 24) take the SSSE3 code: rows averaged with pavgb first
    (twice for 3 : 1), then columns (3, 1), (2, 2), (1, 3)."""
    dw = s.shape[0] // 4 * 3
    out = np.empty(dw, np.int64)
    n = simd
    if n:
        v = _avg(s[:n * 4 // 3], t[:n * 4 // 3])
        if weight == 3:
            v = _avg(s[:n * 4 // 3], v)
        q = v.reshape(-1, 4)
        out[:n:3] = (3 * q[:, 0] + q[:, 1] + 2) >> 2
        out[1:n:3] = (q[:, 1] + q[:, 2] + 1) >> 1
        out[2:n:3] = (q[:, 2] + 3 * q[:, 3] + 2) >> 2
    if n < dw:
        qs, qt = s[n * 4 // 3:].reshape(-1, 4), t[n * 4 // 3:].reshape(-1, 4)

        def cols(q):
            return ((3 * q[:, 0] + q[:, 1] + 2) >> 2,
                    (q[:, 1] + q[:, 2] + 1) >> 1,
                    (q[:, 2] + 3 * q[:, 3] + 2) >> 2)
        for k, (a, b) in enumerate(zip(cols(qs), cols(qt))):
            out[n + k::3] = (a * 3 + b + 2) >> 2 if weight == 3 else \
                (a + b + 1) >> 1
    return out


def _down34(src, deep):
    """ScalePlaneDown34 (box): rows in threes from fours, 3 : 1, 1 : 1
    and 1 : 3."""
    s = src.astype(np.int64)
    dh, dw = s.shape[0] // 4 * 3, s.shape[1] // 4 * 3
    simd = 0 if deep else dw - dw % 24
    out = np.empty((dh, dw), np.int64)
    for k in range(dh // 3):
        r = 4 * k
        out[3 * k] = _down34_row(s[r], s[r + 1], 3, simd)
        out[3 * k + 1] = _down34_row(s[r + 1], s[r + 2], 1, simd)
        out[3 * k + 2] = _down34_row(s[r + 3], s[r + 2], 3, simd)
    return out


def _down38(src, deep):
    """ScalePlaneDown38 (box): 8 rows and columns to 3, boxes of 3, 3 and
    2 each way, each sum times 65536 / its area. The 2-row boxes of 8-bit
    planes average their rows with pavgb in blocks of 6 outputs (SSSE3)."""
    s = src.astype(np.int64)
    dh, dw = s.shape[0] // 8 * 3, s.shape[1] // 8 * 3
    simd = 0 if deep else dw - dw % 6
    out = np.empty((dh, dw), np.int64)

    def cols3(rows):      # 3 rows summed
        q = rows.sum(0).reshape(-1, 8)
        return np.stack([q[:, 0:3].sum(1) * (65536 // 9) >> 16,
                         q[:, 3:6].sum(1) * (65536 // 9) >> 16,
                         q[:, 6:8].sum(1) * (65536 // 6) >> 16], 1).ravel()

    def cols2(rows):
        o = np.empty(dw, np.int64)
        if simd:
            q = _avg(rows[0], rows[1])[:simd * 8 // 3].reshape(-1, 8)
            o[:simd] = np.stack([q[:, 0:3].sum(1) * (65536 // 3) >> 16,
                                 q[:, 3:6].sum(1) * (65536 // 3) >> 16,
                                 q[:, 6:8].sum(1) * (65536 // 2) >> 16],
                                1).ravel()
        q = rows.sum(0)[simd * 8 // 3:].reshape(-1, 8)
        o[simd:] = np.stack([q[:, 0:3].sum(1) * (65536 // 6) >> 16,
                             q[:, 3:6].sum(1) * (65536 // 6) >> 16,
                             q[:, 6:8].sum(1) * (65536 // 4) >> 16],
                            1).ravel()
        return o
    for k in range(dh // 3):
        r = 8 * k
        out[3 * k] = cols3(s[r:r + 3])
        out[3 * k + 1] = cols3(s[r + 3:r + 6])
        out[3 * k + 2] = cols2(s[r + 6:r + 8])
    return out


def _up2_row_linear(s, dw):
    """ScaleRowUp2_Linear_Any: the ends copied, between them 3 : 1."""
    out = np.empty(s.shape[:-1] + (dw,), np.int64)
    out[..., 0] = s[..., 0]
    work = (dw - 1) & ~1
    if work > 0:
        a, b = s[..., :work // 2], s[..., 1:work // 2 + 1]
        out[..., 1:work + 1:2] = (3 * a + b + 2) >> 2
        out[..., 2:work + 2:2] = (a + 3 * b + 2) >> 2
    out[..., dw - 1] = s[..., (dw - 1) // 2]
    return out


def _up2_linear(src, dw, dh):
    """ScalePlaneUp2_Linear: columns doubled, rows point-sampled."""
    sh = src.shape[0]
    s = src.astype(np.int64)
    if dh == 1:
        return _up2_row_linear(s[(sh - 1) // 2][None], dw)
    dy = _fixed_div(sh - 1, dh - 1)
    ys = ((1 << 15) - 1 + np.arange(dh, dtype=np.int64) * dy) >> 16
    return _up2_row_linear(s[ys], dw)


def _up2_bilinear(src, dw, dh):
    """ScalePlaneUp2_Bilinear: both axes doubled, 9 : 3 : 3 : 1 inside,
    3 : 1 along the edges."""
    s = src.astype(np.int64)
    sh = s.shape[0]

    def pair(a, b):       # the two output rows between source rows a, b
        out = np.empty((2, dw), np.int64)
        out[0, 0] = (3 * a[0] + b[0] + 2) >> 2
        out[1, 0] = (a[0] + 3 * b[0] + 2) >> 2
        work = (dw - 1) & ~1
        if work > 0:
            n = work // 2
            a0, a1, b0, b1 = a[:n], a[1:n + 1], b[:n], b[1:n + 1]
            out[0, 1:work + 1:2] = (a0 * 9 + a1 * 3 + b0 * 3 + b1 + 8) >> 4
            out[0, 2:work + 2:2] = (a0 * 3 + a1 * 9 + b0 + b1 * 3 + 8) >> 4
            out[1, 1:work + 1:2] = (a0 * 3 + a1 + b0 * 9 + b1 * 3 + 8) >> 4
            out[1, 2:work + 2:2] = (a0 + a1 * 3 + b0 * 3 + b1 * 9 + 8) >> 4
        e = (dw - 1) // 2
        out[0, dw - 1] = (3 * a[e] + b[e] + 2) >> 2
        out[1, dw - 1] = (a[e] + 3 * b[e] + 2) >> 2
        return out
    rows = [pair(s[0], s[0])[0]]
    for k in range(sh - 1):
        rows.extend(pair(s[k], s[k + 1]))
    if not dh & 1:
        rows.append(pair(s[sh - 1], s[sh - 1])[0])
    return np.stack(rows[:dh])


def scale_plane(src: np.ndarray, dw: int, dh: int, depth: int
                ) -> np.ndarray:
    """One plane scaled to dw x dh as libyuv's ScalePlane (8 bits) or
    ScalePlane_12 (10 and 12 bits) with kFilterBox."""
    sh, sw = src.shape
    deep = depth > 8
    # ScalePlane_12 tries its 2x paths first, which no earlier branch of
    # ScalePlane_16 could take: the order below serves both
    f = filter_reduce(sw, sh, dw, dh, BOX)
    if (dw, dh) == (sw, sh):
        out = src.copy()
    elif dw == sw and f != BOX:
        y, dy = 0, 0
        if dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _center(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        out = _vertical(src, dh, y, dy, f)
    elif dw <= sw and dh <= sh and 4 * dw == 3 * sw and 4 * dh == 3 * sh:
        out = _down34(src, deep)
    elif dw <= sw and dh <= sh and 2 * dw == sw and 2 * dh == sh:
        out = _down2(src)
    elif dw <= sw and dh <= sh and 8 * dw == 3 * sw and 8 * dh == 3 * sh:
        out = _down38(src, deep)
    elif dw <= sw and dh <= sh and 4 * dw == sw and 4 * dh == sh and \
            f in (BOX, NONE):
        out = _down4(src)
    elif f == BOX and dh * 2 < sh:
        out = _box(src, dw, dh, deep)
    elif (dw + 1) // 2 == sw and f == LINEAR:
        out = _up2_linear(src, dw, dh)
    elif (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and \
            f in (BILINEAR, BOX):
        out = _up2_bilinear(src, dw, dh)
    elif f and dh > sh:
        out = _bilinear_up(src, dw, dh, f, deep)
    elif f:
        out = _bilinear_down(src, dw, dh, f, deep)
    else:
        out = _simple(src, dw, dh)
    return (out & (0xFF if not deep else 0xFFFF)).astype(src.dtype)


def scale_frame(planes, alpha, width: int, height: int, ss_x: int,
                ss_y: int, depth: int, dw: int, dh: int):
    """avifImageScaleWithLimit of a frame's planes (luma, then chroma if
    any) and of its alpha plane (or None) from width x height to dw x dh:
    each chroma plane to ((dw + ss_x) >> ss_x, (dh + ss_y) >> ss_y).
    Raises ValueError where libavif refuses (a source side over 16384,
    which libyuv's arithmetic could overflow)."""
    if (width, height) == (dw, dh):
        return planes, alpha
    if width > 16384 or height > 16384:
        raise ValueError("AVIF: libavif does not scale a frame over 16384 "
                         "samples a side")
    out = []
    for p, plane in enumerate(planes or ()):
        sx, sy = (ss_x, ss_y) if p else (0, 0)
        out.append(scale_plane(plane, (dw + sx) >> sx, (dh + sy) >> sy,
                               depth))
    if alpha is not None:
        alpha = scale_plane(alpha, dw, dh, depth)
    return (tuple(out) if planes else planes), alpha
