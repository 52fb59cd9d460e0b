"""CIELAB to sRGB as PIL converts its "LAB" mode: PIL 12 builds a
LittleCMS transform from the built-in D50 Lab (v2) profile to the
built-in sRGB profile, 8 bits in and out, perceptual intent, no flags.
LittleCMS then samples the whole float pipeline (Lab to D50 XYZ, the
inverse of sRGB's Bradford-adapted colorant matrix, the inverse of the
sRGB curve) into a 33 x 33 x 33 table of 16-bit nodes and evaluates an
8-bit pixel by its fixed-point tetrahedral interpolation. This module
recomputes those nodes with the same arithmetic (float32 between the
stages, float64 inside them, its round-to-word rule) and interpolates as
LittleCMS does, so its bytes equal PIL's (every one of the 2^24 inputs
was held against PIL 12.1.0 when this was written).

Input is the "memory" form of PIL's LAB bytes: L, and a and b with 128
added (PIL's TIFF reader XORs its signed a and b with 128 on the way in;
its PSD reader stores them as they are, already offset).
"""
from __future__ import annotations

import numpy as np

GRID = 33                          # LittleCMS's grid for 3-channel input
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # XYZ's 1.15 encoding limit
_table = None


def _inv3(a):
    """LittleCMS's _cmsMAT3inverse (cofactors over the determinant)."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _ev(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
            for i in range(3)]


def _srgb_to_xyz():
    """The built-in sRGB profile's colorants: Rec. 709 primaries and the
    D65 white, adapted to D50 with Bradford (cmsCreate_sRGBProfile)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _ev(_inv3([[xr, xg, xb], [yr, yg, yb],
                      [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
               [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
         [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)]]
    brad = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
            [0.0389, -0.0685, 1.0296]]
    src = _ev(brad, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _ev(brad, list(_D50))
    cone = [[dst[0] / src[0], 0, 0], [0, dst[1] / src[1], 0],
            [0, 0, dst[2] / src[2]]]
    return _mul(_mul(_inv3(brad), _mul(cone, brad)), m)


def _word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: round half up, clamped to 0..65535."""
    return np.clip(np.floor(d + 0.5), 0, 65535).astype(np.int64)


def table() -> np.ndarray:
    """The (33, 33, 33, 3) 16-bit nodes, indexed by the L, a, b nodes."""
    global _table
    if _table is not None:
        return _table
    q = _word(np.arange(GRID) * 65535.0 / (GRID - 1)).astype(np.float64)
    lq, aq, bq = np.meshgrid(q, q, q, indexing="ij")
    f32 = [(x / 65535.0).astype(np.float32).astype(np.float64)
           for x in (lq, aq, bq)]
    fy = (f32[0] * 100.0 + 16.0) / 116.0
    fx = fy + 0.002 * (f32[1] * 255.0 - 128.0)
    fz = fy - 0.005 * (f32[2] * 255.0 - 128.0)

    def f_1(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0)
                        * (t - 16.0 / 116.0), t * t * t)
    xyz = [(f_1(t) * w / _MAX_XYZ).astype(np.float32).astype(np.float64)
           for t, w in zip((fx, fy, fz), _D50)]
    inv = np.asarray(_inv3(_srgb_to_xyz())) * _MAX_XYZ
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    disc = (a * d + b) ** g
    out = []
    for i in range(3):
        r = xyz[0] * inv[i, 0]
        r = r + xyz[1] * inv[i, 1]
        r = (r + xyz[2] * inv[i, 2]).astype(np.float32).astype(np.float64)
        v = np.where(r >= disc, (np.power(np.maximum(r, 0.0), 1.0 / g) - b)
                     / a, r / c)
        out.append(_word(v.astype(np.float32).astype(np.float64) * 65535.0))
    _table = np.stack(out, -1)
    return _table


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 LAB in PIL's memory form -> (..., 3) uint8 sRGB:
    LittleCMS's TetrahedralInterp16 on the 16-bit inputs v * 257, then
    its 16-to-8 rounding."""
    flat = table().reshape(-1)
    v = lab.astype(np.int64) * 257
    dom = GRID - 1
    f = [w * dom + ((w * dom + 0x7fff) // 0xffff) for w in
         (v[..., 0], v[..., 1], v[..., 2])]
    rx, ry, rz = (x & 0xffff for x in f)
    o = (3 * GRID * GRID, 3 * GRID, 3)
    base = sum((x >> 16) * s for x, s in zip(f, o))
    step = [np.where(v[..., k] == 0xffff, 0, o[k]) for k in range(3)]
    sx, sy, sz = step
    # per ordering of the fractions: the tetrahedron's three nodes past
    # the base, and the differences TetrahedralInterp16 weighs by rx, ry,
    # rz (indices into (c0, c1, c2, c3))
    cases = [((rx >= ry) & (ry >= rz), (sx, sx + sy, sx + sy + sz),
              ((1, 0), (2, 1), (3, 2))),
             ((rx >= ry) & (ry < rz) & (rz >= rx),
              (sx + sz, sx + sy + sz, sz), ((1, 3), (2, 1), (3, 0))),
             ((rx >= ry) & (ry < rz) & (rz < rx),
              (sx, sx + sy + sz, sx + sz), ((1, 0), (2, 3), (3, 1))),
             ((rx < ry) & (rx >= rz), (sx + sy, sy, sx + sy + sz),
              ((1, 2), (2, 0), (3, 1))),
             ((rx < ry) & (rx < rz) & (ry >= rz),
              (sx + sy + sz, sy, sy + sz), ((1, 3), (2, 0), (3, 2))),
             ((rx < ry) & (rx < rz) & (ry < rz),
              (sx + sy + sz, sy + sz, sz), ((1, 2), (2, 3), (3, 0)))]
    out = np.zeros(lab.shape, np.int64)
    for ch in range(3):
        c = [flat[base + ch]]
        for mask, nodes, diffs in cases:
            c[1:] = [flat[base + p + ch] for p in nodes]
            d = [c[hi] - c[lo] for hi, lo in diffs]
            rest = d[0] * rx + d[1] * ry + d[2] * rz + 0x8001
            out[..., ch] = np.where(mask, c[0] + ((rest + (rest >> 16))
                                                  >> 16), out[..., ch])
    return (((out * 65281 + 8388608) >> 24) & 0xFF).astype(np.uint8)
