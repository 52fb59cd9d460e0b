"""AVIF at 10 and 12 bits and AVIF grid images: the port (scene/avif.py,
scene/avif_rgb.py over native/av1.cpp) against dav1d 1.5.1 and PIL 12.1.0
(libavif 1.3.0), both called in the libavif that Pillow's wheel ships.

PIL's aom writes 8 bits only, so deeper files are 8-bit files whose
sequence header, av1C and pixi say 10 or 12 bits
(tests/data/avif/make_avif_data.py's `deepen`; AV1's tile syntax differs
between depths only in palette colours). Each is held three ways: the
port's planes against dav1d's at its C-only CPU mask and at full SIMD,
the port's RGBA against PIL's, and the JAX package's texture pool against
the port's. libavif's YUV to RGB step is held on its own, on seeded
planes of every depth, subsampling, range and matrix, with and without
alpha and premultiplication, through its `avifImageYUVToRGB`. Grids are
written through libavif's avifEncoderAddImageGrid (1xN, Nx1, 2x2, with an
alpha grid, at 10 and 12 bits) and then changed where libavif refuses
them (cells too small, odd sizes under 4:2:0, cells that differ, an
output the cells do not cover)."""
import ctypes
import os
import sys

import numpy as np
import pytest
from PIL import Image

from fluctus_tpu_torch.scene import avif, avif_rgb

from test_torch_avif import (DATA, _both_pools, _libavif, avif_bytes,
                             dav1d_planes, picture, pil_rgba, port_rgba,
                             pytestmark)  # noqa: F401

sys.path.insert(0, DATA)
import make_avif_data as mk  # noqa: E402

MASKS = (0, 0xffffffff)        # dav1d's C code, and every SIMD level


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _streams(data):
    """The AV1 streams of the colour item (a grid's cells) and of the
    alpha item."""
    color, _, alpha, *_ = avif.parse(data)
    out = []
    for s in (color, alpha):
        if isinstance(s, avif.Grid):
            out += [c for c, _ in s.cells]
        elif s is not None:
            out.append(s)
    return out


def _assert_planes(data):
    lib = _libavif()
    try:
        for obus in _streams(data):
            got = avif.decode_av1(obus).planes
            for mask in MASKS:
                lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(mask))
                want = dav1d_planes(obus)
                assert want is not None and len(want) == len(got)
                for a, b in zip(want, got):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(b, a, err_msg=str(mask))
    finally:
        lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(0xffffffff))


def _assert_same(data):
    want = pil_rgba(data)
    assert not isinstance(want, int)
    got = avif.decode_avif(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# committed 8-bit files, each a subsampling, range or tool: at 10 and 12
SOURCES = ("deblocking.avif", "cdef.avif", "restoration.avif",
           "film_grain.avif", "all_422.avif", "all_grey.avif",
           "grey_limited.avif", "alpha_prem.avif", "kitchen_floor_n.avif",
           "filters_on.avif", "kitchen_floor_n_filtered.avif")


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", SOURCES)
def test_deep_files_equal_dav1d_and_pil(name, depth):
    """Deblocking, CDEF, loop restoration and film grain alone and
    together, 4:2:0, 4:2:2, 4:4:4 (profile 1 at 10 bits, 2 at 12) and
    grey, both ranges, alpha premultiplied: planes at dav1d's C and SIMD
    levels, and PIL's RGBA."""
    data = mk.deepen(_read(name), depth)
    for obus in _streams(data):
        frame = avif.decode_av1(obus)
        assert frame.bitdepth == depth and frame.planes[0].dtype == np.uint16
    _assert_planes(data)
    _assert_same(data)


def _corpus():
    cases = {}
    for ss in ("4:4:4", "4:2:2", "4:2:0", "L"):
        for rng in ("full", "limited"):
            cases[f"{ss} {rng}"] = (ss, rng)
    return cases


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("case", list(_corpus()))
def test_deep_corpus(case, depth):
    """PIL's defaults (deblocking) at each subsampling and range, and
    with alpha for the colour ones, at 10 and 12 bits."""
    ss, rng = _corpus()[case]
    img = picture(37, 51, 3, 1 if ss == "L" else 4)
    kw = dict(quality=60, range=rng)
    if ss != "L":
        kw["subsampling"] = ss
    data = mk.deepen(avif_bytes(img, **kw), depth)
    _assert_planes(data)
    _assert_same(data)


def test_deep_palettes_fail_as_pil():
    """Screen content (palette, intra block copy): a palette read at
    another depth misreads the tile, so dav1d fails, and so do PIL and
    the port."""
    for depth in (10, 12):
        data = mk.deepen(_read("screen.avif"), depth)
        assert pil_rgba(data) == -1 and port_rgba(data) == -1


@pytest.mark.parametrize("name", ["kitchen_floor_10.avif",
                                  "kitchen_wood_12.avif",
                                  "kitchen_floor_n_grid10.avif"])
def test_deep_kitchen_in_both_pools(tmp_path, name):
    """The committed deep and grid kitchen maps: the JAX package's pool
    and the port's hold the same rows."""
    jax, port = _both_pools(tmp_path, _read(name))
    assert not isinstance(jax, int) and not isinstance(port, (int, str))
    np.testing.assert_array_equal(port, jax)
    _assert_planes(_read(name))


# ------------------------------------------------------------ YUV to RGB

_FMT = {(0, 0, 0): 1, (1, 0, 0): 2, (1, 1, 0): 3, (1, 1, 1): 4}


def libavif_rgb(planes, depth, ss, full, mc, alpha=None, prem=False):
    """PIL's call: avifImageYUVToRGB into 8-bit RGB(A), on planes set in
    an avifImage (libavif 1.3.0's layout: range at byte 16, planes at
    24, row bytes at 48, alpha at 64 and 72, premultiplied at 80, CICP at
    104); the libavif result code where it fails."""
    lib = _libavif()
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 4
    for f, args in (("avifImageAllocatePlanes", [vp, ctypes.c_int]),
                    ("avifRGBImageSetDefaults", [vp, vp]),
                    ("avifRGBImageAllocatePixels", [vp]),
                    ("avifRGBImageFreePixels", [vp]),
                    ("avifImageYUVToRGB", [vp, vp]),
                    ("avifImageDestroy", [vp])):
        getattr(lib, f).argtypes = args
    h, w = planes[0].shape
    img = lib.avifImageCreate(w, h, depth, _FMT[ss])
    try:
        assert lib.avifImageAllocatePlanes(img, 3 if alpha is not None
                                           else 1) == 0
        raw = ctypes.string_at(img, 88)
        ptrs = np.frombuffer(raw[24:48], np.uint64)
        rows = np.frombuffer(raw[48:60], np.uint32)
        dt = np.uint8 if depth == 8 else np.uint16
        pairs = [(int(ptrs[p]), int(rows[p]), pl) for p, pl in
                 enumerate(planes)]
        if alpha is not None:
            pairs.append((int(np.frombuffer(raw[64:72], np.uint64)[0]),
                          int(np.frombuffer(raw[72:76], np.uint32)[0]),
                          alpha))
            ctypes.memmove(img + 80, (ctypes.c_int * 1)(int(prem)), 4)
        for ptr, stride, pl in pairs:
            a = np.ascontiguousarray(pl.astype(dt))
            for r in range(a.shape[0]):
                ctypes.memmove(ptr + r * stride, a[r].ctypes.data,
                               a.shape[1] * a.itemsize)
        ctypes.memmove(img + 16, (ctypes.c_int * 1)(int(full)), 4)
        ctypes.memmove(img + 104, (ctypes.c_uint16 * 3)(1, 2, mc), 6)
        rgb = ctypes.create_string_buffer(128)
        lib.avifRGBImageSetDefaults(rgb, img)
        c = 4 if alpha is not None else 3
        ctypes.memmove(ctypes.addressof(rgb) + 8,
                       (ctypes.c_int * 2)(8, int(c == 4)), 8)
        assert lib.avifRGBImageAllocatePixels(rgb) == 0
        rc = lib.avifImageYUVToRGB(img, rgb)
        if rc:
            return rc
        pix = int(np.frombuffer(rgb.raw[48:56], np.uint64)[0])
        stride = int(np.frombuffer(rgb.raw[56:60], np.uint32)[0])
        out = np.frombuffer(ctypes.string_at(pix, stride * h), np.uint8)
        out = out.reshape(h, stride)[:, :w * c].reshape(h, w, c).copy()
        lib.avifRGBImageFreePixels(rgb)
        return out
    finally:
        lib.avifImageDestroy(img)


class _Frame:
    pass


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_yuv_to_rgb_follows_libavif(depth):
    """Seeded planes at each subsampling (and grey), range and matrix
    (libyuv's BT.601, BT.709, BT.2020 and the chroma-derived one, and
    libavif's own identity, YCgCo and FCC), without alpha, with alpha and
    premultiplied, at two sizes: the port's RGBA equals libavif's, and
    both fail together."""
    g = np.random.default_rng(depth)
    top, bad = (1 << depth) - 1, []
    for h, w in ((23, 31), (8, 9)):
        for ss in _FMT:
            for full in (1, 0):
                for mc in (6, 1, 9, 2, 5, 12, 0, 8, 4):
                    for al in (0, 1, 2):
                        f = _Frame()
                        f.width, f.height, f.bitdepth = w, h, depth
                        f.ss_x, f.ss_y, f.mono = ss
                        ch, cw = (h + ss[1]) >> ss[1], (w + ss[0]) >> ss[0]
                        dt = np.uint8 if depth == 8 else np.uint16
                        f.planes = [g.integers(0, top + 1, (h, w))] + (
                            [] if f.mono else
                            [g.integers(0, top + 1, (ch, cw)),
                             g.integers(0, top + 1, (ch, cw))])
                        f.planes = tuple(p.astype(dt) for p in f.planes)
                        a = None
                        if al:
                            a = g.integers(0, top + 1, (h, w)).astype(dt)
                            a[:3], a[3:5] = top, 0
                        want = libavif_rgb(f.planes, depth, ss, full, mc,
                                           a, al == 2)
                        try:
                            got = avif_rgb.to_rgb(f, ("nclx", 1, 2, mc, full),
                                                  a, al == 2)
                        except ValueError:
                            got = -1
                        if isinstance(want, int) or isinstance(got, int):
                            ok = isinstance(want, int) and \
                                isinstance(got, int)
                        else:
                            got = got if al else got[..., :3]
                            ok = np.array_equal(got, want)
                        if not ok:
                            bad.append((h, ss, full, mc, al))
    assert not bad, bad


# ------------------------------------------------------------ grids

def _agree(tmp_path, data):
    """PIL's RGBA and the port's, and the rows of both pools: the same,
    or -1 in all four."""
    want, got = pil_rgba(data), port_rgba(data)
    jax, port = _both_pools(tmp_path, data)
    if isinstance(want, int):
        assert got == -1 and jax == -1 and port == -1, port
        return None
    assert not isinstance(got, (int, str)), got
    np.testing.assert_array_equal(got, want)
    assert not isinstance(port, (int, str)), port
    np.testing.assert_array_equal(port, jax)
    return want


def _grid(seed, h, w, cols, rows, channels=3, **kw):
    a = mk._pattern(np.random.default_rng(seed), h, w, channels)
    return mk.grid_avif(mk.grid_cells(a, cols, rows), cols, rows, **kw)


def _colr_709(data, drop=()):
    """The file with its colr property's matrix set to BT.709 (the
    sequence headers keep 2, read as BT.601), and that property's
    association taken from the items in `drop` (ipma version 0)."""
    d = bytearray(mk.rewrite(data, prop=lambda t, p: p[:8] + b"\0\1" + p[10:]
                             if t == b"colr" else p))
    colr = [t for t, _ in mk._boxes(dict(mk._boxes(dict(mk._boxes(
        dict(mk._boxes(bytes(d)))[b"meta"], 4))[b"iprp"]))[b"ipco"])]
    k = colr.index(b"colr") + 1
    pos = d.find(b"ipma") + 8
    n, pos = int.from_bytes(d[pos:pos + 4], "big"), pos + 4
    for _ in range(n):
        iid, c = int.from_bytes(d[pos:pos + 2], "big"), d[pos + 2]
        for j in range(pos + 3, pos + 3 + c):
            if iid in drop and d[j] & 0x7F == k:
                d[j] &= 0x80
        pos += 3 + c
    return bytes(d)


@pytest.mark.parametrize("case", ["1x3", "3x1", "2x2", "2x2 alpha",
                                  "2x2 4:4:4", "2x2 4:2:2 limited",
                                  "2x2 10-bit", "2x2 12-bit alpha",
                                  "cropped 120x100", "4:4:4 cropped odd",
                                  "colr of the grid item",
                                  "no colr on the grid item"])
def test_grids_equal_pil(tmp_path, case):
    """Grids libavif writes decode to PIL's RGBA in both pools, the cells
    joined in dimg order and the output cropped from them; the colour
    description is the grid item's colr (the cells' is not read), or
    the cells' sequence header where the grid item has none."""
    if case == "1x3":
        data = _grid(1, 64, 192, 3, 1)
    elif case == "3x1":
        data = _grid(2, 192, 64, 1, 3)
    elif case == "2x2":
        data = _grid(3, 128, 128, 2, 2)
    elif case == "2x2 alpha":
        data = _grid(4, 128, 128, 2, 2, 4)
    elif case == "2x2 4:4:4":
        data = _grid(5, 128, 128, 2, 2, subsampling="4:4:4")
    elif case == "2x2 4:2:2 limited":
        data = _grid(6, 128, 128, 2, 2, subsampling="4:2:2", full=False)
    elif case == "2x2 10-bit":
        data = mk.deepen(_grid(7, 128, 128, 2, 2, speed=4), 10)
    elif case == "2x2 12-bit alpha":
        data = mk.deepen(_grid(8, 128, 128, 2, 2, 4), 12)
    elif case == "cropped 120x100":
        data = mk.regrid(_grid(9, 128, 128, 2, 2), size=(120, 100),
                         ispe={(128, 128): (120, 100)})
    elif case == "4:4:4 cropped odd":
        data = mk.regrid(_grid(10, 128, 128, 2, 2, subsampling="4:4:4"),
                         size=(127, 99), ispe={(128, 128): (127, 99)})
    elif case == "colr of the grid item":
        data = _colr_709(_grid(15, 128, 128, 2, 2), drop=(2, 3, 4, 5))
        assert avif.parse(data)[1][3] == 1
    else:
        data = _colr_709(_grid(16, 128, 128, 2, 2), drop=(1,))
        assert avif.parse(data)[1] is None
    assert isinstance(avif.parse(data)[0], avif.Grid)
    assert _agree(tmp_path, data) is not None


def _small_cells(seed):
    a = mk._pattern(np.random.default_rng(seed), 64, 64, 3)
    return {k: mk.obus_of(avif_bytes(Image.fromarray(c), quality=75))
            for k, c in enumerate(mk.grid_cells(a, 2, 2))}


def _cells_and_props(data):
    """(dimg cell ids, ipco property types) of a grid file."""
    meta = dict(mk._boxes(dict(mk._boxes(data))[b"meta"], 4))
    types = [t for t, _ in mk._boxes(dict(mk._boxes(meta[b"iprp"]))[
        b"ipco"])]
    dimg = []
    for typ, b in mk._boxes(meta[b"iref"], 4):
        if typ == b"dimg":
            dimg = [mk._u(b, 4 + 2 * k, 2) for k in range(mk._u(b, 2, 2))]
    return dimg, types


@pytest.mark.parametrize("case", ["cells 32x32", "odd width 4:2:0",
                                  "odd height 4:2:0", "not covered",
                                  "last column outside", "range differs",
                                  "ispe differs from output",
                                  "descriptor version 1",
                                  "descriptor with a trailing byte",
                                  "a cell missing", "pixi against av1C",
                                  "a cell of another size",
                                  "odd cells 4:2:0"])
def test_grids_libavif_refuses_are_minus_one(tmp_path, case):
    """Grids libavif refuses (cells under 64x64, odd sizes where 4:2:0
    subsamples, cells that do not cover the output or reach past it,
    cells that differ in range, an ispe other than the output size, a
    descriptor of another version or length, fewer dimg cells than the
    grid has, pixi depths other than the cells' av1C, a cell of another
    size stated by its own ispe, 65-pixel-wide cells under 4:2:0): -1 in
    PIL and in both pools."""
    base = _grid(11, 128, 128, 2, 2)
    big = {(128, 128)}
    if case == "cells 32x32":
        data = mk.regrid(base, size=(64, 64), cells=_small_cells(12),
                         ispe={(128, 128): (64, 64), (64, 64): (32, 32)})
    elif case == "odd width 4:2:0":
        data = mk.regrid(base, size=(127, 128), ispe={(128, 128): (127, 128)})
    elif case == "odd height 4:2:0":
        data = mk.regrid(base, size=(128, 121), ispe={(128, 128): (128, 121)})
    elif case == "not covered":
        data = mk.regrid(base, size=(130, 128), ispe={(128, 128): (130, 128)})
    elif case == "last column outside":
        data = mk.regrid(base, size=(64, 128), ispe={(128, 128): (64, 128)})
    elif case == "range differs":
        a = mk._pattern(np.random.default_rng(13), 64, 64, 3)
        data = mk.regrid(base, cells={3: mk.obus_of(avif_bytes(
            Image.fromarray(a), quality=75, range="limited"))})
    elif case == "ispe differs from output":
        data = mk.regrid(base, size=(120, 100))
    elif case == "a cell of another size":
        dimg, types = _cells_and_props(base)
        old, new = types.index(b"ispe", 1) + 1, len(types) + 1
        a = mk._pattern(np.random.default_rng(17), 48, 64, 3)
        cell = mk.obus_of(avif_bytes(Image.fromarray(a), quality=75))
        data = mk.rewrite(
            base, lambda iid, typ, b: cell if iid == dimg[3] else b,
            new_props=[(b"ispe", bytes(4) + (64).to_bytes(4, "big")
                        + (48).to_bytes(4, "big"))],
            assoc=lambda iid, props: props if iid != dimg[3] else
            [new if p & 0x7F == old else p for p in props])
    elif case == "odd cells 4:2:0":
        a = mk._pattern(np.random.default_rng(18), 128, 130, 3)
        cells = {k: mk.obus_of(avif_bytes(Image.fromarray(c), quality=75))
                 for k, c in enumerate(mk.grid_cells(a, 2, 2))}
        data = mk.regrid(base, size=(130, 128), cells=cells,
                         ispe={(128, 128): (130, 128), (64, 64): (65, 64)})
    elif case == "pixi against av1C":
        data = mk.rewrite(base, prop=lambda t, p: p[:5] + bytes([10] * p[4])
                          if t == b"pixi" else p)
    else:
        def item(iid, typ, b):
            if typ != b"grid":
                return b
            if case == "descriptor version 1":
                return b"\1" + b[1:]
            if case == "descriptor with a trailing byte":
                return b + b"\0"
            return b[:2] + bytes([b[2], 2]) + b[4:]     # 2 x 3 cells
        data = mk.rewrite(base, item)
        big = None
    assert big is None or isinstance(avif.parse(base)[0], avif.Grid)
    assert _agree(tmp_path, data) is None


def test_grid_iovl_and_tmap_still_raise():
    """Other derived items keep raising, naming themselves."""
    base = _grid(14, 128, 128, 2, 2)
    i = base.find(b"infe")
    j = base.find(b"grid", i)
    for kind in (b"iovl", b"tmap"):
        data = base[:j] + kind + base[j + 4:]
        with pytest.raises(avif.UnsupportedImage, match=kind.decode()):
            avif.decode_avif(data)
