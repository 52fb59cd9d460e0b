"""AVIF that libavif scales to its stated size, AV1 superres and first
pictures shown by show_existing_frame: the port (scene/avif.py,
scene/avif_scale.py, native/av1.cpp) against dav1d 1.5.1 and PIL 12.1.0
(libavif 1.3.0), both called in the libavif that Pillow's wheel ships.

libavif scales a decoded frame whose size differs from its item's ispe
(or its track's tkhd) with libyuv 1909 (avifImageScaleWithLimit, box
filter): the port's scaler is held against the exported `avifImageScale`
on seeded planes at every depth and subsampling, with and without alpha,
at ratios that reach each of libyuv's paths. The aom in Pillow's libavif
writes neither superres nor hidden frames, so those files are written by
rewriting the headers of frames PIL encodes
(tests/data/avif/make_avif_data.py's `rewrite_key`: the frame coded at
the downscaled width, superres set in the sequence and frame headers; a
key or intra-only frame made hidden and a frame header OBU with
show_existing_frame appended). Each is held three ways: the
port's planes against dav1d's (C code and full SIMD), its RGBA against
PIL's, and the JAX package's texture pool against the port's. A first
shown inter frame still raises UnsupportedImage naming itself."""
import ctypes
import os
import sys

import numpy as np
import pytest
from PIL import Image

from fluctus_tpu_torch.scene import avif, avif_scale

from test_torch_avif import (DATA, RECORD, _agrees, _both_pools, _fuzzed,
                             _libavif, avif_bytes, dav1d_planes, pil_rgba,
                             port_rgba, pytestmark)  # noqa: F401

sys.path.insert(0, DATA)
import make_avif_data as mk  # noqa: E402

MASKS = (0, 0xffffffff)        # dav1d's C code, and every SIMD level
NEW_FILES = ("kitchen_wood_scaled.avif", "kitchen_floor_superres.avif",
             "kitchen_floor_n_hidden.avif", "alpha_scaled.avif",
             "grid_scaled.avif", "superres_12.avif",
             "hidden_intra_grain.avif", "hidden_sequence.avif")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _streams(data):
    """The AV1 streams of the colour item (a grid's cells) and of the
    alpha item, or the first samples of their tracks."""
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
                    np.testing.assert_array_equal(b, a, err_msg=str(mask))
    finally:
        lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(0xffffffff))


def _assert_pil(tmp_path, data):
    """PIL's RGBA, the port's and both pools' rows agree."""
    want = pil_rgba(data)
    assert not isinstance(want, int), "PIL could not read the file"
    got = avif.decode_avif(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    jax, port = _both_pools(tmp_path, data)
    assert not isinstance(port, (int, str)), port
    np.testing.assert_array_equal(port, jax)


# ------------------------------------------------------------ committed files

@pytest.mark.parametrize("name", NEW_FILES)
def test_committed_files_equal_pil(tmp_path, name):
    """Each new committed file (a map coded smaller and restated, a
    superres map, a hidden key frame shown by show_existing_frame, scaled
    alpha, scaled grid cells, 12-bit superres with restoration, a hidden
    intra-only frame with film grain, a track's hidden key frame with
    frame ids and a restated track size): its SHA-256 is the recorded
    one, and the port's planes, RGBA and pool rows are dav1d's, PIL's and
    the JAX pool's."""
    import hashlib
    data = _read(name)
    rec = RECORD["files"][name]
    got = avif.decode_avif(data)
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"]
    _assert_planes(data)
    _assert_pil(tmp_path, data)


# ------------------------------------------------------------ the scaler

_FMT = {"4:4:4": (0, 0, 0, 1), "4:2:2": (1, 0, 0, 2), "4:2:0": (1, 1, 0, 3),
        "4:0:0": (1, 1, 1, 4)}


def libavif_scale(planes, alpha, depth, fmt, dw, dh):
    """avifImageScale on planes set in an avifImage (libavif 1.3.0's
    layout: planes at 24, row bytes at 48, alpha at 64 and 72): the scaled
    planes (alpha last), or the libavif result code where it fails."""
    lib = _libavif()
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 4
    lib.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
    lib.avifImageScale.argtypes = [vp, ctypes.c_uint32, ctypes.c_uint32, vp]
    lib.avifImageDestroy.argtypes = [vp]
    sx, sy, _, code = _FMT[fmt]
    h, w = planes[0].shape
    dt = np.uint8 if depth == 8 else np.uint16
    img = lib.avifImageCreate(w, h, depth, code)

    def where(raw):
        ptrs = np.frombuffer(raw[24:48], np.uint64)
        rows = np.frombuffer(raw[48:60], np.uint32)
        out = [(int(ptrs[p]), int(rows[p])) for p in range(len(planes))]
        if alpha is not None:
            out.append((int(np.frombuffer(raw[64:72], np.uint64)[0]),
                        int(np.frombuffer(raw[72:76], np.uint32)[0])))
        return out
    try:
        assert lib.avifImageAllocatePlanes(
            img, 3 if alpha is not None else 1) == 0
        src = list(planes) + ([alpha] if alpha is not None else [])
        for (ptr, stride), pl in zip(where(ctypes.string_at(img, 88)), src):
            a = np.ascontiguousarray(pl.astype(dt))
            for r in range(a.shape[0]):
                ctypes.memmove(ptr + r * stride, a[r].ctypes.data,
                               a.shape[1] * a.itemsize)
        diag = ctypes.create_string_buffer(512)
        rc = lib.avifImageScale(img, dw, dh, diag)
        if rc:
            return rc
        out = []
        for k, (ptr, stride) in enumerate(where(ctypes.string_at(img, 88))):
            chroma = 0 < k < len(planes)
            pw = (dw + sx) >> sx if chroma else dw
            ph = (dh + sy) >> sy if chroma else dh
            raw = ctypes.string_at(ptr, stride * ph)
            out.append(np.frombuffer(raw, dt).reshape(
                ph, stride // np.dtype(dt).itemsize)[:, :pw].copy())
        return out
    finally:
        lib.avifImageDestroy(img)


# (source w, h) -> (stated w, h): each reaches a path of libyuv's for the
# luma and, at its own size, another for subsampled chroma
RATIOS = [((40, 30), (52, 47)),        # up: bilinear, rows after columns
          ((53, 37), (33, 29)),        # down: bilinear, rows first
          ((32, 24), (64, 48)),        # 2x: ScalePlaneUp2_Bilinear
          ((31, 23), (61, 45)),        # 2x less one
          ((32, 24), (64, 24)),        # 2x across only: ScalePlaneUp2_Linear
          ((96, 48), (72, 36)),        # 3/4 (SIMD blocks of 24 and the rest)
          ((64, 48), (48, 36)),        # 3/4
          ((96, 64), (36, 24)),        # 3/8
          ((64, 48), (16, 12)),        # 1/4
          ((64, 48), (32, 24)),        # 1/2
          ((70, 66), (20, 21)),        # box: under 1/2 both ways
          ((50, 40), (50, 29)),        # rows only: ScalePlaneVertical
          ((50, 40), (50, 90)),        # rows only, up
          ((45, 40), (31, 40)),        # columns only (linear)
          ((45, 42), (15, 14)),        # a third: reduced to point sampling
          ((1, 20), (7, 3)),           # one column: point sampling
          ((20, 1), (5, 9)),           # one row
          ((9, 9), (1, 1))]


@pytest.mark.parametrize("fmt", list(_FMT))
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_scaler_follows_libavif(depth, fmt):
    """Seeded planes (luma, chroma at its subsampled size, and alpha on
    every other case) scaled to each stated size of RATIOS: the port's
    planes equal avifImageScale's, at 8 bits through libyuv's ScalePlane
    and deeper through ScalePlane_12. At 8 bits a bright 600-row plane
    boxed to 2 rows also checks the row sums' saturation."""
    g = np.random.default_rng(depth * 10 + len(fmt))
    sx, sy, mono, _ = _FMT[fmt]
    top = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16
    cases = list(RATIOS)
    if depth == 8:
        cases.append(((70, 600), (3, 2)))
    bad = []
    for k, ((w, h), (dw, dh)) in enumerate(cases):
        lo = 200 if h == 600 else 0
        planes = [g.integers(lo, top + 1, (h, w))]
        if not mono:
            ch, cw = (h + sy) >> sy, (w + sx) >> sx
            planes += [g.integers(0, top + 1, (ch, cw)) for _ in range(2)]
        planes = tuple(p.astype(dt) for p in planes)
        alpha = g.integers(0, top + 1, (h, w)).astype(dt) if k % 2 else None
        want = libavif_scale(planes, alpha, depth, fmt, dw, dh)
        got, a = avif_scale.scale_frame(planes, alpha, w, h, sx, sy, depth,
                                        dw, dh)
        got = list(got) + ([a] if alpha is not None else [])
        if isinstance(want, int) or len(want) != len(got) or not all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(want, got)):
            bad.append(((w, h), (dw, dh)))
    assert not bad, bad


def test_scaler_refuses_as_libavif():
    """libavif refuses to scale a frame wider or taller than 16384; the
    port raises ValueError there (PIL's -1)."""
    planes = (np.zeros((2, 16385), np.uint8),)
    assert isinstance(libavif_scale(planes, None, 8, "4:0:0", 8, 2), int)
    with pytest.raises(ValueError):
        avif_scale.scale_frame(planes, None, 16385, 2, 1, 1, 8, 8, 2)


# ------------------------------------------------------------ superres

def _superres_file(restoration: bool, denom: int, ss: str = "4:2:0",
                   **kw):
    """A pattern PIL encodes at 97 x 65 (loop restoration on at speed 4,
    or PIL's defaults, which deblock), rewritten as superres upscaled by
    denom / 8 (with rewrite_key's other arguments `kw`)."""
    a = mk._pattern(np.random.default_rng(denom), 65, 97, 3)
    enc = dict(quality=60, subsampling=ss)
    if restoration:
        enc.update(speed=4, advanced={"loopfilter-control": "0",
                                      "enable-cdef": "0"})
    data = avif_bytes(Image.fromarray(a), **enc)
    return mk.reframe(data, denom=denom, up_w=mk.superres_width(97, denom),
                      **kw)


@pytest.mark.parametrize("restoration", [True, False])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_superres_equals_dav1d_and_pil(tmp_path, depth, restoration):
    """Superres at denominators 9, 12 and 16 (and 4:4:4 and 4:2:2 at 13):
    the frame is coded at its downscaled width, deblocked and filtered
    with CDEF there, upscaled with the specification's 8-tap filter, then
    restored in upscaled loop-restoration units, at 8, 10 and 12 bits."""
    for denom, ss in ((9, "4:2:0"), (12, "4:2:0"), (16, "4:2:0"),
                      (13, "4:4:4"), (13, "4:2:2")):
        data = _superres_file(restoration, denom, ss)
        if depth > 8:
            data = mk.deepen(data, depth)
        frame = avif.decode_av1(_streams(data)[0])
        assert frame.tools & avif.TOOLS["superres"]
        assert frame.width == mk.superres_width(97, denom)
        assert bool(frame.tools & avif.TOOLS["loop restoration"]) == \
            restoration
        _assert_planes(data)
        _assert_pil(tmp_path, data)


# ------------------------------------------------------------ show_existing

def _track(**kw):
    seq = _read("sequence.avif")
    return mk.retrack(seq, mk.rewrite_key(mk.first_sample(seq), **kw))


SHOW_EXISTING = {
    "key frame": lambda: mk.reframe(_read("deblocking.avif"), show=False,
                                    refresh=0x01, show_slot=0),
    "key frame, frame ids": lambda: mk.reframe(
        _read("cdef.avif"), show=False, refresh=0x44, show_slot=6,
        ids=(3, 7), frame_id=101),
    "intra-only frame": lambda: mk.reframe(
        _read("restoration.avif"), frame_type=2, show=False, refresh=0x80,
        show_slot=7),
    "key frame, film grain, 10-bit": lambda: mk.deepen(mk.reframe(
        _read("film_grain.avif"), show=False, refresh=0x10, show_slot=4),
        10),
    "intra-only frame, film grain, 4:2:2": lambda: mk.reframe(
        _read("all_422.avif"), frame_type=2, show=False, refresh=0x03,
        show_slot=1),
    "key frame, superres": lambda: _superres_file(
        True, 12, show=False, refresh=0x01, show_slot=0),
    "track, key frame": lambda: _track(show=False, refresh=0x20,
                                       show_slot=5),
    "track, intra-only frame, frame ids": lambda: _track(
        frame_type=2, show=False, refresh=0x01, show_slot=0, ids=(4, 12),
        frame_id=4000),
}


@pytest.mark.parametrize("case", list(SHOW_EXISTING))
def test_show_existing_equals_dav1d_and_pil(tmp_path, case):
    """A key or intra-only frame made hidden (showable, refreshing some
    slots), then a frame header whose show_existing_frame shows one of
    them: the first picture is that frame, filtered, with the film grain
    of its own header, in a still item and as a track's first sample."""
    data = SHOW_EXISTING[case]()
    _assert_planes(data)
    _assert_pil(tmp_path, data)


@pytest.mark.parametrize("case", ["empty slot", "another frame id",
                                  "hidden, never shown"])
def test_show_existing_failures_are_minus_one(tmp_path, case):
    """dav1d fails show_existing_frame of a slot no frame refreshed, or
    whose frame id differs from the header's; a stream whose only frame
    stays hidden gives no picture: -1 in PIL and in both pools."""
    src = _read("deblocking.avif")
    if case == "empty slot":
        data = mk.reframe(src, show=False, refresh=0x01, show_slot=1)
    elif case == "another frame id":
        data = mk.reframe(src, show=False, refresh=0x01, ids=(3, 7),
                          frame_id=5, show_slot=0)
        i = data.rfind(bytes([3 << 3 | 2, 2]))     # the appended header
        d = bytearray(data)
        d[i + 2] ^= 0x08                            # its frame id's top bit
        data = bytes(d)
    else:
        data = mk.reframe(src, show=False, refresh=0x01)
    assert pil_rgba(data) == -1 and port_rgba(data) == -1
    assert _both_pools(tmp_path, data) == [-1, -1]


def test_first_shown_inter_frame_raises_naming_itself():
    """A track whose first sample is a hidden key frame and the second
    sample's inter frame: PIL reads it, and the port, which lacks AV1's
    inter prediction, raises naming it."""
    seq = _read("sequence.avif")
    first = mk.first_sample(seq)
    sizes = mk._find_box(seq, mk._STBL + (b"stsz",))
    second = seq[seq.find(first) + len(first):][:mk._u(seq, sizes + 24, 4)]
    inter = b"".join(mk._obu(h, p) for h, t, p in mk._obus(second)
                     if t != 2)
    data = mk.retrack(seq, mk.rewrite_key(first, show=False, refresh=0xFF)
                      + inter)
    assert not isinstance(pil_rgba(data), int)
    with pytest.raises(avif.UnsupportedImage, match="inter frames"):
        avif.decode_avif(data)


# ------------------------------------------------------------ stated sizes

@pytest.mark.parametrize("size", [(24, 20), (36, 30), (64, 40), (17, 61),
                                  (96, 80)])
def test_stated_sizes_scale_colour_and_alpha(tmp_path, size):
    """alpha_prem.avif (48x40, premultiplied alpha) with its colour and
    alpha items stated at another size: libavif scales both, each plane to
    its own size."""
    data = mk.restate(_read("alpha_prem.avif"), {(48, 40): size})
    _assert_pil(tmp_path, data)


def test_limited_range_alpha_is_widened_before_it_is_scaled(tmp_path):
    """An alpha coded in limited range (a damaged file) and stated at
    another size: libavif brings it to full range, then scales it."""
    data = _fuzzed(125, "alpha_prem.avif", 7)
    assert not avif.decode_av1(avif.parse(data)[2]).full_range
    for size in ((36, 30), (71, 59)):
        _assert_pil(tmp_path, mk.restate(data, {(48, 40): size}))


@pytest.mark.parametrize("size", [(36, 20), (60, 48), (40, 24)])
def test_stated_track_sizes_scale(tmp_path, size):
    """A track whose tkhd states another size than its frames' (40x24):
    libavif scales the first sample's frame to it."""
    data = mk.retrack(_read("sequence.avif"), size=size)
    _assert_pil(tmp_path, data)


@pytest.mark.parametrize("ispe, output, cells", [
    ((192, 192), (192, 192), (96, 96)),       # cells scaled down
    ((256, 256), (256, 256), (130, 140)),     # cells scaled up
    ((160, 160), (256, 256), None),           # ispe under the output
    ((256, 250), (256, 256), None),
    ((300, 300), (256, 256), None),           # fewer pixels than stated
])
def test_grid_sizes_follow_libavif_and_pil(tmp_path, ispe, output, cells):
    """A grid (2x2 cells of 128x128) whose cells are stated at another
    size are scaled before they are joined; a grid item's ispe that
    differs from its output size sizes PIL's image, which reads libavif's
    pixels row after row (-1 where they are too few)."""
    sizes = {(256, 256): ispe}
    if cells is not None:
        sizes[(128, 128)] = cells
    data = mk.restate(_read("kitchen_floor_n_grid10.avif"), sizes)
    if output != ispe:
        data = mk.regrid(data, size=output)
    want = pil_rgba(data)
    if ispe == (300, 300):
        assert want == -1 and port_rgba(data) == -1
        return
    _assert_pil(tmp_path, data)


# ------------------------------------------------------------ damage

@pytest.mark.parametrize("name", NEW_FILES)
def test_damaged_new_files_agree_with_pil(tmp_path, name):
    """Seeded damage to each new file (test_torch_avif.py's four kinds),
    through both pools: PIL's pixels or -1, and no refusal but a first
    shown inter frame."""
    data = _read(name)
    mdat = data.find(b"mdat") + 4
    g = np.random.default_rng(2021)
    bad = []
    for t in range(24):
        d = bytearray(data)
        mode = t % 4
        if mode == 0:
            d[int(g.integers(0, mdat))] ^= 1 << int(g.integers(0, 8))
        elif mode == 1:
            for _ in range(1 + int(g.integers(0, 2))):
                d[int(g.integers(mdat, len(d)))] ^= 1 << int(g.integers(0, 8))
        elif mode == 2:
            d = d[:int(g.integers(1, len(d)))]
        else:
            d[int(g.integers(mdat, mdat + 40))] = int(g.integers(0, 256))
        if not _agrees(*_both_pools(tmp_path, bytes(d))):
            bad.append((t, mode))
    assert not bad, f"cases {bad} differ from PIL"


def test_damaged_hidden_frame_follows_dav1d_c():
    """A damaged hidden key frame (the new files' fuzz, seed 54) whose
    dequantised coefficients overflow the inverse transform: the first
    picture, shown by show_existing_frame, equals dav1d's C and SSE2
    planes (ROADMAP.md, Queue 3: PIL's pixels there depend on the CPU)."""
    obus = avif.parse(_fuzzed(54, "kitchen_floor_n_hidden.avif", 7,
                              NEW_FILES))[0]
    got = avif.decode_av1(obus).planes
    lib = _libavif()
    try:
        for mask in (0, 1):
            lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(mask))
            want = dav1d_planes(obus)
            assert want is not None and all(
                np.array_equal(a, b) for a, b in zip(want, got)), mask
    finally:
        lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(0xffffffff))
