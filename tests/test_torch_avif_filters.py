"""AVIF frames whose AV1 reconstruction needs the in-loop filters
(deblocking, CDEF, loop restoration) or film grain: the port's planes
(scene/native/av1.cpp) against those of dav1d 1.5.1 (through ctypes in
the libavif Pillow's wheel ships, tests/test_torch_avif.py::dav1d_planes)
at max abs diff 0, both at dav1d's C code (CPU mask 0) and at its full
SIMD, and the port's RGBA against PIL's `Image.open(...).convert("RGBA")`
byte for byte, on files PIL writes here with aom 3.12.1.

aom turns each tool on or off per frame: `loopfilter-control` 0 keeps
deblocking off, `enable-cdef` 1 asks for CDEF, speed 4 adds loop
restoration and `film-grain-test` picks one of aom's grain test vectors.
Each case also holds the tools the port reads in the frame header
(avif.Frame.tools) to the ones it names, so a case cannot pass without
running its filter. Sizes cut CDEF's 8x8 blocks and 64x64 units, loop
restoration's units and its 64-row stripes (33x47, 70x130, 257x65)."""
import ctypes

import numpy as np
import pytest

import test_torch_avif as A
from fluctus_tpu_torch.scene import avif

pytestmark = A.pytestmark

MASKS = {"C": 0, "SIMD": 0xffffffff}   # dav1d_set_cpu_flags_mask


def _tools(*names) -> int:
    return sum(avif.TOOLS[n] for n in names)


def assert_equal_dav1d_and_pil(data: bytes, tools: int):
    """The port's planes equal dav1d's at both CPU masks, its frame turns
    on exactly `tools`, and its RGBA equals PIL's."""
    obus = avif.parse(data)[0]
    frame = avif.decode_av1(obus)
    assert frame.tools == tools, (frame.tools, tools)
    lib = A._libavif()
    try:
        for name, mask in MASKS.items():
            lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(mask))
            want = A.dav1d_planes(obus)
            assert want is not None and len(want) == len(frame.planes)
            for k, (a, b) in enumerate(zip(want, frame.planes)):
                diff = int(np.abs(a.astype(np.int32) - b).max())
                assert diff == 0, f"plane {k} differs from dav1d's {name} " \
                    f"code by up to {diff}"
    finally:
        lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(0xffffffff))
    want = A.pil_rgba(data)
    assert not isinstance(want, int), "PIL could not read the file"
    np.testing.assert_array_equal(avif.decode_avif(data), want)


def encode(h, w, seed, ss, **kw) -> bytes:
    img = A.picture(h, w, seed)
    if ss == "L":
        return A.avif_bytes(img.convert("L"), **kw)
    return A.avif_bytes(img, subsampling=ss, **kw)


SUBSAMPLINGS = ("4:2:0", "4:4:4", "4:2:2", "L")
SIZES = ((33, 47), (70, 130), (257, 65))
# tool: (aom's options, speed, the tools the frames turn on)
TOOL_CASES = {
    "deblocking": ({"enable-cdef": "0", "enable-restoration": "0"}, 6,
                   _tools("deblocking")),
    "CDEF": ({"loopfilter-control": "0", "enable-cdef": "1",
              "enable-restoration": "0"}, 6, _tools("CDEF")),
    "loop restoration": ({"loopfilter-control": "0", "enable-cdef": "0"}, 4,
                         _tools("loop restoration")),
    "all": ({"enable-cdef": "1"}, 4,
            _tools("deblocking", "CDEF", "loop restoration")),
}
# where aom, asked for every tool, leaves one off in the frame
ALL_BUT = {("4:2:0", (257, 65)): "deblocking",
           ("L", (33, 47)): "loop restoration",
           ("L", (257, 65)): "deblocking"}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ss", SUBSAMPLINGS)
@pytest.mark.parametrize("tool", list(TOOL_CASES))
def test_each_tool_and_all_equal_dav1d(tool, ss, size):
    """Each in-loop filter alone, and all three asked for together, at
    every subsampling and at sizes that cut its blocks, units and
    stripes (quality 50, a seeded picture of gradients, edges and
    noise)."""
    advanced, speed, tools = TOOL_CASES[tool]
    if tool == "all" and (ss, size) in ALL_BUT:
        tools -= avif.TOOLS[ALL_BUT[ss, size]]
    data = encode(*size, sum(size), ss, quality=50, speed=speed,
                  advanced=advanced)
    assert_equal_dav1d_and_pil(data, tools)


@pytest.mark.parametrize("quality", (30, 60, 75))
@pytest.mark.parametrize("sharpness", (0, 3, 7))
def test_deblocking_sharpness_and_quality(sharpness, quality):
    """PIL's default encode (deblocking) at loop filter sharpness 0, 3
    and 7 (aom writes its `sharpness` option into the frame header) and
    at qualities 30, 60 and 75, whose filter levels differ."""
    data = encode(64, 80, sharpness + quality, "4:2:0", quality=quality,
                  advanced={"sharpness": str(sharpness)})
    assert_equal_dav1d_and_pil(data, _tools("deblocking"))


@pytest.mark.parametrize("vector", range(1, 17))
def test_film_grain_vectors(vector):
    """aom's sixteen film grain test vectors (grain from luma and per
    chroma plane, auto-regressive lags 0-3, overlap, clipping to the
    restricted range) on a 4:2:0 frame of three 32-row grain stripes,
    with PIL's default deblocking: libavif has dav1d apply the grain."""
    data = encode(70, 130, vector, "4:2:0", quality=50,
                  advanced={"film-grain-test": str(vector)})
    frame = avif.decode_av1(avif.parse(data)[0])
    tools = _tools("film grain") | (frame.tools & _tools("deblocking"))
    assert_equal_dav1d_and_pil(data, tools)


@pytest.mark.parametrize("ss", SUBSAMPLINGS)
@pytest.mark.parametrize("grain", ["test vector 2", "denoiser"])
def test_film_grain_subsampling(grain, ss):
    """Film grain at every subsampling with every in-loop filter asked
    for: a test vector, and the grain aom's denoiser estimates (which it
    does not do at 4:2:2, where the frame has no grain)."""
    advanced = {"enable-cdef": "1"}
    if grain == "denoiser":
        advanced["denoise-noise-level"] = "25"
    else:
        advanced["film-grain-test"] = "2"
    data = encode(70, 90, 4, ss, quality=50, speed=4, advanced=advanced)
    frame = avif.decode_av1(avif.parse(data)[0])
    want = frame.tools & _tools("deblocking", "CDEF", "loop restoration")
    if not (grain == "denoiser" and ss == "4:2:2"):
        want |= _tools("film grain")
    assert_equal_dav1d_and_pil(data, want)


def _layouts():
    """{name: (a function giving the file's bytes, the tools of which it
    must turn on one, or 0 for none)}"""
    every = {"enable-cdef": "1"}
    some = _tools("deblocking", "CDEF", "loop restoration")
    return {
        "tiles": (lambda: A.avif_bytes(A.picture(300, 530, 4), quality=40,
                                       tile_rows=2, tile_cols=2,
                                       advanced=every), some),
        "sb128": (lambda: A.avif_bytes(A.picture(700, 1100, 12),
                                       quality=50, speed=4, advanced=every),
                  some),
        "delta-q": (lambda: A.avif_bytes(
            A.picture(130, 200, 5), quality=40, speed=4,
            advanced=dict(every, **{"deltaq-mode": "2"})), some),
        "palette": (lambda: A.avif_bytes(A.screen(64, 96, 21), quality=50,
                                         advanced=every), some),
        "intra block copy": (lambda: A.avif_bytes(
            A.screen(200, 330, 20), quality=50, speed=4, advanced=every), 0),
        "quantizer matrices": (lambda: A.avif_bytes(
            A.picture(64, 96, 11), quality=40, speed=4,
            advanced=dict(every, **{"enable-qm": "1"})), some),
        "segments": (lambda: A.avif_bytes(
            A.picture(130, 200, 9), quality=40, speed=4,
            advanced=dict(every, **{"aq-mode": "1"})), some),
        "17x3": (lambda: A.avif_bytes(A.picture(17, 3, 9), quality=20,
                                      speed=4, advanced=every), some),
        # aom's speed 2 codes CDEF's secondary strength 3, which reads 4,
        # here in both planes' strengths
        "CDEF secondary 4": (lambda: A.avif_bytes(
            A.screen(64, 96, 3), quality=20, speed=2, advanced=every),
            _tools("CDEF")),
    }


@pytest.mark.parametrize("name", list(_layouts()))
def test_filters_across_layouts(name):
    """The filters over tile edges (2x2 tiles), 128x128 superblocks,
    delta q, palettes, quantizer matrices, segments, a frame narrower
    than one 4x4 column of blocks and CDEF's largest secondary strength,
    at both CPU masks; a frame that uses
    intra block copy turns every filter off, though aom is asked for
    them."""
    make, must = _layouts()[name]
    data = make()
    frame = avif.decode_av1(avif.parse(data)[0])
    if must:
        assert frame.tools & must, frame.tools
    else:
        assert frame.tools == 0, frame.tools
    assert_equal_dav1d_and_pil(data, frame.tools)
