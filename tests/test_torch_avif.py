"""AVIF: the port's decoder (scene/avif.py, scene/avif_rgb.py over
native/av1.cpp) against PIL 12.1.0, which reads AVIF through libavif
1.3.0 and dav1d 1.5.1, on the same files, byte for byte.

Two layers are held apart: the port's Y, U and V planes against the ones
dav1d gives (called through ctypes in the libavif that Pillow's wheel
ships), then the port's RGBA against PIL's `Image.open(...).convert(
"RGBA")`. Files are the committed ones of tests/data/avif (made by its
make_avif_data.py; their SHA-256 is what the machine with the card, which
has no PIL, checks; among them the kitchen's maps at PIL's defaults and
files whose frames need each in-loop filter and film grain) and a seeded
corpus PIL writes here, every frame free of in-loop filters: lossless and
lossy at several qualities with aom's loop filter, CDEF and restoration
off, every subsampling, both ranges, two speeds, tiles, alpha with and
without premultiplication, the eight EXIF orientations, screen content
(palette and intra block copy), quantizer matrices, delta q, 128x128
superblocks, 1x1 and odd sizes, and the first frame of an `avis`
sequence. The filters themselves, over every subsampling and size, have
tests/test_torch_avif_filters.py, depths of 10 and 12 bits and grids
tests/test_torch_avif_deep.py, stated sizes libavif scales to, superres
and first pictures shown by show_existing_frame
tests/test_torch_avif_scaled.py. Only a first shown inter frame raises
UnsupportedImage."""
import ctypes
import glob
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from fluctus_tpu.scene.textures import TexturePool as JaxPool
from fluctus_tpu_torch.scene import avif
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.textures import TexturePool

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "avif")
ASSETS = os.path.join(os.path.dirname(HERE), "assets")
RECORD = json.load(open(os.path.join(DATA, "avif.json")))
OFF = {"loopfilter-control": "0", "enable-cdef": "0",
       "enable-restoration": "0"}

pytestmark = pytest.mark.skipif(
    not glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        Image.__file__)), "pillow.libs", "libavif-*")),
    reason="needs the libavif of Pillow's wheel")


def _libavif():
    path = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        Image.__file__)), "pillow.libs", "libavif-*"))[0]
    lib = ctypes.CDLL(path)
    lib.dav1d_data_create.restype = ctypes.c_void_p
    lib.dav1d_open.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for f in ("dav1d_send_data", "dav1d_get_picture"):
        getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def dav1d_planes(obus: bytes):
    """The planes dav1d 1.5.1 gives for an OBU stream (one thread, as
    libavif configures it for PIL here), or None where it fails: uint8 at
    8 bits, uint16 where the picture's bits per component are more."""
    lib = _libavif()
    settings = ctypes.create_string_buffer(4096)
    lib.dav1d_default_settings(settings)
    ctypes.memmove(settings, (ctypes.c_int * 2)(1, 1), 8)
    ctx = ctypes.c_void_p()
    assert lib.dav1d_open(ctypes.byref(ctx), settings) == 0
    data = ctypes.create_string_buffer(256)
    ptr = lib.dav1d_data_create(data, ctypes.c_size_t(len(obus)))
    ctypes.memmove(ptr, obus, len(obus))
    pic = ctypes.create_string_buffer(1024)
    planes = None
    try:
        if lib.dav1d_send_data(ctx, data) == 0 and \
                lib.dav1d_get_picture(ctx, pic) == 0:
            raw = pic.raw
            ptrs = np.frombuffer(raw[16:40], np.uint64)
            strides = np.frombuffer(raw[40:56], np.int64)
            w, h, layout, bpc = np.frombuffer(raw[56:72], np.int32)
            sx, sy = int(layout in (1, 2)), int(layout == 1)
            dt = np.uint8 if bpc == 8 else np.uint16
            planes = []
            for p in range(1 if layout == 0 else 3):
                pw, ph = (w, h) if p == 0 else ((w + sx) >> sx,
                                                (h + sy) >> sy)
                st = int(strides[min(p, 1)])
                buf = (ctypes.c_uint8 * (st * int(ph))).from_address(
                    int(ptrs[p]))
                planes.append(np.frombuffer(buf, dt).reshape(
                    ph, st // dt().itemsize)[:, :pw].copy())
            lib.dav1d_picture_unref(pic)
    finally:
        lib.dav1d_data_unref(data)
        lib.dav1d_close(ctypes.byref(ctx))
    return planes


def pil_rgba(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:
        return -1


def port_rgba(data: bytes):
    """The port's RGBA, -1 where the texture pool would give -1, or the
    UnsupportedImage message."""
    try:
        return avif.decode_avif(data)
    except UnsupportedImage as e:
        return str(e)
    except (ValueError, IndexError):
        return -1


def colour_streams(data: bytes) -> list:
    """The AV1 data of the colour item: one stream, or a grid's cells."""
    obus = avif.parse(data)[0]
    if isinstance(obus, avif.Grid):
        return [c for c, _ in obus.cells]
    return [obus]


def assert_planes_equal_dav1d(data: bytes):
    for obus in colour_streams(data):
        want = dav1d_planes(obus)
        got = avif.decode_av1(obus).planes
        assert want is not None and len(want) == len(got)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def avif_bytes(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "AVIF", **kw)
    return buf.getvalue()


def picture(h, w, seed, channels=3):
    """Seeded gradients, edges and noise."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([128 + 110 * np.sin(x / 6 + y / 13),
                   128 + 100 * np.cos(y / 5), (x * y) % 256,
                   np.linspace(0, 255, w)[None, :].repeat(h, 0)][:channels],
                  -1)
    px = np.clip(px + g.integers(-20, 21, px.shape), 0, 255).astype(np.uint8)
    return Image.fromarray(px if channels > 1 else px[..., 0])


def screen(h, w, seed):
    """Few-colour screen content: glyph-like boxes on a ruled page."""
    g = np.random.default_rng(seed)
    a = np.full((h, w, 3), 250, np.uint8)
    for _ in range(h * w // 500):
        r, c = g.integers(0, h - 8), g.integers(0, w - 6)
        a[r:r + 7, c:c + 5] = g.integers(0, 80, 3)
    a[::9] = (20, 40, 160)
    return Image.fromarray(a)


# ------------------------------------------------------------ committed

@pytest.mark.parametrize("name", sorted(RECORD["files"]))
def test_committed_avif_files(name):
    """Each file of tests/data/avif: PIL's RGBA has the recorded SHA-256,
    and so has the port's, with planes equal to dav1d's; the filters the
    port reads as turned on in the frame are the recorded ones (the files
    PIL writes with its defaults need deblocking)."""
    entry = RECORD["files"][name]
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"]
    want = pil_rgba(data)
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    assert_planes_equal_dav1d(data)
    tools = avif.decode_av1(colour_streams(data)[0]).tools
    assert [k for k, bit in avif.TOOLS.items() if tools & bit] == \
        entry["tools"]
    got = avif.decode_avif(data)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_kitchen_maps_load_in_both_pools():
    """The three kitchen maps as AVIF, free of filters and filtered: both
    texture pools hold the same rows, PIL's and the port's."""
    for name in ("kitchen_floor", "kitchen_floor_n", "kitchen_wood",
                 "kitchen_floor_filtered", "kitchen_floor_n_filtered",
                 "kitchen_wood_filtered"):
        pools = []
        for pool in (JaxPool(), TexturePool()):
            assert pool.try_import(os.path.join(DATA, f"{name}.avif"),
                                   "t") == 0
            pools.append(pool.textures[0].rgba)
        np.testing.assert_array_equal(pools[1], pools[0])


# ------------------------------------------------------------ corpus

def _corpus():
    """{case: zero-argument builder of the file's bytes}."""
    cases = {}
    for q in (100, 90, 60, 30):
        for ss in ("4:4:4", "4:2:2", "4:2:0", "L"):
            def make(q=q, ss=ss):
                img = picture(37, 51, q)
                kw = dict(quality=q, advanced=OFF) if q < 100 else \
                    dict(quality=q)
                if ss == "L":
                    return avif_bytes(img.convert("L"), **kw)
                return avif_bytes(img, subsampling=ss, **kw)
            cases[f"q{q}-{ss}"] = make
    cases["limited-444-lossless"] = lambda: avif_bytes(
        picture(29, 33, 1), quality=100, range="limited",
        subsampling="4:4:4")
    cases["limited-420-q60"] = lambda: avif_bytes(
        picture(29, 33, 2), quality=60, range="limited", advanced=OFF)
    for speed in (2, 9):
        cases[f"speed{speed}"] = lambda speed=speed: avif_bytes(
            picture(40, 48, speed), quality=70, speed=speed, advanced=OFF)
    cases["tiles"] = lambda: avif_bytes(
        picture(200, 330, 3), quality=60, tile_rows=1, tile_cols=1,
        advanced=OFF)
    for prem in (False, True):
        cases[f"rgba-prem{int(prem)}"] = lambda prem=prem: avif_bytes(
            picture(24, 40, 4, 4).convert("RGBA"), quality=100,
            alpha_premultiplied=prem)
    cases["rgba-lossy"] = lambda: avif_bytes(
        picture(24, 40, 5, 4).convert("RGBA"), quality=50, advanced=OFF)
    for o in range(1, 9):
        def make(o=o):
            exif = Image.Exif()
            exif[0x0112] = o
            return avif_bytes(picture(20, 30, o), quality=100,
                              exif=exif.tobytes())
        cases[f"orientation{o}"] = make
    cases["screen-intrabc"] = lambda: avif_bytes(
        screen(200, 330, 20), quality=90, advanced=OFF)
    cases["screen-palette"] = lambda: avif_bytes(
        screen(64, 96, 21), quality=100)
    # aom takes 128x128 superblocks at this size
    cases["sb128"] = lambda: avif_bytes(
        picture(700, 1100, 12), quality=60, advanced=OFF)
    cases["sb128-screen-intrabc"] = lambda: avif_bytes(
        screen(700, 1100, 30), quality=50, advanced=OFF)
    for ss, q in (("4:2:0", 50), ("4:2:2", 20), ("4:4:4", 70)):
        cases[f"qm-{ss}-q{q}"] = lambda ss=ss, q=q: avif_bytes(
            picture(64, 96, 11), quality=q, subsampling=ss,
            advanced=dict(OFF, **{"enable-qm": "1"}))
    cases["delta-q"] = lambda: avif_bytes(
        picture(130, 200, 5), quality=40,
        advanced=dict(OFF, **{"deltaq-mode": "2"}))
    cases["1x1"] = lambda: avif_bytes(picture(1, 1, 6), quality=100)
    cases["odd-lossy"] = lambda: avif_bytes(
        picture(17, 3, 7), quality=40, advanced=OFF)

    def sequence():
        frames = [picture(24, 40, 10 + k) for k in range(3)]
        buf = io.BytesIO()
        frames[0].save(buf, "AVIF", save_all=True,
                       append_images=frames[1:], quality=100)
        return buf.getvalue()
    cases["avis-first-frame"] = sequence
    return cases


CORPUS = _corpus()


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_corpus_equals_pil(case):
    """Each file the seeded corpus writes: the port's planes equal dav1d's
    and its RGBA equals PIL's, byte for byte."""
    data = CORPUS[case]()
    assert_planes_equal_dav1d(data)
    want = pil_rgba(data)
    assert not isinstance(want, int), "PIL could not read the file"
    got = avif.decode_avif(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tool, advanced, speed", [
    ("deblocking", None, 6),
    ("film grain", dict(OFF, **{"denoise-noise-level": "30"}), 6),
    ("loop restoration", dict(OFF, **{"enable-restoration": "1"}), 2),
])
def test_frames_that_need_a_tool_raise_naming_it(tool, advanced, speed):
    """Frames that need a tool the port once lacked, and refused naming
    it (PIL's defaults deblock; aom's denoiser adds film grain; its
    restoration at speed 2): the frame turns the tool on, and now decodes
    to dav1d's planes and PIL's RGBA. What still raises (a first shown
    inter frame) PIL cannot write as a still image."""
    kw = {} if advanced is None else dict(advanced=advanced)
    data = avif_bytes(picture(128, 160, 7), quality=70, speed=speed, **kw)
    assert avif.decode_av1(avif.parse(data)[0]).tools & avif.TOOLS[tool]
    assert_planes_equal_dav1d(data)
    np.testing.assert_array_equal(avif.decode_avif(data), pil_rgba(data))


def test_matrix_coefficients_follow_libavif():
    """The colr box's matrix coefficients 0-18 (and its range bit) on a
    4:4:4 and a 4:2:0 file: the RGBA equals PIL's where libavif converts
    (through libyuv's constants, or its own float path with bilinear
    chroma for the matrices libyuv lacks), and both fail where it does."""
    bad = []
    for ss in ("4:4:4", "4:2:0"):
        data = avif_bytes(picture(19, 23, 9), quality=100, subsampling=ss)
        i = data.find(b"nclx")
        for mc in range(19):
            for full in (0, 1):
                for cp in (1, 4):
                    d = bytearray(data)
                    d[i + 4:i + 6] = cp.to_bytes(2, "big")
                    d[i + 8:i + 10] = mc.to_bytes(2, "big")
                    d[i + 10] = 128 * full
                    want, got = pil_rgba(bytes(d)), port_rgba(bytes(d))
                    if isinstance(want, int) or isinstance(got, (int, str)):
                        ok = isinstance(want, int) and isinstance(got, int)
                    else:
                        ok = np.array_equal(want, got)
                    if not ok:
                        bad.append((ss, mc, full, cp))
    assert not bad, bad


# ------------------------------------------------------------ damage

# what the port lacks (a first shown inter frame): the only refusal a
# damaged file that PIL reads may meet
REFUSALS = ("inter frames",)


def _agrees(want, got) -> bool:
    """PIL's result (RGBA or -1) against the port pool's (RGBA, -1 or the
    UnsupportedImage message)."""
    if isinstance(got, str):
        return not isinstance(want, int) and any(r in got for r in REFUSALS)
    if isinstance(want, int) or isinstance(got, int):
        return isinstance(want, int) and isinstance(got, int)
    return want.shape == got.shape and np.array_equal(want, got)


def _both_pools(tmp_path, data: bytes):
    """(JAX pool's RGBA or -1, the port pool's RGBA, -1 or the
    UnsupportedImage message) of one file."""
    path = tmp_path / "t.avif"
    path.write_bytes(data)
    out = []
    for pool in (JaxPool(), TexturePool()):
        try:
            i = pool.try_import(str(path), "t")
            out.append(i if i < 0 else pool.textures[i].rgba)
        except UnsupportedImage as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("name", ["kitchen_floor_n.avif", "alpha_prem.avif",
                                  "screen.avif", "sequence.avif",
                                  "kitchen_wood_filtered.avif",
                                  "film_grain.avif", "all_422.avif",
                                  "all_grey.avif", "kitchen_wood_12.avif",
                                  "kitchen_floor_n_grid10.avif"])
def test_damaged_files_agree_with_pil(tmp_path, name):
    """Seeded damage to committed files, through both texture pools: bit
    flips in the boxes before mdat, bit flips in the AV1 data, cuts, and a
    byte set anew among the OBU headers. The port gives -1 where PIL fails
    (libavif's box rules, dav1d's refusal of a tile read past its end or of
    a bad header) and PIL's pixels otherwise, also where the damage
    restates a size libavif scales to or turns superres on; where it makes
    the first shown frame an inter frame, which the port lacks, it raises
    naming it, and it raises for nothing else. Among the files, a 12-bit one and a grid of 10-bit
    cells."""
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    mdat = data.find(b"mdat") + 4
    g = np.random.default_rng(2020)
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


FUZZ_FILES = ("kitchen_floor_n.avif", "alpha_prem.avif", "screen.avif",
              "sequence.avif", "grey_limited.avif", "kitchen_wood.avif",
              "kitchen_wood_filtered.avif", "all_422.avif",
              "all_grey.avif", "film_grain.avif", "kitchen_wood_12.avif",
              "kitchen_floor_n_grid10.avif")


def _fuzzed(seed: int, name: str, t: int, files=FUZZ_FILES) -> bytes:
    """Case `t` of `name` in a wider damage fuzz: one generator of `seed`
    runs over `files` in order, 40 cases each, with the four kinds of
    damage of test_damaged_files_agree_with_pil."""
    g = np.random.default_rng(seed)
    for fname in files:
        with open(os.path.join(DATA, fname), "rb") as f:
            data = f.read()
        mdat = data.find(b"mdat") + 4
        for k in range(40):
            d = bytearray(data)
            mode = k % 4
            if mode == 0:
                d[int(g.integers(0, mdat))] ^= 1 << int(g.integers(0, 8))
            elif mode == 1:
                for _ in range(1 + int(g.integers(0, 2))):
                    d[int(g.integers(mdat, len(d)))] ^= \
                        1 << int(g.integers(0, 8))
            elif mode == 2:
                d = d[:int(g.integers(1, len(d)))]
            else:
                at = int(g.integers(mdat, min(len(d), mdat + 40)))
                d[at] = int(g.integers(0, 256))
            if (fname, k) == (name, t):
                return bytes(d)
    raise KeyError((name, t))


@pytest.mark.parametrize("seed,name,t", [
    (13, "alpha_prem.avif", 15),    # a 10-bit alpha under 8-bit colour
    (17, "sequence.avif", 19),      # a hidden frame, then an OBU too long
    (24, "alpha_prem.avif", 11),    # a short frame OBU, then a tile group
    (24, "alpha_prem.avif", 39),    # a short frame OBU, then one too long
    (25, "sequence.avif", 39),      # a frame never shown
    (7, "alpha_prem.avif", 23),     # an empty metadata OBU
    (19, "sequence.avif", 24),      # an item without ispe beside the track
    (23, "sequence.avif", 16),      # an item too large beside the track
    (25, "sequence.avif", 36),      # the track's mdhd renamed
    (28, "sequence.avif", 24),      # an stts box cut short
    (32, "sequence.avif", 4),       # pixi depths that differ
    (29, "sequence.avif", 23),      # an inter frame with no references
    (29, "kitchen_floor_n.avif", 27),   # CDEF strengths before film grain
    (8, "sequence.avif", 23),       # a sequence header without its last bit
    (48, "sequence.avif", 32),      # an edts box without elst
    (67, "grey_limited.avif", 11),  # a vertical partition in 4:2:2
    (61, "sequence.avif", 12),      # an mvhd version libavif never reads
    (78, "alpha_prem.avif", 28),    # an infe naming an item without data
    (79, "sequence.avif", 8),       # the same beside a track
    (83, "alpha_prem.avif", 15),    # an empty redundant frame header
    (84, "sequence.avif", 12),      # an stsc box not starting at chunk 1
    (85, "alpha_prem.avif", 4),     # an iref version libavif skips
    (101, "kitchen_floor_n.avif", 8),   # pixi against av1C's depth
    (114, "sequence.avif", 16),     # elst flags libavif does not read
    (125, "alpha_prem.avif", 7),    # an alpha coded in limited range
    (130, "grey_limited.avif", 39),     # 4:0:0 in limited range, filtered
    (13, "all_422.avif", 3),        # a frame header left with deblocking
    (10, "kitchen_wood_filtered.avif", 31),  # restoration turned off
    (8, "all_grey.avif", 19),       # every filter, its grain turned off
    (7, "film_grain.avif", 3),      # film grain turned off
    (22, "kitchen_floor_n_grid10.avif", 0),   # iloc's reserved bits set
    (28, "kitchen_floor_n_grid10.avif", 12),  # the same, another item
    (36, "kitchen_floor_n_grid10.avif", 4),   # a cell referenced twice
    (52, "kitchen_floor_n_grid10.avif", 20),  # a cell without its header
    (55, "kitchen_floor_n_grid10.avif", 20),  # pixi against a cell's av1C
    (173, "kitchen_wood_12.avif", 0),   # av1C's twelve_bit without high
    (213, "sequence.avif", 12),     # a track's hdlr name unterminated
    (7, "kitchen_wood.avif", 27),   # a frame of another size than stated
    (11, "all_422.avif", 25),       # the same in 4:2:2
    (9, "all_grey.avif", 15),       # the same in grey
    (8, "film_grain.avif", 7),      # the same with film grain
    (8, "kitchen_wood_12.avif", 39),    # the same at 12 bits
    (9, "sequence.avif", 11),       # a track's frame of another size
    (14, "alpha_prem.avif", 19),    # an alpha of another size than stated
    (7, "alpha_prem.avif", 4),      # colour and alpha, both
    (7, "kitchen_floor_n_grid10.avif", 23),  # a grid cell, the same
])
def test_fuzzed_damage_agrees_with_pil(tmp_path, seed, name, t):
    """Damaged files on which the port once differed from PIL, found by a
    wider fuzz (_fuzzed). dav1d: libavif drains it after its first
    picture, so an error in the data after the shown frame fails the
    decode; a hidden frame gives no picture; it reads each header's
    trailing bit, a metadata OBU's type, a redundant frame header where
    no frame header is active and each CDEF strength whole; it fails an
    inter frame with no frame before it and vertical partitions in 4:2:2
    (which aom never codes). libavif: an alpha must match the colour in
    depth and size, and one coded in limited range is brought to full
    range; every image item with data needs a valid ispe, also where the
    track is decoded; a track's hdlr needs its name's terminating NUL;
    a frame (colour, alpha or a grid cell, also a track's) whose size
    differs from the one its item or track states is scaled to it;
    it reads av1C's depth as 12 wherever twelve_bit is
    set; it fails an iloc (version 1 or 2) whose 12 bits
    before an item's construction method are not 0, a grid naming a
    cell twice, a cut stts, pixi depths that differ or
    disagree with av1C's, edts without elst and stsc not counting up from
    chunk 1; it skips an iref of an unknown version and reads neither
    mvhd nor elst's other flags, decodes a grid's cells with one dav1d
    context (a cell without a sequence header takes the one before
    it), and converts a 4:0:0 frame in limited
    range with its own code rather than libyuv's. PIL divides by the
    track's timescale. Damage to a filtered frame's header that changes
    which filters run decodes as dav1d decodes it."""
    assert _agrees(*_both_pools(tmp_path, _fuzzed(seed, name, t)))


@pytest.mark.parametrize("seed,name,t,masks", [
    (16, "screen.avif", 3, (0, 1, 3, 7)),
    (38, "screen.avif", 7, (0, 1, 3, 7)),
    (47, "screen.avif", 15, (0, 1, 3, 7)),
    (50, "screen.avif", 23, (0, 1, 3, 7)),
    (74, "screen.avif", 11, (0, 1, 3, 7)),
    (108, "kitchen_floor_n.avif", 17, (0, 1)),
    (133, "grey_limited.avif", 17, (0, 1)),
    (40, "kitchen_floor_n.avif", 21, (0, 1)),
])
def test_out_of_range_coefficients_follow_dav1d_c(seed, name, t, masks):
    """Damaged frames (_fuzzed) whose dequantised coefficients overflow
    the inverse transform: the port's planes equal those of dav1d's C
    code and of the SIMD levels that agree with it (dav1d's CPU masks:
    0 none, 1 SSE2, 3 SSSE3, 7 SSE4.1). dav1d's SSSE3, AVX2 and AVX-512
    transforms saturate at other points on such data and give other
    pixels in one block, so PIL's pixels for these files depend on the
    CPU (ROADMAP.md, Queue 3)."""
    obus = avif.parse(_fuzzed(seed, name, t))[0]
    got = avif.decode_av1(obus).planes
    lib = _libavif()
    try:
        for mask in masks:
            lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(mask))
            want = dav1d_planes(obus)
            assert want is not None and all(
                np.array_equal(a, b) for a, b in zip(want, got)), mask
    finally:
        lib.dav1d_set_cpu_flags_mask(ctypes.c_uint(0xffffffff))


# ------------------------------------------------------------ the kitchen

def test_kitchen_from_avif_maps_renders_like_jax(tmp_path):
    """The kitchen (BASELINE config 3) from a temporary MTL that names the
    committed AVIF copies of its three maps, its camera and light from
    data/states: the port's atlas equals the JAX package's (which reads
    the maps through PIL) byte for byte, and the port's lockstep gives
    what the JAX package's does on 1,024 pixels for two samples at 64²,
    8 bounces, held as the kitchen is held (≥ 99.5 % of pixels within
    RTOL 1e-3 / ATOL 1e-4, mean relative error ≤ 1e-4)."""
    _kitchen_like_jax(tmp_path, "")


def test_filtered_kitchen_maps_render_like_jax(tmp_path):
    """The same with the filtered maps (PIL's defaults for the floor,
    speed 4 with CDEF for the wood, speed 4 at 4:4:4 for the normals),
    whose frames the port deblocks, filters with CDEF and restores."""
    _kitchen_like_jax(tmp_path, "_filtered")


def _kitchen_like_jax(tmp_path, suffix: str):
    import jax
    import jax.numpy as jnp
    import torch
    from golden_common import ATOL, RTOL
    from torch_common import golden_stats

    from fluctus_tpu.core.types import RenderConfig as JaxConfig
    from fluctus_tpu.integrators import lockstep as jax_lockstep
    from fluctus_tpu.render import driver as jax_driver
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.integrators import lockstep
    from fluctus_tpu_torch.render import driver
    kitchen = os.path.join(ASSETS, "kitchen_proxy.obj")
    obj = tmp_path / "kitchen_proxy.obj"
    os.symlink(os.path.abspath(kitchen), obj)
    with open(os.path.splitext(kitchen)[0] + ".mtl") as f:
        mtl = f.read()
    for name in ("kitchen_floor_n", "kitchen_floor", "kitchen_wood"):
        mtl = mtl.replace(f" {name}.png",
                          " " + os.path.join(DATA, f"{name}{suffix}.avif"))
    assert ".png" not in mtl
    (tmp_path / "kitchen_proxy.mtl").write_text(mtl)
    states = os.path.join(os.path.dirname(HERE), "data", "states")
    js = jax_driver.create_session(
        str(obj), env_map=None, cfg=JaxConfig(
            width=64, height=64, max_bounces=8, use_area_light=True,
            use_env_map=False), use_sbvh=True, cache_dir=None,
        state_dir=states, auto_frame=False)
    cfg = RenderConfig(width=64, height=64, use_area_light=True,
                       use_env_map=False, max_bounces=8)
    s = driver.create_session(str(obj), cfg=cfg, state_dir=states,
                              auto_frame=False, device="cpu")
    np.testing.assert_array_equal(s.scene.atlas.data.numpy(),
                                  np.asarray(js.scene.atlas.data))
    c = js.cfg
    pix = np.arange(0, 64 * 64, 4, dtype=np.uint32)
    fn = jax.jit(lambda sc, pa, p, k: jax_lockstep.sample_radiance(
        sc, pa, c, p, k, early_exit=True))
    for smp in (0, 5):
        want = np.asarray(fn(js.scene, js.params, jnp.asarray(pix),
                             jnp.uint32(smp)))
        got = lockstep.sample_radiance(
            s.scene, s.params, cfg, torch.from_numpy(pix.astype(np.int32)),
            smp).numpy()
        assert np.isfinite(got).all()
        share, mean_rel = golden_stats(got, want, RTOL, ATOL)
        assert share >= 0.995 and mean_rel <= 1e-4, (share, mean_rel)


def test_grey_frames_in_limited_range_follow_libavif():
    """A 4:0:0 frame (a damaged sequence header's monochrome bit, its
    filters turned on) under the colr box's matrix coefficients 0-18, its
    range bit and two primaries: libavif converts it with libyuv only at
    full range and with its own code in limited range; the RGBA equals
    PIL's where libavif converts and both fail where it does not."""
    data = _fuzzed(130, "grey_limited.avif", 39)
    assert avif.decode_av1(avif.parse(data)[0]).mono
    i = data.find(b"nclx")
    bad = []
    for mc in range(19):
        for full in (0, 1):
            for cp in (1, 4):
                d = bytearray(data)
                d[i + 4:i + 6] = cp.to_bytes(2, "big")
                d[i + 8:i + 10] = mc.to_bytes(2, "big")
                d[i + 10] = 128 * full
                want, got = pil_rgba(bytes(d)), port_rgba(bytes(d))
                if isinstance(want, int) or isinstance(got, (int, str)):
                    ok = isinstance(want, int) and isinstance(got, int)
                else:
                    ok = np.array_equal(want, got)
                if not ok:
                    bad.append((mc, full, cp))
    assert not bad, bad
