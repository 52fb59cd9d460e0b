"""JPEG: the port's TexturePool (scene/jpeg.py over native/jpeg.cpp)
against the JAX package's (PIL 12.1.0's `Image.open(...).convert("RGBA")`
through libjpeg-turbo 3), byte for byte, on every process PIL reads:
arithmetic coding (SOF9, SOF10, DAC conditioning), lossless (SOF3, the
seven predictors, the point transform), the block smoothing of a
progressive file left unrefined, and libjpeg's recovery from damaged
entropy data (bad codes, markers inside the data, wrong or missing
restart markers); where PIL fails (SOF11, a lossless file it would have
to convert, arithmetic data past PIL's first read) both give -1.

The files of tests/data/jpeg (made by its make_jpeg_data.py, whose own
QM and lossless encoders write what PIL cannot) are held against PIL and
against the SHA-256 recorded beside them, which is what the machine with
the card, which has no PIL, checks. Seeded damage (bit flips, bytes,
0xFF bytes, deletions past the first SOS) over baseline, progressive,
restart, arithmetic, lossless and old-style JPEG TIFF streams must give
-1 in both pools or the same RGBA.

The TIFF faults of the same slice: T.4 data that ends early against
libtiff's own TIFFReadEncodedStrip (through ctypes on PIL's bundled
libtiff), damaged Zstandard frames against libzstd's streaming decoder
(ctypes on PIL's bundled libzstd, as libtiff's ZSTDDecode calls it), and
damaged YCbCr strips, which libtiff's RGBA reader keeps as far as their
codec wrote them.
"""
import ctypes
import glob
import hashlib
import importlib.util
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fluctus_tpu.scene.textures import TexturePool as JaxPool
from fluctus_tpu_torch import fixtures
from fluctus_tpu_torch.scene import ccitt, jpeg, zstd
from fluctus_tpu_torch.scene.textures import TexturePool

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
ASSETS = os.path.join(os.path.dirname(os.path.dirname(DATA)), "..",
                      "assets")
LIBS = os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                    "pillow.libs")


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_data", os.path.join(DATA, "make_jpeg_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MK = _maker()
with open(os.path.join(DATA, "jpeg.json")) as _f:
    RECORD = json.load(_f)


def both(tmp_path, data: bytes, suffix: str = ".jpg"):
    """(JAX pool's RGBA or -1, port pool's RGBA or -1) of one file."""
    path = tmp_path / f"t{suffix}"
    path.write_bytes(data)
    out = []
    for pool in (JaxPool(), TexturePool()):
        i = pool.try_import(str(path), "t")
        out.append(i if i < 0 else pool.textures[i].rgba)
    return out


def agree(tmp_path, data: bytes, suffix: str = ".jpg") -> bool:
    want, got = both(tmp_path, data, suffix)
    if isinstance(want, int) or isinstance(got, int):
        return isinstance(want, int) and isinstance(got, int)
    return want.shape == got.shape and np.array_equal(want, got)


def assert_same(tmp_path, data: bytes, suffix: str = ".jpg"):
    want, got = both(tmp_path, data, suffix)
    assert not isinstance(want, int), "PIL could not read the file"
    assert not isinstance(got, int), "the port could not read the file"
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def pil_jpeg(px, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


# ------------------------------------------------------------ committed

@pytest.mark.parametrize("name", sorted(RECORD["files"]))
def test_committed_jpeg_files(tmp_path, name):
    """Each file of tests/data/jpeg: the port's RGBA equals PIL's and the
    SHA-256 recorded in jpeg.json (the card's check)."""
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    assert_same(tmp_path, data)
    rgba = TexturePool()
    rgba.try_import(os.path.join(DATA, name), "t")
    flat = rgba.textures[0].rgba[::-1]      # the pool keeps rows bottom-up
    rec = RECORD["files"][name]
    assert list(flat.shape) == rec["shape"]
    assert hashlib.sha256(flat.tobytes()).hexdigest() == rec["sha256"]


def test_arith_table_matches_libjpeg():
    """The decoder's QM state table (ITU-T T.81 Table D.2 as jaricom.c
    packs it) equals jpeg_aritab in the read-only data of PIL's bundled
    libjpeg-turbo, and the data script's encoder table too."""
    so = open(glob.glob(os.path.join(LIBS, "libjpeg-*"))[0], "rb").read()
    mine = jpeg.arith_table()
    at = so.find(mine[:2].tobytes())
    assert at >= 0, "jpeg_aritab not found in libjpeg"
    shipped = np.frombuffer(so[at:at + 114 * 8], "<i8")
    np.testing.assert_array_equal(mine, shipped)
    assert MK.ARITAB == mine.tolist()


# ------------------------------------------------------------ probes

def _probe_base():
    return pil_jpeg(MK.picture(96, 128, 41), quality=85)


@pytest.mark.parametrize("off", [200, 400, 900])
def test_bit_flips_decode_as_pil(tmp_path, off):
    """Single-bit flips 200, 400 and 900 bytes into the entropy data of a
    baseline file: libjpeg decodes through every one (a bad code reads as
    0, a marker feeds zeros) and the port gives its pixels."""
    base = _probe_base()
    s0 = MK.entropy_start(base)
    for bit in (0, 3, 6):
        d = bytearray(base)
        d[s0 + off] ^= 1 << bit
        assert_same(tmp_path, bytes(d))


@pytest.mark.parametrize("change", ["number", "removed", "junk"])
def test_restart_marker_damage_resyncs(tmp_path, change):
    """A restart marker given another number, removed, or preceded by
    stray bytes: libjpeg's read_restart_marker / resync_to_restart
    recover, and the port with them."""
    rst = pil_jpeg(MK.picture(96, 128, 41), quality=85,
                   restart_marker_blocks=4)
    marks = MK.restart_markers(rst)
    for k in (0, 3, len(marks) // 2):
        d = bytearray(rst)
        if change == "number":
            for step in (1, 2, 5, 7):
                e = bytearray(rst)
                e[marks[k] + 1] = 0xD0 + ((e[marks[k] + 1] - 0xD0 + step) & 7)
                assert_same(tmp_path, bytes(e))
            continue
        if change == "removed":
            del d[marks[k]:marks[k] + 2]
        else:
            d[marks[k]:marks[k]] = b"\x12\x34\xff\x00"
        assert_same(tmp_path, bytes(d))


@pytest.mark.parametrize("scans", [1, 3, 6])
def test_unrefined_progressive_is_smoothed(tmp_path, scans):
    """A PIL progressive file cut after its 1st, 3rd or 6th scan, then
    EOI: libjpeg-turbo block-smooths the coefficients left unrefined
    (from the DC values alone after the first scan), and the port too;
    a grey one likewise."""
    prog = pil_jpeg(MK.picture(96, 128, 43), quality=85, progressive=True)
    assert_same(tmp_path, MK.cut_after(prog, scans))
    grey = pil_jpeg(MK.picture(64, 72, 43)[..., 1], progressive=True)
    assert_same(tmp_path, MK.cut_after(grey, min(scans, 5)))


# ------------------------------------------------------------ damage

def _fuzz_bases():
    pic = MK.picture(40, 56, 3)
    grey = pic[..., 0]
    bases = {
        "baseline": pil_jpeg(pic, quality=85),
        "baseline 4:2:0": pil_jpeg(pic, quality=60, subsampling=2),
        "grey": pil_jpeg(grey, quality=90),
        "restarts": pil_jpeg(pic, quality=85, restart_marker_blocks=2),
        "progressive": pil_jpeg(pic, quality=85, progressive=True),
        "progressive restarts": pil_jpeg(pic, quality=75, progressive=True,
                                         restart_marker_blocks=3),
        "arithmetic": MK.arith_jpeg(pic, [(2, 2), (1, 1), (1, 1)],
                                    restart=3, dac=(1, 4, 3)),
        "arithmetic progressive": MK.arith_jpeg(
            pic, [(2, 2), (1, 1), (1, 1)], progressive=True, restart=5),
        "lossless": MK.lossless([pic[..., k] for k in range(3)],
                                [(1, 1)] * 3, predictor=4, restart_rows=4),
    }
    return bases


def _ojpeg_bases():
    pic = MK.picture(40, 56, 3)
    out = {}
    for layout in ("jif", "tables"):
        for sub, tag in ((2, (2, 2)), (0, (1, 1)), (2, (2, 1))):
            out[f"old-style {layout} {sub} {tag}"] = fixtures.ojpeg_tiff_bytes(
                pil_jpeg(pic, quality=85, subsampling=sub), 56, 40, layout,
                subsampling=tag)
        out[f"old-style {layout} restarts"] = fixtures.ojpeg_tiff_bytes(
            pil_jpeg(pic, subsampling=2, restart_marker_blocks=3), 56, 40,
            layout)
    return out


FUZZ = _fuzz_bases()
OJPEG = _ojpeg_bases()


@pytest.mark.parametrize("base", sorted(FUZZ))
def test_damaged_streams_agree_with_pil(tmp_path, base):
    """30 seeded damaged copies of each base (1-3 bit flips, random bytes,
    0xFF bytes or deletions after the first SOS): both pools give -1 or
    the same RGBA."""
    b = FUZZ[base]
    g = np.random.default_rng(len(base) * 7 + 1)
    s0 = MK.entropy_start(b)
    bad = []
    for t in range(30):
        d = bytearray(b)
        kind = int(g.integers(0, 4))
        for _ in range(1 + int(g.integers(0, 3))):
            i = int(g.integers(s0, len(d) - 2))
            if kind == 0:
                d[i] ^= 1 << int(g.integers(0, 8))
            elif kind == 1:
                d[i] = int(g.integers(0, 256))
            elif kind == 2:
                d[i] = 0xFF
            else:
                del d[i]
        if not agree(tmp_path, bytes(d)):
            bad.append(t)
    assert not bad, f"cases {bad} differ from PIL"


@pytest.mark.parametrize("base", sorted(OJPEG))
def test_damaged_old_style_jpeg_agrees_with_pil(tmp_path, base):
    """Old-style JPEG TIFFs (libtiff's OJPEG, PIL's RGBA reader for
    YCbCr), whole streams and the tables form, YCbCrSubSampling tags that
    disagree with the coded data among them: as they are, and 25 seeded
    copies with bits flipped in the strip. libtiff fails where libjpeg
    would resynchronize at a restart marker, and where its own reading of
    the stream's header meets a stray byte; a strip whose decoding fails
    reads as the zeroed buffer."""
    b = OJPEG[base]
    assert agree(tmp_path, b, ".tif")
    im = Image.open(io.BytesIO(b))
    off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    g = np.random.default_rng(len(base) * 5 + 3)
    bad = []
    for t in range(25):
        d = bytearray(b)
        for _ in range(1 + int(g.integers(0, 2))):
            d[int(g.integers(off, off + n))] ^= 1 << int(g.integers(0, 8))
        if not agree(tmp_path, bytes(d), ".tif"):
            bad.append(t)
    assert not bad, f"cases {bad} differ from PIL"


def test_streams_cut_at_their_end_agree_with_pil(tmp_path):
    """Baseline files (some over PIL's 64 KiB read) cut 2, 3, 9 and 40
    bytes before their end, so EOI and the last bytes of data are gone:
    PIL decodes some (libjpeg's look-ahead stopped short of the end before
    the last row, and the rest is only markers) and fails on others; the
    port follows it on each, through libjpeg's fast and slow Huffman
    decoders' different read-ahead."""
    g = np.random.default_rng(5)
    for k, q in enumerate((85, 95, 97)):
        h, w = 120 + 90 * k, 100 + 80 * k
        px = np.clip(MK.picture(h, w, k).astype(int) + g.integers(
            -40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        b = pil_jpeg(px, quality=q)
        for cut in (2, 3, 9, 40):
            assert agree(tmp_path, b[:-cut]), (k, cut)


# ------------------------------------------------------------ rules

def test_what_pil_fails_on_is_minus_one(tmp_path):
    """SOF11 (libjpeg-turbo decodes no arithmetic lossless), a lossless
    file libjpeg would have to convert from YCbCr (a JFIF marker, an
    Adobe transform 1), a lossless restart interval that is not a whole
    number of MCU rows, fractional sampling and a progressive file cut
    without EOI: -1 in both pools."""
    pic = MK.picture(32, 40, 9)
    rgb = [pic[..., k] for k in range(3)]
    ll = MK.lossless(rgb, [(1, 1)] * 3, predictor=1)
    sof11 = bytearray(ll)
    sof11[sof11.index(b"\xff\xc3") + 1] = 0xCB
    jfif = MK.segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    adobe1 = MK.segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x01")
    rst = bytearray(MK.lossless(rgb, [(1, 1)] * 3, predictor=1,
                                restart_rows=2))
    i = rst.index(b"\xff\xdd")
    rst[i + 4:i + 6] = struct.pack(">H", 2 * 40 + 1)
    frac = bytearray(pil_jpeg(pic, subsampling=0))
    i = frac.index(b"\xff\xc0")
    frac[i + 11] = 0x31                     # component 1 at h 3, v 1
    frac[i + 14] = 0x21                     # component 2 at h 2
    prog = pil_jpeg(pic, progressive=True)
    for data in (bytes(sof11),
                 MK.lossless(rgb, [(1, 1)] * 3, predictor=1, app=jfif),
                 MK.lossless(rgb, [(1, 1)] * 3, predictor=1, app=adobe1),
                 bytes(rst), bytes(frac), prog[:MK.scan_starts(prog)[4]]):
        assert both(tmp_path, data) == [-1, -1]


def test_arithmetic_data_past_pils_first_read_fails(tmp_path):
    """PIL hands libjpeg 64 KiB at a time into a suspending source;
    jdarith.c cannot suspend, so an arithmetic-coded scan whose data runs
    past the first 64 KiB fails in PIL (the same picture Huffman-coded
    decodes), and in the port."""
    g = np.random.default_rng(3)
    noisy = g.integers(0, 256, (160, 160, 3)).astype(np.uint8)
    big = MK.arith_jpeg(noisy, [(1, 1)] * 3, quality=100)
    assert len(big) > 65536
    assert both(tmp_path, big) == [-1, -1]
    assert_same(tmp_path, pil_jpeg(noisy, quality=100))
    small = MK.arith_jpeg(noisy[:64, :64], [(1, 1)] * 3, quality=100)
    assert len(small) < 65536
    assert_same(tmp_path, small)


def test_missing_huffman_tables(tmp_path):
    """A sequential file without DHT reads libjpeg-turbo's standard tables
    (Motion-JPEG's rule); a progressive one does not, and fails."""
    pic = MK.picture(32, 40, 11)

    def strip_dht(b):
        out, p = bytearray(b[:2]), 2
        while True:
            m, n = b[p + 1], struct.unpack(">H", b[p + 2:p + 4])[0]
            if m == 0xDA:
                return bytes(out + b[p:])
            if m != 0xC4:
                out += b[p:p + 2 + n]
            p += 2 + n
    assert_same(tmp_path, strip_dht(pil_jpeg(pic, quality=80)))
    assert both(tmp_path, strip_dht(pil_jpeg(pic, progressive=True))) == \
        [-1, -1]


# ------------------------------------------------------------ callers

def _jpeg_tables_split(j: bytes):
    """libtiff's layout: the DQT / DHT / DAC segments as JPEGTables, the
    rest as the strip."""
    i, tables, rest = 2, b"", b""
    while True:
        m = j[i + 1]
        n = struct.unpack(">H", j[i + 2:i + 4])[0]
        if m == 0xDA:
            return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + rest + j[i:]
        if m in (0xDB, 0xC4, 0xCC):
            tables += j[i:i + 2 + n]
        else:
            rest += j[i:i + 2 + n]
        i += 2 + n


@pytest.mark.parametrize("kind", ["arithmetic", "lossless", "SOF11"])
def test_tiff_blp_iptc_carry_the_new_processes(tmp_path, kind):
    """An arithmetic-coded and a lossless stream (and SOF11, which every
    path fails on) inside new-style JPEG TIFF (JPEGTables and inline, RGB
    and grey), BLP1 and IPTC: the same RGBA as PIL, or -1 in both."""
    pic = MK.picture(32, 48, 5)
    if kind == "arithmetic":
        rgb = MK.arith_jpeg(pic, [(1, 1)] * 3, quality=90, jfif=False)
        grey = MK.arith_jpeg(pic[..., 0], [(1, 1)], quality=90, jfif=False)
    else:
        rgb = MK.lossless([pic[..., k] for k in range(3)], [(1, 1)] * 3,
                          predictor=1)
        grey = MK.lossless([pic[..., 0]], [(1, 1)], predictor=2)
        if kind == "SOF11":
            rgb = rgb.replace(b"\xff\xc3", b"\xff\xcb", 1)
            grey = grey.replace(b"\xff\xc3", b"\xff\xcb", 1)
    files = []
    for j, photo, spp in ((rgb, 2, 3), (grey, 1, 1)):
        tables, strip = _jpeg_tables_split(j)
        files.append(fixtures.tiff_bytes(48, 32, 8, spp, photo, [strip],
                                         comp=7, tables=tables))
        files.append(fixtures.tiff_bytes(48, 32, 8, spp, photo, [j],
                                         comp=7))
    cut = rgb.index(b"\xff\xda")
    header, body = rgb[:cut], rgb[cut:]
    off = 160 + len(header) + 10
    blp = (b"BLP1" + struct.pack("<iIIIii", 0, 0, 48, 32, 5, 0)
           + struct.pack("<16I", off, *[0] * 15)
           + struct.pack("<16I", len(body), *[0] * 15)
           + struct.pack("<I", len(header)) + header + bytes(10) + body)
    for data, suffix in [(f, ".tif") for f in files] + [
            (blp, ".blp"), (fixtures.iptc_bytes(48, 32, payload=rgb), ".iptc"),
            (fixtures.iptc_bytes(48, 32, payload=grey), ".iptc")]:
        want, got = both(tmp_path, data, suffix)
        if kind == "SOF11":
            assert [want, got] == [-1, -1]
        else:
            assert not isinstance(want, int)
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ TIFF faults

def _libtiff():
    lt = ctypes.CDLL(glob.glob(os.path.join(LIBS, "libtiff-*"))[0])
    lt.TIFFOpen.restype = ctypes.c_void_p
    lt.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lt.TIFFStripSize.restype = ctypes.c_ssize_t
    lt.TIFFStripSize.argtypes = [ctypes.c_void_p]
    lt.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lt.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                        ctypes.c_void_p, ctypes.c_ssize_t]
    lt.TIFFClose.argtypes = [ctypes.c_void_p]
    return lt


def _strip_of(data: bytes) -> bytes:
    im = Image.open(io.BytesIO(data))
    off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    return data[off:off + n]


@pytest.mark.parametrize("t4", [0, 1])
def test_t4_data_that_ends_early_equals_libtiff(tmp_path, t4):
    """T.4 strips (1D, and 2D with T4Options 1) cut at 40 places and with
    25 seeded damages, decoded by scene/ccitt.py and by libtiff's own
    TIFFReadEncodedStrip: the same rows where libtiff succeeds, ValueError
    where it fails. A row whose EOL search runs off the end sends libtiff
    4.7 back to the strip's start without EOLs (tryG3WithoutEOL)."""
    lt = _libtiff()
    bw = Image.fromarray(MK.picture(29, 37, 13)).convert("1")
    kw = {"tiffinfo": {292: 1}} if t4 else {}
    strip = _strip_of(_pil(bw, "TIFF", compression="group3", **kw))
    g = np.random.default_rng(t4 + 17)
    variants = [strip[:c] for c in range(1, len(strip),
                                         max(1, len(strip) // 40))]
    for _ in range(25):
        d = bytearray(strip)
        for _ in range(int(g.integers(1, 4))):
            d[int(g.integers(0, len(d)))] = int(g.integers(0, 256))
        variants.append(bytes(d[:int(g.integers(len(d) // 3, len(d) + 1))]))
    path = tmp_path / "strip.tif"
    for v in variants:
        path.write_bytes(fixtures.tiff_bytes(
            37, 29, 1, 1, 1, [v], comp=3, tags=[(292, 4, [t4])] if t4 else []))
        tif = lt.TIFFOpen(str(path).encode(), b"r")
        buf = ctypes.create_string_buffer(lt.TIFFStripSize(tif))
        rc = lt.TIFFReadEncodedStrip(tif, 0, buf, -1)
        lt.TIFFClose(tif)
        try:
            got = ccitt.decode(v, 3, 37, 29, t4, 0)
        except ValueError:
            assert rc < 0, "the port failed where libtiff decodes"
            continue
        assert rc > 0, "the port decoded where libtiff fails"
        assert got == buf.raw[:len(got)]


def _pil(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("t4", [0, 1])
def test_t4_strips_keep_the_codec_mode(tmp_path, t4):
    """Four T.4 strips, one of them cut: once libtiff retries a strip
    without EOLs its codec keeps that mode for the image's later strips,
    and the port's RGBA equals PIL's wherever the cut falls."""
    pic = MK.picture(40, 37, 21)
    kw = {"tiffinfo": {292: 1}} if t4 else {}
    parts = [_strip_of(_pil(Image.fromarray(pic[k * 10:(k + 1) * 10])
                            .convert("1"), "TIFF", compression="group3",
                            **kw)) for k in range(4)]
    for which in range(4):
        for frac in (0.3, 0.6, 0.9):
            ps = list(parts)
            ps[which] = ps[which][:int(len(ps[which]) * frac)]
            data = fixtures.tiff_bytes(37, 40, 1, 1, 1, ps, comp=3, rps=10,
                                       tags=[(292, 4, [1])] if t4 else [])
            assert agree(tmp_path, data, ".tif"), (which, frac)


def _libzstd_stream(raw: bytes, occ: int):
    """libtiff's ZSTDDecode over PIL's bundled libzstd: ZSTD_decompressStream
    until the frame ends, the input is used or `occ` bytes are out; the
    bytes, or None where libtiff fails."""
    z = ctypes.CDLL(glob.glob(os.path.join(LIBS, "libzstd-*"))[0])

    class Buf(ctypes.Structure):
        _fields_ = [("p", ctypes.c_void_p), ("size", ctypes.c_size_t),
                    ("pos", ctypes.c_size_t)]
    z.ZSTD_createDStream.restype = ctypes.c_void_p
    z.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    z.ZSTD_decompressStream.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(Buf),
                                        ctypes.POINTER(Buf)]
    z.ZSTD_decompressStream.restype = ctypes.c_size_t
    z.ZSTD_isError.argtypes = [ctypes.c_size_t]
    z.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    ds = z.ZSTD_createDStream()
    z.ZSTD_initDStream(ds)
    src = ctypes.create_string_buffer(raw, len(raw))
    dst = ctypes.create_string_buffer(occ)
    ib = Buf(ctypes.cast(src, ctypes.c_void_p), len(raw), 0)
    ob = Buf(ctypes.cast(dst, ctypes.c_void_p), occ, 0)
    try:
        while True:
            r = z.ZSTD_decompressStream(ds, ctypes.byref(ob), ctypes.byref(ib))
            if z.ZSTD_isError(r):
                return None
            if not (r != 0 and ib.pos < ib.size and ob.pos < ob.size):
                break
    finally:
        z.ZSTD_freeDStream(ds)
    return dst.raw if ob.pos == occ else None


def test_zstd_frames_equal_libzstd():
    """Zstandard frames (raw blocks from PIL's TIFF writer; compressed
    blocks with and without checksum and content size from the zstandard
    package) with seeded bit flips, cuts and trailer damage, read into
    buffers of their size and a little less: the port gives libzstd's
    bytes, or fails where it fails. Among them a frame whose four literal
    streams libzstd reads back through one another (its fast Huffman
    path), so the last literal of the first stream comes from the bytes
    before it."""
    zstandard = pytest.importorskip("zstandard")
    img = np.asarray(Image.open(os.path.join(
        ASSETS, "kitchen_wood.png")).convert("RGB")).tobytes()
    frames = [(_strip_of(_pil(Image.fromarray(MK.picture(40, 56, 3)),
                              "TIFF", compression="zstd")), 6720)]
    for lvl, ck, cs, size in ((1, True, True, 6720), (19, True, False, 6720),
                              (5, False, False, 30000)):
        frames.append((zstandard.ZstdCompressor(
            level=lvl, write_checksum=ck, write_content_size=cs).compress(
                img[:size]), size))
    g = np.random.default_rng(29)
    bad = []
    for f, (fr, size) in enumerate(frames):
        for t in range(60):
            d = bytearray(fr)
            mode = int(g.integers(0, 3))
            if mode == 0:
                for _ in range(1 + int(g.integers(0, 2))):
                    d[int(g.integers(0, len(d)))] ^= 1 << int(g.integers(0, 8))
            elif mode == 1:
                d = d[:int(g.integers(1, len(d)))]
            else:
                d[int(g.integers(len(d) - 8, len(d)))] ^= 1 << int(
                    g.integers(0, 8))
            for occ in (size, size - 5):
                want = _libzstd_stream(bytes(d), occ)
                try:
                    got = zstd.decompress(bytes(d), occ)
                    got = got if len(got) >= occ else None
                except ValueError:
                    got = None
                if (want is None) != (got is None) or (
                        want is not None and want != got):
                    bad.append((f, t, occ))
    last = bytearray(frames[3][0])
    last[748] ^= 0x01
    want = _libzstd_stream(bytes(last), 30000)
    assert want is not None and want != img[:30000]
    assert zstd.decompress(bytes(last), 30000) == want
    assert not bad, f"cases {bad} differ from libzstd"


def test_damaged_ycbcr_strips_agree_with_pil(tmp_path):
    """YCbCr TIFFs read through libtiff's RGBA reader, Deflate (one strip
    and 8-row strips) and Zstandard, with seeded bit flips in a strip:
    libtiff ignores the failed read and converts its zeroed buffer as far
    as the codec wrote it (inflate's output before a data error, the
    Zstandard blocks before the failing one)."""
    zstandard = pytest.importorskip("zstandard")
    pic = MK.picture(37, 45, 7)
    h, w = pic.shape[:2]
    y = pic[..., 0]
    g = np.random.default_rng(31)
    cases = []
    for hs, vs in ((2, 2), (2, 1), (1, 1)):
        cb = g.integers(0, 256, (-(-h // vs), -(-w // hs)))
        cr = g.integers(0, 256, cb.shape)
        blk = fixtures.ycbcr_blocks(y, cb, cr, hs, vs)
        cases.append(fixtures.tiff_bytes(w, h, 8, 3, 6, [zlib.compress(blk)],
                                         comp=8, subsampling=[hs, vs]))
        cases.append(fixtures.tiff_bytes(
            w, h, 8, 3, 6, [zstandard.ZstdCompressor(
                level=3, write_content_size=False).compress(blk)],
            comp=50000, subsampling=[hs, vs]))
    cb = g.integers(0, 256, (-(-h // 2), -(-w // 2)))
    cr = g.integers(0, 256, cb.shape)
    cases.append(fixtures.tiff_bytes(w, h, 8, 3, 6, [zlib.compress(
        fixtures.ycbcr_blocks(y[r:r + 8], cb[r // 2:(r + 8) // 2],
                              cr[r // 2:(r + 8) // 2], 2, 2))
        for r in range(0, h, 8)], comp=8, subsampling=[2, 2], rps=8))
    bad = []
    for c, b in enumerate(cases):
        assert agree(tmp_path, b, ".tif")
        im = Image.open(io.BytesIO(b))
        offs, counts = im.tag_v2[273], im.tag_v2[279]
        for t in range(20):
            d = bytearray(b)
            k = int(g.integers(0, len(offs)))
            for _ in range(1 + int(g.integers(0, 2))):
                d[int(g.integers(offs[k], offs[k] + counts[k]))] ^= \
                    1 << int(g.integers(0, 8))
            if not agree(tmp_path, bytes(d), ".tif"):
                bad.append((c, t))
    assert not bad, f"cases {bad} differ from PIL"


def test_one_pass_zstd_ycbcr_strips_agree_with_pil(tmp_path):
    """YCbCr TIFFs whose Zstandard strip names its content size, so libzstd
    decodes it in one pass, with seeded bit flips in the strip: where
    libzstd fails in that pass it reports no output, and libtiff, which
    zeroes its buffer past the output position, converts a zeroed strip
    (the port used to give -1)."""
    zstandard = pytest.importorskip("zstandard")
    h, w = 37, 45
    g = np.random.default_rng(31)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 5 + yy * 3) % 256).astype(np.uint8)
    y[::7] = g.integers(0, 256, y[::7].shape)
    cases = []
    for hs, vs in ((2, 2), (2, 1), (1, 1)):
        cb = np.add.outer(np.arange(-(-h // vs)) * 3,
                          np.arange(-(-w // hs)) * 2) % 256
        blk = fixtures.ycbcr_blocks(y, cb, (255 - cb) // 2, hs, vs)
        cases.append(fixtures.tiff_bytes(
            w, h, 8, 3, 6, [zstandard.ZstdCompressor(
                level=3, write_content_size=True).compress(blk)],
            comp=50000, subsampling=[hs, vs]))
    bad, failed = [], 0
    for c, b in enumerate(cases):
        assert agree(tmp_path, b, ".tif")
        im = Image.open(io.BytesIO(b))
        off, count = im.tag_v2[273][0], im.tag_v2[279][0]
        for t in range(40):
            d = bytearray(b)
            for _ in range(1 + int(g.integers(0, 2))):
                d[int(g.integers(off + 6, off + count))] ^= \
                    1 << int(g.integers(0, 8))
            try:
                zstd.decompress(bytes(d[off:off + count]), 1 << 20)
            except ValueError:
                failed += 1
            if not agree(tmp_path, bytes(d), ".tif"):
                bad.append((c, t))
    assert failed >= 5, "too few damaged frames fail to test the repair"
    assert not bad, f"cases {bad} differ from PIL"


def test_cut_jpeg_tables_read_on_through_the_fake_eoi(tmp_path):
    """New-style JPEG TIFFs whose JPEGTables count cuts the field at every
    third byte: libtiff's source gives a fake EOI (FF D9) at each refill
    past the field, so a cut segment is read on through those bytes to its
    declared length and the tables end there. The port gives PIL's pixels,
    or -1 where PIL fails (a bogus DQT index or Huffman table), for
    both quality settings (it used to give -1 for every cut)."""
    pic = MK.picture(32, 48, 5)
    bad, read = [], 0
    for q in (90, 50):
        j = pil_jpeg(pic, quality=q, subsampling=0)
        j = j[:2] + j[4 + struct.unpack(">H", j[4:6])[0]:]  # no JFIF: RGB
        tables, strip = _jpeg_tables_split(j)
        for k in range(4, len(tables) - 2, 3):
            d = fixtures.tiff_bytes(48, 32, 8, 3, 2, [strip], comp=7,
                                    tables=tables[:k])
            want, got = both(tmp_path, d, ".tif")
            read += not isinstance(want, int)
            if isinstance(want, int) or isinstance(got, int):
                ok = isinstance(want, int) and isinstance(got, int)
            else:
                ok = np.array_equal(want, got)
            if not ok:
                bad.append((q, k))
    assert read >= 100, "too few cut tables that PIL reads"
    assert not bad, f"cuts {bad} differ from PIL"


def _pil_jpeg_strip(px, subsampling: int, jfif: bool) -> bytes:
    """PIL's JPEG of `px` at a subsampling code (0 4:4:4, 1 4:2:2 / 2x1,
    2 4:2:0 / 2x2), with or without its JFIF APP0 segment."""
    j = pil_jpeg(px, quality=90, subsampling=subsampling)
    if not jfif:
        i = j.index(b"\xff\xe0")
        j = j[:i] + j[i + 2 + struct.unpack(">H", j[i + 2:i + 4])[0]:]
    return j


def _factors(j: bytes, hv: int) -> bytes:
    """A grey JPEG whose one component claims sampling factors `hv`."""
    b = bytearray(j)
    b[b.index(b"\xff\xc0") + 11] = hv
    return bytes(b)


# name: (photometric, PlanarConfiguration, YCbCrSubSampling tag or None,
#        PIL's subsampling code or the planes' factors, JFIF, PIL decodes)
NEW_STYLE_CASES = {
    # libtiff passes every layout but chunky YCbCr through, whatever
    # markers the strip carries (the port once converted under a JFIF APP0)
    "RGB chunky with JFIF is passed through": (2, 1, None, 0, True, True),
    "RGB chunky without JFIF is passed through": (2, 1, None, 0, False,
                                                  True),
    "RGB planar with JFIF is passed through": (2, 2, None, 0x11, True, True),
    "RGB planar without JFIF is passed through": (2, 2, None, 0x11, False,
                                                  True),
    "YCbCr chunky with JFIF is converted": (6, 1, (1, 1), 0, True, True),
    # libtiff's JPEGPreDecode fails unless the first component has the
    # YCbCr subsampling (1x1 outside chunky YCbCr) and the others 1x1
    "RGB chunky sampled 2x2 fails": (2, 1, None, 2, True, False),
    "RGB chunky sampled 2x1 fails": (2, 1, None, 1, False, False),
    "RGB planar sampled 2x2 fails": (2, 2, None, 0x22, True, False),
    "RGB planar sampled 2x1 fails": (2, 2, None, 0x21, True, False),
    "YCbCr 2x2 under a 2x2 tag decodes": (6, 1, (2, 2), 2, True, True),
    "YCbCr 2x1 under a 2x1 tag decodes": (6, 1, (2, 1), 1, True, True),
    "YCbCr 2x2 under a 2x1 tag fails": (6, 1, (2, 1), 2, True, False),
    "YCbCr 2x1 under a 2x2 tag fails": (6, 1, (2, 2), 1, False, False),
    "YCbCr 1x1 under a 2x2 tag fails": (6, 1, (2, 2), 0, True, False),
    # without the tag libtiff takes the first strip's factors
    "YCbCr 2x1 without the tag decodes": (6, 1, None, 1, True, True),
    "YCbCr 2x2 without the tag decodes": (6, 1, None, 2, False, True),
}


@pytest.mark.parametrize("tables", [False, True], ids=["inline", "tables"])
@pytest.mark.parametrize("case", list(NEW_STYLE_CASES))
def test_new_style_jpeg_tiff_colour_and_sampling(tmp_path, case, tables):
    """New-style JPEG TIFFs as libtiff's JPEGPreDecode reads them for PIL
    (ROADMAP Queue 3 item 1): the colour spaces it sets (YCbCr to RGB for
    chunky YCbCr, every other layout passed through even where the
    strip's JPEG carries a JFIF marker) and the sampling factors it
    accepts (the YCbCrSubSampling tag's, or the first strip's where the
    tag is absent, for chunky YCbCr; 1x1 elsewhere), with the tables
    inline and as JPEGTables: the port's RGBA equals PIL's, or both give
    -1."""
    photo, planar, tag, sub, jfif, decodes = NEW_STYLE_CASES[case]
    px = MK.picture(32, 48, 7)
    if planar == 1:
        strips = [_pil_jpeg_strip(px, sub, jfif)]
    else:
        strips = [_factors(_pil_jpeg_strip(px[..., k], 0, jfif), sub)
                  for k in range(3)]
    kw = {}
    if tables:
        split = [_jpeg_tables_split(j) for j in strips]
        kw["tables"] = split[0][0]
        strips = [s for _, s in split]
    data = fixtures.tiff_bytes(48, 32, 8, 3, photo, strips, comp=7,
                               planar=planar, subsampling=tag, **kw)
    want, got = both(tmp_path, data, ".tif")
    assert isinstance(want, int) != decodes, "PIL's result is not the case's"
    if decodes:
        assert not isinstance(got, int), "the port failed where PIL decodes"
        np.testing.assert_array_equal(got, want)
    else:
        assert got == -1, "the port decoded where libtiff fails"


# ------------------------------------------------------------ render

def test_lossless_jpeg_kitchen_maps_equal_the_png_atlas():
    """The kitchen's three maps as the committed lossless JPEGs (SOF3,
    predictor 1, components 'R', 'G', 'B'): both pools read them as the
    PNG maps' pixels, byte for byte (the card's jpeg phase renders the
    kitchen from them)."""
    for name in ("kitchen_floor", "kitchen_floor_n", "kitchen_wood"):
        want = TexturePool()
        want.try_import(os.path.join(ASSETS, f"{name}.png"), "t")
        for pool in (JaxPool(), TexturePool()):
            assert pool.try_import(os.path.join(
                DATA, f"{name}.lossless.jpg"), "t") == 0
            np.testing.assert_array_equal(pool.textures[0].rgba,
                                          want.textures[0].rgba)


def test_lossless_jpeg_map_renders_like_jax(tmp_path):
    """A quad whose diffuse map is a committed lossless JPEG and whose
    bump map a grey PNG: the port's lockstep renders what the JAX
    package's does at 16², RTOL 1e-3 / ATOL 1e-4 on every pixel, from an
    atlas byte-equal to JAX's."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    from fluctus_tpu.core.types import AreaLight
    from fluctus_tpu.core.types import RenderConfig as JaxConfig
    from fluctus_tpu.render import driver as jax_driver
    from fluctus_tpu_torch.core.types import AreaLight as PortLight
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver
    with open(os.path.join(DATA, "lossless_p7.jpg"), "rb") as f:
        (tmp_path / "kd.jpg").write_bytes(f.read())
    Image.fromarray(MK.picture(16, 16, 2)[..., 1]).save(tmp_path / "bump.png")
    (tmp_path / "s.mtl").write_text(
        "newmtl m\nKd 0.8 0.8 0.8\nmap_Kd kd.jpg\nmap_bump bump.png\n")
    (tmp_path / "s.obj").write_text(
        "mtllib s.mtl\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\nusemtl m\n"
        "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
    light = dict(pos=[0.0, 0.0, 2.0], right=[1.0, 0.0, 0.0],
                 up=[0.0, 1.0, 0.0], normal=[0.0, 0.0, -1.0],
                 emission=[10.0, 10.0, 10.0], size=[0.5, 0.5])
    jcfg = JaxConfig(width=16, height=16, max_bounces=2, use_area_light=True,
                     use_env_map=False)
    js = jax_driver.create_session(str(tmp_path / "s.obj"), None, jcfg,
                                   cache_dir=None, state_dir=None)
    js.params = js.params.replace(area_light=AreaLight(
        **{k: jnp.asarray(v, jnp.float32) for k, v in light.items()}))
    s = driver.create_session(str(tmp_path / "s.obj"), None,
                              RenderConfig(width=16, height=16,
                                           max_bounces=2,
                                           use_area_light=True,
                                           use_env_map=False),
                              state_dir=None, device="cpu")
    s.params = dataclasses.replace(s.params, area_light=PortLight(
        **{k: torch.tensor(v) for k, v in light.items()}))
    assert s.host_scene.map_kd.tolist() == [-1, 0]
    np.testing.assert_array_equal(s.scene.atlas.data.numpy(),
                                  np.asarray(js.scene.atlas.data))
    want = np.asarray(jax_driver.render(js, 2, integrator="lockstep"))
    got = driver.render(s, 2, integrator="lockstep").numpy()
    assert float(want.mean()) > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_kitchen_from_lossless_jpeg_maps_renders_like_jax(tmp_path):
    """The kitchen (BASELINE config 3) from a temporary MTL that names the
    committed lossless-JPEG copies of its three maps, its camera and light
    from data/states, rendered by the port's lockstep at 64², 8 bounces,
    4 spp on the CPU: held against the JAX package's render of the PNG
    kitchen (the kitchen_cfg3 golden) as test_golden_kitchen_cfg3 holds the
    PNG kitchen (≥ 99.5 % of pixels within RTOL 1e-3 / ATOL 1e-4, mean
    relative error ≤ 1e-4; ROADMAP Queue 3 item 3)."""
    from golden_common import ATOL, RTOL, golden_path
    from torch_common import golden_stats

    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.render.state import load_state
    kitchen = os.path.join(ASSETS, "kitchen_proxy.obj")
    obj = tmp_path / "kitchen_proxy.obj"
    os.symlink(os.path.abspath(kitchen), obj)
    with open(os.path.splitext(kitchen)[0] + ".mtl") as f:
        mtl = f.read()
    for name in ("kitchen_floor_n", "kitchen_floor", "kitchen_wood"):
        mtl = mtl.replace(f" {name}.png", " " + os.path.join(
            DATA, f"{name}.lossless.jpg"))
    assert ".png" not in mtl
    (tmp_path / "kitchen_proxy.mtl").write_text(mtl)
    cfg = RenderConfig(width=64, height=64, use_area_light=True,
                       use_env_map=False, max_bounces=8)
    s = driver.create_session(str(obj), cfg=cfg, state_dir=None,
                              auto_frame=False, device="cpu")
    s.params = load_state(s.params, "c68e332cfae81cc6",
                          state_dir=os.path.join(ASSETS, "..", "data",
                                                 "states"))
    img = driver.render(s, 4).numpy()
    gold = np.load(golden_path("kitchen_cfg3"))["img"]
    assert img.shape == gold.shape and np.isfinite(img).all()
    share, mean_rel = golden_stats(img, gold, RTOL, ATOL)
    assert share >= 0.995, share
    assert mean_rel <= 1e-4, mean_rel
