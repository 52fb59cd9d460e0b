"""JPEG 2000: the port's TexturePool (scene/jpeg2000.py over
native/j2k.cpp) against the JAX package's (PIL 12's
`Image.open(...).convert("RGBA")` through OpenJPEG 2.5.4) on the same
files, byte for byte.

Files are written into tmp_path with PIL: every option of its encoder
(reversible and irreversible, raw codestreams, tiles and their offsets,
resolutions, quality layers, the five progression orders, code-block and
precinct sizes, the colour transform on and off, image offsets, signed
samples) in modes L, LA, RGB, RGBA, I;16 and CMYK at 1x1, 17x13 and
64x64; JP2 header boxes PIL does not write are built around PIL's
codestreams (fixtures.jp2_bytes: every enumerated colour space, ICC
profiles, `pclr` palettes of 3 and 4 columns with repeated colours,
`cdef`, an ihdr that disagrees with the codestream), and OpenJPEG's own
encoder (tests/data/j2k/make_j2k_data.encode, through ctypes on PIL's
bundled libopenjp2) writes codestreams with every code-block style, POC,
SOP/EPH, RGN, tile-parts, subsampled components and other precisions.
Truncated files are -1 in both pools. The files of tests/data/j2k are
held against PIL and against the SHA-256 recorded beside them, which is
what the machine with the card, which has no PIL, checks; the kitchen's
reversible JP2 maps equal their PNGs.
"""
import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from fluctus_tpu.scene.textures import TexturePool as JaxPool
from fluctus_tpu_torch import fixtures
from fluctus_tpu_torch.scene.textures import TexturePool

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "j2k")
ASSETS = os.path.join(os.path.dirname(DATA), "..", "..", "assets")


def _make_data():
    spec = importlib.util.spec_from_file_location(
        "make_j2k_data", os.path.join(DATA, "make_j2k_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(path):
    """(JAX pool's RGBA or -1, port pool's RGBA or -1)."""
    out = []
    for pool in (JaxPool(), TexturePool()):
        i = pool.try_import(str(path), "t")
        out.append(i if i < 0 else pool.textures[i].rgba)
    return out


def same_or_both_fail(path, must_read=True):
    want, got = both(path)
    if isinstance(want, int):
        assert not must_read, "PIL could not read the file"
        assert got == -1
        return
    assert not isinstance(got, int), "the port gave -1 where PIL reads"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def picture(h, w, seed):
    """Seeded RGBA of gradients, edges and noise."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                   (x * y) % 256, 128 + 100 * np.sin(x / 5.0)], -1)
    return np.clip(px + g.integers(-24, 25, px.shape), 0, 255).astype(
        np.uint8)


def image(mode, h, w, seed=0):
    px = picture(h, w, seed)
    if mode == "I;16":
        return Image.fromarray((px[..., 0].astype(np.uint16) * 257
                                + px[..., 1]).astype(np.uint16))
    if mode == "CMYK":
        return Image.frombytes("CMYK", (w, h), px.tobytes())
    return Image.fromarray(px, "RGBA").convert(mode)


def j2k(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


MODES = ("L", "LA", "RGB", "RGBA", "I;16", "CMYK")
SIZES = ((1, 1), (17, 13), (64, 64))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_modes_and_sizes(tmp_path, mode, size):
    """Each mode PIL writes, at each size, reversible and irreversible,
    as JP2 and as a raw codestream."""
    w, h = size
    im = image(mode, h, w, seed=w)
    for k, kw in enumerate((dict(), dict(irreversible=True),
                            dict(no_jp2=True),
                            dict(no_jp2=True, irreversible=True))):
        path = tmp_path / f"t{k}.jp2"
        path.write_bytes(j2k(im, **kw))
        same_or_both_fail(path)


OPTIONS = {
    "tiles 16x16": dict(tile_size=(16, 16)),
    "tiles 24x20, tile offset": dict(tile_size=(24, 20), offset=(3, 5),
                                     tile_offset=(1, 2)),
    "image offset": dict(offset=(7, 3), tile_size=(40, 40)),
    "1 resolution": dict(num_resolutions=1),
    "3 resolutions": dict(num_resolutions=3),
    "layers 40, 10, lossless": dict(quality_layers=[40, 10, 0]),
    "irreversible layers 60, 20": dict(quality_layers=[60, 20],
                                       irreversible=True),
    "dB layers": dict(quality_mode="dB", quality_layers=[30, 45],
                      irreversible=True),
    "LRCP": dict(progression="LRCP", quality_layers=[30, 0]),
    "RLCP": dict(progression="RLCP", quality_layers=[30, 0]),
    "RPCL": dict(progression="RPCL", precinct_size=(32, 32)),
    "PCRL": dict(progression="PCRL", precinct_size=(32, 32),
                 quality_layers=[30, 0]),
    "CPRL": dict(progression="CPRL", precinct_size=(32, 32)),
    "code-blocks 16x16": dict(codeblock_size=(16, 16)),
    "code-blocks 4x64": dict(codeblock_size=(4, 64)),
    "precincts 32x32, code-blocks 8x8": dict(precinct_size=(32, 32),
                                             codeblock_size=(8, 8)),
    "precincts 16x16, code-blocks 16x16": dict(precinct_size=(16, 16),
                                               codeblock_size=(16, 16)),
    "colour transform": dict(mct=1),
    "colour transform, irreversible": dict(mct=1, irreversible=True),
    "signed": dict(signed=True),
    "signed irreversible": dict(signed=True, irreversible=True),
    "PLT markers and a comment": dict(plt=True, comment="fluctus"),
    "cinema 2K": dict(cinema_mode="cinema2k-24"),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_pil_encoder_options(tmp_path, name):
    """PIL's encoder options on a 64x48 picture in L, RGB and RGBA (and
    CMYK where the option allows it); a file PIL cannot read back is -1
    in both pools."""
    for mode in ("L", "RGB", "RGBA", "CMYK"):
        im = image(mode, 48, 64, seed=len(name))
        try:
            data = j2k(im, **OPTIONS[name])
        except (OSError, ValueError):
            continue                 # PIL's encoder refuses the option
        path = tmp_path / f"{mode}.jp2"
        path.write_bytes(data)
        same_or_both_fail(path, must_read=False)


def _boxes_cases():
    g = np.random.default_rng(3)
    grey = j2k(Image.fromarray(g.integers(0, 6, (13, 17), np.uint8)),
               no_jp2=True)
    rgb = j2k(image("RGB", 13, 17, 4), no_jp2=True)
    rgba = j2k(image("RGBA", 13, 17, 5), no_jp2=True)
    la = j2k(image("LA", 13, 17, 6), no_jp2=True)
    pal = g.integers(0, 256, (6, 3))
    pal[3] = pal[1]                             # merged by getcolor
    pal4 = g.integers(0, 256, (6, 4))
    cases = {
        "pclr 3 columns with cmap": fixtures.jp2_bytes(
            grey, 17, 13, 1, pclr=pal, cmap=[(0, 1, k) for k in range(3)]),
        "pclr without cmap": fixtures.jp2_bytes(grey, 17, 13, 1, pclr=pal),
        "pclr 4 columns": fixtures.jp2_bytes(grey, 17, 13, 1, pclr=pal4),
        "pclr 2 columns": fixtures.jp2_bytes(grey, 17, 13, 1,
                                             pclr=pal[:, :2]),
        "pclr of LA": fixtures.jp2_bytes(la, 17, 13, 2, pclr=pal),
        "grey sRGB colr": fixtures.jp2_bytes(grey, 17, 13, 1, colr=(1, 16)),
        "grey ICC colr": fixtures.jp2_bytes(grey, 17, 13, 1,
                                            colr=(2, b"prof")),
        "grey without colr": fixtures.jp2_bytes(grey, 17, 13, 1, colr=None),
        "grey colr method 3": fixtures.jp2_bytes(grey, 17, 13, 1,
                                                 colr=(3, 17)),
        "second colr ignored": fixtures.jp2_bytes(
            grey, 17, 13, 1, jp2h_extra=fixtures.jp2_box(
                b"colr", bytes([1, 0, 0, 0, 0, 0, 16]))),
        "RGB cdef": fixtures.jp2_bytes(rgb, 17, 13, 3, cdef=[
            (0, 0, 3), (1, 0, 2), (2, 0, 1)]),
        "ihdr larger": fixtures.jp2_bytes(rgb, 20, 15, 3),
        "ihdr smaller": fixtures.jp2_bytes(rgb, 10, 15, 3),
        "ihdr 1 component over 3": fixtures.jp2_bytes(rgb, 17, 13, 1),
    }
    for enumcs in (16, 17, 18, 24, 12, 99):
        for n, cs in ((1, grey), (3, rgb), (4, rgba)):
            cases[f"colr {enumcs}, {n} components"] = fixtures.jp2_bytes(
                cs, 17, 13, n, colr=(1, enumcs))
    cases["RGB ICC colr"] = fixtures.jp2_bytes(rgb, 17, 13, 3,
                                               colr=(2, b"icc"))
    return cases


BOXES = _boxes_cases()


@pytest.mark.parametrize("name", list(BOXES))
def test_jp2_boxes(tmp_path, name):
    """JP2 header boxes PIL does not write: PIL's mode (ihdr, colr CMYK,
    pclr through getcolor) and OpenJPEG's colour space (the first colr;
    ICC, unknown and absent spaces taken as unspecified) pick PIL's
    unpacker, or none (-1 in both pools)."""
    path = tmp_path / "t.jp2"
    path.write_bytes(BOXES[name])
    same_or_both_fail(path, must_read=False)


def _opj_cases():
    enc = _make_data().encode
    px = picture(29, 37, 9).astype(np.int32)
    rgb = [px[..., k] for k in range(3)]
    cases = {}
    for bits in (1, 2, 4, 8, 16, 32, 63):
        cases[f"style {bits}"] = dict(planes=rgb, mode=bits,
                                      layers=(40, 10, 0))
        cases[f"style {bits} 9/7"] = dict(planes=rgb, mode=bits,
                                          irreversible=1, mct=1,
                                          layers=(40, 12))
    cases["POC LRCP then CPRL"] = dict(planes=rgb, layers=(20, 0), pocs=[
        (1, 0, 0, 2, 2, 3, 0), (1, 2, 0, 2, 3, 3, 4)])
    cases["POC RLCP, PCRL"] = dict(planes=rgb, layers=(20, 0), pocs=[
        (1, 0, 0, 1, 3, 3, 1), (1, 0, 0, 2, 3, 3, 3)])
    cases["SOP and EPH"] = dict(planes=rgb, csty=6, layers=(20, 0))
    cases["ROI shift 4"] = dict(planes=rgb, roi=(0, 4))
    cases["ROI shift 7, 9/7"] = dict(planes=rgb, roi=(2, 7), irreversible=1)
    cases["tile-parts by resolution"] = dict(planes=rgb, tile=(16, 16),
                                             tp="R")
    cases["tile-parts by layer"] = dict(planes=rgb, tp="L", layers=(20, 0))
    cases["4:2:0 sYCC"] = dict(planes=[px[..., 0], px[::2, ::2, 1],
                                       px[::2, ::2, 2]], dx=[1, 2, 2],
                               dy=[1, 2, 2])
    cases["4:2:2 9/7"] = dict(planes=[px[..., 0], px[:, ::2, 1],
                                      px[:, ::2, 2]], dx=[1, 2, 2],
                              dy=[1, 1, 1], irreversible=1)
    for prec in (1, 4, 7, 9, 12, 16, 24):
        for sgnd in (0, 1):
            v = px[..., 0].astype(np.int64) * (1 << prec) // 256
            if sgnd:
                v -= 1 << (prec - 1)
            cases[f"{prec}-bit grey{' signed' if sgnd else ''}"] = dict(
                planes=[v], prec=prec, sgnd=sgnd)
            cases[f"{prec}-bit RGB{' signed' if sgnd else ''} 9/7"] = dict(
                planes=[v, v // 2, v // 3], prec=prec, sgnd=sgnd,
                irreversible=1, mct=1)
    return cases


OPJ = _opj_cases()


@pytest.mark.parametrize("name", list(OPJ))
def test_openjpeg_encoder_codestreams(tmp_path, name):
    """Codestreams of OpenJPEG's own encoder with what PIL's does not
    emit: the code-block styles BYPASS (1), RESET (2), TERMALL (4),
    VCAUSAL (8), PTERM (16), SEGSYM (32) and all six, in both wavelets;
    POC, SOP / EPH, RGN, tile-parts, subsampled components and
    precisions from 1 to 24 bits, signed and unsigned."""
    path = tmp_path / "t.j2k"
    path.write_bytes(_make_data().encode(**OPJ[name]))
    same_or_both_fail(path, must_read=False)


with open(os.path.join(DATA, "j2k.json")) as _f:
    RECORD = json.load(_f)


@pytest.mark.parametrize("name", sorted(RECORD["files"]))
def test_committed_files(name):
    """tests/data/j2k: the port's RGBA equals PIL's and the SHA-256
    recorded beside the file (what chip_smoke.py checks on the card)."""
    path = os.path.join(DATA, name)
    same_or_both_fail(path)
    pool = TexturePool()
    assert pool.try_import(path, name) == 0
    rgba = np.ascontiguousarray(pool.textures[0].rgba[::-1])
    rec = RECORD["files"][name]
    assert list(rgba.shape) == rec["shape"]
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == rec["sha256"]


@pytest.mark.parametrize("name", ["kitchen_floor", "kitchen_floor_n",
                                  "kitchen_wood"])
def test_kitchen_maps_equal_their_pngs(name):
    """The reversible JP2 copies of the kitchen's maps load into the same
    texture as the PNGs."""
    a, b = TexturePool(), TexturePool()
    assert a.try_import(os.path.join(DATA, f"{name}.jp2"), name) == 0
    assert b.try_import(os.path.join(ASSETS, f"{name}.png"), name) == 0
    np.testing.assert_array_equal(a.textures[0].rgba, b.textures[0].rgba)


def _truncations():
    rgb = image("RGB", 29, 37, 11)
    out = {}
    for label, kw in (("JP2", {}), ("tiles", dict(tile_size=(16, 16))),
                      ("layers", dict(quality_layers=[30, 0],
                                      no_jp2=True))):
        data = j2k(rgb, **kw)
        for cut in (30, len(data) // 3, len(data) // 2, len(data) - 1):
            out[f"{label} cut at {cut} of {len(data)}"] = data[:cut]
    tp = _make_data().encode([picture(29, 37, 3)[..., k].astype(np.int32)
                              for k in range(3)], tile=(16, 16), tp="R")
    sots = [i for i in range(len(tp) - 1) if tp[i:i + 2] == b"\xff\x90"]
    out["tile-parts: after the second SOT"] = tp[:sots[1] + 2]
    return out


TRUNC = _truncations()


@pytest.mark.parametrize("name", list(TRUNC))
def test_truncated_is_minus_one_in_both(tmp_path, name):
    """Files cut inside a header, a tile-part or the EOC: OpenJPEG's
    strict mode fails them and PIL gives -1; so does the port."""
    path = tmp_path / "t.jp2"
    path.write_bytes(TRUNC[name])
    assert both(path) == [-1, -1]


def test_truncated_after_a_whole_tile_keeps_what_was_read(tmp_path):
    """A stream that ends right after a complete tile and the next SOT
    marker: OpenJPEG decodes the tiles it has and PIL leaves the rest 0;
    the port does the same."""
    data = j2k(image("RGB", 29, 37, 12), tile_size=(16, 16), no_jp2=True)
    sots = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\x90"]
    path = tmp_path / "t.j2k"
    path.write_bytes(data[:sots[2] + 2])
    want, got = both(path)
    assert not isinstance(want, int)
    np.testing.assert_array_equal(got, want)
    assert (want[..., :3] == 0).all(axis=-1).any()


def _random_codestreams(seed: int, n: int):
    """`n` seeded OpenJPEG encoder settings: size, components, precision,
    signedness, 4:2:x subsampling, wavelet, colour transform, code-block
    style, SOP/EPH, progression, layers, resolutions, code-block size,
    tiles, a region of interest (the tiles and resolutions kept large
    enough for the encoder's 9/7 to run)."""
    g = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        w, h = int(g.integers(16, 80)), int(g.integers(16, 64))
        nc = int(g.choice([1, 2, 3, 4]))
        prec = int(g.choice([1, 2, 5, 8, 8, 10, 12, 16]))
        sg = int(g.integers(0, 2))
        sub = nc >= 3 and g.random() < 0.3
        dx = [1, 2, 2] + [1] * (nc - 3) if sub else [1] * nc
        vs = int(g.choice([1, 2]))
        dy = [1, vs, vs] + [1] * (nc - 3) if sub else [1] * nc
        lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if sg else (
            0, 1 << prec)
        planes = []
        for k in range(nc):
            hh, ww = -(-h // dy[k]), -(-w // dx[k])
            y, x = np.mgrid[0:hh, 0:ww]
            base = (x * 7 + y * 3 + k * 50) % (hi - lo) + lo
            planes.append(np.where(g.random((hh, ww)) < 0.3, g.integers(
                lo, hi, (hh, ww)), base))
        tile = (int(g.integers(24, 64)), int(g.integers(24, 64))) \
            if g.random() < 0.3 else None
        side = min(w, h, *(tile or ()))
        layers = sorted({float(g.choice([0, 5, 20, 60]))
                         for _ in range(int(g.integers(1, 4)))},
                        reverse=True)
        out.append(dict(
            planes=planes, prec=prec, sgnd=sg, dx=dx, dy=dy,
            irreversible=int(g.integers(0, 2)),
            mct=int(nc >= 3 and not sub and g.random() < 0.5),
            mode=int(g.integers(0, 64)) if g.random() < 0.5 else 0,
            csty=int(g.choice([0, 2, 4, 6])), prog=int(g.integers(0, 5)),
            layers=tuple(layers),
            numres=int(g.integers(1, max(2, side.bit_length() - 3))),
            cblk=(int(g.choice([4, 8, 16, 32, 64])),
                  int(g.choice([4, 8, 16, 32, 64]))),
            tile=tile, roi=(0, int(g.integers(1, 8)))
            if g.random() < 0.2 else None))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_random_openjpeg_codestreams(tmp_path, seed):
    """Seeded random settings of OpenJPEG's encoder, ten a seed: the
    port's RGBA equals PIL's, or both give -1; a subsampled tile PIL reads
    past its buffer raises UnsupportedImage instead."""
    from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
    enc = _make_data().encode
    for k, kw in enumerate(_random_codestreams(seed, 10)):
        path = tmp_path / f"{k}.j2k"
        path.write_bytes(enc(**kw))
        try:
            same_or_both_fail(path, must_read=False)
        except UnsupportedImage as e:
            assert "past its buffer" in str(e)
