"""PIL's last raster test formats on the port: the PNM test formats
(P0CMYK, PyCMYK, PyRGBA, PyP), every IM image type PIL's ImImagePlugin
names, and IPTC band records holding images other than JPEG, each held
against PIL 12.1.0's `Image.open(...).convert("RGBA")` byte for byte (or
-1 where PIL fails) and through both texture pools. The files of
tests/data/raster (make_raster_data.py) carry PIL's SHA-256 to the card's
machine, which has no PIL."""
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from fluctus_tpu.scene.textures import TexturePool as JaxPool
from fluctus_tpu_torch import fixtures
from fluctus_tpu_torch.scene import im, imageformat, iptc, pnm
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.textures import TexturePool

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "raster")
RECORD = json.load(open(os.path.join(DATA, "raster.json")))


def pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception:
        return -1


def port(decode, data: bytes):
    try:
        return decode(data)
    except ValueError:
        return -1


def assert_agrees(want, got):
    if isinstance(want, int):
        assert isinstance(got, int), "PIL fails where the port decodes"
        return
    assert not isinstance(got, int), "the port fails where PIL decodes"
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(RECORD["files"]))
def test_committed_raster_files(tmp_path, name):
    """Each file of tests/data/raster: PIL's RGBA has the recorded
    SHA-256, so has the port's through the texture dispatch, and both
    texture pools hold the same rows."""
    entry = RECORD["files"][name]
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"]
    want = pil(data)
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    got = imageformat.decode(data, imageformat.sniff(data))
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    path = tmp_path / name
    path.write_bytes(data)
    rows = []
    for pool in (JaxPool(), TexturePool()):
        assert pool.try_import(str(path), "t") == 0
        rows.append(pool.textures[0].rgba)
    np.testing.assert_array_equal(rows[1], rows[0])


@pytest.mark.parametrize("maxval", [255, 100, 300, 65535, 1])
@pytest.mark.parametrize("magic", [b"P0CMYK", b"PyCMYK", b"PyRGBA", b"PyP"])
def test_pnm_test_formats(magic, maxval):
    """PIL's PNM test formats at raw and scaled maxvals, whole and cut
    short."""
    g = np.random.default_rng(maxval)
    bands = 1 if magic == b"PyP" else 4
    w, h = 5, 3
    v = g.integers(0, maxval + 1, w * h * bands)
    px = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    for cut in (0, 3):
        data = b"%s\n%d %d\n%d\n" % (magic, w, h, maxval) + px[:len(px) - cut]
        assert_agrees(pil(data), port(pnm.decode_pnm, data))


def _im(kind: str, w: int, h: int, body: bytes, lut: bytes = b"") -> bytes:
    head = (f"Image type: {kind}\r\nImage size (x*y): {w}*{h}\r\n"
            + ("Lut: 1\r\n" if lut else "")).encode()
    return head + b"\0" * (512 - len(head) - 1) + b"\x1a" + lut + body


@pytest.mark.parametrize("kind", sorted(im._OPEN))
def test_im_types(kind):
    """Every image type of PIL's ImImagePlugin, on seeded bytes at two
    sizes, whole and cut short: PIL's RGBA, or -1 in both where PIL has
    no unpacker ("PA", "RLB", "RYB") or the data ends early."""
    g = np.random.default_rng(len(kind))
    for w, h in ((7, 5), (13, 3)):
        body = g.integers(0, 256, w * h * 16, dtype=np.uint8).tobytes()
        for n in (len(body), w * h // 2):
            data = _im(kind, w, h, body[:n])
            assert_agrees(pil(data), port(im.decode_im, data))


@pytest.mark.parametrize("kind", ["B2 image", "B4 image"])
def test_im_palette_types_with_a_lut(kind):
    """B2 and B4 with a colour lookup table: PIL reads them as 8-bit
    palette images through it, as the port does."""
    g = np.random.default_rng(4)
    lut = g.integers(0, 256, 768, dtype=np.uint8).tobytes()
    data = _im(kind, 7, 5, bytes(range(64)), lut)
    assert_agrees(pil(data), port(im.decode_im, data))


def _save(img, fmt):
    buf = io.BytesIO()
    img.save(buf, fmt)
    return buf.getvalue()


def _payloads():
    g = np.random.default_rng(5)
    grey = Image.fromarray(g.integers(0, 256, (13, 17), dtype=np.uint8))
    return {
        "pgm": _save(grey, "PPM"),
        "pgm maxval 300": b"P5\n17 13\n300\n" + g.integers(
            0, 301, 17 * 13).astype(">u2").tobytes(),
        "ppm": _save(grey.convert("RGB"), "PPM"),
        "png grey": _save(grey, "PNG"),
        "png 1-bit": _save(grey.convert("1"), "PNG"),
        "png RGB": _save(grey.convert("RGB"), "PNG"),
        "png palette": _save(grey.convert("P"), "PNG"),
        "png 16-bit": _save(grey.convert("I;16"), "PNG"),
        "qoi": _save(grey.convert("RGB"), "QOI"),
    }


# a first band of PIL's mode P or I;16, which Image.merge copies byte for
# byte, or I, on which PIL crashes: still refused
REFUSED = {("png palette", 0), ("png 16-bit", 0), ("pgm maxval 300", 0)}


@pytest.mark.parametrize("band", [0, 1, 2])
@pytest.mark.parametrize("payload", list(_payloads()))
def test_iptc_band_records(payload, band):
    """IPTC band records of 3 and 4 layers holding PNM, PNG and QOI
    images: Image.merge takes greyscale bands, and a first band of any
    one-byte-a-pixel mode; the rest fails in PIL and gives -1 here."""
    body = _payloads()[payload]
    for layers in (3, 4):
        data = fixtures.iptc_bytes(17, 13, layers=layers, band=band,
                                   payload=body)
        if (payload, band) in REFUSED:
            with pytest.raises(UnsupportedImage, match="IPTC band records"):
                iptc.decode_iptc(data)
            continue
        assert_agrees(pil(data), port(iptc.decode_iptc, data))
