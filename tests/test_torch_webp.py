"""WebP: the port's TexturePool (scene/webp.py over native/webp.cpp)
against the JAX package's (PIL 12's `Image.open(...).convert("RGBA")`
through libwebp's WebPAnimDecoder) on the same files, byte for byte.

Files are written into tmp_path with PIL (lossless at every method, with
and without alpha; lossy at qualities 0, 50 and 100, each method, alpha
qualities; 1x1, 17x13 and 256x256; ICC and EXIF chunks in VP8X) or built
by hand around bitstreams PIL writes (raw and VP8L-compressed ALPH chunks
with each of the four filters, an animation whose first frame is drawn at
an offset, a VP8L header whose alpha bit is 0 over pixels that are not
opaque, truncated and damaged files, which are -1 in both). The files of
tests/data/webp (made by its make_webp_data.py, with libwebp options PIL
does not expose: token partitions, segments, the simple filter,
sharpness) are held against PIL and against the SHA-256 recorded beside
them, which is what the machine with the card, which has no PIL, checks.
"""
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from fluctus_tpu.scene.textures import TexturePool as JaxPool
from fluctus_tpu_torch.scene.textures import TexturePool
from fluctus_tpu_torch.scene.webp import decode_webp

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "webp")


def picture(h, w, seed, alpha=True):
    """Seeded RGBA (or RGB) of gradients, edges and noise."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                   (x * y) % 256, 128 + 100 * np.sin(x / 5.0)], -1)
    px = np.clip(px + g.integers(-24, 25, px.shape), 0, 255)
    img = Image.fromarray(px.astype(np.uint8), "RGBA")
    return img if alpha else img.convert("RGB")


def webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "WEBP", **kw)
    return buf.getvalue()


def both(tmp_path, data: bytes):
    """(JAX pool's RGBA or -1, port pool's RGBA or -1) of one file."""
    path = tmp_path / "t.webp"
    path.write_bytes(data)
    out = []
    for pool in (JaxPool(), TexturePool()):
        i = pool.try_import(str(path), "t")
        out.append(i if i < 0 else pool.textures[i].rgba)
    return out


def assert_same(tmp_path, data: bytes):
    want, got = both(tmp_path, data)
    assert not isinstance(want, int), "PIL could not read the file"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    return (fourcc + struct.pack("<I", len(payload)) + payload
            + bytes(len(payload) & 1))


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def chunks(data: bytes) -> dict:
    """{fourcc: payload} of a RIFF WebP's top-level chunks."""
    out, i = {}, 12
    while i + 8 <= len(data):
        n = struct.unpack_from("<I", data, i + 4)[0]
        out[data[i:i + 4]] = data[i + 8:i + 8 + n]
        i += 8 + n + (n & 1)
    return out


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize("method", range(7))
def test_lossless_methods(tmp_path, method, alpha):
    img = picture(29, 37, method, alpha)
    assert_same(tmp_path, webp(img, lossless=True, method=method,
                               exact=True))


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 50, 100])
def test_lossy_quality_and_method(tmp_path, quality, method):
    img = picture(45, 61, quality + method, alpha=False)
    assert_same(tmp_path, webp(img, quality=quality, method=method))


@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
def test_lossy_alpha_quality(tmp_path, alpha_quality):
    """Lossy with alpha: a VP8X, an ALPH chunk (VP8L-compressed, levels
    quantised below 100) and the VP8 frame."""
    img = picture(45, 61, alpha_quality)
    assert_same(tmp_path, webp(img, quality=70, alpha_quality=alpha_quality,
                               method=4))


def _lossy_frame(w, h, seed) -> bytes:
    return chunks(webp(picture(h, w, seed, alpha=False), quality=70))[
        b"VP8 "]


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "vp8l"])
@pytest.mark.parametrize("alpha_filter", range(4),
                         ids=["none", "horizontal", "vertical", "gradient"])
def test_alpha_filters(tmp_path, alpha_filter, compressed):
    """ALPH chunks with each filter, raw or as a headerless VP8L stream
    (a lossless file's stream of the same width and height without its
    5 header bytes), before a lossy frame PIL wrote."""
    w, h = 23, 19
    a = np.random.default_rng(alpha_filter).integers(0, 256, (h, w),
                                                      dtype=np.uint8)
    if compressed:
        green = np.stack([a * 0, a, a * 0], -1).astype(np.uint8)
        stream = chunks(webp(Image.fromarray(green), lossless=True))[
            b"VP8L"][5:]
        alph = bytes([1 | alpha_filter << 2]) + stream
    else:
        alph = bytes([alpha_filter << 2]) + a.tobytes()
    data = riff(vp8x(0x10, w, h) + chunk(b"ALPH", alph)
                + chunk(b"VP8 ", _lossy_frame(w, h, 5)))
    assert_same(tmp_path, data)


@pytest.mark.parametrize("size", [(1, 1), (17, 13), (256, 256)],
                         ids=["1x1", "17x13", "256x256"])
@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "lossy"])
def test_sizes(tmp_path, size, lossless):
    img = picture(size[1], size[0], size[0])
    kw = dict(lossless=True) if lossless else dict(quality=75)
    assert_same(tmp_path, webp(img, **kw))


@pytest.mark.parametrize("flags", [0x12, 0x02], ids=["alpha", "no alpha"])
@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "lossy"])
def test_animation_offset_first_frame(tmp_path, lossless, flags):
    """ANIM and two ANMF frames: the first, 20x14, at offset (6, 4) of a
    40x30 canvas; PIL gives it on transparent black (its mode RGB when
    the VP8X flags carry no alpha)."""
    kw = dict(lossless=True) if lossless else dict(quality=60)
    first = chunks(webp(picture(14, 20, 2), **kw))
    inner = b"".join(chunk(c, first[c]) for c in (b"ALPH", b"VP8 ", b"VP8L")
                     if c in first)
    second = chunk(b"VP8L", chunks(webp(picture(30, 40, 3),
                                        lossless=True))[b"VP8L"])

    def anmf(x, y, w, h, body):
        return chunk(b"ANMF", b"".join(v.to_bytes(3, "little") for v in (
            x // 2, y // 2, w - 1, h - 1, 100)) + b"\0" + body)

    data = riff(vp8x(flags, 40, 30) + chunk(b"ANIM", bytes(6))
                + anmf(6, 4, 20, 14, inner) + anmf(0, 0, 40, 30, second))
    assert_same(tmp_path, data)


@pytest.mark.parametrize("lossless", [True, False],
                         ids=["lossless", "lossy"])
def test_vp8x_icc_exif_xmp(tmp_path, lossless):
    """VP8X with ICCP, EXIF and XMP chunks, which the decoder skips."""
    kw = dict(lossless=True) if lossless else dict(quality=80)
    assert_same(tmp_path, webp(picture(33, 27, 4), icc_profile=b"i" * 99,
                               exif=b"Exif\0\0" + b"e" * 40,
                               xmp=b"<x:xmpmeta/>", **kw))


def test_vp8l_alpha_bit_clear(tmp_path):
    """A simple VP8L file whose header says no alpha over pixels that
    are not opaque: PIL's mode is RGB, the decoded alpha is dropped."""
    data = bytearray(webp(picture(21, 33, 6), lossless=True))
    assert data[12:16] == b"VP8L"
    bits = struct.unpack_from("<I", data, 21)[0]
    struct.pack_into("<I", data, 21, bits & ~(1 << 28))
    want, got = both(tmp_path, bytes(data))
    assert (want[..., 3] == 255).all()
    np.testing.assert_array_equal(got, want)


def _damaged():
    lossy = webp(picture(48, 64, 7), quality=50)
    lossless = webp(picture(48, 64, 7), lossless=True)
    cases = {}
    for name, data in (("lossy", lossy), ("lossless", lossless)):
        for cut in (10, 24, 40, len(data) // 2, len(data) - 1):
            cases[f"{name} cut at {cut}"] = data[:cut]
        for pos, what in ((8, "WEBP tag"), (12, "chunk tag"),
                          (5, "RIFF size"), (16, "chunk size")):
            bad = bytearray(data)
            bad[pos] ^= 0x5A
            cases[f"{name} {what}"] = bytes(bad)
    bad = bytearray(lossless)
    bad[20] = 0x2E                       # the VP8L signature byte
    cases["lossless signature"] = bytes(bad)
    bad = bytearray(lossy)
    bad[23:26] = b"\0\0\0"               # the VP8 start code
    cases["lossy start code"] = bytes(bad)
    return cases


@pytest.mark.parametrize("name", list(_damaged()))
def test_truncated_and_damaged_are_minus_one(tmp_path, name):
    assert both(tmp_path, _damaged()[name]) == [-1, -1]


RECORD = json.load(open(os.path.join(DATA, "webp.json")))


@pytest.mark.parametrize("name", sorted(RECORD["files"]))
def test_committed_files(tmp_path, name):
    """Each committed file: the port's RGBA equals PIL's here and hashes
    to the SHA-256 recorded with PIL 12.1.0 / libwebp 1.6.0."""
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    assert_same(tmp_path, data)
    rgba = decode_webp(data)
    rec = RECORD["files"][name]
    assert list(rgba.shape) == rec["shape"]
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == rec["sha256"]
