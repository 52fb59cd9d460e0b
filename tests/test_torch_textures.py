"""Texture formats: the port's TexturePool (fluctus_tpu_torch/scene/
textures.py and its decoders png.py, jpeg.py with native/jpeg.cpp, bmp.py,
tga.py) against the JAX package's (PIL's `Image.open(...).convert("RGBA")`)
on the same files, written into tmp_path with PIL or, for what PIL does
not write (every PNG colour type and depth, Adam7, tRNS keys; BMP
bitfields and top-down rows; right-to-left TGA), by hand.

Every format is held byte for byte, JPEG included: the port's decoder
makes libjpeg-turbo's choices (islow IDCT, fancy upsampling, its YCbCr
tables), so its RGBA equals PIL's exactly. A truncated file is -1 in both
pools; a well-formed file in a format the port does not decode
(progressive JPEG, GIF, TIFF, PPM, WebP) loads in the JAX pool and raises
ValueError in the port's, so the gap stays visible."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, features

from fluctus_tpu.scene.textures import TexturePool as JaxPool
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.textures import TexturePool

G = np.random.default_rng(0)


def smooth(h, w):
    """A seeded picture with edges and noise, RGB uint8."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11),
                    128 + 80 * np.cos(x / 5 - y / 3),
                    128 + 60 * np.sin((x + y) / 9)], -1)
    img += np.random.default_rng(h * w).normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def both(path):
    """(JAX pool's RGBA or -1, port pool's RGBA or -1)."""
    out = []
    for pool in (JaxPool(), TexturePool()):
        i = pool.try_import(str(path), "t")
        out.append(i if i < 0 else pool.textures[i].rgba)
    return out


def assert_same(path):
    want, got = both(path)
    assert not isinstance(want, int), "PIL could not read the file"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ PNG

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_png(path, px, ctype, depth, plte=None, trns=None, interlace=0):
    """A PNG of samples px (h, w, ch) ints, rows with filter 0 or 1."""
    def rows(sub):
        h = sub.shape[0]
        flat = sub.reshape(h, -1)
        out = b""
        for y in range(h):
            r = flat[y]
            if depth == 16:
                b = r.astype(">u2").tobytes()
            elif depth == 8:
                b = r.astype(np.uint8).tobytes()
            else:
                per = 8 // depth
                rr = np.concatenate([r, np.zeros((-len(r)) % per, r.dtype)])
                sh = (8 - depth) - depth * np.arange(per)
                b = (rr.reshape(-1, per).astype(np.uint8) << sh).sum(
                    1).astype(np.uint8).tobytes()
            if y % 2:           # Sub filter on odd rows
                step = max(1, px.shape[2] * depth // 8)
                a = np.frombuffer(b, np.uint8).astype(np.int64)
                f = a.copy()
                f[step:] = (a[step:] - a[:-step]) & 0xFF
                out += b"\x01" + f.astype(np.uint8).tobytes()
            else:
                out += b"\x00" + b
        return out

    h, w = px.shape[:2]
    if interlace:
        data = b"".join(rows(px[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7
                        if px[y0::dy, x0::dx].size)
    else:
        data = rows(px)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(plte, np.uint8).ravel()))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


PNG_CASES = [(c, d) for c, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16),
                                  3: (1, 2, 4, 8), 4: (8, 16),
                                  6: (8, 16)}.items() for d in ds]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_CASES)
def test_png_every_colour_type_and_depth(tmp_path, ctype, depth, interlace):
    """With a tRNS key where the type takes one (the key is a pixel's own
    value, so some pixels turn transparent); palettes with indices past
    PLTE; 16-bit samples above 255."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    g = np.random.default_rng(ctype * 100 + depth * 10 + interlace)
    hi = min(1 << depth, 8) + 2 if ctype == 3 else 1 << depth
    px = g.integers(0, hi, (13, 11, ch))
    if depth == 16:
        px[:3] = g.integers(0, 300, (3, 11, ch))
    plte = trns = None
    if ctype == 3:
        plte = g.integers(0, 256, (min(1 << depth, 8), 3))
        trns = bytes(g.integers(0, 256, 3).astype(np.uint8))
    elif ctype == 0:
        trns = struct.pack(">H", int(px[0, 0, 0]))
    elif ctype == 2:
        trns = struct.pack(">HHH", *(int(v) for v in px[0, 0]))
    path = tmp_path / "t.png"
    write_png(path, px, ctype, depth, plte, trns, interlace)
    assert_same(path)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA",
                                  "I;16"])
def test_png_written_by_pil(tmp_path, mode):
    img = Image.fromarray(smooth(21, 34))
    if mode == "P":
        img = img.quantize(17)
    elif mode == "I;16":
        img = Image.fromarray((smooth(21, 34)[..., 0].astype(np.uint16)
                               * 3).astype(np.uint16))
    else:
        img = img.convert(mode)
    path = tmp_path / "t.png"
    img.save(path, optimize=True)
    assert_same(path)


# ------------------------------------------------------------ TGA, BMP

@pytest.mark.parametrize("compression", [None, "tga_rle"])
@pytest.mark.parametrize("orientation", [-1, 1])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_tga(tmp_path, mode, orientation, compression):
    img = Image.fromarray(smooth(19, 27))
    img = img.quantize(23) if mode == "P" else img.convert(mode)
    if mode == "RGBA":
        a = np.asarray(img).copy()
        a[..., 3] = np.arange(27, dtype=np.uint8) * 9
        img = Image.fromarray(a)
    path = tmp_path / "t.tga"
    img.save(path, compression=compression, orientation=orientation)
    assert_same(path)


def test_tga_right_to_left_and_rle_across_rows(tmp_path):
    """Origin bit 4 (columns right to left) on a 24-bit RLE image of 5 x 3
    whose packets stay in their rows; and the same pixels in packets that
    run across rows, which PIL's decoder refuses (a buffer overrun): -1 in
    both pools."""
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, 5, 3, 24,
                       0x10)
    rows = bytes([0x80 + 2, 10, 20, 30, 0x01, 1, 2, 3, 4, 5, 6,
                  0x80 + 4, 200, 100, 50,
                  0x04, *range(15)])
    path = tmp_path / "t.tga"
    path.write_bytes(head + rows)
    assert_same(path)
    path.write_bytes(head + bytes([0x80 + 6, 10, 20, 30, 0x80 + 7, 200, 100,
                                   50]))
    assert both(path) == [-1, -1]


@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA"])
def test_bmp_written_by_pil(tmp_path, mode):
    img = Image.fromarray(smooth(17, 29))
    img = img.quantize(40) if mode == "P" else img.convert(mode)
    path = tmp_path / "t.bmp"
    img.save(path)
    assert_same(path)


def _bmp(w, h, bits, pixels, header=40, comp=0, masks=None, top_down=False):
    """A BMP with a `header`-byte info header; pixels are the rows as
    stored (bottom-up unless top_down), padded to 4 bytes."""
    extra = b""
    hd = struct.pack("<iiHHIIiiII", w, -h if top_down else h, 1, bits, comp,
                     len(pixels), 2835, 2835, 0, 0)
    if header > 40:
        m = masks or (0, 0, 0, 0)
        hd += struct.pack("<IIII", *m) + bytes(header - 4 - len(hd) - 16)
    elif masks:
        extra = struct.pack("<III", *masks[:3])
    off = 14 + header + len(extra)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + struct.pack("<I", header) + hd + extra + pixels)


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("layout", ["rgb24", "bgra v5", "rgba v4",
                                    "bgrx 40"])
def test_bmp_bitfields_and_row_order(tmp_path, layout, top_down):
    w, h = 7, 5
    g = np.random.default_rng(3)
    if layout == "rgb24":
        bits, header, comp, masks = 24, 40, 0, None
    elif layout == "bgra v5":
        bits, header, comp = 32, 124, 3
        masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    elif layout == "rgba v4":
        bits, header, comp = 32, 108, 3
        masks = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
    else:
        bits, header, comp, masks = 32, 40, 3, (0xFF0000, 0xFF00, 0xFF, 0)
    stride = ((w * bits + 31) >> 3) & ~3
    rows = g.integers(0, 256, (h, stride), dtype=np.uint8)
    path = tmp_path / "t.bmp"
    path.write_bytes(_bmp(w, h, bits, rows.tobytes(), header, comp, masks,
                          top_down))
    assert_same(path)


# ------------------------------------------------------------ JPEG

def _jpeg(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", [(37, 53), (8, 8), (3, 2), (2, 70)])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0",
                                         "4:1:1"])
def test_jpeg_baseline_sampling(tmp_path, size, subsampling):
    path = tmp_path / "t.jpg"
    path.write_bytes(_jpeg(Image.fromarray(smooth(*size)), quality=85,
                           subsampling=subsampling))
    assert_same(path)


@pytest.mark.parametrize("kw", [dict(quality=95), dict(quality=5),
                                dict(optimize=True),
                                dict(restart_marker_blocks=3),
                                dict(restart_marker_rows=1),
                                dict(grey=True), dict(grey=True, quality=20,
                                                      restart_marker_rows=2)],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in
                                                 kw.items()))
def test_jpeg_quality_tables_restarts_grey(tmp_path, kw):
    kw = dict(kw)
    img = Image.fromarray(smooth(45, 61))
    if kw.pop("grey", False):
        img = img.convert("L")
    path = tmp_path / "t.jpg"
    path.write_bytes(_jpeg(img, **kw))
    assert_same(path)


def test_jpeg_extended_sequential_16_bit_tables(tmp_path):
    """SOF1 (extended sequential Huffman) with 16-bit quantization tables:
    a baseline file rewritten so, which libjpeg decodes alike."""
    data = _jpeg(Image.fromarray(smooth(30, 41)), quality=70,
                 subsampling="4:2:0")
    out = bytearray(data[:2])
    pos = 2
    while pos < len(data):
        m, ln = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + ln]
        if m == 0xDB:                           # 8-bit -> 16-bit tables
            body, new = seg[4:], b""
            while body:
                new += bytes([0x10 | (body[0] & 15)]) + b"".join(
                    struct.pack(">H", v) for v in body[1:65])
                body = body[65:]
            seg = b"\xff\xdb" + struct.pack(">H", len(new) + 2) + new
        elif m == 0xC0:
            seg = b"\xff\xc1" + seg[2:]
        out += seg
        pos += 2 + ln
        if m == 0xDA:
            out += data[pos:]
            break
    path = tmp_path / "t.jpg"
    path.write_bytes(bytes(out))
    assert_same(path)


# ------------------------------------------------------------ failures

@pytest.mark.parametrize("fmt", ["png", "jpg", "bmp", "tga"])
def test_truncated_file_is_minus_one_in_both(tmp_path, fmt):
    img = Image.fromarray(smooth(40, 40))
    buf = io.BytesIO()
    img.save(buf, {"jpg": "JPEG", "tga": "TGA"}.get(fmt, fmt.upper()))
    data = buf.getvalue()
    path = tmp_path / f"t.{fmt}"
    path.write_bytes(data[:len(data) // 2])
    assert both(path) == [-1, -1]


def _unported():
    cases = {"progressive jpeg": ("jpg", dict(format="JPEG",
                                              progressive=True)),
             "gif": ("gif", dict(format="GIF")),
             "tiff": ("tif", dict(format="TIFF")),
             "ppm": ("ppm", dict(format="PPM"))}
    if features.check("webp"):
        cases["webp"] = ("webp", dict(format="WEBP", lossless=True))
    return cases


@pytest.mark.parametrize("name", list(_unported()))
def test_unported_format_loads_in_jax_and_raises_in_port(tmp_path, name):
    ext, kw = _unported()[name]
    path = tmp_path / f"t.{ext}"
    Image.fromarray(smooth(16, 16)).save(path, **kw)
    pool = JaxPool()
    assert pool.try_import(str(path), "t") == 0
    with pytest.raises(ValueError, match="not decoded by the port"):
        TexturePool().try_import(str(path), "t")
    with pytest.raises(UnsupportedImage):
        TexturePool().try_import(str(path), "t")


def test_unrecognised_bytes_raise(tmp_path):
    path = tmp_path / "t.png"
    path.write_bytes(b"this is not an image at all")
    assert JaxPool().try_import(str(path), "t") == -1
    with pytest.raises(ValueError, match="recognises"):
        TexturePool().try_import(str(path), "t")


# ------------------------------------------------------------ a render

def test_jpeg_and_grey_bump_map_render_like_jax(tmp_path):
    """An MTL naming a .jpg diffuse map and a grey PNG bump map: the port's
    lockstep (plain K1) renders what the JAX package's does, under its
    area light, at the goldens' RTOL 1e-3 / ATOL 1e-4 on every pixel."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    from fluctus_tpu.core.types import AreaLight
    from fluctus_tpu.core.types import RenderConfig as JaxConfig
    from fluctus_tpu.render import driver as jax_driver
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver
    Image.fromarray(smooth(32, 48)).save(tmp_path / "kd.jpg", quality=80)
    Image.fromarray(smooth(16, 16)[..., 1]).save(tmp_path / "bump.png")
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
    from fluctus_tpu_torch.core.types import AreaLight as PortLight
    s.params = dataclasses.replace(s.params, area_light=PortLight(
        **{k: torch.tensor(v) for k, v in light.items()}))
    assert s.host_scene.map_kd.tolist() == [-1, 0]
    assert s.host_scene.map_n.tolist() == [-1, 1]
    np.testing.assert_array_equal(s.scene.atlas.data.numpy(),
                                  np.asarray(js.scene.atlas.data))
    want = np.asarray(jax_driver.render(js, 2, integrator="lockstep"))
    got = driver.render(s, 2, integrator="lockstep").numpy()
    assert float(want.mean()) > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
