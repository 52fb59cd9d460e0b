"""Texture formats: the port's TexturePool (fluctus_tpu_torch/scene/
textures.py, imageformat.py and its decoders png.py, jpeg.py with
native/jpeg.cpp, bmp.py, tga.py, gif.py, pnm.py, tiff.py) against the JAX
package's (PIL's `Image.open(...).convert("RGBA")`) on the same files,
written into tmp_path with PIL or, for what PIL does not write (every PNG
colour type and depth, Adam7, tRNS keys; BMP bitfields, 4- and 16-bit
pixels, RLE and OS/2 headers; right-to-left and 16-bit TGA; GIF frames
offset in their screen; TIFF tiles, 16-bit samples and the predictor,
planar samples, fill order 2, signed and float samples, the
floating-point predictor, BigTIFF and subsampled YCbCr JPEG-in-TIFF;
plain PNM at odd maxvals and PFM; PSD), by hand (fixtures.tiff_bytes,
psd_bytes and the rest).

Every format is held byte for byte, progressive JPEG included: the
port's decoder makes libjpeg-turbo's choices (islow IDCT, fancy
upsampling, its YCbCr tables), so its RGBA equals PIL's exactly. A
truncated file is -1 in both pools, and so are bytes no PIL plugin
identifies; a well-formed file in a format the port does not decode
(WebP) loads in the JAX pool and raises UnsupportedImage in the port's,
so the gap stays visible. DDS (uncompressed layouts and BC1-BC5, BC7
through native/bcn.cpp), ICO and CUR equal PIL on files PIL writes and
on DDS files of seeded blocks (`fixtures.dds_bytes`)."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, features

from fluctus_tpu.scene.textures import TexturePool as JaxPool
from fluctus_tpu_torch import fixtures
from fluctus_tpu_torch.scene import imageformat
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


# ------------------------------------------------------------ PNM and PFM

def _pnm_cases():
    g = np.random.default_rng(11)
    w, h = 7, 5
    cases = {}
    for mv in (1, 7, 255, 256, 1000, 65535):
        v = g.integers(0, mv + 1, (h, w, 3))
        for m, b in (("P2", 1), ("P3", 3), ("P5", 1), ("P6", 3)):
            head = f"{m}\n# comment\n{w} {h}\n{mv}\n".encode()
            vv = v[..., :b]
            if m in ("P2", "P3"):
                body = " ".join(map(str, vv.reshape(-1))).encode() + b"\n"
            else:
                body = vv.astype(np.uint8 if mv < 256 else ">u2").tobytes()
            cases[f"{m} maxval {mv}"] = head + body
    bits = g.integers(0, 2, (h, w))
    cases["P1"] = f"P1\n{w} {h}\n".encode() + " ".join(
        map(str, bits.reshape(-1))).encode()
    cases["P1 packed digits"] = f"P1 {w} {h}\n".encode() + "".join(
        map(str, bits.reshape(-1))).encode()
    cases["P4"] = f"P4\n{w} {h}\n".encode() + np.packbits(
        bits, axis=1).tobytes()
    f = (g.normal(0, 100, (h, w)) + 100).astype(np.float32)
    f[0, 0], f[1, 1], f[2, 2] = np.nan, np.inf, -3.0
    cases["Pf little-endian"] = f"Pf\n{w} {h}\n-1.0\n".encode() + \
        f.astype("<f4").tobytes()
    cases["Pf big-endian"] = f"Pf\n{w} {h}\n2.5\n".encode() + \
        f.astype(">f4").tobytes()
    cases["P6 truncated"] = cases["P6 maxval 255"][:40]
    cases["P2 sample over maxval"] = b"P2\n2 1\n10\n1 11\n"
    return cases


@pytest.mark.parametrize("name", list(_pnm_cases()))
def test_pnm_and_pfm(tmp_path, name):
    path = tmp_path / "t.pnm"
    path.write_bytes(_pnm_cases()[name])
    if "truncated" in name or "over" in name:
        assert both(path) == [-1, -1]
    else:
        assert_same(path)


# ------------------------------------------------------------ progressive

@pytest.mark.parametrize("size", [(17, 13), (48, 64), (1, 1)])
@pytest.mark.parametrize("kw", [
    dict(subsampling="4:2:0", quality=75),
    dict(subsampling="4:2:2", quality=95, restart_marker_blocks=3),
    dict(subsampling="4:4:4", quality=30, optimize=True),
    dict(subsampling="4:2:0", quality=100, restart_marker_blocks=1),
    dict(grey=True, quality=60, restart_marker_blocks=2)])
def test_jpeg_progressive(tmp_path, size, kw):
    kw = dict(kw)
    img = Image.fromarray(smooth(*size))
    if kw.pop("grey", False):
        img = img.convert("L")
    path = tmp_path / "t.jpg"
    img.save(path, "JPEG", progressive=True, **kw)
    assert_same(path)


def test_jpeg_progressive_truncated_is_minus_one(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(smooth(40, 40)).save(buf, "JPEG", progressive=True)
    path = tmp_path / "t.jpg"
    path.write_bytes(buf.getvalue()[:len(buf.getvalue()) * 2 // 3])
    assert both(path) == [-1, -1]


# ------------------------------------------------------------ GIF

def _lzw_literal(idx, min_size):
    """GIF LZW of literal codes, a clear code before the table grows."""
    clear, end, size = 1 << min_size, (1 << min_size) + 1, min_size + 1
    codes, nxt = [clear], end + 1
    for v in idx:
        codes.append(int(v))
        if codes[-2] != clear:
            nxt += 1
        if nxt >= (1 << size) - 1:
            codes.append(clear)
            nxt = end + 1
    codes.append(end)
    acc = bits = 0
    out = bytearray()
    for c in codes:
        acc |= c << bits
        bits += size
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8
    return bytes(out + (bytes([acc]) if bits else b""))


def _sub_blocks(b):
    return b"".join(bytes([len(b[i:i + 255])]) + b[i:i + 255]
                    for i in range(0, len(b), 255)) + b"\0"


def write_gif(sw, sh, gpal, idx, x0=0, y0=0, lpal=None, trans=None,
              interlace=False, min_size=None, code=None):
    fh, fw = idx.shape
    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if gpal is not None:
        out += bytes([0x80 | (len(gpal).bit_length() - 2), 0, 0])
        out += np.asarray(gpal, np.uint8).tobytes()
    else:
        out += b"\0\0\0"
    if trans is not None:
        out += bytes([0x21, 0xF9, 4, 1, 0, 0, trans, 0])
    fl = 0x40 if interlace else 0
    if lpal is not None:
        fl |= 0x80 | (len(lpal).bit_length() - 2)
    out += b"\x2c" + struct.pack("<HHHH", x0, y0, fw, fh) + bytes([fl])
    if lpal is not None:
        out += np.asarray(lpal, np.uint8).tobytes()
    ms = min_size or max(2, int(idx.max()).bit_length())
    out += bytes([ms]) + _sub_blocks(
        code if code is not None else _lzw_literal(idx.reshape(-1), ms))
    return bytes(out + b";")


def _gif_cases():
    g = np.random.default_rng(12)
    cases = {}
    rgb = smooth(23, 40)
    for colors in (2, 16, 256):
        im = Image.fromarray(rgb).quantize(colors)
        for tag, kw in (("", {}), (" interlaced", dict(interlace=True)),
                        (" transparent", dict(transparency=1))):
            buf = io.BytesIO()
            im.save(buf, "GIF", **kw)
            cases[f"PIL {colors} colours{tag}"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb[..., 0]).save(buf, "GIF")
    cases["PIL grey"] = buf.getvalue()
    pal4, pal16 = g.integers(0, 256, (4, 3)), g.integers(0, 256, (16, 3))
    idx = g.integers(0, 4, (6, 9))
    cases["interlaced 19 rows"] = write_gif(5, 19, pal4, g.integers(
        0, 4, (19, 5)), interlace=True)
    cases["frame offset in its screen"] = write_gif(12, 10, pal4, idx, 2, 3)
    cases["offset, transparent"] = write_gif(12, 10, pal4, idx, 2, 3,
                                             trans=2)
    cases["frame grows the screen"] = write_gif(5, 4, pal4, idx, 1, 1)
    cases["local palette"] = write_gif(9, 6, pal4, idx, lpal=pal16)
    cases["no palette, transparent"] = write_gif(9, 6, None, idx, trans=3)
    cases["grey ramp palette"] = write_gif(9, 6, [[i] * 3 for i in range(4)],
                                           idx)
    cases["index past the table"] = write_gif(9, 6, pal4, g.integers(
        0, 16, (6, 9)))
    cases["code size 8"] = write_gif(9, 6, pal4, idx, min_size=8)
    cases["end code early"] = write_gif(
        9, 6, pal4, idx, code=_lzw_literal(idx.reshape(-1)[:20], 2))
    cases["truncated"] = write_gif(9, 6, pal4, idx)[:30]
    return cases


@pytest.mark.parametrize("name", list(_gif_cases()))
def test_gif(tmp_path, name):
    path = tmp_path / "t.gif"
    path.write_bytes(_gif_cases()[name])
    if name in ("end code early", "truncated"):
        assert both(path) == [-1, -1]
    else:
        assert_same(path)


# ------------------------------------------------------------ more BMP, TGA

def write_bmp(w, h, bits, pixels, pal=None, comp=0, core=False, masks=None):
    """A BMP of pre-packed `pixels` (bottom row first) with a 12-byte
    OS/2 core header or a 40-byte info header (masks after it)."""
    ent = 3 if core else 4
    palb = b"" if pal is None else b"".join(
        bytes([c[2], c[1], c[0]]) + b"\0" * (ent - 3) for c in pal)
    if core:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, comp,
                           len(pixels), 2835, 2835, 0, 0)
    mb = struct.pack("<III", *masks) if masks else b""
    off = 14 + len(info) + len(mb) + len(palb)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + mb + palb + pixels)


def _rows(idx, bits):
    """Rows bottom-up, each padded to 4 bytes."""
    h, w = idx.shape
    stride = ((w * bits + 31) >> 3) & ~3
    out = b""
    for r in idx[::-1]:
        if bits == 16:
            row = r.astype("<u2").tobytes()
        elif bits < 8:
            row = np.packbits(np.unpackbits(r.astype(np.uint8)[:, None],
                                            axis=1)[:, 8 - bits:]).tobytes()
        else:
            row = r.astype(np.uint8).tobytes()
        out += row + bytes(stride - len(row))
    return out


def _bmp_cases():
    g = np.random.default_rng(13)
    w, h = 11, 7
    cases = {}
    for bits in (1, 4):
        pal = g.integers(0, 256, (1 << bits, 3)).tolist()
        idx = g.integers(0, 1 << bits, (h, w))
        cases[f"{bits}-bit"] = write_bmp(w, h, bits, _rows(idx, bits), pal)
        cases[f"{bits}-bit OS/2"] = write_bmp(w, h, bits, _rows(idx, bits),
                                              pal, core=True)
    v = g.integers(0, 65536, (h, w))
    cases["16-bit 5-5-5"] = write_bmp(w, h, 16, _rows(v, 16))
    cases["16-bit 5-6-5"] = write_bmp(w, h, 16, _rows(v, 16), comp=3,
                                      masks=(0xF800, 0x7E0, 0x1F))
    pal = g.integers(0, 256, (256, 3)).tolist()
    cases["8-bit OS/2"] = write_bmp(w, h, 8, _rows(g.integers(
        0, 256, (h, w)), 8), pal, core=True)
    runs = b"".join(bytes([4, r, 0, 3, 1, 2, 3, 0, w - 7, r ^ 5, 0, 0])
                    for r in range(h)) + b"\0\1"
    cases["RLE8"] = write_bmp(w, h, 8, runs, pal, comp=1)
    cases["RLE8 delta"] = write_bmp(w, h, 8, bytes([3, 9, 0, 2, 7, 7, 2, 1])
                                    + runs, pal, comp=1)
    pal16 = g.integers(0, 256, (16, 3)).tolist()
    runs4 = b"".join(bytes([5, 0x3A, 0, 5, 0x12, 0x34, 0x50, 0, w - 10,
                            0x7C, 0, 0]) for _ in range(h)) + b"\0\1"
    cases["RLE4"] = write_bmp(w, h, 4, runs4, pal16, comp=2)
    cases["RLE8 truncated"] = write_bmp(w, h, 8, runs[:20], pal, comp=1)
    cases["2-bit"] = write_bmp(w, h, 2, bytes(100))
    return cases


@pytest.mark.parametrize("name", list(_bmp_cases()))
def test_bmp_depths_rle_and_os2(tmp_path, name):
    """1-, 4- and 16-bit BMPs, RLE8/RLE4 by PIL's decoder's rules and
    OS/2 headers; a truncated RLE stream and a depth PIL does not read
    are -1 in both."""
    path = tmp_path / "t.bmp"
    path.write_bytes(_bmp_cases()[name])
    if name in ("RLE8 truncated", "2-bit"):
        assert both(path) == [-1, -1]
    else:
        assert_same(path)


def write_tga(w, h, itype, depth, px, cmap=None, start=0, flags=0):
    mlen, mdepth, cm = 0, 0, b""
    if cmap is not None:
        mdepth, cm = cmap
        mlen = len(cm) // (mdepth // 8)
    return struct.pack("<BBBHHBHHHHBB", 0, int(cmap is not None), itype,
                       start, mlen, mdepth, 0, 0, w, h, depth, flags) + \
        cm + px


def _tga_rle(px, bpp, w):
    """A repeat packet for each run of two or more, raw packets else."""
    out = bytearray()
    for r0 in range(0, len(px), w * bpp):
        row = px[r0:r0 + w * bpp]
        i = 0
        while i < w:
            j = i
            while j < w and j - i < 128 and \
                    row[j * bpp:(j + 1) * bpp] == row[i * bpp:(i + 1) * bpp]:
                j += 1
            if j - i >= 2:
                out += bytes([0x80 | (j - i - 1)]) + row[i * bpp:(i + 1) * bpp]
            else:
                j = min(w, i + 3)
                out += bytes([j - i - 1]) + row[i * bpp:j * bpp]
            i = j
    return bytes(out)


def _tga_cases():
    g = np.random.default_rng(14)
    w, h = 9, 6
    cases = {}
    v16 = g.integers(0, 65536, w * h).astype("<u2").tobytes()
    for flags in (0, 0x20, 0x10, 0x30):
        cases[f"16-bit colour, origin {flags:#x}"] = write_tga(
            w, h, 2, 16, v16, flags=flags)
    rep = np.repeat(np.frombuffer(v16, "<u2")[:w * h // 3], 3)
    cases["16-bit colour RLE"] = write_tga(
        w, h, 10, 16, _tga_rle(rep.astype("<u2").tobytes(), 2, w))
    la = g.integers(0, 256, w * h * 2).astype(np.uint8).tobytes()
    cases["16-bit grey"] = write_tga(w, h, 3, 16, la)
    cases["16-bit grey RLE"] = write_tga(w, h, 11, 16, _tga_rle(la, 2, w))
    cases["1-bit grey"] = write_tga(w, h, 3, 1, g.integers(
        0, 256, 2 * h).astype(np.uint8).tobytes())
    idx = g.integers(0, 40, w * h).astype(np.uint8).tobytes()
    for md in (16, 24, 32):
        cm = (md, g.integers(0, 256, 30 * md // 8).astype(np.uint8).tobytes())
        cases[f"{md}-bit map"] = write_tga(w, h, 1, 8, idx, cm, start=5)
        cases[f"{md}-bit map RLE"] = write_tga(w, h, 9, 8,
                                               _tga_rle(idx, 1, w), cm,
                                               start=5)
    return cases


@pytest.mark.parametrize("name", list(_tga_cases()))
def test_tga_depths_and_maps(tmp_path, name):
    """16-bit colour (PIL's inverted attribute bit as alpha), 16-bit and
    1-bit grey, 16- and 24-bit colour maps starting past index 0; a 32-bit
    map, which PIL 12 fails to load, is -1 in both."""
    path = tmp_path / "t.tga"
    path.write_bytes(_tga_cases()[name])
    if name.startswith("32-bit map"):
        assert both(path) == [-1, -1]
    else:
        assert_same(path)


# ------------------------------------------------------------ TIFF

def write_tiff(w, h, bits, spp, photo, chunks, comp=1, tile=None, rps=None,
               extra=None, pred=1, bo="<", cmap=None):
    """A classic TIFF of pre-encoded strips (rps rows) or tiles."""
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
            (259, 3, [comp]), (262, 3, [photo]), (277, 3, [spp])]
    if extra is not None:
        tags.append((338, 3, extra))
    if pred != 1:
        tags.append((317, 3, [pred]))
    if cmap is not None:
        tags.append((320, 3, cmap))
    offs, o = [], 8
    for c in chunks:
        offs.append(o)
        o += len(c)
    counts = [len(c) for c in chunks]
    if tile:
        tags += [(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, 4, offs),
                 (325, 4, counts)]
    else:
        tags += [(273, 4, offs), (278, 4, [rps or h]), (279, 4, counts)]
    tags.sort()
    ifd_off = o + o % 2
    ext_off = ifd_off + 2 + 12 * len(tags) + 4
    ifd, ext = struct.pack(bo + "H", len(tags)), b""
    for tag, typ, vals in tags:
        raw = struct.pack(bo + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) <= 4:
            ifd += struct.pack(bo + "HHI", tag, typ, len(vals)) + \
                raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(bo + "HHII", tag, typ, len(vals),
                               ext_off + len(ext))
            ext += raw
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(bo + "I",
                                                               ifd_off)
    return head + b"".join(chunks) + b"\0" * (o % 2) + ifd + b"\0" * 4 + ext


def _tiff_cases():
    g = np.random.default_rng(15)
    cases = {}
    base = Image.fromarray(smooth(9, 13))
    modes = {"1": base.convert("1"), "L": base.convert("L"),
             "LA": base.convert("LA"), "RGB": base, "RGBA":
             base.convert("RGBA"), "P": base.quantize(20),
             "I;16": Image.fromarray(g.integers(0, 65536, (9, 13)).astype(
                 np.uint16))}
    for mode, im in modes.items():
        for comp in ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"):
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression=comp)
            cases[f"PIL {mode} {comp}"] = buf.getvalue()
        if mode in ("L", "RGB", "RGBA", "I;16"):
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
            cases[f"PIL {mode} LZW, predictor"] = buf.getvalue()
    w, h = 13, 9
    for bo in ("<", ">"):
        for bits in (8, 16):
            top = (1 << bits) - 1
            dt = np.uint8 if bits == 8 else bo + "u2"
            for spp, extra in ((3, None), (4, [2]), (4, [1]), (4, [0])):
                a = g.integers(0, top + 1, (h, w, spp))
                if extra == [1]:
                    a[..., :3] = np.minimum(a[..., :3], a[..., 3:4])
                name = f"{bits}-bit x{spp} extra {extra} {bo}"
                cases[name + " strips"] = write_tiff(
                    w, h, bits, spp, 2, [a[i:i + 4].astype(dt).tobytes()
                                         for i in range(0, h, 4)],
                    rps=4, extra=extra, bo=bo)
                d = a.copy()
                d[:, 1:] = (a[:, 1:] - a[:, :-1]) % (top + 1)
                cases[name + " deflate, predictor"] = write_tiff(
                    w, h, bits, spp, 2,
                    [zlib.compress(d[i:i + 4].astype(dt).tobytes())
                     for i in range(0, h, 4)], comp=8, rps=4, extra=extra,
                    pred=2, bo=bo)
    a = g.integers(0, 256, (40, 37, 3))
    tiles = []
    for ty in range(0, 40, 16):
        for tx in range(0, 37, 16):
            t = np.zeros((16, 16, 3), np.uint8)
            blk = a[ty:ty + 16, tx:tx + 16]
            t[:blk.shape[0], :blk.shape[1]] = blk
            tiles.append(zlib.compress(t.tobytes()))
    cases["tiles 16x16, Deflate"] = write_tiff(37, 40, 8, 3, 2, tiles,
                                               comp=32946, tile=(16, 16))
    for bits in (1, 2, 4):
        for photo in (0, 1, 3):
            v = g.integers(0, 1 << bits, (h, w)).astype(np.uint8)
            packed = np.packbits(np.unpackbits(v[..., None], axis=2)[
                ..., 8 - bits:].reshape(h, -1), axis=1).tobytes()
            cmap = g.integers(0, 65536, 3 << bits).tolist() \
                if photo == 3 else None
            cases[f"{bits}-bit photometric {photo}"] = write_tiff(
                w, h, bits, 1, photo, [packed], cmap=cmap)
    full = cases["PIL RGB tiff_lzw"]
    cases["truncated"] = full[:len(full) // 2]
    return cases


@pytest.mark.parametrize("name", list(_tiff_cases()))
def test_tiff(tmp_path, name):
    path = tmp_path / "t.tif"
    path.write_bytes(_tiff_cases()[name])
    if name == "truncated":
        assert both(path) == [-1, -1]
    else:
        assert_same(path)


def _jpeg_segments(j: bytes):
    """A JPEG stream split into its tables (DQT, DHT) and the rest from
    SOF to EOI, APPn segments dropped."""
    i, tables, rest = 2, b"", b""
    while True:
        (n,) = struct.unpack_from(">H", j, i + 2)
        m = j[i + 1]
        if m == 0xda:
            return tables, rest + j[i:]
        if m in (0xdb, 0xc4):
            tables += j[i:i + 2 + n]
        elif not 0xe0 <= m <= 0xef:
            rest += j[i:i + 2 + n]
        i += 2 + n


def _jpeg_tiff(a, sub, rps=None, tile=None, tables=True):
    """A YCbCr JPEG-in-TIFF of `a` as libtiff lays it out: one JPEG
    stream a strip (rps rows) or tile, encoded by PIL at `sub`
    (0 4:4:4, 1 4:2:2, 2 4:2:0), its tables in JPEGTables (`tables`) or
    in every stream. PIL's TIFF writer cannot subsample."""
    h, w = a.shape[:2]
    if tile:
        tw, th = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, 3), np.uint8)
        pad[:h, :w] = a
        parts = [pad[y:y + th, x:x + tw] for y in range(0, h, th)
                 for x in range(0, w, tw)]
    else:
        parts = [a[y:y + rps] for y in range(0, h, rps)]
    chunks, tabs = [], None
    for p in parts:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(p)).save(
            buf, "JPEG", quality=88, subsampling=sub)
        t, rest = _jpeg_segments(buf.getvalue())
        if tables:
            tabs = b"\xff\xd8" + t + b"\xff\xd9"
            chunks.append(b"\xff\xd8" + rest)
        else:
            chunks.append(b"\xff\xd8" + t + rest)
    return fixtures.tiff_bytes(
        w, h, 8, 3, 6, chunks, comp=7, rps=rps, tile=tile, tables=tabs,
        subsampling={0: (1, 1), 1: (2, 1), 2: (2, 2)}[sub])


def _fp_diff(a: np.ndarray, spp: int = 1) -> bytes:
    """libtiff's floating-point predictor on rows of float32: each row's
    bytes as planes, most significant first, then differenced along the
    row with stride spp."""
    out = []
    for row in a.reshape(a.shape[0], -1):
        by = np.frombuffer(row.astype("<f4").tobytes(), np.uint8).reshape(
            -1, 4)
        planes = np.concatenate([by[:, 3 - k] for k in range(4)])
        d = planes.copy()
        d[spp:] = planes[spp:] - planes[:-spp]
        out.append(d)
    return np.concatenate(out).tobytes()


REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_layout_cases():
    """{name: (file bytes, whether PIL reads it)}: the layouts of PR 15's
    repair (planar, fill order 2, signed and float samples, predictor 3,
    CMYK, BigTIFF, JPEG), written by PIL where it writes them and by
    fixtures.tiff_bytes otherwise."""
    g = np.random.default_rng(16)
    tb = fixtures.tiff_bytes
    cases = {}
    pic = smooth(37, 29)
    for mode in ("RGB", "L", "YCbCr"):
        for rps in (None, 16):
            buf = io.BytesIO()
            Image.fromarray(pic).convert(mode).save(
                buf, "TIFF", compression="jpeg",
                tiffinfo={} if rps is None else {278: rps})
            cases[f"PIL {mode} jpeg rps {rps}"] = (buf.getvalue(), True)
    for sub in (0, 1, 2):
        cases[f"YCbCr jpeg 4:{[4, 2, 2][sub]}:{[4, 2, 0][sub]} strips"] = (
            _jpeg_tiff(pic, sub, rps=16), True)
    cases["YCbCr jpeg 4:2:0 one stream, tables inline"] = (
        _jpeg_tiff(pic, 2, rps=37, tables=False), True)
    cases["YCbCr jpeg 4:2:0 tiles 16x16"] = (
        _jpeg_tiff(pic, 2, tile=(16, 16)), True)
    for mode, arr in (("F", (g.normal(size=(9, 13)) * 150 + 100).astype(
            np.float32)), ("I", g.integers(-400, 700, (9, 13)).astype(
                np.int32))):
        arr.flat[:4] = [np.nan, np.inf, -np.inf, 255.5] if mode == "F" \
            else [-1, 255, 256, 2 ** 31 - 1]
        for comp in ("raw", "tiff_deflate", "tiff_lzw"):
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "TIFF", compression=comp)
            cases[f"PIL {mode} {comp}"] = (buf.getvalue(), True)
    cmyk = Image.fromarray(pic).convert("CMYK")
    for comp in ("raw", "packbits", "tiff_deflate"):
        buf = io.BytesIO()
        cmyk.save(buf, "TIFF", compression=comp)
        cases[f"PIL CMYK {comp}"] = (buf.getvalue(), True)
    w, h = 13, 9
    for bo in ("<", ">"):
        v16 = g.integers(-500, 800, (h, w)).astype(bo + "i2")
        d16 = v16.copy()
        d16[:, 1:] = v16[:, 1:] - v16[:, :-1]
        v32 = g.integers(-500, 800, (h, w)).astype(bo + "i4")
        f32 = (g.normal(size=(h, w)) * 150 + 100).astype(bo + "f4")
        for comp, z in ((1, lambda x: x), (8, zlib.compress)):
            cases[f"I;16S {bo} comp {comp}"] = (tb(
                w, h, 16, 1, 1, [z(v16.tobytes())], comp=comp, fmt=[2],
                bo=bo), True)
            cases[f"I;32S {bo} comp {comp}"] = (tb(
                w, h, 32, 1, 1, [z(v32.tobytes())], comp=comp, fmt=[2],
                bo=bo), True)
            cases[f"F min-is-white {bo} comp {comp}"] = (tb(
                w, h, 32, 1, 0, [z(f32.tobytes())], comp=comp, fmt=[3],
                bo=bo), True)
        cases[f"I;16S {bo} deflate, predictor 2"] = (tb(
            w, h, 16, 1, 1, [zlib.compress(d16.tobytes())], comp=8, fmt=[2],
            bo=bo, pred=2), True)
        cases[f"F {bo} deflate, predictor 3"] = (tb(
            w, h, 32, 1, 1, [zlib.compress(_fp_diff(f32[i:i + 4]))
                             for i in range(0, h, 4)], comp=8, fmt=[3],
            bo=bo, pred=3, rps=4), True)
        cases[f"I;32N {bo}"] = (tb(w, h, 32, 1, 1, [v32.astype(
            bo + "u4").tobytes()], fmt=[1], bo=bo), bo == "<")
        c16 = g.integers(0, 65536, (h, w, 4)).astype(bo + "u2")
        cases[f"CMYK 16-bit {bo} deflate"] = (tb(
            w, h, 16, 4, 5, [zlib.compress(c16.tobytes())], comp=8, bo=bo),
            True)
    cases["float16"] = (tb(w, h, 16, 1, 1, [np.ones((h, w), np.float16)
                                            .tobytes()], fmt=[3]), False)
    cases["signed 8-bit"] = (tb(w, h, 8, 1, 1, [g.integers(
        0, 256, (h, w)).astype(np.uint8).tobytes()], fmt=[2]), True)
    lab = g.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for comp, z in ((1, lambda x: x), (8, zlib.compress)):
        cases[f"CIELAB comp {comp}"] = (tb(w, h, 8, 3, 8, [z(lab.tobytes())],
                                           comp=comp), True)
    c8 = g.integers(0, 256, (h, w, 5)).astype(np.uint8)
    cases["CMYK + unused extra sample"] = (tb(w, h, 8, 5, 5, [
        c8.tobytes()], extra=[0]), True)
    # planar: one chunk list a plane (PIL writes none)
    for bits in (8, 16):
        dt = np.uint8 if bits == 8 else "<u2"
        for name, spp, photo, extra in (("L", 1, 1, None), ("LA", 2, 1, [2]),
                                        ("RGB", 3, 2, None),
                                        ("RGBA", 4, 2, [2]),
                                        ("RGBa", 4, 2, [1]),
                                        ("RGBX", 4, 2, [0])):
            a = g.integers(0, 1 << bits, (h, w, spp)).astype(dt)
            if extra == [1]:
                a[..., :3] = np.minimum(a[..., :3], a[..., 3:])
            for comp, z in ((1, lambda x: x), (8, zlib.compress)):
                reads = bits == 16 and name in ("LA",) or (
                    comp == 1 and (name in ("LA", "RGBa", "RGBX")
                                   or name == "L" and bits == 16)) or (
                    name == "RGBX")
                cases[f"planar {name} {bits}-bit comp {comp}"] = (tb(
                    w, h, bits, spp, photo,
                    [z(a[i:i + 4, :, k].tobytes()) for k in range(spp)
                     for i in range(0, h, 4)], comp=comp, rps=4, extra=extra,
                    planar=2), not reads)
    a = g.integers(0, 256, (h, w)).astype(np.uint8)
    cases["planar min-is-white 8-bit raw"] = (tb(
        w, h, 8, 1, 0, [a.tobytes()], planar=2), True)
    a = g.integers(0, 256, (40, 37, 3)).astype(np.uint8)
    tiles = []
    for k in range(3):
        for ty in range(0, 40, 16):
            for tx in range(0, 37, 16):
                t = np.zeros((16, 16), np.uint8)
                blk = a[ty:ty + 16, tx:tx + 16, k]
                t[:blk.shape[0], :blk.shape[1]] = blk
                tiles.append(t.tobytes())
    cases["planar RGB tiles 16x16 raw"] = (tb(37, 40, 8, 3, 2, tiles,
                                              tile=(16, 16), planar=2), True)
    cases["planar RGB tiles 16x16 deflate"] = (tb(
        37, 40, 8, 3, 2, [zlib.compress(x) for x in tiles], comp=8,
        tile=(16, 16), planar=2), True)
    # fill order 2: every stored byte bit-reversed
    for name, bits, spp, photo, reads in (
            ("L", 8, 1, 1, True), ("min-is-white L", 8, 1, 0, None),
            ("RGB", 8, 3, 2, True), ("RGBA", 8, 4, 2, False),
            ("1-bit", 1, 1, 1, True), ("1-bit min-is-white", 1, 1, 0, True),
            ("4-bit", 4, 1, 1, True), ("4-bit palette", 4, 1, 3, None),
            ("palette", 8, 1, 3, True), ("16-bit", 16, 1, 1, True)):
        if bits < 8:
            v = g.integers(0, 1 << bits, (h, w)).astype(np.uint8)
            raw = np.packbits(np.unpackbits(v[..., None], axis=2)[
                ..., 8 - bits:].reshape(h, -1), axis=1).tobytes()
        else:
            hi = 300 if bits == 16 else 256
            raw = g.integers(0, hi, (h, w, spp)).astype(
                np.uint8 if bits == 8 else "<u2").tobytes()
        cmap = g.integers(0, 65536, 3 << bits).tolist() if photo == 3 \
            else None
        for comp, z in ((1, lambda x: x), (8, zlib.compress)):
            stored = REV[np.frombuffer(z(raw), np.uint8)].tobytes()
            ok = (comp == 8) if reads is None else reads
            cases[f"fill order 2, {name}, comp {comp}"] = (tb(
                w, h, bits, spp, photo, [stored], comp=comp, fill=2,
                cmap=cmap, extra=[2] if spp == 4 else None), ok)
    # BigTIFF
    a = g.integers(0, 256, (h, w, 4)).astype(np.uint8)
    for bo in ("<", ">"):
        # PIL fails on big-endian BigTIFF: it tests the third byte for 43
        cases[f"BigTIFF RGB {bo}"] = (tb(w, h, 8, 3, 2, [a[..., :3].tobytes()],
                                         bo=bo, bigtiff=True), bo == "<")
        cases[f"BigTIFF RGBA deflate strips {bo}"] = (tb(
            w, h, 8, 4, 2, [zlib.compress(a[i:i + 4].tobytes())
                            for i in range(0, h, 4)], comp=8, rps=4,
            extra=[2], bo=bo, bigtiff=True), bo == "<")
    tiles = []
    for ty in range(0, 40, 16):
        for tx in range(0, 37, 16):
            t = np.zeros((16, 16), "<u2")
            blk = g.integers(0, 300, (16, 16))
            t[:] = blk
            tiles.append(zlib.compress(t.tobytes()))
    cases["BigTIFF 16-bit grey tiles"] = (tb(37, 40, 16, 1, 1, tiles, comp=8,
                                             tile=(16, 16), bigtiff=True),
                                          True)
    return cases


TIFF_LAYOUTS = _tiff_layout_cases()


@pytest.mark.parametrize("name", list(TIFF_LAYOUTS))
def test_tiff_layouts(tmp_path, name):
    """Planar samples, fill order 2, signed and float samples, the
    floating-point predictor, CMYK, BigTIFF and new-style JPEG: the
    port's RGBA equals PIL's byte for byte, and a layout PIL cannot read
    is -1 in both pools."""
    data, reads = TIFF_LAYOUTS[name]
    path = tmp_path / "t.tif"
    path.write_bytes(data)
    if reads:
        assert_same(path)
    else:
        assert both(path) == [-1, -1]


# ------------------------------------------------------------ DDS, ICO, CUR

DDS_SIZES = ((16, 12), (13, 7), (1, 1))


@pytest.mark.parametrize("size", DDS_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", fixtures.DDS_FORMATS)
def test_dds_seeded_blocks(tmp_path, fmt, size):
    """Every layout of fixtures.dds_bytes (BC1-BC5 by FourCC and DX10,
    signed BC5, BC7 with a block in each mode 0-7 and the reserved mode 8,
    DX10 RGBA8, L8, L8A8, P8 and masked RGB(A)) over seeded random bytes,
    at sizes that do and do not fill their last blocks."""
    path = tmp_path / "t.dds"
    path.write_bytes(fixtures.dds_bytes(fmt, *size, seed=size[0]))
    assert_same(path)


@pytest.mark.parametrize("mode,pf", [
    ("RGBA", "DXT1"), ("RGBA", "DXT3"), ("RGBA", "DXT5"), ("RGBA", "BC2"),
    ("RGBA", "BC3"), ("RGB", "BC5"), ("RGBA", None), ("RGB", None),
    ("L", None), ("LA", None)])
def test_dds_written_by_pil(tmp_path, mode, pf):
    """DDS files PIL writes: its block encoders and its uncompressed
    layouts."""
    path = tmp_path / "t.dds"
    img = Image.fromarray(smooth(19, 23)).convert("RGBA")
    img.putalpha(Image.fromarray(smooth(19, 23)[..., 2]))
    img.convert(mode).save(path, "DDS",
                           **({} if pf is None else {"pixel_format": pf}))
    assert_same(path)


def test_dds_bc7_2048_and_damage(tmp_path):
    """A 2048^2 BC7 texture (262,144 blocks) decodes as PIL does, a
    truncated block stream is -1 in both, and BC6H, which PIL reads,
    raises in the port."""
    path = tmp_path / "t.dds"
    data = fixtures.dds_bytes("BC7", 2048, 2048, seed=7)
    path.write_bytes(data)
    assert_same(path)
    path.write_bytes(data[:len(data) // 2])
    assert both(path) == [-1, -1]
    bc6 = bytearray(fixtures.dds_bytes("BC7", 8, 8, seed=1))
    bc6[128:132] = (95).to_bytes(4, "little")      # DXGI BC6H_UF16
    path.write_bytes(bytes(bc6))
    assert JaxPool().try_import(str(path), "t") == 0
    with pytest.raises(UnsupportedImage, match="BC6H"):
        TexturePool().try_import(str(path), "t")


def _ico_cases():
    cases = {}
    img = Image.fromarray(smooth(32, 32)).convert("RGBA")
    img.putalpha(Image.fromarray(smooth(32, 32)[..., 1]))
    for mode in ("RGBA", "RGB", "P", "L", "1"):
        for fmt in ("png", "bmp"):
            buf = io.BytesIO()
            img.convert(mode).save(buf, "ICO", bitmap_format=fmt,
                                   sizes=[(16, 16), (32, 32), (24, 24)])
            cases[f"ICO {mode} {fmt}"] = buf.getvalue()
    g = np.random.default_rng(16)

    def dib(w, h, bits, pal, px):
        palb = b"".join(bytes([c[2], c[1], c[0], 0]) for c in pal or [])
        return struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0,
                           len(px), 0, 0, 0, 0) + palb + px

    def cur(entries):
        off, dirs, body = 6 + 16 * len(entries), b"", b""
        for w, h, d in entries:
            dirs += struct.pack("<BBBBHHII", w, h, 0, 0, 1, 1, len(d),
                                off + len(body))
            body += d
        return b"\0\0\2\0" + struct.pack("<H", len(entries)) + dirs + body

    w, h = 13, 9
    for bits in (1, 4, 8, 24, 32):
        stride = ((w * bits + 31) >> 3) & ~3
        pal = g.integers(0, 256, (1 << bits, 3)).tolist() \
            if bits <= 8 else None
        px = g.integers(0, 256, 2 * stride * h, dtype=np.uint8).tobytes()
        cases[f"CUR {bits}-bit"] = cur([(w, h, dib(w, h, bits, pal, px))])
        cases[f"CUR {bits}-bit, second entry larger"] = cur(
            [(4, 4, dib(4, 4, bits, pal, px[:160])),
             (w, h, dib(w, h, bits, pal, px))])
    return cases


@pytest.mark.parametrize("name", list(_ico_cases()))
def test_ico_and_cur(tmp_path, name):
    """ICO files PIL writes (PNG and BMP frames, every mode; the largest
    entry loads, a BMP frame's alpha from its AND mask or, at 32 bits,
    its fourth bytes) and hand-built cursors (the largest entry, no mask,
    a 32-bit bitmap at byte 22 keeping its alpha)."""
    path = tmp_path / "t.ico"
    path.write_bytes(_ico_cases()[name])
    assert_same(path)


def _repaired_cases():
    g = np.random.default_rng(17)
    cases = {}
    for w in (1, 3, 4, 5, 11):
        idx = g.integers(0, 16, (7, w))
        cases[f"4-bit grey ramp, width {w}"] = write_bmp(
            w, 7, 4, _rows(idx, 4), [[i] * 3 for i in range(16)])
    runs4 = bytes([5, 0x3A, 0, 4, 0x12, 0x34, 0, 0]) * 3 + b"\0\1"
    cases["RLE4 grey ramp"] = write_bmp(9, 3, 4, runs4,
                                        [[i] * 3 for i in range(16)],
                                        comp=2)
    w, h = 9, 6
    raw = g.integers(0, 256, 2 * h).astype(np.uint8).tobytes()
    for flags in (0, 0x20):
        cases[f"1-bit RLE TGA, origin {flags:#x}"] = write_tga(
            w, h, 11, 1, _tga_rle(raw, 1, 2) + bytes(64), flags=flags)
    return cases


@pytest.mark.parametrize("name", list(_repaired_cases()))
def test_grey_ramp_bmp_and_one_bit_rle_tga(tmp_path, name):
    """A 4-bit BMP whose palette is the grey ramp reads its packed rows as
    8-bit grey in PIL (from a memory map of the file, a row past its
    padded bytes running on into the next); PIL 12's RLE decoder never
    fills a 1-bit TGA (-1 in both pools)."""
    path = tmp_path / ("t.tga" if "TGA" in name else "t.bmp")
    path.write_bytes(_repaired_cases()[name])
    want, got = both(path)
    if isinstance(want, int):
        assert got == want == -1
    else:
        assert_same(path)


# ------------------------------------------------------------ raster formats

def _pil_bytes(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _pcx_planes(idx, planes, pal, stride_pad=0):
    """A PCX of `planes` one-bit planes (EGA style), rows RLE-coded as
    PIL codes them, the stride made even (PIL's rule) plus `stride_pad`."""
    h, w = idx.shape
    stride = (w + 7) // 8
    stride += stride % 2 + stride_pad
    head = bytearray(128)
    head[0:4] = bytes([10, 5, 1, 1])
    head[4:12] = struct.pack("<HHHH", 0, 0, w - 1, h - 1)
    head[16:64] = np.asarray(pal, np.uint8).tobytes()
    head[65] = planes
    head[66:68] = struct.pack("<H", stride)
    body = bytearray()
    for y in range(h):
        for k in range(planes):
            row = np.zeros(stride, np.uint8)
            bits = np.packbits(((idx[y] >> k) & 1).astype(np.uint8))
            row[:len(bits)] = bits
            for b in row:
                body += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return bytes(head + body)


def _raster_cases():
    g = np.random.default_rng(21)
    cases = {}
    for h, w in ((9, 13), (16, 16), (3, 2)):
        im = Image.fromarray(smooth(h, w))
        rgba = np.asarray(im.convert("RGBA")).copy()
        rgba[..., 3] = g.integers(0, 256, (h, w))
        rgba[::2, 1::3] = rgba[0, 0]
        for mode in ("1", "L", "P", "RGB"):
            x = im.quantize(29) if mode == "P" else im.convert(mode)
            cases[f"PCX {mode} {w}x{h}"] = _pil_bytes(x, "PCX")
            cases[f"DIB {mode} {w}x{h}"] = _pil_bytes(x, "DIB")
        cases[f"DIB RGBA {w}x{h}"] = _pil_bytes(im.convert("RGBA"), "DIB")
        cases[f"QOI RGB {w}x{h}"] = _pil_bytes(im, "QOI")
        cases[f"QOI RGBA {w}x{h}"] = _pil_bytes(Image.fromarray(rgba),
                                                "QOI")
        for mode in ("L", "RGB", "RGBA"):
            src = im.convert(mode)
            if mode == "RGBA":
                src = Image.fromarray(rgba)
            for bpc in (1, 2):
                cases[f"SGI {mode} {8 * bpc}-bit {w}x{h}"] = _pil_bytes(
                    src, "SGI", bpc=bpc)
                px = np.asarray(src).reshape(h, w, -1)[::-1].astype(
                    np.int64) * (257 if bpc == 2 else 1)
                cases[f"SGI RLE {mode} {8 * bpc}-bit {w}x{h}"] = \
                    fixtures.sgi_bytes(px, bpc, rle=True)
        cases[f"MSP 1 {w}x{h}"] = _pil_bytes(im.convert("1"), "MSP")
        bits = np.asarray(im.convert("1")).copy()
        bits[0] = True                       # a blank (all-white) row
        cases[f"MSP 2 {w}x{h}"] = fixtures.msp_bytes(bits, 2)
        cases[f"XBM {w}x{h}"] = _pil_bytes(im.convert("1"), "XBM")
        cases[f"XBM hot spot {w}x{h}"] = _pil_bytes(
            im.convert("1"), "XBM", hotspot=(1, 2))
        for mode in fixtures.PSD_MODES:
            for rle in (False, True):
                cases[f"PSD {mode} {'RLE' if rle else 'raw'} {w}x{h}"] = \
                    fixtures.psd_bytes(mode, w, h, rle, seed=h + w)
        for depth in (1, 4, 8, 24, 32):
            for rle in (False, True):
                tag = "RLE" if rle else "raw"
                cases[f"Sun {depth}-bit {tag} {w}x{h}"] = \
                    fixtures.sun_raster_bytes(depth, w, h, rle, seed=w)
                if depth in (4, 8):
                    cases[f"Sun {depth}-bit map {tag} {w}x{h}"] = \
                        fixtures.sun_raster_bytes(
                            depth, w, h, rle, seed=h,
                            colors=9 if depth == 4 else 200)
            if depth >= 24:
                cases[f"Sun {depth}-bit RGB order {w}x{h}"] = \
                    fixtures.sun_raster_bytes(depth, w, h, False, seed=3,
                                              rgb_order=True)
    idx = g.integers(0, 16, (11, 21))
    pal = g.integers(0, 256, (16, 3))
    cases["PCX 4 planes"] = _pcx_planes(idx, 4, pal)
    cases["PCX 4 planes, padded stride"] = _pcx_planes(idx, 4, pal, 2)
    cases["PCX 2 planes"] = _pcx_planes(idx & 3, 2, pal)
    grey = Image.fromarray(smooth(12, 10)[..., 0])
    ramp = _pil_bytes(grey.convert("P"), "PCX")
    cases["PCX 8-bit, grey-ramp palette"] = ramp[:-768] + bytes(
        np.repeat(np.arange(256, dtype=np.uint8), 3))
    frame = _pil_bytes(Image.fromarray(smooth(10, 14)), "PCX")
    cases["DCX, one frame"] = (struct.pack("<II", 0x3ADE68B1, 12)
                               + struct.pack("<I", 0) + frame)
    for fmt in fixtures.RASTER_FORMATS:
        cases[f"fixtures.raster_bytes {fmt}"] = fixtures.raster_bytes(
            fmt, 37, 23, seed=5)
    cases["DCX, two frames"] = (
        struct.pack("<III", 0x3ADE68B1, 16, 16 + len(frame))
        + struct.pack("<I", 0) + frame + _pil_bytes(grey, "PCX"))
    return cases


RASTER_CASES = _raster_cases()


@pytest.mark.parametrize("name", list(RASTER_CASES))
def test_raster_formats_equal_pil(tmp_path, name):
    """DIB, PCX, DCX, QOI, SGI (raw and RLE, 8 and 16 bits), PSD (raw and
    PackBits), Sun raster (raw and RLE, with and without a colour map),
    MSP (versions 1 and 2) and XBM: the port's RGBA equals PIL's byte for
    byte."""
    path = tmp_path / "t.img"
    path.write_bytes(RASTER_CASES[name])
    assert_same(path)


@pytest.mark.parametrize("name", ["PCX RGB 16x16", "QOI RGBA 16x16",
                                  "SGI RLE RGB 8-bit 16x16",
                                  "PSD RGB RLE 16x16",
                                  "Sun 8-bit map RLE 16x16", "MSP 2 16x16",
                                  "XBM 16x16", "DCX, one frame"])
def test_raster_formats_truncated_are_minus_one(tmp_path, name):
    data = RASTER_CASES[name]
    path = tmp_path / "t.img"
    path.write_bytes(data[:len(data) * 2 // 3])
    assert both(path) == [-1, -1]


@pytest.mark.parametrize("rle", [False, True], ids=["raw", "packbits"])
def test_psd_cmyk_loads_in_jax_and_port(tmp_path, rle):
    """A CMYK composite (colour mode 4) whose channel count says RGBA's
    four: PIL reads each plane inverted and converts CMYK to RGB; the
    port's RGBA equals PIL's."""
    data = bytearray(fixtures.psd_bytes("RGBA", 6, 5, rle, seed=1))
    data[24:26] = struct.pack(">H", 4)
    path = tmp_path / "t.psd"
    path.write_bytes(bytes(data))
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
    """{case: (extension, PIL save arguments, whether the port decodes
    it)}: formats PIL writes, decoded by the port or still raising."""
    cases = {"progressive jpeg": ("jpg", dict(format="JPEG",
                                              progressive=True), True),
             "gif": ("gif", dict(format="GIF"), True),
             "tiff": ("tif", dict(format="TIFF"), True),
             "ppm": ("ppm", dict(format="PPM"), True),
             "ico": ("ico", dict(format="ICO"), True),
             "dds": ("dds", dict(format="DDS"), True),
             "pcx": ("pcx", dict(format="PCX"), True),
             "dib": ("dib", dict(format="DIB"), True),
             "qoi": ("qoi", dict(format="QOI"), True),
             "sgi": ("sgi", dict(format="SGI"), True),
             "jpeg in tiff": ("tif", dict(format="TIFF",
                                          compression="jpeg"), True)}
    if features.check("webp"):
        cases["webp"] = ("webp", dict(format="WEBP", lossless=True), False)
    return cases


@pytest.mark.parametrize("name", list(_unported()))
def test_unported_format_loads_in_jax_and_raises_in_port(tmp_path, name):
    """Each format loads in the JAX pool; the port's pool gives the same
    bytes for those it decodes and raises UnsupportedImage, naming the
    format, for the rest."""
    ext, kw, decoded = _unported()[name]
    path = tmp_path / f"t.{ext}"
    Image.fromarray(smooth(16, 16)).save(path, **kw)
    assert JaxPool().try_import(str(path), "t") == 0
    if decoded:
        assert_same(path)
        return
    with pytest.raises(UnsupportedImage, match="not decoded by the port"):
        TexturePool().try_import(str(path), "t")


EXR_HEADER = (b"\x76\x2f\x31\x01\x02\x00\x00\x00channels\x00chlist\x00"
              + bytes(40))


def test_unrecognised_bytes_raise(tmp_path):
    """Bytes no PIL plugin identifies (seeded noise, an OpenEXR header,
    a colour PFM) leave the slot at -1 in both pools, as files PIL does
    not identify do in the JAX package."""
    noise = np.random.default_rng(9).integers(0, 256, 300,
                                              dtype=np.uint8).tobytes()
    pf = b"PF\n2 2\n-1.0\n" + np.zeros(12, "<f4").tobytes()
    for data in (b"this is not an image at all", noise, EXR_HEADER, pf):
        path = tmp_path / "t.png"
        path.write_bytes(data)
        assert both(path) == [-1, -1], data[:16]


@pytest.mark.parametrize("data", [
    b"", b"\x00" * 64, b"P7 332\n", b"GIF89a", b"II*\x00\x08\x00\x00\x00",
    b"\x89PNG\r\n\x1a\n", b"BM" + bytes(60), b"P6\n4 4\n255\n",
    b"\xff\xd8\xff\xe0" + bytes(20), EXR_HEADER],
    ids=["empty", "zeros", "xv thumb", "gif head", "tiff head", "png head",
         "bmp zeros", "ppm head", "jpeg head", "exr"])
def test_identification_as_pil(tmp_path, data):
    """Short, empty and header-only files: -1 in both pools, or, where
    PIL identifies a format the port does not decode, a raise."""
    path = tmp_path / "t.bin"
    path.write_bytes(data)
    want = JaxPool().try_import(str(path), "t")
    try:
        got = TexturePool().try_import(str(path), "t")
    except UnsupportedImage:
        got = "raise"
    assert want == -1 and got in (-1, "raise"), (want, got)
    if got == "raise":                   # a PIL plugin accepts the bytes
        name, _ = imageformat.identify(data)
        assert Image.OPEN[name][1](data[:16])


MAGICS = [b"BLP1", b"BM", b"(\x00\x00\x00", b"BUFR", b"\x00\x00\x02\x00",
          b"\n\x05", b"\xb1h\xde:", b"DDS ", b"%!PS", b"\xc5\xd0\xd3\xc6",
          b"SIMPLE", b"FTEX", b"GIF87a", b"GRIB\x00\x00\x00\x01",
          b"\x89HDF\r\n\x1a\n", b"\x89PNG\r\n\x1a\n", b"\xffO\xffQ",
          b"icns", b"\x00\x00\x01\x00", b"\xff\xd8\xff",
          b"\x00" * 7 + b"\x04", b"\x00\x00\x01\xb3", b"II*\x00", b"MM\x00+",
          b"DanM", b"\x80\xe8\x00\x00", b"P5", b"Pf", b"P7", b"8BPS", b"qoif",
          b"\x01\xda", b"Y\xa6j\x95", b"RIFF\x00\x00\x00\x00WEBPVP8L",
          b"\x01\x00\x00\x00", b"  #define", b"/* XPM */", b"P7 332",
          b"\x00\x00\x00\x0cftypavif"]


def test_signature_table_copies_pil():
    """Every `_accept` PIL registers for Image.open, against the port's
    copy, on each plugin's magic and on seeded noise (16-byte prefixes,
    as Image.open reads): the same verdict, except where the port's row
    adds the `_open` test that lets PIL go on to the next plugin (CUR and
    ICO with an empty directory, PPM magics PIL has no mode for, GBR
    headers its `_open` refuses)."""
    from PIL import Image as PILImage
    PILImage.init()
    g = np.random.default_rng(4)
    probes = [m + bytes(16) for m in MAGICS]
    probes += [m + bytes([1, 0]) + bytes(14) for m in MAGICS]
    probes += [g.integers(0, 256, 16, dtype=np.uint8).tobytes()
               for _ in range(400)]
    probes += [bytes([k]) + g.integers(0, 256, 15, dtype=np.uint8).tobytes()
               for k in (0, 1, 0x0A, 0x1C, 0x50, 0xFF) for _ in range(40)]
    rows = {name: test for name, test, _ in imageformat._PLUGINS}
    assert set(rows) == set(PILImage.ID)
    opened = ("CUR", "ICO", "PPM", "GBR")
    for name in PILImage.ID:
        accept = PILImage.OPEN[name][1]
        if accept is None:
            continue
        for data in probes:
            want = bool(accept(data))
            got = rows[name](data)
            if name in opened and want and not got:
                continue
            assert got == want, (name, data)


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
