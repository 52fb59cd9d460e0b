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
identifies; a well-formed file the port does not decode would load in
the JAX pool and raise UnsupportedImage in the port's, so that a gap
stays visible (an AVIF at PIL's default settings, whose AV1 frame needs
the in-loop filters, now decodes); AVIF itself has
tests/test_torch_avif.py and tests/test_torch_avif_filters.py. DDS (uncompressed layouts and
BC1-BC7 through native/bcn.cpp, BC6H unsigned and signed), ICO and CUR
equal PIL on files PIL writes and on DDS files of seeded blocks
(`fixtures.dds_bytes`). PIL's simple plugins (XPM, XV thumbnail, IM with
its YCC type, IMT, SPIDER, PIXAR, McIdas, FTEX, GBR, FITS, BLP, ICNS with
PNG and RLE members, FLI / FLC, Photo CD, IPTC) are held on files PIL
writes and on hand-built ones (`fixtures.fli_bytes`, `pcd_bytes`,
`iptc_bytes`, `icns_rle_bytes`) and ICNS JPEG 2000 members, with the
variants PIL fails on (-1 in both); EPS follows PIL's Ghostscript
lookup. The TIFF compressions and modes libtiff decodes for PIL (CCITT,
LZMA, Zstandard, ThunderScan, old-style LZW and JPEG, YCbCr through
libtiff's RGBA reader, 12-bit grey, palettes with extra samples, tiles
below 8 bits, planar layouts) are held on files PIL writes and on
fixtures, with the files of tests/data/tiff; the TIFF, JPEG and PSD
layouts PIL fails on are -1 in both. JPEG 2000 has
tests/test_torch_jpeg2000.py. WebP has tests/test_torch_webp.py;
here it is one of the formats PIL writes, and the textured-plane render
takes a lossy WebP diffuse map beside the JPEG one."""
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
    truncated block stream is -1 in both, and BC6H, unsigned (DXGI 95)
    and signed (96), decodes as PIL does on seeded blocks of its 14 modes
    and 4 reserved ones."""
    path = tmp_path / "t.dds"
    data = fixtures.dds_bytes("BC7", 2048, 2048, seed=7)
    path.write_bytes(data)
    assert_same(path)
    path.write_bytes(data[:len(data) // 2])
    assert both(path) == [-1, -1]
    for fmt in ("BC6H", "BC6HS"):
        path.write_bytes(fixtures.dds_bytes(fmt, 64, 36, seed=1))
        assert_same(path)


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
        w, h = (32, 32) if fmt == "icns" else (37, 23)   # an icon's size
        cases[f"fixtures.raster_bytes {fmt}"] = fixtures.raster_bytes(
            fmt, w, h, seed=5)
    cases["DCX, two frames"] = (
        struct.pack("<III", 0x3ADE68B1, 16, 16 + len(frame))
        + struct.pack("<I", 0) + frame + _pil_bytes(grey, "PCX"))
    return cases


# ------------------------------------------------------------ PIL's simple
# raster plugins: XPM, XV thumbnail, IM, IMT, SPIDER, PIXAR, McIdas, FTEX,
# GBR, FITS, BLP and ICNS (PNG members)

def _xpm(g, w, h, n, cpp, none=None, pixels_comment=True):
    """An XPM of n seeded colours, keys of cpp characters; `none`: a
    "None" key that is unused ("unused") or used by one pixel ("used")."""
    alphabet = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123"
    keys = [bytes(alphabet[(i // len(alphabet) ** j) % len(alphabet)]
                  for j in range(cpp)) for i in range(n)]
    out = [b"/* XPM */", b"static char *t[] = {",
           b"/* columns rows colors chars-per-pixel */",
           b'"%d %d %d %d",' % (w, h, n + (none is not None), cpp)]
    out += [b'"%s c #%06X",' % (k, c)
            for k, c in zip(keys, g.integers(0, 1 << 24, n))]
    if none is not None:
        out.append(b'"%s c None",' % (b"~" * cpp))
    if pixels_comment:
        out.append(b"/* pixels */")
    rows = [[keys[i] for i in r] for r in g.integers(0, n, (h, w))]
    if none == "used":
        rows[0][0] = b"~" * cpp
    out += [b'"' + b"".join(r) + b'",' for r in rows]
    return b"\n".join(out + [b"};", b""])


def _xv(g, w, h, comments=True):
    return (b"P7 332\n"
            + (b"#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n" if comments
               else b"")
            + b"%d %d 255\n" % (w, h)
            + g.integers(0, 256, w * h, dtype=np.uint8).tobytes())


def _pixar(g, w, h, codes=(14, 2)):
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<HHxxxxHH", head, 416, h, w, *codes)
    return bytes(head) + g.integers(0, 256, 3 * w * h,
                                    dtype=np.uint8).tobytes()


def _mcidas(g, w, h, b, pad=3, elems=1, tail=0):
    """A McIdas area: w[11] = b bytes a sample, rows of pad + w * b *
    elems bytes."""
    words = [0] * 65
    for k, v in {2: 4, 9: h, 10: w, 11: b, 14: elems, 15: pad,
                 34: 256}.items():
        words[k] = v
    stride = pad + w * b * elems
    return struct.pack(">64i", *words[1:]) + g.integers(
        0, 256, stride * h + tail, dtype=np.uint8).tobytes()


def _ftex(g, w, h, fmt):
    n = ((w + 3) // 4) * ((h + 3) // 4) * 8 if fmt == 0 else 3 * w * h
    body = g.integers(0, 256, n, dtype=np.uint8).tobytes()
    return (b"FTEX" + struct.pack("<7i", 1, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(body)) + body)


def _gbr(g, w, h, depth, version):
    comment = b"brush\0"
    head = struct.pack(">5I", (20 if version == 1 else 28) + len(comment),
                       version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 10)
    return head + comment + g.integers(0, 256, w * h * depth,
                                       dtype=np.uint8).tobytes()


def _card(k, v=None):
    return (k.ljust(8).encode() + (b"" if v is None else
                                   b"= " + str(v).rjust(20).encode())
            ).ljust(80)


def _fits_unit(cards):
    head = b"".join(_card(*c) for c in cards) + b"END".ljust(80)
    return head + b" " * (-len(head) % 2880)


def _fits(g, w, h, bitpix, naxis=2, extra=()):
    cards = [("SIMPLE", "T"), ("BITPIX", bitpix), ("NAXIS", naxis),
             ("NAXIS1", w)] + ([("NAXIS2", h)] if naxis == 2 else [])
    if bitpix < 0:
        body = g.normal(100, 90, w * h).astype(f">f{-bitpix // 8}")
    else:
        nb = bitpix // 8
        body = g.integers(0, 256 ** nb, w * h, dtype=np.uint64).astype(
            {1: "u1", 2: ">u2", 4: ">u4"}[nb])
    body = body.tobytes()
    return (_fits_unit(cards + list(extra)) + body
            + b"\0" * (-len(body) % 2880))


def _fits_gzip(g, w, h, zbitpix):
    """A tile-compressed FITS: a BINTABLE whose table PIL skips, then
    one gzip stream of 4-byte words."""
    words = g.integers(0, 1 << 32, w * h, dtype=np.uint64).astype(">u4")
    ext = [("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
           ("NAXIS1", 8), ("NAXIS2", h), ("ZIMAGE", "T"),
           ("ZCMPTYPE", "'GZIP_1  '"), ("ZBITPIX", zbitpix), ("ZNAXIS", 2),
           ("ZNAXIS1", w), ("ZNAXIS2", h)]
    return (_fits_unit([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)])
            + _fits_unit(ext) + bytes(8 * h)
            + zlib.compress(words.tobytes(), wbits=31))


def _blp2_dxt(g, w, h, alpha_enc, alpha):
    """A BLP2 of DXT blocks (alpha encoding 0, 1 or 7: DXT1, DXT3,
    DXT5); half the DXT1 blocks in 3-colour order."""
    n = ((w + 3) // 4) * ((h + 3) // 4)
    blocks = g.integers(0, 256, (n, 8 if alpha_enc == 0 else 16),
                        dtype=np.uint8)
    if alpha_enc == 0:
        c = blocks[:, :4].copy().view("<u2")
        swap = g.random(n) < 0.5
        c[swap] = c[swap][:, ::-1]
        blocks[:, :4] = c.view(np.uint8)
    body = blocks.tobytes()
    head = (b"BLP2" + struct.pack("<i", 1)
            + struct.pack("<bbbb", 2, alpha, alpha_enc, 0)
            + struct.pack("<II", w, h))
    return (head + struct.pack("<16I", 1172, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15)
            + g.integers(0, 256, 1024, dtype=np.uint8).tobytes() + body)


def _blp1_jpeg(w, h, alpha, grey=False, picture=None):
    """A BLP1 of JPEG compression: the JPEG's tables as the shared
    header, its scans as the mip, 10 bytes apart."""
    im = Image.fromarray(smooth(*(picture or (h, w))))
    j = _pil_bytes(im.convert("L") if grey else im, "JPEG", quality=90)
    cut = j.index(b"\xff\xda")
    header, body = j[:cut], j[cut:]
    off = 160 + len(header) + 10
    return (b"BLP1" + struct.pack("<iIIIii", 0, alpha, w, h, 5, 0)
            + struct.pack("<16I", off, *[0] * 15)
            + struct.pack("<16I", len(body), *[0] * 15)
            + struct.pack("<I", len(header)) + header + bytes(10) + body)


def _icns(members):
    body = b"".join(code + struct.pack(">I", len(b) + 8) + b
                    for code, b in members)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def _spider_stack(data):
    """PIL's SPIDER file as the first image of a stack: the stack flag
    set and a second header before the pixels (PIL skips both)."""
    words = np.frombuffer(data, ">f4").copy()
    hdr = int(words[21])
    words[23], words[25] = 1, 1
    head = words[:hdr // 4].tobytes()
    return head + head + data[hdr:]


def _tier1_cases():
    g = np.random.default_rng(31)
    cases = {}
    pic = Image.fromarray(smooth(13, 9))
    rgba = np.asarray(pic.convert("RGBA")).copy()
    rgba[..., 3] = g.integers(0, 256, (13, 9))
    cases["XPM 20 colours 1 char 11x7"] = _xpm(g, 11, 7, 20, 1)
    cases["XPM 200 colours 2 chars 11x7"] = _xpm(g, 11, 7, 200, 2)
    cases["XPM 300 colours (RGB) 9x8"] = _xpm(g, 9, 8, 300, 2)
    cases["XPM unused None key 6x5"] = _xpm(g, 6, 5, 9, 1, "unused")
    cases["XPM no pixels comment 9x8"] = _xpm(g, 9, 8, 30, 1,
                                              pixels_comment=False)
    cases["XV thumbnail 13x7"] = _xv(g, 13, 7)
    cases["XV thumbnail no comments 5x9"] = _xv(g, 5, 9, False)
    ims = {"1": pic.convert("1"), "L": pic.convert("L"),
           "LA": Image.fromarray(rgba).convert("LA"), "P": pic.quantize(20),
           "PA": pic.quantize(20).convert("PA"),
           "I": Image.fromarray(smooth(13, 9)[..., 0].astype(np.int32) * 3
                                - 100),
           "I;16": pic.convert("L").convert("I;16"),
           "F": Image.fromarray(smooth(13, 9)[..., 0].astype(np.float32)
                                * 1.7 - 50.3),
           "RGB": pic, "RGBA": Image.fromarray(rgba),
           "RGBX": pic.convert("RGBX"), "CMYK": pic.convert("CMYK")}
    for mode, im in ims.items():
        cases[f"IM {mode} 9x13"] = _pil_bytes(im, "IM")
    ramp = Image.fromarray(np.arange(256, dtype=np.uint8).reshape(16, 16))
    cases["IM P, grey palette"] = _pil_bytes(ramp.convert("P"), "IM")
    cases["IM L 16B"] = cases["IM I;16 9x13"].replace(b"L 16 image",
                                                      b"L 16B image")
    head = b"Image type: X 24 image\r\nImage size (x*y): 9*13\r\n"
    cases["IM X 24"] = (head + b"\0" * (511 - len(head)) + b"\x1a"
                        + smooth(13, 9).tobytes())
    cases["IMT 9x7"] = (b"width 9\nheight 7\n* a comment\npixel n8\n\x0c"
                        + g.integers(0, 256, 63, dtype=np.uint8).tobytes())
    spider = _pil_bytes(ims["F"], "SPIDER")
    cases["SPIDER F 9x13"] = spider
    cases["SPIDER from L 9x13"] = _pil_bytes(ims["L"], "SPIDER")
    cases["SPIDER little-endian"] = np.frombuffer(spider, ">f4").astype(
        "<f4").tobytes()
    cases["SPIDER stack"] = _spider_stack(spider)
    cases["PIXAR 7x5"] = _pixar(g, 7, 5)
    for b in (1, 2, 4):
        cases[f"McIdas {8 * b}-bit 9x6"] = _mcidas(g, 9, 6, b)
    cases["McIdas 8-bit, rows overlapping"] = _mcidas(g, 9, 6, 1, 3, 0, 50)
    for fmt, tag in ((0, "DXT1"), (1, "RGB")):
        for w, h in ((16, 8), (13, 7)):
            cases[f"FTEX {tag} {w}x{h}"] = _ftex(g, w, h, fmt)
    for depth in (1, 4):
        for version in (1, 2):
            cases[f"GBR depth {depth} v{version} 7x9"] = _gbr(g, 7, 9, depth,
                                                             version)
    for bitpix in (8, 16, 32, -32, -64):
        cases[f"FITS BITPIX {bitpix} 11x7"] = _fits(g, 11, 7, bitpix)
    cases["FITS one axis"] = _fits(g, 11, 1, 8, naxis=1)
    cases["FITS BZERO ignored"] = _fits(g, 11, 7, 16,
                                        extra=[("BZERO", 32768)])
    for zbitpix in (8, 16, 32):
        cases[f"FITS gzip tiles {zbitpix}"] = _fits_gzip(g, 9, 7, zbitpix)
    pal = pic.quantize(50)
    trans = pic.quantize(50)
    trans.info["transparency"] = 3
    for version in ("BLP1", "BLP2"):
        cases[f"BLP {version} palette"] = _pil_bytes(pal, "BLP",
                                                     blp_version=version)
        cases[f"BLP {version} palette, alpha"] = _pil_bytes(
            trans, "BLP", blp_version=version)
    for enc, tag in ((0, "DXT1"), (1, "DXT3"), (7, "DXT5")):
        for alpha in (0, 8):
            for w, h in ((16, 12), (13, 7)):
                cases[f"BLP2 {tag} alpha {alpha} {w}x{h}"] = _blp2_dxt(
                    g, w, h, enc, alpha)
    for alpha in (0, 8):
        cases[f"BLP1 JPEG alpha {alpha}"] = _blp1_jpeg(16, 12, alpha)
        cases[f"BLP1 JPEG grey alpha {alpha}"] = _blp1_jpeg(13, 9, alpha,
                                                           grey=True)
    cases["BLP1 JPEG narrower than its picture"] = _blp1_jpeg(
        10, 12, 0, picture=(12, 16))
    cases["ICNS written by PIL"] = _pil_bytes(Image.fromarray(
        smooth(16, 16)), "ICNS")
    big = Image.fromarray(np.asarray(Image.fromarray(smooth(32, 32))
                                     .convert("RGBA")))
    for mode in ("RGBA", "RGB", "P", "L", "LA"):
        src = {"P": big.convert("RGB").quantize(30)}.get(mode) or \
            big.convert(mode)
        cases[f"ICNS icp5 PNG {mode}"] = _icns([(b"icp5",
                                                 _pil_bytes(src, "PNG"))])
    cases["ICNS two PNG members"] = _icns([
        (b"icp4", _pil_bytes(Image.fromarray(smooth(16, 16)), "PNG")),
        (b"ic08", _pil_bytes(Image.fromarray(smooth(256, 256)), "PNG"))])
    return cases


def _tier1_damage():
    """Files of these plugins that PIL fails on: -1 in both pools."""
    g = np.random.default_rng(32)
    png = _pil_bytes(Image.fromarray(smooth(24, 24)), "PNG")
    gbr = bytearray(_gbr(g, 7, 9, 4, 2))
    gbr[3] = 24                           # a version-2 header under 28
    blp = bytearray(_blp2_dxt(g, 8, 8, 0, 0))
    blp[8] = 3                            # "raw BGRA", which PIL refuses
    return {
        "XPM pixel of the None key": _xpm(g, 6, 5, 9, 1, "used"),
        "XPM 300 colours with a None key": _xpm(g, 9, 8, 300, 2, "unused"),
        "PIXAR channel codes other than 14, 2": _pixar(g, 7, 5, (14, 3)),
        "McIdas stride 0": _mcidas(g, 9, 6, 1, 0, 0, 50),
        "McIdas 32-bit rows overlapping": _mcidas(g, 9, 6, 4, 3, 0, 50),
        "FITS gzip tiles of floats": _fits_gzip(g, 9, 7, -32),
        "FITS without an image": _fits_unit([("SIMPLE", "T"),
                                             ("BITPIX", 8), ("NAXIS", 0)])
        + bytes(2880),
        "GBR version 2, short header": bytes(gbr),
        "BLP2 raw BGRA": bytes(blp),
        "ICNS member of a size no icon has": _icns([(b"ic12", png)]),
        "ICNS member neither PNG nor JPEG 2000": _icns([(b"icp5",
                                                         b"junk" * 20)]),
    }


def _tier1_decoded():
    """IM's YCC type, ICNS RLE and JPEG 2000 members, FLI / FLC, Photo
    CD and IPTC (files PIL reads that the port decodes since it gained
    their decoders)."""
    pic = Image.fromarray(smooth(16, 16))
    cases = {
        "ICNS JPEG 2000 member": _icns([(b"icp4", _pil_bytes(
            pic, "JPEG2000"))]),
        "ICNS JPEG 2000 raw codestream member": _icns([(b"ic07", _pil_bytes(
            Image.fromarray(smooth(128, 128)), "JPEG2000", no_jp2=True,
            irreversible=True))]),
        "IM YCC": _pil_bytes(pic.convert("YCbCr"), "IM"),
        "ICNS RLE RGB member": _icns([(b"is32", bytes(16 * 16 * 3)),
                                      (b"icp4", _pil_bytes(pic, "PNG"))]),
    }
    for size in sorted(fixtures.ICNS_RLE_MEMBERS):
        cases[f"ICNS RLE {size} with mask"] = fixtures.icns_rle_bytes(
            size, seed=size)
    cases["ICNS RLE 32 without mask"] = fixtures.icns_rle_bytes(
        32, seed=3, mask=False)
    cases["ICNS raw RGB 48 with mask"] = fixtures.icns_rle_bytes(
        48, seed=4, rle=False)
    for first in ("brun", "copy", "lc"):
        cases[f"FLC {first} 37x21"] = fixtures.fli_bytes(37, 21, seed=5,
                                                         first=first)
    cases["FLI COLOR_64 brun 20x9"] = fixtures.fli_bytes(
        20, 9, seed=6, flc=False, colour64=True)
    for o in (0, 1, 2, 3):
        cases[f"PCD orientation {o}"] = fixtures.pcd_bytes(seed=o,
                                                           orientation=o)
    cases["IPTC raw one band 17x13"] = fixtures.iptc_bytes(17, 13, seed=7)
    cases["IPTC raw, long records 200x180"] = fixtures.iptc_bytes(
        200, 180, seed=8, record=40000)
    for layers, band in ((3, 0), (3, 2), (4, 3), (3, -1)):
        cases[f"IPTC raw band {band} of {layers}"] = fixtures.iptc_bytes(
            17, 13, seed=9, layers=layers, band=band)
    for mode in ("L", "RGB"):
        jpg = _pil_bytes(Image.fromarray(smooth(13, 17)).convert(mode),
                         "JPEG", quality=85)
        cases[f"IPTC JPEG {mode}"] = fixtures.iptc_bytes(17, 13,
                                                         payload=jpg)
    jpg = _pil_bytes(Image.fromarray(smooth(13, 17)).convert("L"), "JPEG")
    cases["IPTC JPEG band 1 of 3"] = fixtures.iptc_bytes(
        17, 13, layers=3, band=1, payload=jpg)
    return cases


TIER1_CASES = {**_tier1_cases(), **_tier1_decoded()}
RASTER_CASES = {**_raster_cases(), **TIER1_CASES}


@pytest.mark.parametrize("name", list(RASTER_CASES))
def test_raster_formats_equal_pil(tmp_path, name):
    """DIB, PCX, DCX, QOI, SGI (raw and RLE, 8 and 16 bits), PSD (raw and
    PackBits), Sun raster (raw and RLE, with and without a colour map),
    MSP (versions 1 and 2), XBM, and PIL's simple plugins: XPM (P and
    RGB), XV thumbnails, IM (every mode PIL writes, YCC included), IMT,
    SPIDER, PIXAR, McIdas, FTEX, GBR, FITS (every BITPIX, gzip tiles),
    BLP (palette, DXT1/3/5, JPEG), ICNS PNG, JPEG 2000, RLE and raw RGB
    members with their masks, FLI / FLC (BRUN, COPY, BLACK and LC, SS2,
    COLOR_256 and COLOR_64), Photo CD in each orientation and IPTC (raw one band, a
    band of RGB or CMYK, JPEG): the port's RGBA equals PIL's byte for
    byte."""
    path = tmp_path / "t.img"
    path.write_bytes(RASTER_CASES[name])
    assert_same(path)


@pytest.mark.parametrize("name", [
    "PCX RGB 16x16", "QOI RGBA 16x16", "SGI RLE RGB 8-bit 16x16",
    "PSD RGB RLE 16x16", "Sun 8-bit map RLE 16x16", "MSP 2 16x16",
    "XBM 16x16", "DCX, one frame", "XPM 200 colours 2 chars 11x7",
    "XV thumbnail 13x7", "IM RGB 9x13", "IM P 9x13", "IM F 9x13",
    "IMT 9x7", "SPIDER F 9x13", "PIXAR 7x5", "McIdas 16-bit 9x6",
    "FTEX DXT1 16x8", "FTEX RGB 13x7", "GBR depth 4 v2 7x9",
    "FITS gzip tiles 16", "BLP BLP1 palette",
    "BLP BLP2 palette, alpha", "BLP2 DXT5 alpha 8 16x12",
    "BLP1 JPEG alpha 0", "ICNS icp5 PNG RGBA", "ICNS RLE 16 with mask",
    "FLC brun 37x21", "PCD orientation 1", "IPTC raw one band 17x13",
    "IPTC JPEG RGB"])
def test_raster_formats_truncated_are_minus_one(tmp_path, name):
    data = RASTER_CASES[name]
    path = tmp_path / "t.img"
    path.write_bytes(data[:len(data) * 2 // 3])
    assert both(path) == [-1, -1]


@pytest.mark.parametrize("name", list(_tier1_damage()))
def test_simple_raster_damage_is_minus_one(tmp_path, name):
    """Variants PIL opens and then fails on (a pixel of XPM's "None"
    key, PIXAR channels other than RGB, McIdas strides PIL refuses, FITS
    gzip floats, an icon member of a size no icon has, ...): -1 in both
    pools."""
    path = tmp_path / "t.img"
    path.write_bytes(_tier1_damage()[name])
    assert both(path) == [-1, -1]


@pytest.mark.parametrize("found", [False, True],
                         ids=["no Ghostscript", "Ghostscript"])
def test_eps_follows_ghostscript(tmp_path, monkeypatch, found):
    """EPS: PIL rasterises through Ghostscript at load. Without it the
    JAX pool gives -1 and so does the port's; with it the port raises
    UnsupportedImage, since PIL would render the page."""
    import shutil

    from PIL import EpsImagePlugin
    path = tmp_path / "t.eps"
    Image.fromarray(smooth(8, 8)).save(path, "EPS")
    monkeypatch.setattr(shutil, "which",
                        lambda name, *a, **k: "/bin/gs" if found else None)
    if not found:
        monkeypatch.setattr(EpsImagePlugin, "gs_binary", False)
        assert both(path) == [-1, -1]
        return
    with pytest.raises(UnsupportedImage, match="EPS"):
        TexturePool().try_import(str(path), "t")


@pytest.mark.parametrize("platform,binary,found", [
    ("linux", "gs", True), ("linux", "gswin64c", False),
    ("linux", None, False), ("win32", "gswin32c", True),
    ("win32", "gswin64c", True), ("win32", "gs", True),
    ("win32", None, False)])
def test_ghostscript_names_as_pil(monkeypatch, platform, binary, found):
    """The port's Ghostscript check looks for PIL's names: "gs" away
    from Windows, "gswin32c", "gswin64c" or "gs" on it."""
    import shutil
    import sys

    from fluctus_tpu_torch.scene import eps
    monkeypatch.setattr(sys, "platform", platform)
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k:
                        f"/bin/{name}" if name == binary else None)
    assert eps.has_ghostscript() is found


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


# ------------------------------------------------------------ TIFF leftovers

def _bits_tiles(v, tile, bits):
    """(h, w) values of `bits` bits as packed tiles of `tile` pixels."""
    h, w = v.shape
    out = []
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            t = np.zeros((tile, tile), np.uint8)
            part = v[ty:ty + tile, tx:tx + tile]
            t[:part.shape[0], :part.shape[1]] = part
            out.append(np.packbits(np.unpackbits(
                t[..., None], axis=2)[..., 8 - bits:].reshape(tile, -1),
                axis=1).tobytes())
    return out


def _strip(data: bytes) -> bytes:
    """The single strip of a TIFF PIL wrote."""
    im = Image.open(io.BytesIO(data))
    off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    return data[off:off + n]


def _tiff_leftover_cases():
    """{name: (bytes, whether PIL reads it)}: the compressions and modes
    the port gained, written by PIL where it writes them and by
    fixtures.tiff_bytes, ojpeg_tiff_bytes, lzw_compat_bytes,
    thunderscan_bytes and ycbcr_blocks otherwise."""
    import lzma
    tb = fixtures.tiff_bytes
    g = np.random.default_rng(18)
    pic = smooth(29, 37)
    w, h = 37, 29
    bw = Image.fromarray(pic).convert("1")
    cases = {}
    for comp in ("tiff_ccitt", "tiff_raw_16", "group3", "group4"):
        cases[f"PIL {comp}"] = (_pil_bytes(bw, "TIFF", compression=comp),
                                True)
    cases["PIL group3 2D"] = (_pil_bytes(bw, "TIFF", compression="group3",
                                         tiffinfo={292: 1}), True)
    cases["PIL group3 2D, byte-aligned EOLs"] = (_pil_bytes(
        bw, "TIFF", compression="group3", tiffinfo={292: 5}), True)
    wide = np.full((6, 2700), 255, np.uint8)
    for r, (a, b) in enumerate(((1, 1900), (63, 2600), (64, 1729),
                                (1791, 2559), (0, 5), (2047, 2112))):
        wide[r, a:b] = 0
    for comp in ("tiff_ccitt", "group3", "group4"):
        cases[f"PIL {comp} long runs"] = (_pil_bytes(
            Image.fromarray(wide).convert("1"), "TIFF", compression=comp),
            True)
    g4 = _pil_bytes(bw, "TIFF", compression="group4")
    rev = bytes(int(f"{x:08b}"[::-1], 2) for x in _strip(g4))
    cases["G4 fill order 2"] = (tb(w, h, 1, 1, 1, [rev], comp=4, fill=2),
                                True)
    cases["G4 min-is-white"] = (tb(w, h, 1, 1, 0, [_strip(g4)], comp=4),
                                True)
    rlew = _strip(_pil_bytes(bw, "TIFF", compression="tiff_raw_16"))
    cases["32771 at an odd offset"] = (tb(w, h, 1, 1, 1, [rlew],
                                          comp=32771, lead=b"\0"), True)
    tiles = []
    for ty in range(0, 48, 32):
        for tx in range(0, 64, 32):
            t = np.full((32, 32), 255, np.uint8)
            part = np.asarray(bw, np.uint8)[ty:ty + 32, tx:tx + 32] * 255
            t[:part.shape[0], :part.shape[1]] = part
            tiles.append(_strip(_pil_bytes(Image.fromarray(t).convert("1"),
                                           "TIFF", compression="group4")))
    cases["G4 tiles 32x32"] = (tb(w, h, 1, 1, 1, tiles, comp=4,
                                  tile=(32, 32)), True)
    damaged = bytearray(_strip(_pil_bytes(bw, "TIFF",
                                          compression="group3")))
    damaged[len(damaged) // 3] ^= 0x5A
    cases["G3 with a damaged row"] = (tb(w, h, 1, 1, 1, [bytes(damaged)],
                                         comp=3), True)
    raw = pic.tobytes()
    cases["LZMA"] = (tb(w, h, 8, 3, 2, [lzma.compress(raw)], comp=34925),
                     True)
    d16 = np.concatenate([pic[:, :1], np.diff(pic.astype(np.int16), axis=1)
                          .astype(np.uint8)], 1)
    cases["LZMA, predictor"] = (tb(w, h, 8, 3, 2, [lzma.compress(
        d16.tobytes())], comp=34925, pred=2), True)
    cases["LZMA strips"] = (tb(w, h, 8, 3, 2, [lzma.compress(
        pic[r:r + 8].tobytes()) for r in range(0, h, 8)], comp=34925,
        rps=8), True)
    try:
        import zstandard
    except ImportError:
        zstandard = None
    if zstandard is not None:
        for level in (1, 19):
            cases[f"Zstandard level {level}"] = (tb(w, h, 8, 3, 2, [
                zstandard.ZstdCompressor(level=level).compress(raw)],
                comp=50000), True)
        g16 = (pic[..., 0].astype(np.uint16) * 251).astype("<u2")
        cases["Zstandard 16-bit grey with checksum"] = (tb(w, h, 16, 1, 1, [
            zstandard.ZstdCompressor(level=3, write_checksum=True)
            .compress(g16.tobytes())], comp=50000), True)
    for layout in ("jif", "tables"):
        for sub, tag in ((2, (2, 2)), (2, None), (0, (1, 1)), (1, (2, 1))):
            j = _pil_bytes(Image.fromarray(pic), "JPEG", quality=85,
                           subsampling=sub)
            cases[f"OJPEG {layout} {sub} {tag}"] = (
                fixtures.ojpeg_tiff_bytes(j, w, h, layout, subsampling=tag),
                True)
        j = _pil_bytes(Image.fromarray(pic), "JPEG", subsampling=2,
                       restart_marker_blocks=3)
        cases[f"OJPEG {layout} restarts"] = (fixtures.ojpeg_tiff_bytes(
            j, w, h, layout), True)
        j = _pil_bytes(Image.fromarray(pic).convert("L"), "JPEG")
        cases[f"OJPEG {layout} grey"] = (fixtures.ojpeg_tiff_bytes(
            j, w, h, layout, photo=1), True)
    big = np.tile(pic, (5, 4, 1))
    cases["old-style LZW"] = (tb(148, 145, 8, 3, 2, [
        fixtures.lzw_compat_bytes(big.tobytes())], comp=5), True)
    v4 = pic[..., 1] >> 4
    cases["ThunderScan 4-bit"] = (tb(w, h, 4, 1, 1, [
        fixtures.thunderscan_bytes(v4)], comp=32809), True)
    cases["ThunderScan 4-bit strips"] = (tb(w, h, 4, 1, 1, [
        fixtures.thunderscan_bytes(v4[r:r + 10]) for r in range(0, h, 10)],
        comp=32809, rps=10), True)
    y = pic[..., 0]
    for hs, vs in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4),
                   (2, 4)):
        cb = g.integers(0, 256, (-(-h // vs), -(-w // hs)))
        cr = g.integers(0, 256, cb.shape)
        cases[f"YCbCr {hs}x{vs} Deflate"] = (tb(w, h, 8, 3, 6, [
            zlib.compress(fixtures.ycbcr_blocks(y, cb, cr, hs, vs))],
            comp=8, subsampling=[hs, vs]), (hs, vs) != (2, 4))
    cb = g.integers(0, 256, (15, 19))
    cr = g.integers(0, 256, (15, 19))
    blocks = zlib.compress(fixtures.ycbcr_blocks(y, cb, cr, 2, 2))
    cases["YCbCr default subsampling"] = (tb(w, h, 8, 3, 6, [blocks],
                                             comp=8), True)
    cases["YCbCr ReferenceBlackWhite"] = (tb(
        w, h, 8, 3, 6, [blocks], comp=8, tags=[(532, 5, [
            16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])]), True)
    cases["YCbCr coefficients"] = (tb(w, h, 8, 3, 6, [blocks], comp=8,
                                      tags=[(529, 5, [2126, 10000, 7152,
                                                      10000, 722, 10000])]),
                                   True)
    cases["YCbCr strips of 4 rows"] = (tb(w, h, 8, 3, 6, [
        zlib.compress(fixtures.ycbcr_blocks(
            y[r:r + 4], cb[r // 2:r // 2 + 2], cr[r // 2:r // 2 + 2], 2, 2))
        for r in range(0, h, 4)], comp=8, rps=4), True)
    cases["YCbCr planar 1x1"] = (tb(w, h, 8, 3, 6, [
        zlib.compress(pic[..., k].tobytes()) for k in range(3)], comp=8,
        planar=2, subsampling=[1, 1]), True)
    cases["YCbCr planar 2x2"] = (tb(w, h, 8, 3, 6, [
        zlib.compress(pic[..., k].tobytes()) for k in range(3)], comp=8,
        planar=2), False)
    cases["YCbCr LZMA 1x1"] = (tb(w, h, 8, 3, 6, [lzma.compress(raw)],
                                  comp=34925, subsampling=[1, 1]), True)
    cases["YCbCr one sample"] = (tb(w, h, 8, 1, 6, [zlib.compress(
        y.tobytes())], comp=8), False)
    v12 = (pic[..., 0].astype(np.uint16) * 16 + pic[..., 1] % 16)
    bits = np.unpackbits(v12.astype(">u2").view(np.uint8).reshape(
        h, w, 2), axis=2)[..., 4:].reshape(h, -1)
    p12 = np.packbits(bits, axis=1).tobytes()
    cases["12-bit grey"] = (tb(w, h, 12, 1, 1, [p12]), True)
    cases["12-bit grey Deflate"] = (tb(w, h, 12, 1, 1, [zlib.compress(p12)],
                                       comp=8), True)
    cases["12-bit grey, predictor"] = (tb(w, h, 12, 1, 1, [
        zlib.compress(p12)], comp=8, pred=2), False)
    cmap = list(g.integers(0, 65536, 768))
    two = pic[..., :2].tobytes()
    for name, extra in (("PX", 0), ("PA", 2)):
        cases[f"{name} raw"] = (tb(w, h, 8, 2, 3, [two], extra=[extra],
                                   cmap=cmap), True)
        cases[f"{name} Deflate"] = (tb(w, h, 8, 2, 3, [zlib.compress(two)],
                                       comp=8, extra=[extra], cmap=cmap),
                                    True)
    pa = Image.fromarray(pic[..., 0]).convert("P").convert("PA")
    cases["PIL PA"] = (_pil_bytes(pa, "TIFF"), True)
    for bits in (1, 2, 4):
        v = g.integers(0, 1 << bits, (40, 45)).astype(np.uint8)
        t = _bits_tiles(v, 16, bits)
        cases[f"{bits}-bit tiles raw"] = (tb(45, 40, bits, 1, 1, t,
                                             tile=(16, 16)), True)
        cases[f"{bits}-bit tiles Deflate"] = (tb(45, 40, bits, 1, 1, [
            zlib.compress(x) for x in t], comp=8, tile=(16, 16)), True)
        cases[f"{bits}-bit palette tiles Deflate"] = (tb(
            45, 40, bits, 1, 3, [zlib.compress(x) for x in t], comp=8,
            tile=(16, 16), cmap=list(g.integers(0, 65536, 3 << bits))),
            True)
        cases[f"{bits}-bit strips, predictor"] = (tb(
            48, 40, bits, 1, 1, [zlib.compress(b"".join(_bits_tiles(
                v[:, :45], 48, bits)[:1]))], comp=8, pred=2), False)
    planes8 = [np.ascontiguousarray(pic[..., k]).tobytes() for k in range(3)]
    cmyk16 = g.integers(0, 65536, (h, w, 4)).astype("<u2")
    planes16 = [np.ascontiguousarray(cmyk16[..., k]).tobytes()
                for k in range(4)]
    cases["planar CMYK 8-bit Deflate"] = (tb(w, h, 8, 4, 5, [
        zlib.compress(p) for p in planes8 + planes8[:1]], comp=8, planar=2),
        True)
    cases["planar CMYK 16-bit raw"] = (tb(w, h, 16, 4, 5, planes16,
                                          planar=2), True)
    cases["planar CMYK 16-bit Deflate"] = (tb(w, h, 16, 4, 5, [
        zlib.compress(p) for p in planes16], comp=8, planar=2), True)
    for comp in (1, 8):
        ps = planes8 if comp == 1 else [zlib.compress(p) for p in planes8]
        cases[f"planar LAB comp {comp}"] = (tb(w, h, 8, 3, 8, ps, comp=comp,
                                               planar=2), True)
        cases[f"planar PA comp {comp}"] = (tb(w, h, 8, 2, 3, ps[:2],
                                              comp=comp, planar=2,
                                              extra=[2], cmap=cmap),
                                           comp == 8)
        cases[f"planar PX comp {comp}"] = (tb(w, h, 8, 2, 3, ps[:2],
                                              comp=comp, planar=2,
                                              extra=[0], cmap=cmap), False)
    for bits, photo, fmt in ((1, 1, 1), (4, 1, 1), (4, 3, 1), (32, 1, 3),
                             (32, 1, 2), (2, 0, 1), (16, 1, 1)):
        if bits < 8:
            v = g.integers(0, 1 << bits, (h, 16)).astype(np.uint8)
            data = b"".join(_bits_tiles(v, 16, bits)[:1] + _bits_tiles(
                v[16:], 16, bits)[:1])
            ww = 16
        else:
            dt = {16: "<u2", 32: "<f4" if fmt == 3 else "<i4"}[bits]
            data = (g.random((h, w)) * 300).astype(dt).tobytes()
            ww = w
        cases[f"planar single {bits}-bit photometric {photo} format "
              f"{fmt}"] = (tb(ww, h, bits, 1, photo, [data], planar=2,
                              fmt=[fmt], cmap=list(g.integers(
                                  0, 65536, 3 << bits)) if photo == 3
                              else None), (bits, photo) not in (
                                  (2, 0), (4, 1), (16, 1)))
    cases["planar JPEG RGB"] = (tb(w, h, 8, 3, 2, [
        _pil_bytes(Image.fromarray(pic[..., k]), "JPEG") for k in range(3)],
        comp=7, planar=2), True)
    cases["planar JPEG YCbCr 1x1"] = (tb(w, h, 8, 3, 6, [
        _pil_bytes(Image.fromarray(pic[..., k]), "JPEG") for k in range(3)],
        comp=7, planar=2, subsampling=[1, 1]), True)
    cases["PIL CMYK JPEG"] = (_pil_bytes(Image.fromarray(pic).convert(
        "CMYK"), "TIFF", compression="jpeg"), True)
    cases["grey JPEG"] = (tb(w, h, 8, 1, 1, [_pil_bytes(
        Image.fromarray(pic[..., 0]), "JPEG")], comp=7), True)
    cases["mixed header MM*0 raw"] = (tb(w, h, 8, 3, 2, [raw], bo=">",
                                         magic=b"MM*\x00"), True)
    cases["mixed header II0* raw"] = (tb(w, h, 8, 3, 2, [raw],
                                         magic=b"II\x00*"), True)
    cases["mixed header with Deflate"] = (tb(w, h, 8, 3, 2, [
        zlib.compress(raw)], comp=8, bo=">", magic=b"MM*\x00"), False)
    cases["CCITT at 8 bits"] = (tb(w, h, 8, 1, 1, [raw[:w * h]], comp=4),
                                False)
    return cases


TIFF_LEFTOVERS = _tiff_leftover_cases()


@pytest.mark.parametrize("name", list(TIFF_LEFTOVERS))
def test_tiff_leftovers(tmp_path, name):
    """CCITT (modified Huffman, 32771 with libtiff's word alignment, T.4
    1D and 2D, T.6; long runs, fill order 2, min-is-white, tiles, a
    damaged row, data cut short), LZMA, Zstandard, old-style JPEG in both
    layouts, old-style LZW, ThunderScan, YCbCr through libtiff's RGBA
    reader, 12-bit grey, PX and PA, tiles below 8 bits, planar CMYK, Lab,
    PA and single-sample planes, planar and CMYK JPEG, the mixed byte-
    order headers: the port's RGBA equals PIL's byte for byte, and what
    PIL fails on is -1 in both pools."""
    data, reads = TIFF_LEFTOVERS[name]
    path = tmp_path / "t.tif"
    path.write_bytes(data)
    if reads:
        assert_same(path)
    else:
        assert both(path) == [-1, -1]


@pytest.mark.parametrize("comp", ["group3", "group4"])
def test_fax_data_that_ends_early_raises(tmp_path, comp):
    """T.4 or T.6 data cut after its first rows: libtiff decodes those.
    After them it leaves the rest of PIL's strip buffer as it was for T.6,
    so PIL's rows there are not the file's alone and the port raises
    UnsupportedImage rather than guess; for T.4 it decodes the strip again
    from its start without EOLs (libtiff 4.7's tryG3WithoutEOL), which the
    port reproduces: the same RGBA as PIL."""
    bw = Image.fromarray(smooth(29, 37)).convert("1")
    data = _strip(_pil_bytes(bw, "TIFF", compression=comp))
    path = tmp_path / "t.tif"
    path.write_bytes(fixtures.tiff_bytes(
        37, 29, 1, 1, 1, [data[:len(data) // 2]], comp=3 if comp == "group3"
        else 4))
    if comp == "group3":
        assert_same(path)
        return
    with pytest.raises(UnsupportedImage, match="T.6"):
        TexturePool().try_import(str(path), "t")


def _libtiff_strip(data: bytes, tmp_path) -> tuple:
    """libtiff's own decode of a one-strip TIFF (PIL's bundled libtiff,
    called through ctypes, which PIL has loaded): (return value, strip
    bytes)."""
    import ctypes
    import glob
    import os
    libs = os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                        "pillow.libs")
    lt = ctypes.CDLL(glob.glob(os.path.join(libs, "libtiff-*"))[0])
    lt.TIFFOpen.restype = ctypes.c_void_p
    lt.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lt.TIFFStripSize.restype = ctypes.c_ssize_t
    lt.TIFFStripSize.argtypes = [ctypes.c_void_p]
    lt.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lt.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                        ctypes.c_void_p, ctypes.c_ssize_t]
    lt.TIFFClose.argtypes = [ctypes.c_void_p]
    path = tmp_path / "strip.tif"
    path.write_bytes(data)
    tif = lt.TIFFOpen(str(path).encode(), b"r")
    buf = ctypes.create_string_buffer(lt.TIFFStripSize(tif))
    rc = lt.TIFFReadEncodedStrip(tif, 0, buf, -1)
    lt.TIFFClose(tif)
    return rc, buf.raw


@pytest.mark.parametrize("name", ["ccitt_mh.tif", "ccitt_rlew.tif",
                                  "ccitt_g3_1d.tif", "ccitt_g3_2d.tif",
                                  "ccitt_g4.tif"])
def test_fax_strips_equal_libtiff(tmp_path, name):
    """Seeded damaged and cut copies of a committed fax strip, decoded by
    scene/ccitt.py and by libtiff itself: the same rows where libtiff
    succeeds, ValueError where it fails (PIL's -1); T.6 data that ends
    before the last row may raise UnsupportedImage instead (see
    test_fax_data_that_ends_early_raises)."""
    import os
    from fluctus_tpu_torch.scene import ccitt
    d, _ = _tiff_record()
    data = open(os.path.join(d, name), "rb").read()
    im = Image.open(io.BytesIO(data))
    strip = _strip(data)
    comp, t4 = im.tag_v2[259], im.tag_v2.get(292, 0)
    w, h = im.size
    g = np.random.default_rng(len(name))
    variants = [strip[:cut] for cut in (7, len(strip) // 2,
                                        len(strip) - 3)]
    for _ in range(21):
        b = bytearray(strip)
        for _ in range(int(g.integers(1, 4))):
            b[int(g.integers(0, len(b)))] = int(g.integers(0, 256))
        variants.append(bytes(b))
    for v in variants:
        tags = [(292, 4, [t4])] if t4 else []
        rc, want = _libtiff_strip(fixtures.tiff_bytes(
            w, h, 1, 1, 1, [v], comp=comp, tags=tags), tmp_path)
        try:
            got = ccitt.decode(v, comp, w, h, t4, 0)
        except UnsupportedImage:
            continue
        except ValueError:
            assert rc < 0, "the port failed where libtiff decodes"
            continue
        assert rc > 0, "the port decoded where libtiff fails"
        assert got == want


def _repair_cases():
    """The layouts the port refused where PIL gives -1 (compressions PIL
    does not name or libtiff lacks, codecs that refuse the layout,
    uncompressed YCbCr, hierarchical and 12-bit JPEG)."""
    tb = fixtures.tiff_bytes
    pic = smooth(13, 17)
    raw = pic.tobytes()
    jpg = _pil_bytes(Image.fromarray(pic), "JPEG")
    sof = jpg.index(b"\xff\xc0")

    def with_sof(marker, precision=8):
        b = bytearray(jpg)
        b[sof + 1] = marker
        b[sof + 4] = precision
        return bytes(b)

    return {
        "TIFF compression 99": tb(17, 13, 8, 3, 2, [raw], comp=99),
        "TIFF SGILog on RGB": tb(17, 13, 8, 3, 2, [raw], comp=34676),
        "TIFF SGILog with LogLuv photometric": tb(
            17, 13, 16, 3, 32845, [raw * 2], comp=34676),
        "TIFF WebP": tb(17, 13, 8, 3, 2, [raw], comp=50001),
        "TIFF ThunderScan at 8 bits": tb(17, 13, 8, 1, 1, [raw[:221]],
                                         comp=32809),
        "TIFF uncompressed YCbCr": _pil_bytes(Image.fromarray(pic).convert(
            "YCbCr"), "TIFF"),
        "JPEG SOF5 (hierarchical)": with_sof(0xC5),
        "JPEG SOF1 at 12 bits": with_sof(0xC1, 12),
    }


@pytest.mark.parametrize("name", list(_repair_cases()))
def test_files_pil_fails_on_are_minus_one_in_both(tmp_path, name):
    path = tmp_path / "t.img"
    path.write_bytes(_repair_cases()[name])
    assert both(path) == [-1, -1]


def _tiff_record():
    import json
    import os
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "tiff")
    with open(os.path.join(d, "tiff.json")) as f:
        return d, json.load(f)


@pytest.mark.parametrize("name", sorted(_tiff_record()[1]["files"]))
def test_committed_tiff_files(name):
    """tests/data/tiff: the port's RGBA equals PIL's and the SHA-256
    recorded beside the file (what chip_smoke.py checks on the card)."""
    import hashlib
    import os
    d, rec = _tiff_record()
    path = os.path.join(d, name)
    assert_same(path)
    pool = TexturePool()
    assert pool.try_import(path, name) == 0
    rgba = np.ascontiguousarray(pool.textures[0].rgba[::-1])
    assert list(rgba.shape) == rec["files"][name]["shape"]
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == \
        rec["files"][name]["sha256"]


@pytest.mark.parametrize("size", [0, 100, 767, 769, 1536])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_psd_indexed_without_a_768_byte_palette(tmp_path, size, rle):
    """PIL takes an indexed PSD's colour-mode data as its palette only at
    768 bytes, and otherwise keeps a black one."""
    path = tmp_path / "t.psd"
    path.write_bytes(fixtures.psd_bytes("P", 17, 13, rle, seed=size,
                                        palette_bytes=size))
    assert_same(path)


@pytest.mark.parametrize("kw", [dict(), dict(quality=95, subsampling=0),
                                dict(progressive=True)],
                         ids=["default", "q95 4:4:4", "progressive"])
def test_cmyk_jpeg(tmp_path, kw):
    """Four-component JPEG: PIL reads it as Adobe's inverted CMYK."""
    path = tmp_path / "t.jpg"
    Image.fromarray(smooth(21, 19)).convert("CMYK").save(path, "JPEG", **kw)
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
                                          compression="jpeg"), True),
             "im": ("im", dict(format="IM"), True),
             "spider": ("spi", dict(format="SPIDER"), True),
             "icns": ("icns", dict(format="ICNS"), True)}
    if features.check("webp"):
        cases["webp"] = ("webp", dict(format="WEBP", lossless=True), True)
    if features.check("avif"):
        cases["avif"] = ("avif", dict(format="AVIF", quality=100), True)
        cases["avif with filters"] = ("avif", dict(format="AVIF"), True)
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
    _render_like_jax(tmp_path, "kd.jpg", dict(quality=80))


def test_lossy_webp_and_grey_bump_map_render_like_jax(tmp_path):
    """The same scene with a lossy WebP diffuse map (quality 70): the
    atlas is byte-equal to the JAX package's and the frame within RTOL
    1e-3 / ATOL 1e-4 on every pixel (same shapes, so JAX's compile of the
    JPEG case is reused in the process)."""
    _render_like_jax(tmp_path, "kd.webp", dict(quality=70))


def _render_like_jax(tmp_path, kd_name, save_kw):
    import dataclasses

    import jax.numpy as jnp
    import torch

    from fluctus_tpu.core.types import AreaLight
    from fluctus_tpu.core.types import RenderConfig as JaxConfig
    from fluctus_tpu.render import driver as jax_driver
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver
    Image.fromarray(smooth(32, 48)).save(tmp_path / kd_name, **save_kw)
    Image.fromarray(smooth(16, 16)[..., 1]).save(tmp_path / "bump.png")
    (tmp_path / "s.mtl").write_text(
        f"newmtl m\nKd 0.8 0.8 0.8\nmap_Kd {kd_name}\n"
        "map_bump bump.png\n")
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
