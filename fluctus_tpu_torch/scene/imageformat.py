"""Image-file dispatch for texture import: the format is read from the
file's signature as PIL identifies it, and the port's own decoders give
what PIL's `Image.open(...).convert("RGBA")` gives, which is what the JAX
package's TexturePool loads.

`_PLUGINS` copies, as data and code, the signature test of every image
plugin PIL 12 registers for `Image.open`, in PIL's order (its `_accept`,
or for the plugins that have none the header test of their `_open`; for
CUR and ICO, whose signature a TGA header can carry, also the non-empty
directory their `_open` needs, so PIL goes on to TGA, and for GBR the
header tests of its `_open`), with one of three outcomes:

- a format the port decodes goes to its decoder: PNG (scene/png.py),
  JPEG (scene/jpeg.py), BMP and DIB (scene/bmp.py), GIF (scene/gif.py),
  TIFF (scene/tiff.py), PBM/PGM/PPM/PFM (scene/pnm.py), TGA
  (scene/tga.py), ICO and CUR (scene/ico.py), DDS (scene/dds.py), PCX
  and DCX (scene/pcx.py), QOI (scene/qoi.py), SGI (scene/sgi.py), PSD
  (scene/psd.py), Sun raster (scene/sun.py), MSP (scene/msp.py) and XBM
  (scene/xbm.py);
- a format PIL reads and the port does not decode raises
  `UnsupportedImage` naming it, so a map the JAX package would load is
  never dropped without notice;
- bytes no plugin accepts, and formats PIL names but has no decoder for
  (its stub plugins), give None: the texture slot stays -1, as in the
  JAX package (an OpenEXR file, for instance, is not a PIL format).

A file whose data is damaged raises another error in its decoder, which
the pool turns into -1 as the JAX package does.
"""
from __future__ import annotations

import re
import struct

import numpy as np


class UnsupportedImage(ValueError):
    """A well-formed image in a format or variant the port does not
    decode."""


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0] if len(b) >= o + 2 else -1


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0] if len(b) >= o + 4 else -1


def _avif(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


def _webp(p: bytes) -> bool:
    return (p.startswith(b"RIFF") and p[8:12] == b"WEBP"
            and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"))


# IM's header: "Key: value" lines, the first key one of its tags
_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = (b"Image type", b"Image size (x*y)", b"File size (no of images)",
            b"Number of bands", b"Number of frames", b"Lut", b"Name",
            b"Scale (x*y)", b"Image size", b"Image name", b"Comment")


def _im(data: bytes) -> bool:
    if b"\n" not in data[:100]:
        return False
    m = _IM_SPLIT.match(data.split(b"\n", 1)[0].rstrip(b"\r"))
    return bool(m) and m.group(1) in _IM_TAGS


def _imt(data: bytes) -> bool:
    head = data[:100]
    return b"\n" in head and re.match(rb"(width|height|pixel) [^ \r\n]*",
                                      head) is not None


def _iptc(data: bytes) -> bool:
    return len(data) >= 5 and data[0] == 0x1C and data[1] in (
        1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _spider(data: bytes) -> bool:
    """SpiderImagePlugin.isSpiderHeader on either byte order."""
    if len(data) < 27 * 4:
        return False
    for order in (">", "<"):
        h = (99.0,) + struct.unpack(order + "27f", data[:27 * 4])
        try:
            if any(h[i] != int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
                continue
        except (ValueError, OverflowError):
            continue
        if int(h[5]) in (1, 3, -11, -12, -21, -22) and \
                int(h[22]) == int(h[13]) * int(h[23]):
            return True
    return False


def _gbr(data: bytes) -> bool:
    """GbrImagePlugin's `_accept`, then the header tests of its `_open`
    (a non-zero size, colour depth 1 or 4, version 2's "GIMP"), without
    which PIL goes on to the next plugin (a QOI file of width 1 or 2
    passes the accept test)."""
    if len(data) < 8:
        return False
    size, version = struct.unpack_from(">II", data)
    if size < 20 or version not in (1, 2):
        return False
    if len(data) < 20:
        return False
    w, h, depth = struct.unpack_from(">III", data, 8)
    return (w != 0 and h != 0 and depth in (1, 4)
            and (version == 1 or data[20:24] == b"GIMP"))


def _pnm(data: bytes) -> bool:
    from fluctus_tpu_torch.scene import pnm
    return len(data) >= 2 and data[:1] == b"P" and \
        data[1:2] in b"0123456fy" and pnm.magic(data) in pnm.MODES


def _tga(data: bytes) -> bool:
    from fluctus_tpu_torch.scene import tga
    return tga.accept(data)


# (PIL plugin, test of the file's bytes, outcome): a decoder name, "raise"
# (PIL reads it, the port does not) or None (PIL names it and loads no
# pixels: its stub plugins, MPEG and WMF away from Windows). The order is
# the one Image.open tries: Image.preinit's plugins, then Image.init's.
_PLUGINS = (
    ("BMP", lambda d: d.startswith(b"BM"), "bmp"),
    ("DIB", lambda d: _i32(d) in (12, 40, 52, 56, 64, 108, 124), "dib"),
    ("GIF", lambda d: d.startswith((b"GIF87a", b"GIF89a")), "gif"),
    ("JPEG", lambda d: d.startswith(b"\xff\xd8\xff"), "jpeg"),
    ("PPM", _pnm, "pnm"),
    ("PNG", lambda d: d.startswith(b"\x89PNG\r\n\x1a\n"), "png"),
    ("AVIF", _avif, "raise"),
    ("BLP", lambda d: d.startswith((b"BLP1", b"BLP2")), "raise"),
    ("BUFR", lambda d: d.startswith((b"BUFR", b"ZCZC")), None),
    ("CUR", lambda d: d.startswith(b"\0\0\2\0") and _i16(d, 4) > 0,
     "cur"),
    ("PCX", lambda d: len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5),
     "pcx"),
    ("DCX", lambda d: _i32(d) == 0x3ADE68B1, "dcx"),
    ("DDS", lambda d: d.startswith(b"DDS "), "dds"),
    ("EPS", lambda d: d.startswith(b"%!PS") or _i32(d) == 0xC6D3D0C5,
     "raise"),
    ("FITS", lambda d: d.startswith(b"SIMPLE"), "raise"),
    ("FLI", lambda d: len(d) >= 16 and _i16(d, 4) in (0xAF11, 0xAF12)
     and _i16(d, 14) in (0, 3), "raise"),
    ("FTEX", lambda d: d.startswith(b"FTEX"), "raise"),
    ("GBR", _gbr, "raise"),
    ("GRIB", lambda d: len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1,
     None),
    ("HDF5", lambda d: d.startswith(b"\x89HDF\r\n\x1a\n"), None),
    ("JPEG2000", lambda d: d.startswith(
        (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
     "raise"),
    ("ICNS", lambda d: d.startswith(b"icns"), "raise"),
    ("ICO", lambda d: d.startswith(b"\0\0\1\0") and _i16(d, 4) > 0,
     "ico"),
    ("IM", _im, "raise"),
    ("IMT", _imt, "raise"),
    ("IPTC", _iptc, "raise"),
    ("MCIDAS", lambda d: d.startswith(b"\0\0\0\0\0\0\0\4"), "raise"),
    ("MPEG", lambda d: d.startswith(b"\0\0\1\xb3"), None),
    ("TIFF", lambda d: d.startswith((b"MM\x00*", b"II*\x00", b"MM*\x00",
                                     b"II\x00*", b"MM\x00+", b"II+\x00")),
     "tiff"),
    ("MSP", lambda d: d.startswith((b"DanM", b"LinS")), "msp"),
    ("PCD", lambda d: d[2048:2052] == b"PCD_" and len(d) >= 2048 + 1539,
     "raise"),
    ("PIXAR", lambda d: d.startswith(b"\200\350\000\000"), "raise"),
    ("PSD", lambda d: d.startswith(b"8BPS"), "psd"),
    ("QOI", lambda d: d.startswith(b"qoif"), "qoi"),
    ("SGI", lambda d: len(d) >= 2 and struct.unpack_from(">H", d)[0] == 474,
     "sgi"),
    ("SPIDER", _spider, "raise"),
    ("SUN", lambda d: len(d) >= 4 and struct.unpack_from(">I", d)[0]
     == 0x59A66A95, "sun"),
    ("TGA", _tga, "tga"),
    ("WEBP", _webp, "raise"),
    ("WMF", lambda d: d.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                    b"\x01\x00\x00\x00")), None),
    ("XBM", lambda d: d[:16].lstrip().startswith(b"#define"), "xbm"),
    ("XPM", lambda d: d.startswith(b"/* XPM */"), "raise"),
    ("XVTHUMB", lambda d: d.startswith(b"P7 332"), "raise"),
)


def identify(data: bytes) -> tuple[str | None, str | None]:
    """(PIL's name for the format of `data`, its outcome) by the first
    plugin whose test accepts it; (None, None) when none does."""
    for name, test, outcome in _PLUGINS:
        if test(data):
            return name, outcome
    return None, None


def sniff(data: bytes) -> str | None:
    """The decoder for `data` (a key of `decode`), or None when the JAX
    package leaves the slot at -1. Raises UnsupportedImage naming a
    format PIL reads and the port does not."""
    name, outcome = identify(data)
    if outcome == "raise":
        raise UnsupportedImage(f"{name} images are not decoded by the port")
    return outcome


# decoder key -> (module under fluctus_tpu_torch.scene, function)
_DECODERS = {
    "png": ("png", "decode_png"), "jpeg": ("jpeg", "decode_jpeg"),
    "bmp": ("bmp", "decode_bmp"), "dib": ("bmp", "decode_dib_file"),
    "gif": ("gif", "decode_gif"), "tiff": ("tiff", "decode_tiff"),
    "pnm": ("pnm", "decode_pnm"), "ico": ("ico", "decode_ico"),
    "cur": ("ico", "decode_cur"), "dds": ("dds", "decode_dds"),
    "tga": ("tga", "decode_tga"), "pcx": ("pcx", "decode_pcx"),
    "dcx": ("pcx", "decode_dcx"), "qoi": ("qoi", "decode_qoi"),
    "sgi": ("sgi", "decode_sgi"), "psd": ("psd", "decode_psd"),
    "sun": ("sun", "decode_sun"), "msp": ("msp", "decode_msp"),
    "xbm": ("xbm", "decode_xbm"),
}


def decode(data: bytes, kind: str) -> np.ndarray:
    """Image bytes of format `kind` -> (H, W, 4) uint8 RGBA, top row
    first. The decoders import this module, so they are imported here."""
    import importlib
    module, fn = _DECODERS[kind]
    mod = importlib.import_module(f"fluctus_tpu_torch.scene.{module}")
    return getattr(mod, fn)(data)
