"""JPEG 2000 decoding (JP2 files and raw codestreams) through the port's
codestream decoder (`native/j2k.cpp`, which gives OpenJPEG 2.5.4's
samples), with PIL 12's reading of the file around it, so the RGBA equals
PIL's `Image.open(...).convert("RGBA")`.

PIL's side, copied here:

- the mode: from the SIZ marker of a raw codestream (1 component: "L",
  or "I;16" above 8 bits; 2 "LA", 3 "RGB", 4 "RGBA") or from the JP2
  header box (ihdr: "I;16" only above 9 bits; a `colr` box with the
  enumerated space CMYK gives "CMYK" to 4 components; a `pclr` box with
  entries of at most 8 bits turns "L" / "LA" into "P" / "PA", its palette
  built entry by entry through ImagePalette.getcolor, which merges equal
  colours);
- OpenJPEG's colour space: from the first `colr` box of the JP2 header
  (sRGB, greyscale, sYCC, e-sYCC, CMYK); with no such box, an ICC
  profile or any other enumerated space, and in a raw codestream, PIL
  takes the space as grey for 1 or 2 components and as sRGB, or sYCC
  when the second or third component is subsampled, for 3 or 4;
- PIL's Jpeg2KDecode.c unpackers, tile by tile: each sample read from
  OpenJPEG's tile buffer (components in turn, 1, 2 or 4 bytes a sample)
  as an unsigned word, the offset of a signed component and the rounding
  half of a right shift added, shifted to 8 bits (16 for "I;16") and cut
  to the pixel's bytes; subsampled components are repeated by dividing
  the pixel position, the row stride and the component's start taken as
  PIL computes them (the tile size divided by the subsampling, rounded
  down; where that reads past the tile's data, PIL reads memory the file
  does not decide, and the port raises); sYCC goes through PIL's YCbCr
  table (scene/pilmodes.py). Tiles
  the codestream does not hold stay 0, as in PIL's image. PIL fails
  where the JP2 header's size is not the codestream's.

The library is compiled with g++ at first use into the package build
directory (with -ffp-contract=off, so the 9/7 wavelet's float operations
are OpenJPEG's); a failed compile raises, it never turns into a missing
texture.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from fluctus_tpu_torch.build import build_shared
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.pilmodes import to_rgba, ycbcr_to_rgb

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "j2k.cpp")
_lib = None

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# OpenJPEG's colour spaces
_UNSPECIFIED, _SRGB, _GRAY, _SYCC, _EYCC, _CMYK = 0, 1, 2, 3, 4, 5
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}


def load_library():
    """Build (at first use) and load the decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "j2k", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                          "-ffp-contract=off"])
        lib = ctypes.CDLL(path)
        lib.j2k_header.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_int]
        lib.j2k_header.restype = ctypes.c_int
        lib.j2k_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_void_p]
        lib.j2k_decode.restype = ctypes.c_int
        lib.j2k_last_error.argtypes = []
        lib.j2k_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, rc: int) -> None:
    if rc == 0:
        return
    msg = lib.j2k_last_error().decode()
    if rc == 2:
        raise UnsupportedImage(f"JPEG 2000: {msg}")
    raise ValueError(f"JPEG 2000: {msg}")


class _Boxes:
    """PIL's BoxReader over `data[start:end]`."""

    def __init__(self, data: bytes, start: int = 0, end: int | None = None):
        self.data, self.pos = data, start
        self.end = end                       # None: no known length
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.end is not None and self.pos + n > self.end:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise ValueError("JP2: not enough data in header")
        b = self.data[self.pos:self.pos + n]
        if len(b) < n:
            raise ValueError("JP2: file is truncated")
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return b

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def sub(self) -> "_Boxes":
        start = self.pos
        size = self.remaining
        self.read(size)
        return _Boxes(self.data, start, start + size)

    def has_next(self) -> bool:
        if self.end is not None:
            return self.pos + self.remaining < self.end
        return True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            (lbox,) = self.fields(">Q")
            hlen = 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise ValueError("JP2: invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _getcolor(pal: bytearray, colors: dict, mode: str, color: tuple) -> None:
    """ImagePalette.getcolor, allocating `color` in `pal`."""
    if mode == "RGB" and len(color) == 4:
        if color[3] != 255:
            raise ValueError("cannot add non-opaque RGBA color to RGB "
                             "palette")
        color = color[:3]
    elif mode == "RGBA" and len(color) == 3:
        color += (255,)
    if color in colors:
        return
    n = len(mode)
    index = len(pal) // n
    if index >= 256:
        raise ValueError("cannot allocate more than 256 colors")
    colors[color] = index
    if index * n < len(pal):
        pal[index * n:index * n + n] = bytes(color)
    else:
        pal += bytes(color)


def _jp2_header(data: bytes):
    """PIL's _parse_jp2_header: (size, mode, palette mode, palette bytes)."""
    r = _Boxes(data, 12)
    header = None
    while r.has_next():
        if r.next_type() == b"jp2h":
            header = r.sub()
            break
    if header is None:
        raise ValueError("JP2: no header box")
    size = mode = nc = None
    pmode, pal = None, None
    while header.has_next():
        t = header.next_type()
        if t == b"ihdr":
            h, w, nc, bpc = header.fields(">IIHB")
            size = (w, h)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA",
                    3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif t == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif t == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                pmode = "RGBA" if npc == 4 else "RGB"
                pal, colors = bytearray(), {}
                for _ in range(ne):
                    _getcolor(pal, colors, pmode,
                              header.fields(">" + "B" * npc))
                mode = "P" if mode == "L" else "PA"
        elif t == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise ValueError("JP2: malformed header")
    return size, mode, pmode, pal


def _jp2_openjpeg(data: bytes):
    """OpenJPEG's reading of the JP2 boxes: (colour space, codestream)."""
    pos, nbox, enumcs, has_colr = 0, 0, 0, False
    seen_header = False
    while pos + 8 <= len(data):
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > len(data):
                break
            (lbox,) = struct.unpack_from(">Q", data, pos + 8)
            hlen = 16
        elif lbox == 0:
            lbox = len(data) - pos
        if lbox < hlen:
            raise ValueError("JP2: bad box length")
        body = data[pos + hlen:pos + lbox]
        if nbox == 0 and tbox != b"jP  " or nbox == 1 and tbox != b"ftyp":
            raise ValueError("JP2: the first boxes are not jP and ftyp")
        nbox += 1
        if tbox == b"jp2c":
            if not seen_header:
                raise ValueError("JP2: codestream before the header box")
            return _ENUMCS.get(enumcs, _UNSPECIFIED), data[pos + hlen:]
        if tbox == b"jp2h":
            seen_header = True
            p, has_ihdr = 0, False
            while p + 8 <= len(body):
                l2, t2 = struct.unpack_from(">I4s", body, p)
                if l2 < 8 or p + l2 > len(body):
                    raise ValueError("JP2: bad box in the header box")
                if t2 == b"ihdr":
                    has_ihdr = True
                elif t2 == b"colr" and not has_colr:
                    b2 = body[p + 8:p + l2]
                    if len(b2) < 3:
                        raise ValueError("JP2: bad colr box")
                    if b2[0] == 1:
                        if len(b2) < 7:
                            raise ValueError("JP2: bad colr box")
                        enumcs = struct.unpack_from(">I", b2, 3)[0]
                        has_colr = True
                    elif b2[0] == 2:
                        enumcs, has_colr = 0, True
                p += l2
            if not has_ihdr:
                raise ValueError("JP2: no ihdr box")
        pos += lbox
    raise ValueError("JP2: no codestream box")


def _codestream_mode(cs: bytes):
    """PIL's _parse_codestream: (size, mode)."""
    if len(cs) < 6:
        raise ValueError("J2K: truncated")
    (lsiz,) = struct.unpack_from(">H", cs, 4)
    siz = cs[4:4 + lsiz]
    if len(siz) < 38:
        raise ValueError("J2K: truncated SIZ")
    _, _, xs, ys, xo, yo, _, _, _, _, csiz = struct.unpack_from(
        ">HHIIIIIIIIH", siz)
    size = (xs - xo, ys - yo)
    if csiz == 1:
        if len(siz) < 39:
            raise ValueError("J2K: truncated SIZ")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    else:
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
    if mode is None:
        raise ValueError("unable to determine J2K image mode")
    return size, mode


# PIL's j2k_unpackers: (mode, colour space, components, subsampled ok)
_UNPACKERS = [
    ("L", _GRAY, 1, False, "gray_l"), ("P", _SRGB, 1, False, "gray_l"),
    ("PA", _SRGB, 2, False, "graya_la"), ("I;16", _GRAY, 1, False, "gray_i"),
    ("I;16B", _GRAY, 1, False, "gray_i"), ("LA", _GRAY, 2, False, "graya_la"),
    ("RGB", _GRAY, 1, False, "gray_rgb"), ("RGB", _GRAY, 2, False, "gray_rgb"),
    ("RGB", _SRGB, 3, True, "srgb_rgb"), ("RGB", _SYCC, 3, True, "sycc_rgb"),
    ("RGB", _SRGB, 4, True, "srgb_rgb"), ("RGB", _SYCC, 4, True, "sycc_rgb"),
    ("RGBA", _GRAY, 1, False, "gray_rgb"),
    ("RGBA", _GRAY, 2, False, "graya_la"),
    ("RGBA", _SRGB, 3, True, "srgb_rgb"),
    ("RGBA", _SYCC, 3, True, "sycc_rgb"),
    ("RGBA", _SRGB, 4, True, "srgba_rgba"),
    ("RGBA", _SYCC, 4, True, "sycca_rgba"),
    ("RGBA", _GRAY, 4, True, "srgba_rgba"),
    ("CMYK", _CMYK, 4, True, "srgba_rgba"),
]


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _words(buf: bytes, start: int, csiz: int, index: np.ndarray) -> np.ndarray:
    """Unsigned little-endian words of `csiz` bytes at byte offsets
    start + csiz * index of `buf`."""
    b = np.frombuffer(buf, np.uint8).astype(np.uint32)
    at = start + csiz * index.astype(np.int64)
    if at.size and (at.min() < 0 or at.max() + csiz > len(buf)):
        # a subsampled component whose grid is not the tile's: PIL reads
        # past the tile's data, into memory the file does not decide
        raise UnsupportedImage("JPEG 2000: PIL reads this subsampled tile "
                               "past its buffer")
    v = np.zeros(index.shape, np.uint32)
    for k in range(csiz):
        v |= b[at + k] << np.uint32(8 * k)
    return v


def _shifted(word: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """j2ku_shift(offset + word, shift) for a pixel of `bits` bits."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (word + np.uint32(offset)).astype(np.uint32)
    v = v >> np.uint32(-shift) if shift < 0 else v << np.uint32(shift)
    return (v & np.uint32((1 << bits) - 1)).astype(
        np.uint8 if bits == 8 else np.uint16)


def _unpack(kind: str, comps, buf: bytes, w: int, h: int) -> np.ndarray:
    """PIL's unpacker over one tile: (h, w, 4) uint8, or (h, w) uint16
    for "I;16"."""
    yy, xx = np.mgrid[0:h, 0:w]
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        prec, sgnd = comps[0][2], comps[0][3]
        cs = _csiz(prec)
        v = _shifted(_words(buf, 0, cs, yy * w + xx), prec, sgnd,
                     16 if kind == "gray_i" else 8)
        if kind == "gray_i":
            return v
        out = np.zeros((h, w, 4), np.uint8)
        out[..., :3] = v[..., None]
        out[..., 3] = 255 if kind == "gray_rgb" else 0
        return out
    if kind == "graya_la":
        (p0, s0), (p1, s1) = comps[0][2:4], comps[1][2:4]
        c0, c1 = _csiz(p0), _csiz(p1)
        v = _shifted(_words(buf, 0, c0, yy * w + xx), p0, s0, 8)
        a = _shifted(_words(buf, c0 * w * h, c1, yy * w + xx), p1, s1, 8)
        out = np.zeros((h, w, 4), np.uint8)
        out[..., :3] = v[..., None]
        out[..., 3] = a
        return out
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    out = np.zeros((h, w, 4), np.uint8)
    out[..., 3] = 255
    start = 0
    for k in range(n):
        dx, dy, prec, sgnd = comps[k]
        cs = _csiz(prec)
        idx = (yy // dy) * (w // dx) + xx // dx
        out[..., k] = _shifted(_words(buf, start, cs, idx), prec, sgnd, 8)
        start += cs * (w // dx) * (h // dy)
    if kind in ("sycc_rgb", "sycca_rgba"):
        out[..., :3] = ycbcr_to_rgb(out[..., :3])
    return out


def _tile_buffer(planes, comps, grid, x0, y0, x1, y1) -> bytes:
    """OpenJPEG's decoded tile data: each component's samples over the
    tile, cut to 1, 2 or 4 bytes, in turn."""
    parts = []
    for plane, (dx, dy, prec, sgnd), (gx0, gy0) in zip(planes, comps, grid):
        cx0, cy0 = -(-x0 // dx) - gx0, -(-y0 // dy) - gy0
        cx1, cy1 = -(-x1 // dx) - gx0, -(-y1 // dy) - gy0
        v = plane[cy0:cy1, cx0:cx1]
        cs = _csiz(prec)
        parts.append(v.astype({1: "<u1", 2: "<u2", 4: "<u4"}[cs]).tobytes()
                     if not sgnd else
                     v.astype({1: "<i1", 2: "<i2", 4: "<i4"}[cs]).tobytes())
    return b"".join(parts)


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """JP2 or J2K bytes -> (H, W, 4) uint8 RGBA, top row first."""
    pmode = pal = None
    if data.startswith(J2K_MAGIC):
        size, mode = _codestream_mode(data)
        space, cs = _UNSPECIFIED, data
    elif data.startswith(JP2_MAGIC):
        size, mode, pmode, pal = _jp2_header(data)
        space, cs = _jp2_openjpeg(data)
    else:
        raise ValueError("not a JPEG 2000 file")
    lib = load_library()
    head = np.zeros(9 + 4 * 16384, np.int32)
    _check(lib, lib.j2k_header(cs, len(cs), head.ctypes.data, head.size))
    ix0, iy0, ix1, iy1, nc, tx0, ty0, tdx, tdy = (
        int(v) for v in head[:9].view(np.uint32))
    comps = [tuple(int(v) for v in head[9 + 4 * k:13 + 4 * k])
             for k in range(nc)]
    if not 1 <= nc <= 4:
        raise ValueError("J2K: PIL cannot handle this image")
    if size != (ix1 - ix0, iy1 - iy0):
        raise ValueError("J2K: the header's size is not the codestream's")
    sub = next((k for k, c in enumerate(comps) if c[:2] != (1, 1)), -1)
    if space == _UNSPECIFIED:
        space = _GRAY if nc <= 2 else _SYCC if sub in (1, 2) else _SRGB
    kind = next((u[4] for u in _UNPACKERS if u[1] == space and u[2] == nc
                 and (u[3] or sub == -1) and u[0] == mode), None)
    if kind is None:
        raise ValueError(f"J2K: PIL has no unpacker for {mode} from this "
                         "codestream")
    grid = [(-(-ix0 // dx), -(-iy0 // dy)) for dx, dy, _, _ in comps]
    shapes = [(-(-iy1 // dy) - gy, -(-ix1 // dx) - gx)
              for (dx, dy, _, _), (gx, gy) in zip(comps, grid)]
    total = sum(a * b for a, b in shapes)
    numx = -(-(ix1 - tx0) // tdx)
    numy = -(-(iy1 - ty0) // tdy)
    flat = np.zeros(total, np.int32)
    done = np.zeros(numx * numy, np.uint8)
    _check(lib, lib.j2k_decode(cs, len(cs), flat.ctypes.data,
                               done.ctypes.data))
    planes, k = [], 0
    for a, b in shapes:
        planes.append(flat[k:k + a * b].reshape(a, b))
        k += a * b
    w, h = size
    img = np.zeros((h, w) if mode in ("I;16", "I;16B") else (h, w, 4),
                   np.uint16 if mode in ("I;16", "I;16B") else np.uint8)
    for t in np.flatnonzero(done):
        p, q = int(t) % numx, int(t) // numx
        x0, y0 = max(tx0 + p * tdx, ix0), max(ty0 + q * tdy, iy0)
        x1, y1 = min(tx0 + (p + 1) * tdx, ix1), min(ty0 + (q + 1) * tdy, iy1)
        buf = _tile_buffer(planes, comps, grid, x0, y0, x1, y1)
        img[y0 - iy0:y1 - iy0, x0 - ix0:x1 - ix0] = _unpack(
            kind, comps, buf, x1 - x0, y1 - y0)
    if mode in ("I;16", "I;16B"):
        return to_rgba("I;16", img)
    if mode == "L":
        return to_rgba("L", img[..., 0])
    if mode == "LA":
        return to_rgba("LA", img[..., [0, 3]])
    if mode == "RGB":
        return to_rgba("RGB", img[..., :3])
    if mode == "RGBA":
        return img
    if mode == "CMYK":
        return to_rgba("CMYK", img)
    return _palette_rgba(img, mode, pmode, pal)


def _palette_rgba(img, mode, pmode, pal) -> np.ndarray:
    """PIL's P / PA to RGBA through the palette PIL built."""
    n = len(pmode)
    entries = len(pal) // n
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    p = np.frombuffer(bytes(pal[:entries * n]), np.uint8).reshape(-1, n)
    table[:entries, :n] = p[:256]
    out = table[img[..., 0]]
    if mode == "PA":
        out[..., 3] = img[..., 3]
    return out
