"""DirectDraw Surface (DDS) decoding that gives what PIL 12's
`Image.open(...).convert("RGBA")` gives (its DdsImagePlugin rules); the
first mip level only.

- Uncompressed RGB(A) (DDPF_RGB): `bitcount // 8` little-endian bytes a
  pixel; each channel is the pixel under its mask, shifted down and
  scaled as int(v / max * 255) in double precision, as PIL's dds_rgb
  decoder does. PIL reads past the end of the file as zero bytes, and so
  does the port.
- Luminance (8-bit L, 16-bit L+A), 8-bit palette (1,024-byte RGBA
  palette) and DX10 R8G8B8A8: raw bytes.
- Block-compressed: BC1/DXT1, BC2/DXT3, BC3/DXT5, BC4/ATI1, BC5/ATI2 (and
  signed BC5), BC7, decoded by `native/bcn.cpp` (g++ at first use,
  PIL's arithmetic), since Python over the 262,144 blocks of a 2048^2
  texture would take minutes.

The pixels follow the header (128 bytes, 148 with the DX10 extension,
and the palette after it): PIL's `load_seek` ignores the tile offset.
BC6H, which PIL reads, raises UnsupportedImage; pixel formats PIL does
not read are damage.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from fluctus_tpu_torch.build import build_shared
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "bcn.cpp")
_lib = None

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8 = 0x1, 0x4, 0x20
DDPF_RGB, DDPF_LUMINANCE = 0x40, 0x20000


def _fourcc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


# FourCC -> PIL's BCn number (-5: signed BC5)
_FOURCC = {_fourcc(b"DXT1"): 1, _fourcc(b"DXT3"): 2, _fourcc(b"DXT5"): 3,
           _fourcc(b"BC4U"): 4, _fourcc(b"ATI1"): 4, _fourcc(b"BC5S"): -5,
           _fourcc(b"BC5U"): 5, _fourcc(b"ATI2"): 5}
DX10 = _fourcc(b"DX10")
# DXGI format -> BCn number; 0: raw RGBA; 6: BC6H
_DXGI = {70: 1, 71: 1, 73: 2, 74: 2, 76: 3, 77: 3, 79: 4, 80: 4, 82: 5,
         83: 5, 84: -5, 95: 6, 96: 6, 97: 7, 98: 7, 99: 7, 27: 0, 28: 0,
         29: 0}


def load_library():
    """Build (at first use) and load the block decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "bcn", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        lib.bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        lib.bcn_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode_bcn(blocks: bytes, fmt: int, w: int, h: int) -> np.ndarray:
    """Blocks of PIL's BCn number `fmt` -> (h, w, 4) uint8 RGBA."""
    out = np.empty((h, w, 4), np.uint8)
    rc = load_library().bcn_decode(blocks, len(blocks), fmt, w, h,
                                   out.ctypes.data)
    if rc:
        raise ValueError("DDS: image file is truncated")
    return out


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int,
            masks) -> np.ndarray:
    """PIL's dds_rgb decoder: one byte per mask per pixel."""
    nb = bitcount // 8
    raw = data[pos:pos + w * h * nb]
    raw += bytes(w * h * nb - len(raw))
    px = np.frombuffer(raw, np.uint8).reshape(-1, max(nb, 1))[:, :nb] \
        .astype(np.uint64)
    v = np.zeros(w * h, np.uint64)
    for k in range(min(nb, 4)):     # the masks are 32-bit
        v |= px[:, k] << np.uint64(8 * k)
    out = []
    for mask in masks:
        off = 0
        if mask:
            while mask >> (off + 1) << (off + 1) == mask:
                off += 1
        total = mask >> off
        if total:
            ch = ((v & np.uint64(mask)) >> np.uint64(off)).astype(np.float64)
            out.append(np.floor(ch / total * 255).astype(np.uint8))
        else:
            out.append(np.zeros(w * h, np.uint8))
    return np.stack(out, -1).reshape(h, w, len(masks))


def _raw(data: bytes, pos: int, w: int, h: int, ch: int) -> np.ndarray:
    raw = data[pos:pos + w * h * ch]
    if len(raw) != w * h * ch:
        raise ValueError("DDS: image file is truncated")
    return np.frombuffer(raw, np.uint8).reshape(h, w, ch)


def decode_dds(data: bytes) -> np.ndarray:
    """DDS bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if data[:4] != b"DDS " or len(data) < 8:
        raise ValueError("not a DDS file")
    if struct.unpack("<I", data[4:8])[0] != 124:
        raise ValueError("DDS: unsupported header size")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError("DDS: incomplete header")
    _, h, w = struct.unpack("<3I", header[:12])
    pfflags, fourcc, bitcount = struct.unpack("<3I", header[72:84])
    pos = 128
    rgba = np.full((h, w, 4), 255, np.uint8)
    if pfflags & DDPF_RGB:
        n = 4 if pfflags & DDPF_ALPHAPIXELS else 3
        masks = struct.unpack(f"<{n}I", header[84:84 + 4 * n])
        rgba[..., :n] = _masked(data, pos, w, h, bitcount, masks)
        return rgba
    if pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            px = _raw(data, pos, w, h, 1)
        elif bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            px = _raw(data, pos, w, h, 2)
            rgba[..., 3] = px[..., 1]
        else:
            raise ValueError(f"DDS: PIL reads no {bitcount}-bit luminance")
        rgba[..., :3] = px[..., :1]
        return rgba
    if pfflags & DDPF_PALETTEINDEXED8:
        pal = np.zeros((256, 4), np.uint8)
        ent = np.frombuffer(data[pos:pos + 1024], np.uint8)
        pal.reshape(-1)[:len(ent)] = ent
        return pal[_raw(data, pos + 1024, w, h, 1)[..., 0]]
    if not pfflags & DDPF_FOURCC:
        raise ValueError(f"DDS: unknown pixel format flags {pfflags}")
    if fourcc == DX10:
        if len(data) < 148:
            raise ValueError("DDS: truncated DX10 header")
        fmt = _DXGI.get(struct.unpack("<I", data[128:132])[0])
        pos = 148
    else:
        fmt = _FOURCC.get(fourcc)
    if fmt is None:
        raise ValueError("DDS: a pixel format PIL does not read")
    if fmt == 6:
        raise UnsupportedImage("DDS: BC6H is not decoded by the port")
    if fmt == 0:
        return _raw(data, pos, w, h, 4).copy()
    return decode_bcn(data[pos:], fmt, w, h)
