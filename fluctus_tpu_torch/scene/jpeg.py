"""JPEG decoding through the port's sequential Huffman decoder
(`native/jpeg.cpp`: baseline, extended sequential and progressive,
8-bit, grey, YCbCr/RGB or CMYK/YCCK (PIL reads four components as
Adobe's inverted CMYK), any integral sampling, restart intervals),
written to the
choices libjpeg-turbo makes under PIL (the islow IDCT, fancy upsampling,
its fixed-point YCbCr tables), so the RGBA it gives equals PIL's
`Image.open(...).convert("RGBA")`.

The library is compiled with g++ at first use into the package build
directory; a failed compile raises, it never turns into a missing texture.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from fluctus_tpu_torch.build import build_shared
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.pilmodes import to_rgba

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "jpeg.cpp")
_lib = None


def load_library():
    """Build (at first use) and load the decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "jpeg", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong, i32p,
                                  i32p, i32p]
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.c_void_p]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_planes.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.jpeg_planes.restype = ctypes.c_int
        lib.jpeg_last_error.argtypes = []
        lib.jpeg_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, rc: int) -> None:
    if rc == 0:
        return
    msg = lib.jpeg_last_error().decode()
    if rc == 2:
        raise UnsupportedImage(f"JPEG: {msg}")
    raise ValueError(f"JPEG: {msg}")


def decode_jpeg_samples(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 1) grey, (H, W, 3) RGB or (H, W, 4) CMYK
    uint8 (as libjpeg gives them), top row first."""
    lib = load_library()
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.jpeg_info(data, len(data), ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(nc)))
    out = np.empty((h.value, w.value, nc.value), np.uint8)
    _check(lib, lib.jpeg_decode(data, len(data), out.ctypes.data))
    return out


def decode_jpeg_planes(data: bytes) -> list:
    """JPEG bytes -> [(h factor, v factor, plane)]: each component after
    the IDCT, before upsampling (whole MCUs, uint8)."""
    lib = load_library()
    dims = np.zeros(1 + 4 * 4, np.int32)
    _check(lib, lib.jpeg_planes(data, len(data), dims.ctypes.data,
                                dims.size, None))
    n = int(dims[0])
    shapes = [(int(dims[4 + 4 * i]), int(dims[3 + 4 * i])) for i in range(n)]
    out = np.empty(sum(a * b for a, b in shapes), np.uint8)
    _check(lib, lib.jpeg_planes(data, len(data), dims.ctypes.data,
                                dims.size, out.ctypes.data))
    planes, k = [], 0
    for i, (a, b) in enumerate(shapes):
        planes.append((int(dims[1 + 4 * i]), int(dims[2 + 4 * i]),
                       out[k:k + a * b].reshape(a, b)))
        k += a * b
    return planes


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, top row first."""
    out = decode_jpeg_samples(data)
    if out.shape[2] == 4:         # PIL's "CMYK;I": Adobe's inverted CMYK
        return to_rgba("CMYK", 255 - out)
    rgba = np.full(out.shape[:2] + (4,), 255, np.uint8)
    rgba[..., :3] = out           # grey broadcasts to R, G and B
    return rgba
