"""JPEG decoding through the port's sequential Huffman decoder
(`native/jpeg.cpp`: baseline and extended sequential, 8-bit, grey or
YCbCr/RGB, any integral sampling, restart intervals), written to the
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


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, top row first."""
    lib = load_library()
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.jpeg_info(data, len(data), ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(nc)))
    out = np.empty((h.value, w.value, nc.value), np.uint8)
    _check(lib, lib.jpeg_decode(data, len(data), out.ctypes.data))
    rgba = np.full((h.value, w.value, 4), 255, np.uint8)
    rgba[..., :3] = out           # grey broadcasts to R, G and B
    return rgba
