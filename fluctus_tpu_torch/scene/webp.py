"""WebP decoding through the port's decoder (`native/webp.cpp`: lossless
VP8L, lossy VP8 with its ALPH chunk, the VP8X container and the first
frame of an animation), written to what libwebp 1.6.0 gives under PIL
12's WebPAnimDecoder, so the RGBA equals PIL's
`Image.open(...).convert("RGBA")`.

PIL opens every WebP as an animation: the first frame is drawn at its
offset on a transparent black canvas, and when the container does not
flag alpha (a VP8X without the alpha bit, a simple lossy file, or a
lossless one whose header's alpha bit is 0) PIL's mode is RGB: the
decoded alpha is dropped and the pixels are opaque.

The library is compiled with g++ at first use into the package build
directory; a failed compile raises, it never turns into a missing texture.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from fluctus_tpu_torch.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "webp.cpp")
_lib = None


def load_library():
    """Build (at first use) and load the decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "webp", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.webp_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong, i32p,
                                  i32p, i32p]
        lib.webp_info.restype = ctypes.c_int
        lib.webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.c_void_p]
        lib.webp_decode.restype = ctypes.c_int
        lib.webp_last_error.argtypes = []
        lib.webp_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 4) uint8 RGBA, top row first."""
    lib = load_library()
    w, h, rgba = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.webp_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                     ctypes.byref(rgba)):
        raise ValueError(f"WebP: {lib.webp_last_error().decode()}")
    out = np.empty((h.value, w.value, 4), np.uint8)
    if lib.webp_decode(data, len(data), out.ctypes.data):
        raise ValueError(f"WebP: {lib.webp_last_error().decode()}")
    if not rgba.value:
        out[..., 3] = 255
    return out
