"""Zstandard decompression through the port's decoder (`native/zstd.cpp`,
RFC 8878 frames), for TIFF strips and tiles of compression 50000; the
machine with the card has no zstd module.

The library is compiled with g++ at first use into the package build
directory; a failed compile raises, it never turns into a missing texture.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from fluctus_tpu_torch.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "zstd.cpp")
_lib = None


def load_library():
    """Build (at first use) and load the decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "zstd", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        lib.zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_longlong)]
        lib.zstd_decode.restype = ctypes.c_longlong
        lib.zstd_last_error.argtypes = []
        lib.zstd_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decompress(data: bytes, size: int) -> bytes:
    """The first frame of `data` as libtiff reads it through libzstd's
    streaming decoder: at most `size` bytes (fewer where the data ends
    early, which the caller refuses); where libzstd fails, tiff.PartialData
    with what its streaming decoder had handed over (nothing where it
    decoded the frame in one pass)."""
    from fluctus_tpu_torch.scene.tiff import PartialData
    lib = load_library()
    out = np.empty(max(size, 1), np.uint8)
    partial = ctypes.c_longlong(0)
    n = lib.zstd_decode(data, len(data), out.ctypes.data, size,
                        ctypes.byref(partial))
    if n < 0:
        raise PartialData(f"Zstandard: {lib.zstd_last_error().decode()}",
                          out[:partial.value].tobytes())
    return out[:n].tobytes()
