"""CCITT fax decoding for TIFF strips and tiles through the port's copy
of libtiff's fax3 decoder (`native/ccitt.cpp`): modified Huffman (TIFF
compression 2 and 32771), T.4 (3) and T.6 (4).

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
                    "ccitt.cpp")
_lib = None


def load_library():
    """Build (at first use) and load the decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "ccitt", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        lib.ccitt_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_void_p]
        lib.ccitt_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode(data: bytes, comp: int, width: int, rows: int, t_options: int,
           odd: int, state: dict | None = None) -> bytes:
    """`rows` rows of `width` pixels, 1 bits black (libtiff's fill), each
    row (width + 7) // 8 bytes; ValueError where libtiff's read fails,
    UnsupportedImage where PIL's pixels are not the file's (T.6 data that
    ends early). `odd` is the parity of the chunk's offset in the file;
    `state` carries libtiff's codec mode from one chunk of an image to the
    next (T.4 data retried without EOLs stays so)."""
    lib = load_library()
    out = np.zeros(((width + 7) // 8) * rows, np.uint8)
    state = {} if state is None else state
    noeol = ctypes.c_int(state.get("noeol", 0))
    rc = lib.ccitt_decode(data, len(data), comp, width, rows, t_options, odd,
                          ctypes.byref(noeol), out.ctypes.data)
    state["noeol"] = noeol.value
    if rc < 0:
        raise ValueError("TIFF: the fax data ends before its rows")
    if rc == 2:
        raise UnsupportedImage("TIFF: T.6 data that ends before its last "
                               "row leaves PIL's rows after it undefined")
    return out.tobytes()
