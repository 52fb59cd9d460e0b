"""JPEG decoding through the port's decoder (`native/jpeg.cpp`), written
to the choices libjpeg-turbo 3 makes under PIL, so the RGBA it gives
equals PIL's `Image.open(...).convert("RGBA")` byte for byte. It decodes
every JPEG process PIL reads, at 8 bits a sample:

- baseline and extended sequential Huffman (SOF0, SOF1), progressive
  Huffman (SOF2), sequential and progressive arithmetic coding (SOF9,
  SOF10, with DAC conditioning) and lossless Huffman (SOF3, predictors
  1-7 and the point transform);
- grey, YCbCr or RGB, CMYK or YCCK (PIL reads four components as Adobe's
  inverted CMYK), any integral sampling, restart intervals;
- libjpeg's block smoothing of a progressive file whose low-frequency
  coefficients are not fully refined, and its recovery from damaged
  entropy data (bad codes, markers inside the data, wrong or missing
  restart markers).

Where PIL fails (truncated streams, hierarchical or arithmetic lossless
coding, other than 8-bit samples, fractional sampling ratios) the
decoder fails too, with ValueError.

`source` says how the caller's library feeds libjpeg: "pil" (ImageFile's
64 KiB reads into a suspending source), "libtiff" (libtiff's JPEG codec:
a fake EOI past the end of the data, errors after the last row ignored)
or "libtiff-ojpeg" (its old-style JPEG codec: as "libtiff", and a wrong
restart marker fails).

The library is compiled with g++ at first use into the package build
directory; a failed compile raises, it never turns into a missing texture.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from fluctus_tpu_torch.build import build_shared
from fluctus_tpu_torch.scene.pilmodes import to_rgba

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "jpeg.cpp")
_lib = None
_SOURCES = {"pil": 0, "libtiff": 1, "libtiff-ojpeg": 2}
_COLOURS = {None: 0, "none": 1, "ycc": 2}


def load_library():
    """Build (at first use) and load the decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "jpeg", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int)
        cint = ctypes.c_int
        lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong, cint,
                                  i32p, i32p, i32p]
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    cint, ctypes.c_void_p]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_factors.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                     cint, ctypes.c_void_p, cint]
        lib.jpeg_factors.restype = ctypes.c_int
        lib.jpeg_planes.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    cint, ctypes.c_void_p, cint,
                                    ctypes.c_void_p]
        lib.jpeg_planes.restype = ctypes.c_int
        lib.jpeg_arith_table.argtypes = [ctypes.c_void_p]
        lib.jpeg_arith_table.restype = None
        lib.jpeg_last_error.argtypes = []
        lib.jpeg_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class JpegDataError(ValueError):
    """libjpeg failed after the headers and the first scan's setup, while
    decoding (what a caller that keeps a failed strip's buffer tells
    apart from a stream it cannot start)."""


def _check(lib, rc: int, data_error: bool = False) -> None:
    if rc == 0:
        return
    msg = f"JPEG: {lib.jpeg_last_error().decode()}"
    raise JpegDataError(msg) if data_error else ValueError(msg)


def arith_table() -> np.ndarray:
    """libjpeg's jpeg_aritab as the decoder holds it (114 int64)."""
    out = np.zeros(114, np.int64)
    load_library().jpeg_arith_table(out.ctypes.data)
    return out


def sampling_factors(data: bytes, source: str = "pil") -> list:
    """The frame's [(h, v)] sampling factors, one pair a component."""
    lib = load_library()
    hv = np.zeros(1 + 2 * 256, np.int32)
    _check(lib, lib.jpeg_factors(data, len(data), _SOURCES[source],
                                 hv.ctypes.data, hv.size))
    return [(int(hv[1 + 2 * i]), int(hv[2 + 2 * i])) for i in range(hv[0])]


def decode_jpeg_samples(data: bytes, source: str = "pil",
                        colour: str | None = None) -> np.ndarray:
    """JPEG bytes -> (H, W, 1) grey, (H, W, 3) RGB or (H, W, 4) CMYK
    uint8 (as libjpeg gives them), top row first. `colour` sets libjpeg's
    colour spaces over what the markers say, as libtiff does: "none"
    passes the components through, "ycc" converts YCbCr to RGB."""
    lib = load_library()
    mode = _SOURCES[source] | _COLOURS[colour] << 2
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.jpeg_info(data, len(data), mode, ctypes.byref(w),
                              ctypes.byref(h), ctypes.byref(nc)))
    out = np.empty((h.value, w.value, nc.value), np.uint8)
    _check(lib, lib.jpeg_decode(data, len(data), mode, out.ctypes.data))
    return out


def decode_jpeg_planes(data: bytes) -> list:
    """JPEG bytes -> [(h factor, v factor, plane)]: each component after
    the IDCT, before upsampling (whole MCUs, uint8), as libtiff's old-style
    JPEG codec reads them (raw data, through its source)."""
    lib = load_library()
    mode = _SOURCES["libtiff-ojpeg"]
    dims = np.zeros(1 + 4 * 4, np.int32)
    _check(lib, lib.jpeg_planes(data, len(data), mode, dims.ctypes.data,
                                dims.size, None))
    n = int(dims[0])
    shapes = [(int(dims[4 + 4 * i]), int(dims[3 + 4 * i])) for i in range(n)]
    out = np.empty(sum(a * b for a, b in shapes), np.uint8)
    _check(lib, lib.jpeg_planes(data, len(data), mode, dims.ctypes.data,
                                dims.size, out.ctypes.data), True)
    planes, k = [], 0
    for i, (a, b) in enumerate(shapes):
        planes.append((int(dims[1 + 4 * i]), int(dims[2 + 4 * i]),
                       out[k:k + a * b].reshape(a, b)))
        k += a * b
    return planes


def decode_jpeg(data: bytes, source: str = "pil") -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, top row first."""
    out = decode_jpeg_samples(data, source)
    if out.shape[2] == 4:         # PIL's "CMYK;I": Adobe's inverted CMYK
        return to_rgba("CMYK", 255 - out)
    rgba = np.full(out.shape[:2] + (4,), 255, np.uint8)
    rgba[..., :3] = out           # grey broadcasts to R, G and B
    return rgba
