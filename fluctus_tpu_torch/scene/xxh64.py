"""XXH64 (Yann Collet's xxHash, 64-bit): the scene hash.

The hash keys the saved camera and light state
(`data/states/state_<hash>.json`), the hierarchy cache and the PBRT parse
cache, so it must equal the `xxhash` package's `xxh64().hexdigest()` of
the file; the port carries its own copy to keep that package off its
import path. `file_hash` streams the file through the native hash
(`native/xxh64.cpp`, built with g++ at first use; a failed build raises);
`xxh64_digest` is its plain Python version, which the tests hold it
against.
"""
from __future__ import annotations

import ctypes
import os

from fluctus_tpu_torch.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "xxh64.cpp")
_lib = None

_M = (1 << 64) - 1
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * P2) & _M
    return (_rotl(acc, 31) * P1) & _M


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * P1 + P4) & _M


def xxh64_digest(data: bytes, seed: int = 0) -> int:
    n = len(data)
    mv = memoryview(data)
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & _M
        v2 = (seed + P2) & _M
        v3 = seed & _M
        v4 = (seed - P1) & _M
        nstripes = n // 32
        lanes = mv[:nstripes * 32].cast("Q")   # little-endian hosts
        for k in range(0, nstripes * 4, 4):
            v1 = (_rotl((v1 + lanes[k] * P2) & _M, 31) * P1) & _M
            v2 = (_rotl((v2 + lanes[k + 1] * P2) & _M, 31) * P1) & _M
            v3 = (_rotl((v3 + lanes[k + 2] * P2) & _M, 31) * P1) & _M
            v4 = (_rotl((v4 + lanes[k + 3] * P2) & _M, 31) * P1) & _M
        i = nstripes * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + P5) & _M
    h = (h + n) & _M
    while i + 8 <= n:
        k1 = _round(0, int.from_bytes(mv[i:i + 8], "little"))
        h = (_rotl(h ^ k1, 27) * P1 + P4) & _M
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(mv[i:i + 4], "little") * P1 & _M),
                   23) * P2 + P3) & _M
        i += 4
    while i < n:
        h = (_rotl(h ^ (mv[i] * P5 & _M), 11) * P1) & _M
        i += 1
    h ^= h >> 33
    h = (h * P2) & _M
    h ^= h >> 29
    h = (h * P3) & _M
    h ^= h >> 32
    return h


def xxh64_hexdigest(data: bytes, seed: int = 0) -> str:
    return f"{xxh64_digest(data, seed):016x}"


def load_library():
    """Build (at first use) and load the native hash."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "xxh64", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        lib.xxh64_file.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_ulonglong)]
        lib.xxh64_file.restype = ctypes.c_int
        _lib = lib
    return _lib


def file_hash(path: str) -> str:
    """xxh64 of a file's contents, read in 1 MiB chunks (reference:
    src/utils.cpp:63-91)."""
    out = ctypes.c_ulonglong()
    if load_library().xxh64_file(os.fsencode(path), ctypes.byref(out)):
        raise OSError(f"cannot read {path}")
    return f"{out.value:016x}"
