"""ctypes bindings for the native SAH/SBVH builder (`builder.cpp`, the same
source as the JAX package's builder, so both build identical trees).

Compiled with g++ at first use into the package build directory; a failed
compile raises (`available` says whether it builds). Each build records
the builder's counters in `built.stats`, printed for SBVH builds under
FLUCTUS_BUILD_STATS=1, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from fluctus_tpu_torch.accel.bvh import BuiltBVH
from fluctus_tpu_torch.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "builder.cpp")
_lib = None

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def get_lib():
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "builder",
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        lib.build_hierarchy.argtypes = [_F] * 3 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        lib.build_hierarchy.restype = ctypes.c_int
        lib.fetch_arrays.argtypes = [_F, _F] + [_I32] * 4
        lib.fetch_arrays.restype = ctypes.c_int
        lib.get_stats.argtypes = [ctypes.POINTER(ctypes.c_int64)] * 4
        lib.release.argtypes = []
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the native builder compiles and loads here."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


def build_native(v0, v1, v2, max_leaf: int, max_depth: int, alpha: float,
                 use_spatial: bool) -> BuiltBVH:
    """SAH BVH (use_spatial=False) or SBVH over a triangle soup."""
    lib = get_lib()
    vs = [np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2)]
    n_nodes = ctypes.c_int64()
    n_prims = ctypes.c_int64()
    depth = ctypes.c_int()
    rc = lib.build_hierarchy(
        *(v.ctypes.data_as(_F) for v in vs), len(vs[0]), max_leaf,
        max_depth, alpha, int(use_spatial), ctypes.byref(n_nodes),
        ctypes.byref(n_prims), ctypes.byref(depth))
    if rc != 0:
        raise RuntimeError(f"native hierarchy build failed (rc={rc})")
    n, k = n_nodes.value, n_prims.value
    node_lo = np.empty((n, 3), np.float32)
    node_hi = np.empty((n, 3), np.float32)
    ints = [np.empty(n, np.int32) for _ in range(3)] + [np.empty(k, np.int32)]
    lib.fetch_arrays(node_lo.ctypes.data_as(_F), node_hi.ctypes.data_as(_F),
                     *(a.ctypes.data_as(_I32) for a in ints))
    sn, du, ul, ur = (ctypes.c_int64() for _ in range(4))
    lib.get_stats(*(ctypes.byref(c) for c in (sn, du, ul, ur)))
    lib.release()
    built = BuiltBVH(node_lo=node_lo, node_hi=node_hi, node_right=ints[0],
                     node_count=ints[1], node_parent=ints[2],
                     prim_idx=ints[3], depth=depth.value)
    tris = len(vs[0])
    built.stats = {
        "spatial_nodes": sn.value, "duplicated": du.value,
        "unsplit_left": ul.value, "unsplit_right": ur.value,
        "refs": int(k), "tris": int(tris),
        "duplication_pct": 100.0 * (k - tris) / max(tris, 1),
    }
    if use_spatial and os.environ.get("FLUCTUS_BUILD_STATS", "0") == "1":
        print(f"[sbvh] {built.stats}")
    return built
