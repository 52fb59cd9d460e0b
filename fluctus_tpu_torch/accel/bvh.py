"""Binary BVH record, builder constants and the NumPy full-sweep SAH
builder (counterpart of `fluctus_tpu/accel/bvh.py`, the same arithmetic
in the same order, so both packages build the same tree). The native
SAH/SBVH builder in `accel/native` is the default; `build_bvh` and
`accel/sbvh.py` build under FLUCTUS_NATIVE=0."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_LEAF = 8      # reference: src/sbvh.hpp:38 / src/bvh.hpp:64-68
MAX_DEPTH = 64
BUILDER_VERSION = 2


@dataclass
class BuiltBVH:
    """Flat binary BVH: left child = index + 1, pre-order."""
    node_lo: np.ndarray      # (N, 3) f32
    node_hi: np.ndarray      # (N, 3) f32
    node_right: np.ndarray   # (N,) i32: inner -> right child; leaf -> start
    node_count: np.ndarray   # (N,) i32: 0 inner, prim count for a leaf
    node_parent: np.ndarray  # (N,) i32
    prim_idx: np.ndarray     # (K,) i32
    depth: int = 0

    @property
    def n_nodes(self) -> int:
        return len(self.node_count)


def sah_cost(bvh: BuiltBVH, c_trav: float = 1.0,
             c_isect: float = 1.0) -> float:
    """Expected traversal SAH cost of a built tree (MacDonald-Booth):
    sum over interior nodes of SA(n)*c_trav plus over leaves of
    SA(n)*nPrims*c_isect, normalized by root surface area. Used to compare
    tree QUALITY across builders whose float tie-breaks differ (the C++ and
    NumPy SBVH builders are independent implementations of
    the reference's src/sbvh.cpp algorithm, not bit-identical)."""
    lo = bvh.node_lo.astype(np.float64)
    hi = bvh.node_hi.astype(np.float64)
    sa = _surface_area(lo, hi)
    leaf = bvh.node_count > 0
    root_sa = max(sa[0], 1e-30)
    return float((sa[~leaf].sum() * c_trav
                  + (sa[leaf] * bvh.node_count[leaf]).sum() * c_isect)
                 / root_sa)


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def _sweep_sah_split(ids: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                     centroid: np.ndarray):
    """Full-sweep SAH over 3 axes (reference: src/bvh.cpp:339-407).

    Returns (axis, order, split_pos, cost) where `order` is the permutation of
    `ids` sorted along `axis` and the left side is order[:split_pos]."""
    n = len(ids)
    best = (None, None, None, np.inf)
    for axis in range(3):
        order = np.argsort(centroid[ids, axis], kind="stable")
        slo, shi = lo[ids][order], hi[ids][order]
        # prefix (left) boxes after i prims, suffix (right) boxes
        left_lo = np.minimum.accumulate(slo, axis=0)
        left_hi = np.maximum.accumulate(shi, axis=0)
        right_lo = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
        right_hi = np.maximum.accumulate(shi[::-1], axis=0)[::-1]
        sa_l = _surface_area(left_lo[:-1], left_hi[:-1])     # split after i+1
        sa_r = _surface_area(right_lo[1:], right_hi[1:])
        counts_l = np.arange(1, n, dtype=np.float64)
        cost = sa_l * counts_l + sa_r * (n - counts_l)
        i = int(np.argmin(cost))
        if cost[i] < best[3]:
            best = (axis, order, i + 1, cost[i])
    return best


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              max_leaf: int = MAX_LEAF, max_depth: int = MAX_DEPTH) -> BuiltBVH:
    """Build a SAH BVH over triangle soup. Returns flat SoA arrays."""
    m = len(v0)
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((lo + hi) * 0.5).astype(np.float32)

    prim_idx = np.arange(m, dtype=np.int32)

    node_lo, node_hi = [], []
    node_right, node_count, node_parent = [], [], []
    max_seen_depth = 0

    # Pre-order DFS with explicit stack; entries: (start, end, parent, is_right, depth)
    # Left child is always emitted immediately after its parent.
    stack = [(0, m, -1, False, 0)]
    while stack:
        start, end, parent, is_right, depth = stack.pop()
        idx = len(node_count)
        if is_right and parent >= 0:
            node_right[parent] = idx
        ids = prim_idx[start:end]
        nlo = lo[ids].min(axis=0)
        nhi = hi[ids].max(axis=0)
        node_lo.append(nlo)
        node_hi.append(nhi)
        node_parent.append(parent)
        max_seen_depth = max(max_seen_depth, depth)

        n = end - start
        # depth bound is soft: oversized leaves would silently overflow the
        # fixed-width leaf tests, so keep median-splitting past max_depth
        make_leaf = n <= max_leaf
        if not make_leaf:
            if depth >= max_depth:
                axis, order, split = None, None, None  # median fallback
            else:
                axis, order, split, _ = _sweep_sah_split(ids, lo, hi,
                                                         centroid)
            if split is None or split <= 0 or split >= n:
                split = n // 2  # median fallback (reference: src/bvh.cpp:274-319)
                order = np.argsort(centroid[ids, np.argmax(nhi - nlo)],
                                   kind="stable")
            prim_idx[start:end] = ids[order]
            node_right.append(-1)  # patched when right child is emitted
            node_count.append(0)
            # push right first so left is processed (emitted) next
            stack.append((start + split, end, idx, True, depth + 1))
            stack.append((start, start + split, idx, False, depth + 1))
        else:
            node_right.append(start)  # iStart
            node_count.append(n)

    return BuiltBVH(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_right=np.asarray(node_right, np.int32),
        node_count=np.asarray(node_count, np.int32),
        node_parent=np.asarray(node_parent, np.int32),
        prim_idx=prim_idx,
        depth=max_seen_depth,
    )


def validate(bvh: BuiltBVH, lo: np.ndarray | None = None,
             hi: np.ndarray | None = None) -> None:
    """Structural invariants (the reference asserts these at build time,
    src/bvh.cpp:27-32,73-75): child containment, leaf sizes, full coverage."""
    n = bvh.n_nodes
    seen = np.zeros(len(bvh.prim_idx), bool)
    for i in range(n):
        cnt = bvh.node_count[i]
        if cnt == 0:
            l, r = i + 1, bvh.node_right[i]
            assert 0 < r < n, f"bad right child at {i}"
            for c in (l, r):
                assert bvh.node_parent[c] == i
                assert np.all(bvh.node_lo[c] >= bvh.node_lo[i] - 1e-5)
                assert np.all(bvh.node_hi[c] <= bvh.node_hi[i] + 1e-5)
        else:
            assert cnt <= 255
            s = bvh.node_right[i]
            seen[s:s + cnt] = True
    assert seen.all(), "not all primitive slots referenced by leaves"
