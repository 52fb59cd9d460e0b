"""Collapse a binary SAH BVH into the 8-wide fat-leaf traversal layout
(counterpart of `fluctus_tpu/accel/wide.py::build_wide`, bit-equal rows).

An 8-ary BVH with 16-triangle leaves cuts the dependent steps of a
traversal 4-8x against the binary tree; each step reads one 224-byte node
row or one 640-byte leaf row.

Collapse: greedily expand the largest-surface-area binary child until 8
children (standard BVH8 collapse); any binary subtree with <= leaf_width
triangles becomes one fat leaf row.

Row layouts (gather-once):
  nodes: (N, 56) f32 = 8 children x [lo(3) hi(3)] + 8 refs (int32 bitcast)
  leaves: (L, leaf_width, 10) f32 = [v0(3) e1(3) e2(3) id(bitcast)]
ref encoding: >= 0 wide-node index, < 0 leaf: row = ~ref; refs of empty child
slots point to a degenerate box (+inf lo) and are never followed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fluctus_tpu_torch.accel.bvh import BuiltBVH

BRANCHING = 8
LEAF_WIDTH = 16
MAX_WIDE_DEPTH = 12


@dataclass
class WideBVHHost:
    nodes: np.ndarray      # (N, 56) f32
    leaves: np.ndarray     # (L, leaf_width, 10) f32
    root_ref: int
    depth: int
    n_leaf_tris: int


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def build_wide(built: BuiltBVH, v0: np.ndarray, v1: np.ndarray,
               v2: np.ndarray, leaf_width: int = LEAF_WIDTH) -> WideBVHHost:
    n = built.n_nodes
    counts = built.node_count
    rights = built.node_right

    # triangle count per binary subtree (children follow parents in the
    # pre-order flattening, so a reverse sweep is a post-order reduction)
    tri_count = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if counts[i] > 0:
            tri_count[i] = counts[i]
        else:
            tri_count[i] = tri_count[i + 1] + tri_count[rights[i]]

    leaf_rows: list[np.ndarray] = []

    def collect_tris(b: int) -> np.ndarray:
        ids = []
        stack = [b]
        while stack:
            x = stack.pop()
            if counts[x] > 0:
                s = rights[x]
                ids.extend(built.prim_idx[s:s + counts[x]].tolist())
            else:
                stack.append(x + 1)
                stack.append(rights[x])
        return np.asarray(ids, np.int64)

    def make_leaf(b: int) -> int:
        ids = collect_tris(b)
        assert len(ids) <= leaf_width
        row = np.zeros((leaf_width, 10), np.float32)
        k = len(ids)
        a = v0[ids]
        row[:k, 0:3] = a
        row[:k, 3:6] = v1[ids] - a
        row[:k, 6:9] = v2[ids] - a
        id_col = np.full(leaf_width, -1, np.int32)
        id_col[:k] = ids
        row[:, 9] = id_col.view(np.float32)
        leaf_rows.append(row)
        return ~(len(leaf_rows) - 1)

    nodes: list[np.ndarray] = []

    def build_node(b: int) -> int:
        """Create a wide node for binary subtree b; returns encoded ref."""
        if tri_count[b] <= leaf_width:
            return make_leaf(b)
        # expand to up to 8 children
        children = [b + 1, int(rights[b])]

        def expandable(c):
            return counts[c] == 0 and tri_count[c] > leaf_width

        while len(children) < BRANCHING:
            best, best_sa = -1, -1.0
            for j, c in enumerate(children):
                if expandable(c):
                    sa = _surface_area(built.node_lo[c], built.node_hi[c])
                    if sa > best_sa:
                        best, best_sa = j, sa
            if best < 0:
                break
            c = children.pop(best)
            children.extend([c + 1, int(rights[c])])

        row = np.zeros(56, np.float32)
        row[0:48:6] = np.inf  # empty slots: lo.x=+inf never hits
        my_idx = len(nodes)
        nodes.append(row)  # placeholder; fill after recursion
        refs = np.zeros(BRANCHING, np.int32)
        for j, c in enumerate(children):
            row[j * 6 + 0: j * 6 + 3] = built.node_lo[c]
            row[j * 6 + 3: j * 6 + 6] = built.node_hi[c]
            if expandable(c):
                refs[j] = build_node(c)
            else:
                refs[j] = make_leaf(c)
        row[48:56] = refs.view(np.float32)
        nodes[my_idx] = row
        return my_idx

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        root_ref = build_node(0)
    finally:
        sys.setrecursionlimit(old_limit)

    node_arr = np.stack(nodes) if nodes else np.zeros((1, 56), np.float32)
    leaf_arr = np.stack(leaf_rows)

    # measure depth (wide levels) for the trail bound
    depth = _measure_depth(node_arr, root_ref)
    return WideBVHHost(nodes=node_arr, leaves=leaf_arr, root_ref=root_ref,
                       depth=depth, n_leaf_tris=leaf_arr.shape[0] * leaf_width)


def _measure_depth(nodes: np.ndarray, root_ref: int) -> int:
    if root_ref < 0:
        return 1
    depth = 0
    stack = [(int(root_ref), 1)]
    while stack:
        idx, d = stack.pop()
        depth = max(depth, d)
        refs = nodes[idx, 48:56].view(np.int32)
        lo_x = nodes[idx, 0:48:6]
        for j in range(BRANCHING):
            if np.isfinite(lo_x[j]) and refs[j] >= 0:
                stack.append((int(refs[j]), d + 1))
    return depth


def estimate_table_bytes(n_tris: int, leaf_width: int = LEAF_WIDTH) -> int:
    """Table footprint estimate of a wide BVH over n_tris triangles:
    collapsed leaves average ~50% occupancy, hence twice the leaf rows
    (fluctus_tpu/accel/wide.py::estimate_table_bytes)."""
    leaves = max(1, (n_tris + leaf_width - 1) // leaf_width) * 2
    nodes = max(1, leaves // 4)
    return leaves * leaf_width * 10 * 4 + nodes * 56 * 4


def build_wide_forest(v0, v1, v2, build_binary, leaf_width: int = LEAF_WIDTH,
                      budget_bytes: int = 4 << 20):
    """The packet forest's chunks (fluctus_tpu/accel/wide.py::
    build_wide_forest): split the triangles at the median centroid of the
    widest axis until each chunk's `estimate_table_bytes` fits
    `budget_bytes`, then build a binary BVH (`build_binary`) and its
    8-wide collapse per chunk. Returns (list of WideBVHHost, list of
    int32 maps from a chunk's triangle ids to global ids)."""
    centroid = ((np.minimum(np.minimum(v0, v1), v2)
                 + np.maximum(np.maximum(v0, v1), v2)) * 0.5)
    chunks: list[np.ndarray] = []
    todo = [np.arange(len(v0), dtype=np.int64)]
    while todo:                       # depth first, lower half first
        ids = todo.pop()
        if estimate_table_bytes(len(ids), leaf_width) <= budget_bytes:
            chunks.append(ids)
            continue
        c = centroid[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(ids) // 2
        todo += [ids[order[half:]], ids[order[:half]]]

    hosts, maps = [], []
    for ids in chunks:
        built = build_binary(v0[ids], v1[ids], v2[ids])
        hosts.append(build_wide(built, v0[ids], v1[ids], v2[ids],
                                leaf_width=leaf_width))
        maps.append(ids.astype(np.int32))
    return hosts, maps
