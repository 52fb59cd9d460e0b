"""Pack a binary BVH into child-pair rows and swizzled leaves (counterpart
of `fluctus_tpu/accel/pack.py`, the same arrays bit for bit), the tables
of the `backend="packed"` walk (ops/traverse_packed.py):

  * child-pair nodes: (N, 16) f32 rows [left_lo(3) left_hi(3) right_lo(3)
    right_hi(3) pad(4)], so one row tests both children of a node;
  * child refs: (N, 2) int32, >= 0 an inner node, < 0 a leaf as ~row;
  * swizzled leaves: (L, 8, 9) f32 rows [v0, e1, e2] a triangle slot with
    (L, 8) int32 triangle ids (pad slots -1, degenerate).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fluctus_tpu_torch.accel.bvh import BuiltBVH

LEAF_WIDTH = 8


@dataclass
class PackedLayoutHost:
    child_boxes: np.ndarray  # (N, 16) f32
    child_refs: np.ndarray   # (N, 2) i32
    leaf_tris: np.ndarray    # (L, 8, 9) f32
    leaf_ids: np.ndarray     # (L, 8) i32
    root_ref: int            # encoded ref of the root (inner idx or ~leaf)


def pack_bvh(built: BuiltBVH, v0: np.ndarray, v1: np.ndarray,
             v2: np.ndarray) -> PackedLayoutHost:
    n = built.n_nodes
    counts = built.node_count
    rights = built.node_right

    is_leaf = counts > 0
    leaf_nodes = np.flatnonzero(is_leaf)
    leaf_row_of_node = np.full(n, -1, np.int64)
    leaf_row_of_node[leaf_nodes] = np.arange(len(leaf_nodes))

    # swizzled leaf rows
    n_leaves = len(leaf_nodes)
    leaf_tris = np.zeros((max(n_leaves, 1), LEAF_WIDTH, 9), np.float32)
    leaf_ids = np.full((max(n_leaves, 1), LEAF_WIDTH), -1, np.int32)
    for row, node in enumerate(leaf_nodes):
        start, cnt = rights[node], counts[node]
        ids = built.prim_idx[start:start + cnt]
        k = min(cnt, LEAF_WIDTH)
        a = v0[ids[:k]]
        leaf_tris[row, :k, 0:3] = a
        leaf_tris[row, :k, 3:6] = v1[ids[:k]] - a
        leaf_tris[row, :k, 6:9] = v2[ids[:k]] - a
        leaf_ids[row, :k] = ids[:k]

    def encode(child: np.ndarray) -> np.ndarray:
        lr = leaf_row_of_node[child]
        return np.where(lr >= 0, ~lr, child).astype(np.int32)

    # child-pair rows of the inner nodes (leaf rows stay zero)
    child_boxes = np.zeros((n, 16), np.float32)
    child_refs = np.zeros((n, 2), np.int32)
    inner = np.flatnonzero(~is_leaf)
    if len(inner):
        left = inner + 1
        right = rights[inner].astype(np.int64)
        child_boxes[inner, 0:3] = built.node_lo[left]
        child_boxes[inner, 3:6] = built.node_hi[left]
        child_boxes[inner, 6:9] = built.node_lo[right]
        child_boxes[inner, 9:12] = built.node_hi[right]
        child_refs[inner, 0] = encode(left)
        child_refs[inner, 1] = encode(right)

    root_ref = int(encode(np.asarray([0]))[0])
    return PackedLayoutHost(child_boxes=child_boxes, child_refs=child_refs,
                            leaf_tris=leaf_tris, leaf_ids=leaf_ids,
                            root_ref=root_ref)
