"""Host-side builders of the two big-scene forests (counterpart of
`fluctus_tpu/accel/forest.py`: `_split_chunks`, `HostBrute`,
`build_brute_forest`, `HostForest`, `_wrap_leaf_root`,
`build_host_forest`; their arrays equal the JAX package's bit for bit).

Both cut the triangle set by spatial median splits into chunks of at most
`target_tris` triangles.

- The brute-chunk forest carries no hierarchy inside a chunk. The
  triangles are re-ordered by a second median-split recursion down to
  `tile`, so every run of `tile` consecutive triangles is spatially tight
  and gets its own AABB (`tboxes`), which lets the traversal skip tiles
  that no ray of a block can hit (ops/traverse_brute.py).
- The treelet forest gives every chunk its own 8-wide BVH
  (`build_binary`, 8-wide collapse) with global triangle ids in the leaf
  rows, rooted at node 0, padded to one table shape
  (ops/traverse_forest.py).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from fluctus_tpu_torch.accel import bvh as bvh_mod
from fluctus_tpu_torch.accel.wide import LEAF_WIDTH, build_wide

# triangles per treelet chunk (the JAX package's TARGET_TRIS)
TARGET_TRIS = 8192
BRUTE_TARGET_TRIS = 8192
# triangles per tile AABB; the K2 kernel's Moller tile equals it
BRUTE_TILE = 128


def _split_chunks(v0, v1, v2, target_tris: int) -> list[np.ndarray]:
    """Spatial median split on the widest centroid axis until every chunk
    holds <= target_tris triangles."""
    centroid = ((np.minimum(np.minimum(v0, v1), v2)
                 + np.maximum(np.maximum(v0, v1), v2)) * 0.5)
    chunks: list[np.ndarray] = []
    stack = [np.arange(len(v0), dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= target_tris:
            chunks.append(ids)
            continue
        c = centroid[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(ids) // 2
        stack.append(ids[order[:half]])
        stack.append(ids[order[half:]])
    return chunks


@dataclass
class HostBrute:
    tris: np.ndarray     # (C, 16, Tp) f32: rows [ax ay az e1x..e2z tid+1 0..]
    boxes: np.ndarray    # (C, 8) f32 chunk AABB lo(3) hi(3) pad(2)
    boxes_t: np.ndarray  # (8, Cp) f32 component-major; pad chunks inverted
    tboxes: np.ndarray | None = None  # (C, 8, NTp) f32 per-tile AABBs;
    #                                   pad tiles inverted
    tile: int = 512      # triangles per tboxes entry


def build_brute_forest(v0, v1, v2, target_tris: int = BRUTE_TARGET_TRIS,
                       tile: int | None = None) -> HostBrute:
    """Partition the triangles into spatial chunks and pack per-chunk
    Moller tables. Every triangle lands in exactly one chunk, so merges
    across chunks never tie on one prim. Triangle ids are stored as f32
    tid+1 (exact below 2^24); 0 marks a pad slot."""
    if tile is None:
        tile = BRUTE_TILE
    n = len(v0)
    assert n < (1 << 24) - 1, "brute forest: tri ids exceed f32-exact range"
    chunk_ids = _split_chunks(v0, v1, v2, target_tris)
    c = len(chunk_ids)
    tp = max(-(-max(len(ids) for ids in chunk_ids) // tile) * tile, tile)
    nt = tp // tile
    ntp = -(-nt // 128) * 128
    tris = np.zeros((c, 16, tp), np.float32)
    boxes = np.zeros((c, 8), np.float32)
    tboxes = np.zeros((c, 8, ntp), np.float32)
    tboxes[:, 0:3, :] = 3.0e37     # pad tiles: inverted
    tboxes[:, 3:6, :] = -3.0e37
    for i, ids in enumerate(chunk_ids):
        if len(ids) > tile:
            # spatial tile ordering: concatenate the median-split leaves
            sub = _split_chunks(v0[ids], v1[ids], v2[ids], tile)
            ids = ids[np.concatenate(sub)]
        k = len(ids)
        a = v0[ids]
        tris[i, 0:3, :k] = a.T
        tris[i, 3:6, :k] = (v1[ids] - a).T
        tris[i, 6:9, :k] = (v2[ids] - a).T
        tris[i, 9, :k] = (ids + 1).astype(np.float32)
        t = np.concatenate([v0[ids], v1[ids], v2[ids]])
        boxes[i, 0:3] = t.min(0)
        boxes[i, 3:6] = t.max(0)
        for j in range(-(-k // tile)):
            jj = ids[j * tile:(j + 1) * tile]
            tj = np.concatenate([v0[jj], v1[jj], v2[jj]])
            tboxes[i, 0:3, j] = tj.min(0)
            tboxes[i, 3:6, j] = tj.max(0)
    cp = -(-c // 128) * 128
    # pad chunks get an inverted far box; the traversal also masks them by
    # id, since the min/max slab test does not reject an inverted box
    boxes_t = np.zeros((8, cp), np.float32)
    boxes_t[0:3] = 3.0e37
    boxes_t[3:6] = -3.0e37
    boxes_t[0:3, :c] = boxes[:, 0:3].T
    boxes_t[3:6, :c] = boxes[:, 3:6].T
    return HostBrute(tris=tris, boxes=boxes, boxes_t=boxes_t,
                     tboxes=tboxes, tile=tile)


@dataclass
class HostForest:
    """Stacked, padded per-chunk wide-BVH tables (f32, accel/wide.py row
    layout). Pad node rows have every child slot empty (lo.x = +inf); pad
    leaf slots carry triangle id -1."""
    nodes: np.ndarray     # (C, Tp, 56) f32
    leaves: np.ndarray    # (C, Lp, W, 10) f32, global triangle ids
    boxes: np.ndarray     # (C, 8) f32 chunk AABB lo(3) hi(3) pad(2)
    lvl: int              # max wide depth over chunks + 1
    leaf_width: int


def _wrap_leaf_root(h):
    """A chunk whose triangles fit one fat leaf gets a one-node wrapper, so
    every chunk's root is node 0."""
    if h.root_ref >= 0:
        return h
    lv = h.leaves
    a = lv[:, :, 0:3]
    b = a + lv[:, :, 3:6]
    c = a + lv[:, :, 6:9]
    tid = lv[:, :, 9].view(np.int32)
    m = (tid >= 0)[..., None]
    big = np.float32(3e37)
    lo = np.minimum(np.minimum(np.where(m, a, big).min((0, 1)),
                               np.where(m, b, big).min((0, 1))),
                    np.where(m, c, big).min((0, 1)))
    hi = np.maximum(np.maximum(np.where(m, a, -big).max((0, 1)),
                               np.where(m, b, -big).max((0, 1))),
                    np.where(m, c, -big).max((0, 1)))
    row = np.zeros(56, np.float32)
    row[0:48:6] = np.inf
    row[0:3] = lo
    row[3:6] = hi
    refs = np.zeros(8, np.int32)
    refs[0] = h.root_ref
    row[48:56] = refs.view(np.float32)
    h.nodes = row[None, :]
    h.root_ref = 0
    h.depth = 1
    return h


def build_binary(v0, v1, v2):
    """The per-chunk binary build, as the JAX package builds its chunks:
    the native builder with spatial splits, or the NumPy SAH builder under
    FLUCTUS_NATIVE=0."""
    if not native_enabled():
        return bvh_mod.build_bvh(v0, v1, v2)
    from fluctus_tpu_torch.accel import native
    return native.build_native(v0, v1, v2, bvh_mod.MAX_LEAF,
                               bvh_mod.MAX_DEPTH, 1e-5, True)


def native_enabled() -> bool:
    """FLUCTUS_NATIVE=0 selects the NumPy builders (the JAX package's
    knob)."""
    return os.environ.get("FLUCTUS_NATIVE", "1") != "0"


def build_host_forest(v0, v1, v2, leaf_width: int = LEAF_WIDTH,
                      target_tris: int = TARGET_TRIS) -> HostForest:
    """Build and stack one wide BVH per spatial chunk (`build_binary`, then
    the 8-wide collapse), with the chunk's triangle ids remapped to global
    ids and tables padded to a common shape (a multiple of 128 rows)."""
    chunk_ids = _split_chunks(v0, v1, v2, target_tris)
    hosts = []
    for ids in chunk_ids:
        built = build_binary(v0[ids], v1[ids], v2[ids])
        h = build_wide(built, v0[ids], v1[ids], v2[ids],
                       leaf_width=leaf_width)
        h = _wrap_leaf_root(h)
        tid = h.leaves[:, :, 9].view(np.int32).copy()
        valid = tid >= 0
        tid[valid] = ids[tid[valid]].astype(np.int32)
        h.leaves[:, :, 9] = tid.view(np.float32)
        hosts.append(h)

    n_max = -(-max(h.nodes.shape[0] for h in hosts) // 128) * 128
    l_max = -(-max(h.leaves.shape[0] for h in hosts) // 128) * 128
    c = len(hosts)
    nodes = np.zeros((c, n_max, 56), np.float32)
    nodes[:, :, 0:48:6] = np.inf           # pad rows: children never hit
    leaves = np.zeros((c, l_max, leaf_width, 10), np.float32)
    leaves[..., 9] = np.int32(-1).view(np.float32)   # pad slots: tid -1
    boxes = np.zeros((c, 8), np.float32)
    lvl = 1
    for i, (h, ids) in enumerate(zip(hosts, chunk_ids)):
        nodes[i, :h.nodes.shape[0]] = h.nodes
        leaves[i, :h.leaves.shape[0]] = h.leaves
        lvl = max(lvl, int(h.depth) + 1)
        t = np.concatenate([v0[ids], v1[ids], v2[ids]])
        boxes[i, 0:3] = t.min(0)
        boxes[i, 3:6] = t.max(0)
        assert h.nodes.shape[0] < (1 << 16), "forest chunk node count"
        assert h.leaves.shape[0] < (1 << 16), "forest chunk leaf count"
    assert len(v0) < (1 << 24) - 1, "global tri ids exceed 3-byte encoding"
    return HostForest(nodes=nodes, leaves=leaves, boxes=boxes, lvl=lvl,
                      leaf_width=leaf_width)
