"""Host-side builder of the brute-chunk forest for big scenes (counterpart
of `fluctus_tpu/accel/forest.py`: `_split_chunks`, `HostBrute`,
`build_brute_forest`; NumPy only, so its arrays equal the JAX package's
bit for bit).

The triangle set is cut by spatial median splits into chunks of at most
`target_tris` triangles; a chunk carries no hierarchy. Inside a chunk the
triangles are re-ordered by a second median-split recursion down to
`tile`, so every run of `tile` consecutive triangles is spatially tight
and gets its own AABB (`tboxes`), which lets the traversal skip tiles
that no ray of a block can hit (ops/traverse_brute.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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
