"""Closest-hit and any-hit traversal of the 8-wide BVH: kernel K1 and its
plain version.

K1 (`csrc/traverse_stack.cu`) is the Hopper counterpart of the TPU kernel
`fluctus_tpu/ops/traverse_mxu.py::_kernel`: a team of lanes per ray walks
a near-first stack over the f32 node and leaf rows (the team reads a row
together and splits its children or triangle slots), with the ray's stack
in shared memory, per-lane t_max, and an any-hit form that stops at the
first hit.

The plain version is the restart-trail walk of
`fluctus_tpu/ops/traverse_wide.py` in PyTorch ops: each step a lane visits
its current node's nearest unconsumed child or backs up one level. Steps
run on the still-active lanes only. It visits children in the same
ascending (tmin, slot) order as the kernel and evaluates the same
expressions, so the two agree bit for bit.

`traverse_closest` / `traverse_any` take the plain version for CPU tensors
and launch K1 for CUDA tensors; there is no fallback between the two.

`traverse_closest_forest` / `traverse_any_forest` trace the packet forest
(`DeviceScene.wforest`) with one K1 call a chunk, as the JAX package's
`traverse_mxu.*_forest` do; `closest_forest_plain` / `any_forest_plain`
are the same loops over the plain version.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from fluctus_tpu_torch.core.types import WideBVH
from fluctus_tpu_torch.launch import (CSRC, check, check_aligned, launch,
                                      load_library)

TRI_EPS = 1e-12
BIG = 3.0e38
# stack entries of the deepest hierarchy the binary builder makes (depth
# 64, accel/bvh.py, so wide depth <= 64): stack_entries(64), kDeepStackCap
# of csrc/wide_walk.cuh
MAX_STACK = 464

# launches of K1 per form, and calls of the plain version; chip_smoke.py
# zeroes these before the frame and reads them after it
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}


class Traversal(NamedTuple):
    t: torch.Tensor
    prim: torch.Tensor   # int32, -1 = miss
    u: torch.Tensor
    v: torch.Tensor


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def stack_entries(depth: int) -> int:
    """Worst-case stack occupancy: 7 pending siblings per ancestor level
    plus 8 children of the deepest node (as `s_rows` of the TPU kernel)."""
    return 7 * (depth + 1) + 9


# ---------------------------------------------------------------- plain

def _inv_dir(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-20,
                             torch.where(d < 0, -1e-20, 1e-20), d)


def _moller(rows, o, d, best_t):
    """rows (A, W, 10) [v0 e1 e2 id]; returns per-slot (t, u, v, ids, ok)."""
    a = rows[..., 0:3]
    e1 = rows[..., 3:6]
    e2 = rows[..., 6:9]
    ids = rows[..., 9].contiguous().view(torch.int32)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) >= TRI_EPS
    idet = 1.0 / torch.where(ok, det, 1.0)
    tvx = ox - a[..., 0]
    tvy = oy - a[..., 1]
    tvz = oz - a[..., 2]
    u = (tvx * px + tvy * py + tvz * pz) * idet
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * idet
    t = (e2x * qx + e2y * qy + e2z * qz) * idet
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= 0.0) & (ids >= 0) & (t < best_t[:, None])
    return t, u, v, ids, ok


def _pick_first_min(t, u, v, ids, ok):
    """Closest valid slot, the first one on equal t."""
    t_sel = torch.where(ok, t, torch.inf)
    j = torch.argmin(t_sel, dim=1, keepdim=True)
    got = torch.gather(ok, 1, j)[:, 0]
    pick = lambda x: torch.gather(x, 1, j)[:, 0]
    return got, pick(t), pick(u), pick(v), pick(ids)


def traverse_plain(bvh: WideBVH, orig, dir, t_max, any_hit: bool,
                   stats: dict | None = None):
    """Restart-trail walk (fluctus_tpu/ops/traverse_wide.py::_traverse).
    Returns (Traversal, blocked). With `stats`, adds over all rays the
    inner-node and leaf visits ("node_visits", "leaf_visits"), the
    occupied child slots of the visited nodes ("child_tests") and the real
    triangle ids of the visited leaves ("tri_tests"): the rows K1 fetches
    and the tests it needs for the same rays, since it visits in the same
    order."""
    dev = orig.device
    b = orig.shape[0]
    inv = _inv_dir(dir)
    best_t = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (b,)).clone()
    best_prim = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(b, dtype=torch.float32, device=dev)
    best_v = torch.zeros(b, dtype=torch.float32, device=dev)
    blocked = torch.zeros(b, dtype=torch.bool, device=dev)

    if stats is not None:
        for k in ("node_visits", "leaf_visits", "child_tests", "tri_tests"):
            stats.setdefault(k, 0)
        n_tris = (bvh.leaves[..., 9].contiguous().view(torch.int32)
                  >= 0).sum(1)
        n_kids = (~torch.isinf(bvh.nodes[:, 0:48:6])).sum(1)
    if bvh.root_ref < 0:
        if stats is not None:
            stats["leaf_visits"] += b
            stats["tri_tests"] += b * int(n_tris[~bvh.root_ref])
        rows = bvh.leaves[~bvh.root_ref].expand(b, -1, -1)
        t, u, v, ids, ok = _moller(rows, orig, dir, best_t)
        if any_hit:
            return Traversal(best_t, best_prim, best_u, best_v), ok.any(1)
        got, pt, pu, pv, pid = _pick_first_min(t, u, v, ids, ok)
        return Traversal(torch.where(got, pt, best_t),
                         torch.where(got, pid, best_prim),
                         torch.where(got, pu, best_u),
                         torch.where(got, pv, best_v)), blocked

    lvl = bvh.depth + 1
    boxes_all = bvh.nodes[:, 0:48].reshape(-1, 8, 6)
    refs_all = bvh.nodes[:, 48:56].contiguous().view(torch.int32)
    slot_bits = 1 << torch.arange(8, device=dev)
    cur = torch.full((b,), bvh.root_ref, dtype=torch.int64, device=dev)
    level = torch.zeros(b, dtype=torch.int64, device=dev)
    trail = torch.zeros((b, lvl), dtype=torch.int64, device=dev)
    chain = torch.zeros((b, lvl), dtype=torch.int64, device=dev)
    act = torch.arange(b, device=dev)
    if stats is not None:
        stats["node_visits"] += b
        stats["child_tests"] += b * int(n_kids[bvh.root_ref])

    while act.numel():
        lv = level[act]
        c = cur[act]
        bt = best_t[act]
        o = orig[act]
        boxes = boxes_all[c]
        lo, hi = boxes[:, :, 0:3], boxes[:, :, 3:6]
        t0 = (lo - o[:, None, :]) * inv[act][:, None, :]
        t1 = (hi - o[:, None, :]) * inv[act][:, None, :]
        tmin = torch.minimum(t0, t1).amax(dim=-1)
        tmax = torch.maximum(t0, t1).amin(dim=-1)
        hit = (tmax >= 0.0) & (tmin <= tmax) & (tmin < bt[:, None]) \
            & ~torch.isinf(lo[:, :, 0])          # empty slots never hit
        tr = trail[act, lv]
        avail = hit & ((tr[:, None] & slot_bits) == 0)
        t_sel = torch.where(avail, tmin, torch.inf)
        s_min, slot = torch.min(t_sel, dim=1)    # first slot on ties
        has = s_min < BIG
        trail[act, lv] = torch.where(has, tr | (1 << slot), tr)
        ref = torch.gather(refs_all[c], 1, slot[:, None])[:, 0].to(
            torch.int64)
        visit_leaf = has & (ref < 0)
        descend = has & (ref >= 0)
        if stats is not None:
            stats["node_visits"] += int(descend.sum())
            stats["leaf_visits"] += int(visit_leaf.sum())
            stats["child_tests"] += int(n_kids[ref[descend]].sum())
            stats["tri_tests"] += int(n_tris[~ref[visit_leaf]].sum())

        if visit_leaf.any():
            la = act[visit_leaf]
            rows = bvh.leaves[~ref[visit_leaf]]
            t, u, v, ids, ok = _moller(rows, orig[la], dir[la], best_t[la])
            if any_hit:
                blocked[la] = ok.any(1)
            else:
                got, pt, pu, pv, pid = _pick_first_min(t, u, v, ids, ok)
                g = la[got]
                best_t[g] = pt[got]
                best_prim[g] = pid[got]
                best_u[g] = pu[got]
                best_v[g] = pv[got]

        if descend.any():
            da = act[descend]
            dl = lv[descend]
            chain[da, dl] = c[descend]
            trail[da, dl + 1] = 0
            cur[da] = ref[descend]
            level[da] = dl + 1

        back = ~has
        if back.any():
            ba = act[back]
            nl = lv[back] - 1
            level[ba] = nl
            up = nl >= 0
            cur[ba[up]] = chain[ba[up], nl[up]]

        keep = level[act] >= 0
        if any_hit:
            keep &= ~blocked[act]
        act = act[keep]
    return Traversal(best_t, best_prim, best_u, best_v), blocked


# ---------------------------------------------------------------- kernel

_SRC = os.path.join(CSRC, "traverse_stack.cu")
WALK_HEADER = os.path.join(CSRC, "wide_walk.cuh")   # shared with K5
_lib = None
BUILD_INFO: dict = {}


def load_kernel():
    """Build (at first use) and load the K1 library."""
    global _lib
    if _lib is None:
        _lib = load_library(_SRC, "k1_traverse", {"k1_traverse": "K1"},
                            deps=[WALK_HEADER], info=BUILD_INFO)
    return _lib


def traverse_kernel(bvh: WideBVH, orig, dir, t_max, any_hit: bool):
    """Launch K1 on the current stream. Returns Traversal (closest form) or
    a bool tensor (any-hit form)."""
    b = orig.shape[0]
    dev = orig.device
    t_vec = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev),
        (b,)).contiguous()
    w = bvh.leaf_width
    check("K1", "orig", orig, torch.float32, (b, 3))
    check("K1", "dir", dir, torch.float32, (b, 3))
    check("K1", "t_max", t_vec, torch.float32, (b,))
    check("K1", "nodes", bvh.nodes, torch.float32, (bvh.nodes.shape[0], 56))
    check("K1", "leaves", bvh.leaves, torch.float32,
          (bvh.leaves.shape[0], w, 10))
    cap = stack_entries(bvh.depth)    # the launch's shared memory
    if cap > MAX_STACK:
        raise ValueError(f"K1: hierarchy depth {bvh.depth} needs {cap} "
                         f"stack entries, more than {MAX_STACK}")
    check_aligned("K1", "nodes", bvh.nodes, 16)
    check_aligned("K1", "leaves", bvh.leaves, 8)
    lib = _lib or load_kernel()
    if any_hit:
        blocked = torch.empty(b, dtype=torch.uint8, device=dev)
        outs = (0, 0, 0, 0, blocked.data_ptr())
    else:
        t = torch.empty(b, dtype=torch.float32, device=dev)
        prim = torch.empty(b, dtype=torch.int32, device=dev)
        u = torch.empty(b, dtype=torch.float32, device=dev)
        v = torch.empty(b, dtype=torch.float32, device=dev)
        outs = (t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), 0)
    launch(lib.k1_traverse, orig.get_device(), orig.data_ptr(),
           dir.data_ptr(), t_vec.data_ptr(), bvh.nodes.data_ptr(),
           bvh.leaves.data_ptr(), b, int(bvh.root_ref), w, int(any_hit),
           *outs, cap)
    if any_hit:
        LAUNCHES["any"] += 1
        return blocked.view(torch.bool)
    LAUNCHES["closest"] += 1
    return Traversal(t, prim, u, v)


# ---------------------------------------------------------------- entry

def traverse_closest(bvh: WideBVH, orig, dir, t_max) -> Traversal:
    """Closest hit under a scalar or per-lane t_max."""
    if orig.is_cuda:
        return traverse_kernel(bvh, orig, dir, t_max, any_hit=False)
    PLAIN_CALLS["closest"] += 1
    return traverse_plain(bvh, orig, dir, t_max, any_hit=False)[0]


def traverse_any(bvh: WideBVH, orig, dir, t_max) -> torch.Tensor:
    """True where some triangle is hit before the per-lane t_max."""
    if orig.is_cuda:
        return traverse_kernel(bvh, orig, dir, t_max, any_hit=True)
    PLAIN_CALLS["any"] += 1
    return traverse_plain(bvh, orig, dir, t_max, any_hit=True)[1]


# ---------------------------------------------------------------- forest

def _forest_closest(walk, chunks, prim_maps, orig, dir, t_max) -> Traversal:
    """Closest hit over the chunks in order, `walk(chunk, orig, dir,
    t_vec)` per chunk: the running best t is the next chunk's per-lane
    t_max, and a hit's chunk-local id maps through the chunk's id map
    (fluctus_tpu/ops/traverse_mxu.py::traverse_closest_forest)."""
    b = orig.shape[0]
    dev = orig.device
    best = Traversal(
        torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                           device=dev), (b,)).contiguous(),
        torch.full((b,), -1, dtype=torch.int32, device=dev),
        torch.zeros(b, dtype=torch.float32, device=dev),
        torch.zeros(b, dtype=torch.float32, device=dev))
    for wb, pmap in zip(chunks, prim_maps):
        r = walk(wb, orig, dir, best.t)
        got = r.prim >= 0
        gprim = pmap[torch.clamp(r.prim, min=0).long()].to(torch.int32)
        best = Traversal(torch.where(got, r.t, best.t),
                         torch.where(got, gprim, best.prim),
                         torch.where(got, r.u, best.u),
                         torch.where(got, r.v, best.v))
    return best


def _forest_any(walk, chunks, orig, dir, t_max) -> torch.Tensor:
    """Any-hit over the chunks in order: a blocked lane's length drops to
    0 for the later chunks, so it leaves them at their root
    (fluctus_tpu/ops/traverse_mxu.py::traverse_any_forest)."""
    b = orig.shape[0]
    lens = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=orig.device), (b,))
    blocked = torch.zeros(b, dtype=torch.bool, device=orig.device)
    for wb in chunks:
        cur = torch.where(blocked, 0.0, lens).contiguous()
        blocked = blocked | walk(wb, orig, dir, cur)
    return blocked


def traverse_closest_forest(chunks, prim_maps, orig, dir,
                            t_max) -> Traversal:
    """Closest hit over the packet forest, one K1 launch a chunk (the
    plain version for CPU tensors)."""
    return _forest_closest(traverse_closest, chunks, prim_maps, orig, dir,
                           t_max)


def traverse_any_forest(chunks, orig, dir, t_max) -> torch.Tensor:
    """Any-hit over the packet forest, one K1 launch a chunk."""
    return _forest_any(traverse_any, chunks, orig, dir, t_max)


def closest_forest_plain(chunks, prim_maps, orig, dir, t_max) -> Traversal:
    """traverse_closest_forest over the plain version on any device."""
    return _forest_closest(
        lambda wb, o, d, t: traverse_plain(wb, o, d, t, False)[0],
        chunks, prim_maps, orig, dir, t_max)


def any_forest_plain(chunks, orig, dir, t_max) -> torch.Tensor:
    """traverse_any_forest over the plain version on any device."""
    return _forest_any(
        lambda wb, o, d, t: traverse_plain(wb, o, d, t, True)[1],
        chunks, orig, dir, t_max)
