"""Packet traversal of the 8-wide BVH: kernel K4 and its plain version
(counterpart of `fluctus_tpu/ops/traverse_pallas.py`, the `backend="pallas"`
path).

A packet of BLK = 512 rays walks one shared stack, which holds the worst
case of the hierarchy's wide depth (`stack_entries`): K4's holds
MAX_STACK = 449 entries, enough for wide depth 64, the deepest the builder
makes; the plain version's is sized from the depth.
At an inner node every lane slab-tests the 8 children; a child is pushed
if any lane hits it, far-to-near by the least entry distance over the
hitting lanes (the lowest slot first among equal keys, so the highest of
them pops first). At a leaf every lane Moller-tests the W triangle slots
in slot order (`|det| >= 1e-12`, `t >= 0`, strict `t < best`). The
any-hit form stops when every lane is blocked. Nothing is pruned on pop:
a packet visits the union of the nodes its lanes touch, so rays are
sorted by octant and Morton code before the walk (ops/ray_sort.py).

K4 (`csrc/traverse_packet.cu`) runs a packet on a cluster of CTAs, each
warp with its own copy of the stack and its own staged rows in shared
memory, the packet's per-child partials exchanged once an inner visit,
and reads K1's packed node and leaf rows (the JAX kernel's split tables
are kept only as `split_tables`, which the tests hold against the JAX
package); the plain version walks every packet's
stack at once with PyTorch ops (state: stack (P, cap), sp (P,), lanes
(P, 512)). Both evaluate the same expressions in the same order, and the
kernel is built with -fmad=false, so they agree bit for bit. The wrapper
takes the plain version for CPU tensors and launches K4 for CUDA tensors,
with no fallback between the two.

Deliberate differences from the JAX kernel: empty child slots (lo.x =
+inf) are skipped, as K1 skips them. The JAX kernel slab-tests their
degenerate boxes, which a ray through the line y = z = 0 with equal y and
z slab distances can "hit", pushing node 0 again. And the stack holds the
worst case of every hierarchy the builder makes: the JAX kernel's holds
192 entries and, on a deeper hierarchy, clamps the push position and
overwrites its top entry, which can lose a subtree (ROADMAP Queue 3,
faults of the JAX reference).
One CUDA kernel covers both of the JAX kernel's table placements
(`hbm`): rows come from device memory either way.

`traverse_closest_forest` / `traverse_any_forest` trace the packet forest
(`DeviceScene.wforest`) with one K4 call a chunk; passing
`launch=packet_plain` gives their plain versions.
"""
from __future__ import annotations

import os

import torch

from fluctus_tpu_torch.core.types import WideBVH
from fluctus_tpu_torch.launch import (CSRC, check, check_aligned, launch,
                                      load_library)
from fluctus_tpu_torch.ops import traverse_stack
from fluctus_tpu_torch.ops.traverse_stack import (
    WALK_HEADER, Traversal, _inv_dir as _safe_inv, _moller, _pick_first_min)

BLK = 512          # rays per packet (threads per CUDA block)
MAX_LEAF_WIDTH = 32   # kMaxW of the CUDA source
MAX_STACK = 449       # kMaxStack of the CUDA source: stack_entries(64)
BIG = 3.0e38
NEG_INF = float("-inf")

# kernel launches and plain-version calls per form; chip_smoke.py zeroes
# these before a frame and reads them after it
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _form(any_hit: bool) -> str:
    return "any" if any_hit else "closest"


def stack_entries(depth: int) -> int:
    """Worst-case shared-stack occupancy: a visit pops one entry and pushes
    at most 8, so 7 more per wide level, plus the root."""
    return 7 * depth + 1


def split_tables(bvh: WideBVH):
    """The JAX kernel's tables: node boxes (N, 48) f32, node refs (N, 8)
    int32, leaf triangles (L, 9W) f32 and leaf ids (L, W) int32 from the
    packed rows. K4 and its plain version read the packed rows instead."""
    nodes = bvh.nodes[:, 0:48].contiguous()
    nrefs = bvh.nodes[:, 48:56].contiguous().view(torch.int32)
    leaves2d = bvh.leaves[:, :, 0:9].reshape(bvh.leaves.shape[0],
                                             -1).contiguous()
    lids = bvh.leaves[:, :, 9].contiguous().view(torch.int32)
    return nodes, nrefs, leaves2d, lids


def _prep(orig, dir, t_max, blk: int = BLK):
    """Pad the rays to a packet multiple: origin 0, direction (0, 0, 1),
    t_max 0 (no hit: t < 0 is impossible)."""
    b = orig.shape[0]
    dev = orig.device
    pad = (-b) % blk
    t_vec = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (b,))
    if pad:
        orig = torch.cat([orig, torch.zeros((pad, 3), device=dev)])
        dir = torch.cat([dir, torch.tensor(
            [0.0, 0.0, 1.0], device=dev).expand(pad, 3)])
        t_vec = torch.cat([t_vec, torch.zeros(pad, device=dev)])
    return orig.contiguous(), dir.contiguous(), t_vec.contiguous(), b


def wbvh_bounds(bvh: WideBVH):
    """Scene AABB from the root node's occupied child boxes (node 0 for a
    leaf-root hierarchy, as the JAX package reads it)."""
    root = max(int(bvh.root_ref), 0)
    boxes = bvh.nodes[root, 0:48].reshape(8, 6)
    valid = torch.isfinite(boxes[:, 0])[:, None]
    lo = torch.where(valid, boxes[:, 0:3], float("inf")).amin(0)
    hi = torch.where(valid, boxes[:, 3:6], float("-inf")).amax(0)
    return lo, hi


# ---------------------------------------------------------------- plain

def packet_plain(orig, dir, t_vec, bvh: WideBVH, any_hit: bool,
                 n_real: int | None = None, stats: dict | None = None):
    """K4's plain version over padded rays (B a multiple of BLK). Returns
    (t, prim or blocked, u, v), each (B,). With `stats`, adds per visit the
    occupied child slots ("child_tests") and real triangles ("tri_tests")
    times the packet's real lanes (the first `n_real` rays are real), and
    the node and leaf visits ("node_visits", "leaf_visits"); and appends
    this call's visits of each packet ("packet_node_visits",
    "packet_leaf_visits", int64 (P,) tensors, one more row per call)."""
    PLAIN_CALLS[_form(any_hit)] += 1
    nodes, leaves = bvh.nodes, bvh.leaves
    dev = orig.device
    b = orig.shape[0]
    npk = b // BLK
    w = bvh.leaf_width
    o = orig.reshape(npk, BLK, 3)
    d = dir.reshape(npk, BLK, 3)
    inv = _safe_inv(d)
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    ix, iy, iz = inv[..., 0], inv[..., 1], inv[..., 2]
    best_t = t_vec.reshape(npk, BLK).clone()
    best_prim = torch.full((npk, BLK), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((npk, BLK), device=dev)
    best_v = torch.zeros((npk, BLK), device=dev)
    blocked = torch.zeros((npk, BLK), dtype=torch.bool, device=dev)
    cap = stack_entries(bvh.depth)
    stack = torch.zeros((npk, cap), dtype=torch.int64, device=dev)
    stack[:, 0] = bvh.root_ref
    sp = torch.ones(npk, dtype=torch.int64, device=dev)
    if stats is not None:
        for k in ("node_visits", "leaf_visits", "child_tests", "tri_tests"):
            stats.setdefault(k, 0)
        n_real = b if n_real is None else n_real
        lanes = (n_real - torch.arange(npk, device=dev) * BLK).clamp(0, BLK)
        n_kids = (~torch.isinf(nodes[:, 0:48:6])).sum(1)
        n_tris = (leaves[:, :, 9].contiguous().view(torch.int32)
                  >= 0).sum(1)
        pk_nodes = torch.zeros(npk, dtype=torch.int64, device=dev)
        pk_leaves = torch.zeros(npk, dtype=torch.int64, device=dev)
    pk_all = torch.arange(npk, device=dev)

    while True:
        act = sp > 0
        if any_hit:
            act &= ~blocked.all(1)
        if not bool(act.any()):
            break
        pk = pk_all[act]
        enc = stack[pk, sp[pk] - 1]
        sp[pk] -= 1
        inner = enc >= 0

        if bool(inner.any()):
            pi = pk[inner]
            node = enc[inner]
            row = nodes[node]                              # (n, 56)
            refs = row[:, 48:56].contiguous().view(torch.int32).long()
            c = [row[:, k:48:6][:, :, None] for k in range(6)]  # (n, 8, 1)
            oxi, oyi, ozi = (x[pi][:, None, :] for x in (ox, oy, oz))
            ixi, iyi, izi = (x[pi][:, None, :] for x in (ix, iy, iz))
            t0x = (c[0] - oxi) * ixi
            t1x = (c[3] - oxi) * ixi
            t0y = (c[1] - oyi) * iyi
            t1y = (c[4] - oyi) * iyi
            t0z = (c[2] - ozi) * izi
            t1z = (c[5] - ozi) * izi
            tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                               torch.minimum(t0y, t1y)),
                                 torch.minimum(t0z, t1z))
            tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                               torch.maximum(t0y, t1y)),
                                 torch.maximum(t0z, t1z))
            lane_hit = (tmax >= 0.0) & (tmin <= tmax) \
                & (tmin < best_t[pi][:, None, :]) & ~torch.isinf(c[0])
            if any_hit:
                lane_hit &= ~blocked[pi][:, None, :]
            key = torch.where(lane_hit, tmin, BIG).amin(2)
            ks = torch.where(lane_hit.any(2), key, NEG_INF)   # (n, 8)
            # push the hit children far to near; the stable sort keeps the
            # first slot first among equal keys, as the kernel's repeated
            # first-maximum pick does, and the hit ones lead
            ks, order = torch.sort(ks, stable=True, dim=1, descending=True)
            kref = refs.gather(1, order)
            valid = ks > NEG_INF
            spi = sp[pi]
            for r in range(8):
                pos = (spi + r).clamp(max=cap - 1)
                stack[pi, pos] = torch.where(valid[:, r], kref[:, r],
                                             stack[pi, pos])
            sp[pi] = spi + valid.sum(1)
            if stats is not None:
                stats["node_visits"] += int(pi.numel())
                pk_nodes[pi] += 1
                stats["child_tests"] += int((n_kids[node] * lanes[pi]).sum())

        if not bool(inner.all()):
            pl_ = pk[~inner]
            leaf = ~enc[~inner]
            n, sh = pl_.numel(), (-1, BLK)
            # every lane of each packet against every slot of its leaf at
            # once, op for op as K1's plain walk tests a leaf; the first
            # slot at the least t is what the kernel's fold under t < best
            # keeps
            rows = leaves[leaf][:, None].expand(n, BLK, w, 10)
            t, u, v, ids, ok = _moller(
                rows.reshape(n * BLK, w, 10), o[pl_].reshape(-1, 3),
                d[pl_].reshape(-1, 3), best_t[pl_].reshape(-1))
            if any_hit:
                blocked[pl_] = blocked[pl_] | ok.any(1).view(sh)
            else:
                got, pt, pu, pv, pid = _pick_first_min(t, u, v, ids, ok)
                got = got.view(sh)
                for best, new in ((best_t, pt), (best_prim, pid),
                                  (best_u, pu), (best_v, pv)):
                    best[pl_] = torch.where(got, new.view(sh), best[pl_])
            if stats is not None:
                stats["leaf_visits"] += int(pl_.numel())
                pk_leaves[pl_] += 1
                stats["tri_tests"] += int((n_tris[leaf] * lanes[pl_]).sum())

    if stats is not None:
        for k, x in (("packet_node_visits", pk_nodes),
                     ("packet_leaf_visits", pk_leaves)):
            stats[k] = torch.cat([stats[k], x]) if k in stats else x
    prim = blocked.to(torch.int32) if any_hit else best_prim
    return (best_t.reshape(-1), prim.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))


# ---------------------------------------------------------------- kernel

_SRC = os.path.join(CSRC, "traverse_packet.cu")
_lib = None
BUILD_INFO: dict = {}


def load_kernel():
    """Build (at first use) and load the K4 library."""
    global _lib
    if _lib is None:
        _lib = load_library(_SRC, "k4_packet", {"k4_packet": "K4"},
                            deps=[WALK_HEADER], info=BUILD_INFO)
    return _lib


def packet_kernel(orig, dir, t_vec, bvh: WideBVH, any_hit: bool):
    """Launch K4 on the current stream (signature of packet_plain, without
    the stats)."""
    nodes, leaves = bvh.nodes, bvh.leaves
    b = orig.shape[0]
    n, l_ = nodes.shape[0], leaves.shape[0]
    w = bvh.leaf_width
    if b % BLK or not 0 < w <= MAX_LEAF_WIDTH:
        raise ValueError(f"K4: {b} rays must be a multiple of {BLK} and the"
                         f" leaf width {w} in 1..{MAX_LEAF_WIDTH}")
    for name, x, dt, shape in (("orig", orig, torch.float32, (b, 3)),
                               ("dir", dir, torch.float32, (b, 3)),
                               ("t_max", t_vec, torch.float32, (b,)),
                               ("nodes", nodes, torch.float32, (n, 56)),
                               ("leaves", leaves, torch.float32,
                                (l_, w, 10))):
        check("K4", name, x, dt, shape)
    for name, x in (("nodes", nodes), ("leaves", leaves)):
        check_aligned("K4", name, x, 8)
    lib = _lib or load_kernel()
    dev = orig.device
    outs = (torch.empty(b, dtype=torch.float32, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.float32, device=dev),
            torch.empty(b, dtype=torch.float32, device=dev))
    launch(lib.k4_packet, orig.get_device(), *(x.data_ptr() for x in (
        orig, dir, t_vec, nodes, leaves)),
        b, int(bvh.root_ref), w, int(any_hit),
        *(x.data_ptr() for x in outs))
    LAUNCHES[_form(any_hit)] += 1
    return outs


def _launcher(dev: torch.device):
    """The wrapper for `dev`: K4 for CUDA, the plain version for the CPU."""
    return packet_kernel if dev.type == "cuda" else packet_plain


# ---------------------------------------------------------------- entry

def _run(bvh: WideBVH, orig, dir, t_max, any_hit: bool, launch=None):
    if stack_entries(bvh.depth) > MAX_STACK:
        raise ValueError(f"K4: hierarchy depth {bvh.depth} is deeper than "
                         "the builder makes (wide depth 64)")
    o, d, tv, b = _prep(orig, dir, t_max)
    launch = launch or _launcher(o.device)
    res = launch(o, d, tv, bvh, any_hit)
    return tuple(x[:b] for x in res)


def traverse_closest(bvh: WideBVH, orig, dir, t_max,
                     launch=None) -> Traversal:
    """Closest hit under a scalar or per-lane t_max, rays in the caller's
    order (packets are consecutive runs of 512). `launch` overrides the
    wrapper chosen by device (packet_plain or packet_kernel)."""
    return Traversal(*_run(bvh, orig, dir, t_max, False, launch))


def traverse_any(bvh: WideBVH, orig, dir, t_max, launch=None):
    """True where some triangle is hit before the per-lane t_max."""
    return _run(bvh, orig, dir, t_max, True, launch)[1] > 0


def traverse_closest_forest(chunks, prim_maps, orig, dir, t_max,
                            launch=None) -> Traversal:
    """Closest hit over the packet forest, one K4 call a chunk, the
    running best t as the next chunk's per-lane t_max
    (fluctus_tpu/ops/traverse_pallas.py::traverse_closest_forest). Rays
    in the caller's order; `launch` as in traverse_closest."""
    return traverse_stack._forest_closest(
        lambda wb, o, d, t: traverse_closest(wb, o, d, t, launch),
        chunks, prim_maps, orig, dir, t_max)


def traverse_any_forest(chunks, orig, dir, t_max, launch=None):
    """Any-hit over the packet forest: the flags of one K4 call a chunk,
    ORed, each under the full t_max (the JAX package's
    traverse_any_forest does not shorten the blocked lanes)."""
    blocked = torch.zeros(orig.shape[0], dtype=torch.bool,
                          device=orig.device)
    for wb in chunks:
        blocked = blocked | traverse_any(wb, orig, dir, t_max, launch)
    return blocked
