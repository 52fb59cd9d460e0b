"""Binary BVH walk with an explicit per-ray stack: the `backend="jnp"`
traversal (counterpart of `fluctus_tpu/ops/traverse.py`; reference:
src/bvh.cl:234-310 bvh_intersect, :312-375 bvh_occluded).

In the JAX package this is XLA code, not a Pallas kernel, and so it is
here: plain PyTorch on the session's device, one node pop a ray a step,
driven from Python with a host sync a step. Only a caller who names the
backend gets it; "auto" takes the kernels. Each step pops a node of
every live ray, slab-tests it, tests up to MAX_LEAF triangles of a leaf
(the closest, the first on equal t) and pushes an inner node's right
child, then its left one.

The JAX walk's stack holds STACK_DEPTH entries and clamps a push past
its end onto the top entry; a hierarchy that deep makes it loop without
end (ROADMAP Queue 3). The builders cap the depth at 64, below that; the
port's stack grows instead, so the two agree wherever the JAX walk ends.
"""
from __future__ import annotations

import torch

from fluctus_tpu_torch.core.types import FlatBVH
from fluctus_tpu_torch.ops.intersect import ray_aabb, ray_triangle
from fluctus_tpu_torch.ops.traverse_stack import Traversal, _inv_dir

STACK_DEPTH = 96   # the JAX walk's stack; the port's grows past it
MAX_LEAF = 8       # builder leaf cap (reference: src/sbvh.hpp:38)


def _grown(stack, need: int):
    """`stack` with at least `need` columns (doubled as needed)."""
    cols = stack.shape[1]
    if need <= cols:
        return stack
    while cols < need:
        cols *= 2
    return torch.cat([stack, stack.new_zeros(
        (stack.shape[0], cols - stack.shape[1]))], dim=1)


def _walk(bvh: FlatBVH, v0, v1, v2, orig, dir, t_max, any_hit: bool):
    dev = orig.device
    b = orig.shape[0]
    inv = _inv_dir(dir)
    best_t = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=dev), (b,)).clone()
    best_prim = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(b, dtype=torch.float32, device=dev)
    best_v = torch.zeros(b, dtype=torch.float32, device=dev)
    blocked = torch.zeros(b, dtype=torch.bool, device=dev)
    stack = torch.zeros((b, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(b, dtype=torch.int64, device=dev)   # the root at 0
    k = torch.arange(MAX_LEAF, device=dev)
    act = torch.arange(b, device=dev)
    while act.numel():
        spa = sp[act] - 1
        node = stack[act, spa]
        sp[act] = spa
        o, d = orig[act], dir[act]
        box_hit, _ = ray_aabb(o, inv[act], bvh.node_lo[node],
                              bvh.node_hi[node], best_t[act])
        count = bvh.node_count[node].to(torch.int64)
        right = bvh.node_right[node].to(torch.int64)
        do_leaf = box_hit & (count > 0)
        do_inner = box_hit & (count == 0)

        if do_leaf.any():
            la = act[do_leaf]
            valid = k[None, :] < count[do_leaf][:, None]
            slot = torch.where(valid, right[do_leaf][:, None] + k, 0)
            tri = bvh.prim_idx[slot].to(torch.int64)
            t, u, v, hit = ray_triangle(orig[la][:, None, :],
                                        dir[la][:, None, :], v0[tri],
                                        v1[tri], v2[tri])
            hit = hit & valid & (t < best_t[la][:, None])
            if any_hit:
                blocked[la] = blocked[la] | hit.any(1)
            else:
                j = torch.argmin(torch.where(hit, t, torch.inf), dim=1,
                                 keepdim=True)
                got = torch.gather(hit, 1, j)[:, 0]
                g = la[got]

                def pick(x):
                    return torch.gather(x, 1, j)[:, 0][got]

                best_t[g] = pick(t)
                best_prim[g] = pick(tri).to(torch.int32)
                best_u[g] = pick(u)
                best_v[g] = pick(v)

        if do_inner.any():
            ia = act[do_inner]
            pos = sp[ia]
            stack = _grown(stack, int(pos.max()) + 2)
            stack[ia, pos] = right[do_inner]
            stack[ia, pos + 1] = node[do_inner] + 1
            sp[ia] = pos + 2

        keep = sp[act] > 0
        if any_hit:
            keep &= ~blocked[act]
        act = act[keep]
    return Traversal(best_t, best_prim, best_u, best_v), blocked


def traverse_closest(bvh: FlatBVH, v0, v1, v2, orig, dir,
                     t_max) -> Traversal:
    """Closest hit of each ray under a scalar or per-lane t_max."""
    return _walk(bvh, v0, v1, v2, orig, dir, t_max, any_hit=False)[0]


def traverse_any(bvh: FlatBVH, v0, v1, v2, orig, dir,
                 t_max) -> torch.Tensor:
    """True where some triangle is hit before the per-lane t_max; a ray
    stops at its first hit."""
    return _walk(bvh, v0, v1, v2, orig, dir, t_max, any_hit=True)[1]
