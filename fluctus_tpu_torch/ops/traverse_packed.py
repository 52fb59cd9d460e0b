"""Walk over the packed layout (child-pair rows, a tmin stack, swizzled
leaves): the `backend="packed"` traversal (counterpart of
`fluctus_tpu/ops/traverse_packed.py`; reference: src/bvh.cl:234-375).

In the JAX package this is XLA code, not a Pallas kernel, and so it is
here: plain PyTorch on the session's device, driven from Python with a
host sync a step. Only a caller who names the backend gets it; "auto"
takes the kernels. Each step pops one entry of every live ray: an inner
row tests both children and pushes the far hit child, then the near one
(the closest form; the any-hit form pushes right, then left), with its
entry distance, which prunes the entry on its pop; a leaf row tests its
8 triangle slots.

The JAX walk's stack holds STACK_DEPTH entries and clamps a push past
its end onto the top entry, which loses subtrees (ROADMAP Queue 3); the
builders cap the depth at 64, below that. The port's stack grows
instead.
"""
from __future__ import annotations

import torch

from fluctus_tpu_torch.core import vecmath as vm
from fluctus_tpu_torch.core.types import PackedBVH
from fluctus_tpu_torch.ops.intersect import ray_aabb
from fluctus_tpu_torch.ops.traverse import _grown
from fluctus_tpu_torch.ops.traverse_stack import Traversal, _inv_dir

STACK_DEPTH = 96   # the JAX walk's stack; the port's grows past it
TRI_EPS = 1e-12


def _leaf_hit(pbvh: PackedBVH, orig, dir, li, best_t):
    """Moller-Trumbore over one swizzled leaf row a lane: (A, 8) tests."""
    rows = pbvh.leaf_tris[li]            # (A, 8, 9)
    ids = pbvh.leaf_ids[li]              # (A, 8)
    a = rows[..., 0:3]
    e1 = rows[..., 3:6]
    e2 = rows[..., 6:9]
    o = orig[:, None, :]
    d = dir[:, None, :]
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    ok = torch.abs(det) >= TRI_EPS
    idet = 1.0 / torch.where(ok, det, 1.0)
    tvec = o - a
    u = vm.dot(tvec, pvec) * idet
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * idet
    t = vm.dot(e2, qvec) * idet
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= 0.0) & (ids >= 0) & (t < best_t[:, None])
    return t, u, v, ids, ok


def _walk(pbvh: PackedBVH, orig, dir, t_max, any_hit: bool):
    dev = orig.device
    b = orig.shape[0]
    inv = _inv_dir(dir)
    best_t = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=dev), (b,)).clone()
    best_prim = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(b, dtype=torch.float32, device=dev)
    best_v = torch.zeros(b, dtype=torch.float32, device=dev)
    blocked = torch.zeros(b, dtype=torch.bool, device=dev)
    stack_ref = torch.zeros((b, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((b, STACK_DEPTH), dtype=torch.float32, device=dev)
    stack_ref[:, 0] = int(pbvh.root_ref)
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    act = torch.arange(b, device=dev)
    while act.numel():
        spa = sp[act] - 1
        ref = stack_ref[act, spa]
        tmin = stack_t[act, spa]
        sp[act] = spa
        bt = best_t[act]
        live = torch.ones_like(tmin, dtype=torch.bool) if any_hit \
            else tmin < bt
        inner = live & (ref >= 0)
        leaf = live & (ref < 0)

        if inner.any():
            ia = act[inner]
            ni = ref[inner]
            boxes = pbvh.child_boxes[ni]
            refs = pbvh.child_refs[ni].to(torch.int64)
            o, iv, t_b = orig[ia], inv[ia], bt[inner]
            hit_l, t_l = ray_aabb(o, iv, boxes[:, 0:3], boxes[:, 3:6], t_b)
            hit_r, t_r = ray_aabb(o, iv, boxes[:, 6:9], boxes[:, 9:12], t_b)
            # the closest form pushes the far hit child, then the near
            # one; the any-hit form right, then left (its entry
            # distances are never read)
            lf = torch.ones_like(hit_l) if any_hit else t_l <= t_r
            pushes = ((torch.where(lf, refs[:, 1], refs[:, 0]),
                       torch.maximum(t_l, t_r), torch.where(lf, hit_r, hit_l)),
                      (torch.where(lf, refs[:, 0], refs[:, 1]),
                       torch.minimum(t_l, t_r), torch.where(lf, hit_l, hit_r)))
            pos = sp[ia]
            stack_ref = _grown(stack_ref, int(pos.max()) + 2)
            stack_t = _grown(stack_t, stack_ref.shape[1])
            for r, tm, m in pushes:
                w = ia[m]
                stack_ref[w, pos[m]] = r[m]
                stack_t[w, pos[m]] = tm[m]
                pos = pos + m.to(torch.int64)
            sp[ia] = pos

        if leaf.any():
            la = act[leaf]
            t, u, v, ids, ok = _leaf_hit(pbvh, orig[la], dir[la],
                                         ~ref[leaf], best_t[la])
            if any_hit:
                blocked[la] = blocked[la] | ok.any(1)
            else:
                j = torch.argmin(torch.where(ok, t, torch.inf), dim=1,
                                 keepdim=True)
                got = torch.gather(ok, 1, j)[:, 0]
                g = la[got]

                def pick(x):
                    return torch.gather(x, 1, j)[:, 0][got]

                best_t[g] = pick(t)
                best_prim[g] = pick(ids).to(torch.int32)
                best_u[g] = pick(u)
                best_v[g] = pick(v)

        keep = sp[act] > 0
        if any_hit:
            keep &= ~blocked[act]
        act = act[keep]
    return Traversal(best_t, best_prim, best_u, best_v), blocked


def traverse_closest(pbvh: PackedBVH, orig, dir, t_max) -> Traversal:
    """Closest hit of each ray under a scalar or per-lane t_max."""
    return _walk(pbvh, orig, dir, t_max, any_hit=False)[0]


def traverse_any(pbvh: PackedBVH, orig, dir, t_max) -> torch.Tensor:
    """True where some triangle is hit before the per-lane t_max; a ray
    stops at its first hit."""
    return _walk(pbvh, orig, dir, t_max, any_hit=True)[1]
