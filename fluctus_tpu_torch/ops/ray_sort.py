"""Ray sorting for coherent packets and blocks (counterpart of
`fluctus_tpu/ops/ray_sort.py`).

The packet kernel K4 (ops/traverse_pallas.py) visits the union of the
nodes its 512 rays touch, and the treelet forest's block scheduler
(ops/traverse_forest.py) the union of their chunks; both sort rays by
direction octant, then origin Morton code, before traversal and scatter
the results back. The sorts are stable, as `jnp.argsort` is, so every
packet and block holds the same rays as in the JAX package.
"""
from __future__ import annotations

import torch


def _expand_bits(x):
    """5-bit value -> bits spread to every 3rd position (Morton)."""
    x = (x | (x << 8)) & 0x0300F
    x = (x | (x << 4)) & 0x030C3
    x = (x | (x << 2)) & 0x09249
    return x


def ray_sort_keys(orig, dir, lo, hi):
    """(B,) int64 keys below 2^18: [3-bit direction octant | 15-bit origin
    Morton code over the box lo..hi]."""
    octant = ((dir[:, 0] > 0).long() | ((dir[:, 1] > 0).long() << 1)
              | ((dir[:, 2] > 0).long() << 2))
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((orig - lo) / extent * 31.0, 0.0, 31.0).long()
    morton = (_expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1)
              | (_expand_bits(q[:, 2]) << 2))
    return (octant << 15) | morton


def sort_order(orig, dir, lo, hi):
    """(order, inverse): rays[order] is sorted, sorted[inverse] restores."""
    order = torch.argsort(ray_sort_keys(orig, dir, lo, hi), stable=True)
    return order, torch.argsort(order, stable=True)


def sorted_apply(orig, dir, lo, hi, fn, *per_ray):
    """Run `fn(orig_sorted, dir_sorted, *per_ray_sorted)` on
    coherence-sorted rays; `per_ray` are (B, ...) tensors sorted along
    with the rays (per-lane t_max). `fn` returns a tensor or a NamedTuple
    of (B, ...) tensors, which come back in the input order."""
    order, inv = sort_order(orig, dir, lo, hi)
    out = fn(orig[order], dir[order], *(x[order] for x in per_ray))
    if isinstance(out, torch.Tensor):
        return out[inv]
    return type(out)(*(a[inv] for a in out))
