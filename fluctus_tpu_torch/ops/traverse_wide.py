"""8-wide fat-leaf walk with a restart trail: the `backend="wide"`
traversal (counterpart of `fluctus_tpu/ops/traverse_wide.py`).

In the JAX package this is XLA code, not a Pallas kernel. The port
already has it as K1's plain version (`ops/traverse_stack.py::
traverse_plain`, the same walk in PyTorch ops), so this module calls it
on the session's device: plain PyTorch with a host sync a step, taken
only when the backend is named; "auto" takes the kernels. It visits the
nearest unconsumed child of the current node each step, or backs up one
level. Empty child slots are never hit here, as in K1; the JAX walk
slab-tests them.
"""
from __future__ import annotations

import torch

from fluctus_tpu_torch.core.types import WideBVH
from fluctus_tpu_torch.ops.traverse_stack import Traversal, traverse_plain


def traverse_closest(bvh: WideBVH, orig, dir, t_max) -> Traversal:
    """Closest hit of each ray under a scalar or per-lane t_max."""
    return traverse_plain(bvh, orig, dir, t_max, any_hit=False)[0]


def traverse_any(bvh: WideBVH, orig, dir, t_max) -> torch.Tensor:
    """True where some triangle is hit before the per-lane t_max."""
    return traverse_plain(bvh, orig, dir, t_max, any_hit=True)[1]
