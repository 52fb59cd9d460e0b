"""The launch floor on the card (counterpart of
`scripts/probe_pallas_floor.py`).

    python3 -m fluctus_tpu_torch.scripts.probe_launch_floor

Times, per launch, 16 launches back to back between two CUDA events, best
of 3:
  1. P1 `copy_plus_one` on one (8, 128) tile, one block: a launch's cost;
  2. P1 on 64 tiles, 64 blocks: the cost of more blocks;
  3. K1 closest on 1,024 rays: a traversal launch of one wave;
  4. K1 closest on 65,536 rays: the integrator's tile.
The rays are seeded random rays inside the kitchen (the TPU probe used
the teapot, which is not in the repository). If (3) is near (1), a
traversal call's floor is the launch; if (3) is far above it, it lives in
the traversal itself. Needs a CUDA card.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from fluctus_tpu_torch.timing import BEST_OF, REPS, card_line, time_launches

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KITCHEN = os.path.join(REPO, "assets", "kitchen_proxy.obj")


def random_rays(lo, hi, n: int, seed: int, device="cuda"):
    """n rays with origins uniform in the box [lo, hi] and uniform
    directions, from a seed."""
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def kitchen_bvh():
    """The kitchen's 8-wide hierarchy on the card and its bounds."""
    from fluctus_tpu_torch.scene.scene import load_scene
    host = load_scene(KITCHEN)
    host.build_bvh(use_sbvh=True)
    return host.to_device("cuda").wbvh, host.bounds()


def probes(wbvh, lo, hi) -> dict:
    """{probe: call} for the four probes of the module docstring."""
    from fluctus_tpu_torch.ops import probes as pr
    from fluctus_tpu_torch.ops import traverse_stack as ts

    x1 = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    x64 = torch.zeros((64 * 8, 128), dtype=torch.float32, device="cuda")
    o, d = random_rays(lo, hi, 1 << 16, seed=0)
    o1, d1 = o[:1024].contiguous(), d[:1024].contiguous()
    return {
        "p1_1_block": lambda: pr.copy_plus_one_kernel(x1),
        "p1_64_blocks": lambda: pr.copy_plus_one_kernel(x64),
        "k1_closest_1k": lambda: ts.traverse_kernel(wbvh, o1, d1, 3.4e38,
                                                    False),
        "k1_closest_64k": lambda: ts.traverse_kernel(wbvh, o, d, 3.4e38,
                                                     False),
    }


def measure(wbvh, lo, hi) -> dict:
    """{probe: ms per launch}."""
    return {k: time_launches(f) for k, f in probes(wbvh, lo, hi).items()}


LABELS = {"p1_1_block": "P1 copy, 1 block      ",
          "p1_64_blocks": "P1 copy, 64 blocks    ",
          "k1_closest_1k": "K1 closest, 1k rays   ",
          "k1_closest_64k": "K1 closest, 64k rays  "}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_launch_floor needs a CUDA card")
    print(f"card: {card_line()} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    wbvh, (lo, hi) = kitchen_bvh()
    for k, ms in measure(wbvh, lo, hi).items():
        print(f"{LABELS[k]}: {ms * 1e3:9.2f} us per launch ({REPS} back to "
              f"back, best of {BEST_OF})", flush=True)


if __name__ == "__main__":
    main()
