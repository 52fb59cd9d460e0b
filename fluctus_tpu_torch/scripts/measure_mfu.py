"""Peak rates of the card and the brute-chunk kernel's share of them
(counterpart of `scripts/measure_mfu.py`).

    python3 -m fluctus_tpu_torch.scripts.measure_mfu

Measures, 16 launches back to back between two CUDA events, best of 3:
  1. P2 `fma_chain` on a (512, 1024) f32 tile, 512 trips of 8 steps, no
     memory traffic in the loop: the FP32 pipe's FMA peak (fused form) and
     its one-instruction-per-operation rate (unfused form), the rate the
     bounds of chip_smoke.py assume;
  2. `torch.matmul` in bf16 at 2048^2: the tensor cores (a library call,
     as the JAX probe left its product to XLA; a reference point only);
  3. HBM stream bandwidth: an in-place scale of a 512 MiB f32 array, read
     and written once per launch;
  4. K2's Moller throughput: one full visit of a synthetic 8,192-triangle
     slab chunk by 16,384 rays from above (every tile live), as Moller
     lane tests per second, x MOLLER_FLOPS, and its share of (1).
Needs a CUDA card.
"""
from __future__ import annotations

import numpy as np
import torch

from fluctus_tpu_torch.timing import BEST_OF, REPS, card_line, time_launches

# f32 mul and add operations of one Moller-Trumbore lane test (3 cross
# products, 3 dots, the t/u/v scale), as the JAX probe counts them
MOLLER_FLOPS = 45
P2_SHAPE = (512, 1024)
P2_ITERS = 512


def p2_rate(fused: bool, iters: int = P2_ITERS, shape=P2_SHAPE):
    """(FLOP/s, ms per launch) of P2: 2 FLOPs per step, 8 steps a trip."""
    from fluctus_tpu_torch.ops import probes
    x = torch.ones(shape, dtype=torch.float32, device="cuda")
    ms = time_launches(lambda: probes.fma_chain_kernel(x, iters, fused))
    return 2 * 8 * iters * shape[0] * shape[1] / (ms * 1e-3), ms


def matmul_bf16(n: int = 2048) -> float:
    """FLOP/s of one (n, n) x (n, n) bf16 product by torch.matmul."""
    g = torch.Generator(device="cuda").manual_seed(0)
    a = (torch.randn((n, n), generator=g, device="cuda")
         / n ** 0.5).to(torch.bfloat16)
    ms = time_launches(lambda: torch.matmul(a, a))
    return 2 * n ** 3 / (ms * 1e-3)


def hbm_bw(mib: int = 512) -> float:
    """Bytes/s of an in-place scale of `mib` MiB of f32 (read + write)."""
    x = torch.ones(mib * (1 << 20) // 4, dtype=torch.float32, device="cuda")
    ms = time_launches(lambda: x.mul_(1.0000001))
    return 2 * x.numel() * 4 / (ms * 1e-3)


def brute_visit_rate(n_tris: int = 8192, n_rays: int = 1 << 14,
                     seed: int = 3):
    """K2 on one chunk of a thin random triangle slab, every lane of every
    128-ray block visiting it with every tile live: (seconds per block
    visit, Moller lane tests per second)."""
    from fluctus_tpu_torch.accel.forest import build_brute_forest
    from fluctus_tpu_torch.convert import brute_from_numpy
    from fluctus_tpu_torch.ops import traverse_brute as tb

    g = np.random.default_rng(seed)
    v0 = g.uniform(0, 1, (n_tris, 3)).astype(np.float32)
    v0[:, 2] *= 0.001               # thin slab of triangles near z = 0
    v1 = v0 + g.uniform(0.001, 0.01, (n_tris, 3)).astype(np.float32)
    v2 = v0 + g.uniform(0.001, 0.01, (n_tris, 3)).astype(np.float32)
    hb = build_brute_forest(v0, v1, v2, target_tris=n_tris)
    bf = brute_from_numpy({f: getattr(hb, f) for f in
                           ("tris", "boxes", "boxes_t", "tboxes", "tile")},
                          device="cuda")
    tp = int(bf.tris.shape[2])
    blk = tb.BLK
    nb = n_rays // blk
    o = g.uniform(0.2, 0.8, (n_rays, 3)).astype(np.float32)
    o[:, 2] = 1.0
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n_rays, 1))
    rays8 = torch.from_numpy(np.concatenate(
        [o, d, np.zeros((n_rays, 2), np.float32)], 1)).cuda().contiguous()
    sel = torch.zeros(nb, dtype=torch.int32, device="cuda")
    val = torch.ones(nb, dtype=torch.int32, device="cuda")
    it = torch.full((n_rays, 1), 3.4e38, device="cuda")
    ip = torch.full((n_rays, 1), -1, dtype=torch.int32, device="cuda")
    z = torch.zeros((n_rays, 1), device="cuda")
    tt = int(bf.tile)
    gr = tb._resolve_gr(tt, tp)
    ms = time_launches(lambda: tb.vlaunch_kernel(
        sel, val, bf.tris, bf.tboxes, rays8, it, ip, z, z, False, blk, tt,
        1, gr))
    return ms * 1e-3 / nb, n_rays * tp / (ms * 1e-3)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_mfu needs a CUDA card")
    print(f"card: {card_line()} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    fused, fused_ms = p2_rate(True)
    unfused, unfused_ms = p2_rate(False)
    mm = matmul_bf16()
    bw = hbm_bw()
    per_visit, tests_s = brute_visit_rate()
    print(f"--- peak rates ({REPS} launches back to back, best of "
          f"{BEST_OF}) ---")
    print(f"P2 f32 FMA peak (fused):  {fused / 1e12:8.3f} TFLOP/s = "
          f"{fused / 2e12:.3f} T instructions/s ({fused_ms:.4f} ms)")
    print(f"P2 unfused mul + add:     {unfused / 1e12:8.3f} TFLOP/s = "
          f"{unfused / 1e12:.3f} T instructions/s ({unfused_ms:.4f} ms)")
    print(f"bf16 matmul 2048^2:       {mm / 1e12:8.3f} TFLOP/s")
    print(f"HBM stream bandwidth:     {bw / 1e9:8.1f} GB/s")
    print(f"K2 Moller visit:          {per_visit * 1e6:8.3f} us per "
          f"128-lane full-chunk visit")
    print(f"Moller lane tests:        {tests_s / 1e9:8.2f} G tests/s = "
          f"{tests_s * MOLLER_FLOPS / 1e12:.3f} TFLOP/s = "
          f"{100 * tests_s * MOLLER_FLOPS / fused:.1f}% of the measured "
          f"P2 FMA peak", flush=True)


if __name__ == "__main__":
    main()
