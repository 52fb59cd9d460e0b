"""The measurement probes P1 (launch floor) and P2 (FP32 pipe rate): kernels
in `csrc/probes.cu` and their plain versions.

P1 `copy_plus_one` is the Hopper counterpart of
`scripts/probe_pallas_floor.py::_copy_kernel`: o = x + 1 over (8k, 128)
f32, one (8, 128) tile per CUDA block, as the TPU probe's `copy1` (one
block) and `copy64` (a 64-step grid). P2 `fma_chain` is the counterpart of
`scripts/measure_mfu.py::_fma_kernel`: `iters` trips of 8 steps
x = x * 1.000000119 + 1e-7 on every element, fused (one FMA per step) or
unfused (a multiply and an add). The plain versions are the same
arithmetic in PyTorch ops: P1 and unfused P2 round each op to f32; fused
P2 takes each step's multiply-add in float64, which is exact here, and
rounds it once to f32, as an FMA does. Each kernel is bit-equal to its
plain version.

The wrappers take the plain version for CPU tensors and launch the kernel
for CUDA tensors; there is no fallback between the two.
"""
from __future__ import annotations

import os

import torch

from fluctus_tpu_torch.launch import CSRC, launch, load_library

TILE = (8, 128)
P2_CHAINS = 2            # kChains of the CUDA source
P2_THREADS = 256         # kP2Threads
FMA_MUL = 1.000000119
FMA_ADD = 1e-7

# launches of each kernel, and calls of the plain versions
LAUNCHES = {"p1": 0, "p2_fused": 0, "p2_unfused": 0}
PLAIN_CALLS = {"p1": 0, "p2_fused": 0, "p2_unfused": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _p2_key(fused: bool) -> str:
    return "p2_fused" if fused else "p2_unfused"


# ---------------------------------------------------------------- plain

def copy_plus_one_plain(x: torch.Tensor) -> torch.Tensor:
    PLAIN_CALLS["p1"] += 1
    return x + 1.0


def fma_chain_plain(x: torch.Tensor, iters: int,
                    fused: bool) -> torch.Tensor:
    """The chain, unfused: a multiply and an add per step, each rounded to
    f32. Fused: the step's product and sum in float64, rounded once to
    f32. The product of two floats is exact in float64, and so is the sum
    with 1e-7 while |x| lies in [2^-30, 64) (the two span at most 53
    bits), so this is the FMA's single rounding."""
    PLAIN_CALLS[_p2_key(fused)] += 1
    dt = torch.float64 if fused else torch.float32
    mul = torch.tensor(FMA_MUL, dtype=torch.float32).to(dt).to(x.device)
    add = torch.tensor(FMA_ADD, dtype=torch.float32).to(dt).to(x.device)
    for _ in range(iters * 8):
        x = (x.to(dt) * mul + add).to(torch.float32)
    return x


# ---------------------------------------------------------------- kernel

_SRC = os.path.join(CSRC, "probes.cu")
_lib = None
BUILD_INFO: dict = {}
_F32 = torch.float32


def load_kernel():
    """Build (at first use) and load the P1/P2 library."""
    global _lib
    if _lib is None:
        _lib = load_library(_SRC, "probes", {"p1_copy_plus_one": "P1",
                                             "p2_fma_chain": "P2"},
                            info=BUILD_INFO)
    return _lib


def _refuse(name, x, want: str):
    raise ValueError(
        f"{name}: x must be a contiguous CUDA float32 tensor {want}, got "
        f"{x.dtype} {tuple(x.shape)} on {x.device}"
        + ("" if x.is_contiguous() else ", not contiguous"))


def copy_plus_one_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch P1 on the current stream: one block per (8, 128) tile."""
    s = x.shape                                    # (k * 8, 128): TILE
    if not (x.is_cuda and x.dtype is _F32 and len(s) == 2 and s[1] == 128
            and s[0] % 8 == 0 and s[0] and x.is_contiguous()):
        _refuse("P1", x, f"of shape (k * {TILE[0]}, {TILE[1]})")
    o = torch.empty_like(x)
    launch((_lib or load_kernel()).p1_copy_plus_one, x.get_device(),
           x.data_ptr(), o.data_ptr(), s[0] >> 3)
    LAUNCHES["p1"] += 1
    return o


def fma_chain_kernel(x: torch.Tensor, iters: int,
                     fused: bool) -> torch.Tensor:
    """Launch P2 on the current stream (fused or unfused form)."""
    q = P2_CHAINS * P2_THREADS
    if not (x.is_cuda and x.dtype is _F32 and x.is_contiguous()
            and x.numel() > 0 and x.numel() % q == 0):
        _refuse("P2", x, f"of a multiple of {q} elements")
    if not 0 <= iters < 1 << 24:
        raise ValueError(f"P2: iters {iters} out of range")
    o = torch.empty_like(x)
    launch((_lib or load_kernel()).p2_fma_chain, x.get_device(),
           x.data_ptr(), o.data_ptr(), x.numel(), iters, int(fused))
    LAUNCHES[_p2_key(fused)] += 1
    return o


# ---------------------------------------------------------------- entry

def copy_plus_one(x: torch.Tensor) -> torch.Tensor:
    """o = x + 1 over an (8k, 128) f32 tensor."""
    if x.is_cuda:
        return copy_plus_one_kernel(x)
    return copy_plus_one_plain(x)


def fma_chain(x: torch.Tensor, iters: int, fused: bool) -> torch.Tensor:
    """`iters` trips of 8 chained multiply-adds on every element."""
    if x.is_cuda:
        return fma_chain_kernel(x, iters, fused)
    return fma_chain_plain(x, iters, fused)
