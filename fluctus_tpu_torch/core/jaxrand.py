"""JAX's default PRNG (threefry-2x32) as JAX 0.9 computes it, for the few
draws the port must share with the JAX package: `PRNGKey`, `fold_in`,
`split` and `randint`. The optimizer's stratified pixel minibatches
(`render/optimize.py`) draw through it, so a minibatch step of the port
picks the pixels the JAX package picks.

The bits follow `jax_threefry_partitionable=True` (JAX's default since
0.5): `random_bits` hashes the 64-bit iota of the output shape as (high,
low) count pairs, and `split` is fold-like. Arithmetic is uint32 held in
int64 tensors (PyTorch's CPU build lacks uint32 ops), masked after every
add and shift. Keys are (2,) int64 tensors of uint32 values, on the CPU.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 block (20 rounds) of key (k1, k2) over the count
    pairs (x1, x2); returns the two output words."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _key(k) -> tuple[int, int]:
    k = [int(v) for v in k]
    return k[0], k[1]


def prng_key(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 32-bit seed: (0, seed)."""
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def fold_in(key, data: int) -> torch.Tensor:
    """jax.random.fold_in: the hash of the pair (0, data) under key."""
    k1, k2 = _key(key)
    b1, b2 = threefry2x32(k1, k2, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK],
                                       dtype=torch.int64))
    return torch.cat([b1, b2])


def _iota_bits(key, n: int):
    k1, k2 = _key(key)
    return threefry2x32(k1, k2, torch.zeros(n, dtype=torch.int64),
                        torch.arange(n, dtype=torch.int64))


def split(key, num: int = 2) -> torch.Tensor:
    """jax.random.split (fold-like): (num, 2) keys."""
    b1, b2 = _iota_bits(key, num)
    return torch.stack([b1, b2], 1)


def random_bits32(key, n: int) -> torch.Tensor:
    """n uint32 draws of jax.random.bits(key, (n,)): the two words of the
    iota's hash, xored."""
    b1, b2 = _iota_bits(key, n)
    return b1 ^ b2


def randint(key, n: int, minval: int, maxval: int) -> torch.Tensor:
    """jax.random.randint(key, (n,), minval, maxval) for int32 and
    0 <= minval < maxval < 2**31: two 32-bit draws per value folded into
    the span by the modulus rule of jax.random._randint. Returns int64."""
    k = split(key, 2)
    hi = random_bits32(k[0], n)
    lo = random_bits32(k[1], n)
    span = (maxval - minval) & _MASK
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return minval + off % span
