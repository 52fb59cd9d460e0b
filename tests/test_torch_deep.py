"""Deep hierarchies: the port's traversals against the JAX package's and a
brute-force closest hit on the chains of fluctus_tpu_torch/fixtures.py
(`deep_chain_bvh`: 7 leaves and one inner child a level).

K1's plain version is held against JAX K1 (`traverse_mxu`, which sizes its
stack from the depth) in Pallas interpret mode at wide depth 20 and 30,
with the inner child entered first ("near", the deepest stacks) and last
("far"). K4's plain version is held against JAX K4 where that kernel's
192-entry stack holds (7 * depth + 1 <= 192: depth 20 near, and depth 30
far, whose stack stays shallow). At depth 30 near the JAX K4 stack
overflows (211 entries): it clamps the push position, overwrites its top
entry and loses subtrees; the port sizes its stack from the depth and
matches the brute-force hit on every ray, while JAX K4 misses hits (the
fault is pinned here; ROADMAP Queue 3, faults of the JAX reference)."""
import re

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_mxu as tm
import fluctus_tpu.ops.traverse_pallas as jtp
from fluctus_tpu.core.types import WideBVH as JaxWide
from fluctus_tpu_torch.convert import wide_from_numpy
from fluctus_tpu_torch.fixtures import brute_closest, deep_chain_bvh
from fluctus_tpu_torch.launch import CSRC
from fluctus_tpu_torch.ops import traverse_pallas as tp
from fluctus_tpu_torch.ops import traverse_stack as ts

from torch_common import assert_hits_match

N_RAYS = 1024


@pytest.fixture
def interp(monkeypatch):
    orig_call = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(tm.pl, "pallas_call", pl.pallas_call)
    monkeypatch.setattr(jtp.pl, "pallas_call", pl.pallas_call)


def chain(depth, order):
    arrays, o, d, tris = deep_chain_bvh(depth, order, n_rays=N_RAYS)
    pw = wide_from_numpy(arrays, device="cpu")
    jw = JaxWide(nodes=jnp.asarray(arrays["nodes"]),
                 leaves=jnp.asarray(arrays["leaves"]), root_ref=0,
                 depth=depth, leaf_width=arrays["leaf_width"])
    t = np.full(len(o), 3.4e38, np.float32)
    return pw, jw, o, d, t, tris


def assert_brute(rp, o, d, t, tris):
    bt, bp = brute_closest(tris, o, d, t)
    np.testing.assert_array_equal(rp.prim.numpy(), bp)
    hit = bp >= 0
    np.testing.assert_allclose(rp.t.numpy()[hit], bt[hit], rtol=1e-5)
    return bp


@pytest.mark.parametrize("depth,order", [(20, "near"), (20, "far"),
                                         (30, "near"), (30, "far")])
def test_k1_plain_deep_chain_matches_jax_and_brute(interp, depth, order):
    pw, jw, o, d, t, tris = chain(depth, order)
    to = lambda x: torch.from_numpy(x)
    rp = ts.traverse_closest(pw, to(o), to(d), to(t))
    bp = assert_brute(rp, o, d, t, tris)
    assert (bp >= 0).mean() > 0.5
    assert_hits_match(rp, tm.traverse_closest(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), blk=128))
    # any-hit under a t_max that ends some rays above their hit
    t2 = np.where(np.arange(len(o)) % 2 == 0, t, np.float32(4.0))
    bp2 = ts.traverse_any(pw, to(o), to(d), to(t2)).numpy()
    np.testing.assert_array_equal(bp2, brute_closest(tris, o, d, t2)[1] >= 0)
    np.testing.assert_array_equal(bp2, np.asarray(tm.traverse_any(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t2), blk=128)))


@pytest.mark.parametrize("depth,order", [(20, "near"), (30, "far")])
def test_k4_plain_deep_chain_matches_jax_where_its_stack_holds(
        interp, depth, order):
    pw, jw, o, d, t, tris = chain(depth, order)
    to = lambda x: torch.from_numpy(x)
    rp = tp.traverse_closest(pw, to(o), to(d), to(t))
    assert_brute(rp, o, d, t, tris)
    assert_hits_match(rp, jtp.traverse_closest(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)))
    bp = tp.traverse_any(pw, to(o), to(d), to(t)).numpy()
    np.testing.assert_array_equal(bp, np.asarray(jtp.traverse_any(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))))


def test_k4_deep_chain_where_the_jax_stack_overflows(interp):
    """Depth 30 near: the packet stack reaches 7 * 30 + 1 = 211 entries.
    The port's plain K4 (and K1) give the brute-force hit on every ray;
    JAX K4, whose stack holds 192, loses subtrees and misses hits."""
    pw, jw, o, d, t, tris = chain(30, "near")
    assert tp.stack_entries(30) > 192
    to = lambda x: torch.from_numpy(x)
    bp = assert_brute(tp.traverse_closest(pw, to(o), to(d), to(t)), o, d, t,
                      tris)
    assert_brute(ts.traverse_closest(pw, to(o), to(d), to(t)), o, d, t, tris)
    jp = np.asarray(jtp.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(t)).prim)
    assert (jp != bp).mean() > 0.05     # the JAX reference's fault


def test_stack_caps_cover_the_builders_deepest_tree():
    """Binary depth 64 (accel/bvh.py) gives wide depth <= 64: K1 and K5
    need stack_entries(64) = 464 entries (kDeepStackCap of
    csrc/wide_walk.cuh), K4 7 * 64 + 1 = 449 (kMaxStack of
    csrc/traverse_packet.cu); the CUDA constants hold them."""
    from fluctus_tpu_torch.accel.bvh import MAX_DEPTH
    assert MAX_DEPTH == 64
    assert ts.stack_entries(64) == ts.MAX_STACK == 464
    assert tp.stack_entries(64) == 449

    def const(fname, name):
        with open(f"{CSRC}/{fname}") as f:
            return int(re.search(rf"constexpr int {name} = (\d+);",
                                 f.read()).group(1))

    assert const("wide_walk.cuh", "kDeepStackCap") == ts.MAX_STACK
    assert const("wide_walk.cuh", "kStackCap") == 128
    assert const("traverse_packet.cu", "kMaxStack") == tp.MAX_STACK \
        == tp.stack_entries(64)
