"""Port parity of K1's plain version (ops/traverse_stack.py) against the
JAX package's traversals on the same hierarchy and rays.

References: `traverse_wide` (the XLA restart-trail walk the plain version
ports) and `traverse_mxu` (the TPU kernel K1 replaces), the latter run in
Pallas interpret mode as tests/test_traverse_mxu.py runs it. Prim ids must
be equal except where two triangles are hit at equal t; t may differ by a
few float32 ulps, since XLA contracts the Moller-Trumbore multiply-adds
into FMAs, and up to ~30 ulps on triangles hit at grazing angles: t is
held at 1e-5 relative (84 ulps); any-hit flags must be equal."""
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_mxu as tm
from fluctus_tpu.core.types import WideBVH as JaxWide
from fluctus_tpu.ops import traverse_wide as tw
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.scene.scene import load_scene

T_REL = 1e-5          # t agreement on hits, relative


@pytest.fixture
def interp(monkeypatch):
    orig_call = pl.pallas_call
    monkeypatch.setattr(
        tm.pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in ("cornell", "kitchen"):
        host = load_scene(f"assets/{name}_proxy.obj")
        host.build_bvh(use_sbvh=True)
        w = host.to_device("cpu").wbvh
        jw = JaxWide(nodes=jnp.asarray(w.nodes.numpy()),
                     leaves=jnp.asarray(w.leaves.numpy()),
                     root_ref=w.root_ref, depth=w.depth,
                     leaf_width=w.leaf_width)
        out[name] = (host, w, jw)
    return out


def rays(host, n, seed, t_max_mode):
    """Origins inside the scene bounds, directions on the sphere, and a
    scalar or per-lane t_max."""
    g = np.random.default_rng(seed)
    lo, hi = host.bounds()
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if t_max_mode == "f32max":
        t = np.full(n, 3.4e38, np.float32)
    else:
        t = np.where(g.random(n) < 0.3, np.float32(3.4e38),
                     g.uniform(0.05, 3.0, n)).astype(np.float32)
    return o, d.astype(np.float32), t


def assert_closest_matches(got, t_ref, prim_ref):
    prim = got.prim.numpy()
    t = got.t.numpy()
    diff = prim != prim_ref
    # a differing prim is only allowed where both walks stopped at equal t
    np.testing.assert_allclose(t[diff], t_ref[diff], rtol=T_REL,
                               err_msg="prim mismatches that are not ties")
    assert diff.mean() < 0.01
    hit = prim_ref >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=T_REL)


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
@pytest.mark.parametrize("t_max_mode", ["f32max", "per_lane"])
def test_plain_matches_traverse_wide(scenes, name, t_max_mode):
    host, w, jw = scenes[name]
    o, d, t = rays(host, 4096, seed=len(name), t_max_mode=t_max_mode)
    ref = tw.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t))
    got = ts.traverse_closest(w, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t))
    assert_closest_matches(got, np.asarray(ref.t), np.asarray(ref.prim))
    any_ref = tw.traverse_any(jw, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t))
    any_got = ts.traverse_any(w, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t))
    np.testing.assert_array_equal(any_got.numpy(), np.asarray(any_ref))


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_plain_matches_traverse_mxu_interpret(scenes, name, interp):
    host, w, jw = scenes[name]
    o, d, t = rays(host, 512, seed=5, t_max_mode="per_lane")
    ref = tm.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t), blk=128)
    got = ts.traverse_closest(w, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t))
    assert_closest_matches(got, np.asarray(ref.t), np.asarray(ref.prim))
    any_ref = tm.traverse_any(jw, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t), blk=128)
    any_got = ts.traverse_any(w, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t))
    np.testing.assert_array_equal(any_got.numpy(), np.asarray(any_ref))


def test_all_miss_at_f32_max_stays_miss(scenes):
    """Phantom-hit guard (traverse_mxu.py:268-271): with t_max 3.4e38,
    above the 3e38 sentinel, rays that miss everything keep prim -1."""
    host, w, _ = scenes["kitchen"]
    lo, hi = host.bounds()
    n = 256
    o = np.tile((hi + 10.0).astype(np.float32), (n, 1))
    d = np.tile(np.float32([0.0, 1.0, 0.0]), (n, 1))
    o[::2] = np.float32([3.0e37, 3.0e37, 3.0e37])   # neutralized lanes
    d[::2] = np.float32([0.0, 0.0, 1.0])
    r = ts.traverse_closest(w, torch.from_numpy(o), torch.from_numpy(d),
                            3.4e38)
    assert (r.prim.numpy() == -1).all()
    assert (r.t.numpy() == np.float32(3.4e38)).all()
    assert not ts.traverse_any(w, torch.from_numpy(o), torch.from_numpy(d),
                               torch.full((n,), 3.4e38)).any()


def test_single_leaf_root():
    """A scene small enough to be one fat leaf (root_ref < 0)."""
    g = np.random.default_rng(9)
    v0 = g.uniform(-1, 1, (6, 3)).astype(np.float32)
    v1 = v0 + g.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
    v2 = v0 + g.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
    from fluctus_tpu.accel import bvh as jbvh
    from fluctus_tpu.accel.wide import build_wide
    wh = build_wide(jbvh.build_bvh(v0, v1, v2), v0, v1, v2)
    assert wh.root_ref < 0
    jw = JaxWide(nodes=jnp.asarray(wh.nodes), leaves=jnp.asarray(wh.leaves),
                 root_ref=wh.root_ref, depth=wh.depth, leaf_width=16)
    w = ts.WideBVH(nodes=torch.from_numpy(wh.nodes),
                   leaves=torch.from_numpy(wh.leaves),
                   root_ref=int(wh.root_ref), depth=int(wh.depth))
    o = np.tile(np.float32([0.0, 0.0, -4.0]), (1024, 1))
    d = g.normal(size=(1024, 3)).astype(np.float32) * 0.2
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = tw.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                              np.float32(3.4e38))
    got = ts.traverse_closest(w, torch.from_numpy(o), torch.from_numpy(d),
                              3.4e38)
    assert_closest_matches(got, np.asarray(ref.t), np.asarray(ref.prim))


def test_visit_stats_count_rows():
    """The plain version's visit counts, which chip_smoke.py turns into
    K1's operation bound, cover every ray's root visit, and count only the
    occupied child slots and the real triangle ids of the visited rows."""
    host = load_scene("assets/cornell_proxy.obj")
    host.build_bvh(use_sbvh=True)
    w = host.to_device("cpu").wbvh
    o, d, t = rays(host, 300, seed=4, t_max_mode="f32max")
    stats = {}
    ts.traverse_plain(w, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(t), False, stats=stats)
    assert stats["node_visits"] >= 300 and stats["leaf_visits"] > 0
    assert 2 * stats["node_visits"] <= stats["child_tests"] \
        < 8 * stats["node_visits"]
    assert stats["leaf_visits"] <= stats["tri_tests"] \
        < w.leaf_width * stats["leaf_visits"]


@pytest.mark.parametrize("t_max", [3.4e38, 9.5])
def test_wide_tie_bvh_plain_matches_winners_and_jax(interp, t_max):
    """The tie hierarchy of fluctus_tpu_torch/fixtures.py (equal-t copies
    of one triangle in slots a team deals to different lanes, in two
    leaves entered in a known order, and in two leaves with equal entry
    distances): the plain walk returns the copy K1's sequential rule
    picks on every tie ray, and agrees with JAX's traverse_wide and K1 in
    interpret mode; the any-hit flags agree too (at t_max 9.5 every tie
    ray is blocked)."""
    from fluctus_tpu_torch.convert import wide_from_numpy
    from fluctus_tpu_torch.fixtures import wide_tie_bvh
    from torch_common import assert_hits_match
    arrays, o, d, want = wide_tie_bvh()
    w = wide_from_numpy(arrays, device="cpu")
    jw = JaxWide(nodes=jnp.asarray(arrays["nodes"]),
                 leaves=jnp.asarray(arrays["leaves"]),
                 root_ref=arrays["root_ref"], depth=arrays["depth"],
                 leaf_width=arrays["leaf_width"])
    t = np.full(len(o), t_max, np.float32)
    got = ts.traverse_closest(w, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t))
    tie = want["k1"] >= 0
    np.testing.assert_array_equal(got.prim.numpy()[tie], want["k1"][tie])
    assert int((got.prim >= 0).sum()) > int(tie.sum())   # fillers hit too
    for ref in (tw.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t)),
                tm.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t), blk=128)):
        assert_hits_match(got, ref)
    blocked = ts.traverse_any(w, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(blocked, np.asarray(tm.traverse_any(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), blk=128)))
    assert blocked[tie].all()
