"""Port parity of the treelet-forest path: the forest build
(accel/forest.py `build_host_forest`), the plain version of K5 behind
both schedulers (ops/traverse_forest.py), the upload and routing rules
of the forest knobs, and the lockstep slice with a forest attached,
against the JAX package on the same inputs.

The JAX forest kernel runs in Pallas interpret mode, as
tests/test_traverse_forest.py runs it. Both packages get the same
tables: the JAX builder's f32 staging arrays, which the JAX package then
encodes in bf16 for its one-hot gathers and the port carries across with
convert.forest_from_numpy. The bf16 boxes are conservative and the JAX
kernel orders children by truncated keys, so the two visit chunks and
nodes in different orders but find the same hits: prim ids must be equal
except where two triangles are hit at equal t, t within 1e-5 relative,
u and v within 1e-4 absolute, any-hit flags exactly."""
import types

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_forest as jtf
from fluctus_tpu.accel import bvh as jbvh, cpu_ref
from fluctus_tpu.accel import native as jnative
from fluctus_tpu.accel.forest import build_host_forest as jax_build
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.accel.forest import build_binary, build_host_forest
from fluctus_tpu_torch.accel.wide import build_wide_forest
from fluctus_tpu_torch.convert import (
    forest_from_numpy, params_from_numpy, scene_from_numpy)
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.integrators import lockstep
from fluctus_tpu_torch.ops import traverse_forest as tf
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.render import driver
from fluctus_tpu_torch.scene import scene as scene_mod
from fluctus_tpu_torch.scene.scene import fast_big_eligible, load_scene

from golden_common import ATOL, RTOL, _cornell_light
from test_bvh import random_rays, random_tris
from torch_common import assert_hits_match, params_arrays, scene_arrays

FIELDS = ("nodes", "leaves", "boxes", "lvl", "leaf_width")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one thread each keeps the parallel test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interp(monkeypatch):
    orig_call = pl.pallas_call
    monkeypatch.setattr(
        jtf.pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))


def jax_sbvh(a, b, c):
    """The JAX package's per-chunk build: its native builder with spatial
    splits (fluctus_tpu/scene/scene.py)."""
    return jnative.build_native(a, b, c, jbvh.MAX_LEAF, jbvh.MAX_DEPTH,
                                1e-5, True)


def forests(v0, v1, v2, target_tris=128, leaf_width=16):
    """The same tables for both packages, from the JAX builder."""
    h = jax_build(v0, v1, v2, jax_sbvh, leaf_width=leaf_width,
                  target_tris=target_tris)
    return (jtf.encode_forest(h),
            forest_from_numpy({f: getattr(h, f) for f in FIELDS}, "cpu"))


def tmax_of(mode, n, seed):
    g = np.random.default_rng(seed)
    if mode == "scalar":
        return np.float32(1e30)
    if mode == "f32max":
        return np.float32(3.4e38)
    return np.where(g.random(n) < 0.3, np.float32(3.4e38),
                    g.uniform(0.05, 3.0, n)).astype(np.float32)


def t_torch(t_max):
    return torch.as_tensor(np.asarray(t_max))


# ------------------------------------------------------------ forest build

@pytest.mark.parametrize("source,target,width", [
    ("soup", 128, 16), ("soup", 300, 8), ("soup", 12, 16),
    ("cornell", 512, 16)])
def test_forest_build_bit_equal(source, target, width):
    if source == "soup":
        v0, v1, v2 = random_tris(np.random.default_rng(3), m=700)
    else:
        h = load_scene(f"assets/{source}_proxy.obj")
        v0, v1, v2 = h.v0, h.v1, h.v2
    hj = jax_build(v0, v1, v2, jax_sbvh, leaf_width=width,
                   target_tris=target)
    hp = build_host_forest(v0, v1, v2, leaf_width=width, target_tris=target)
    assert (hp.lvl, hp.leaf_width) == (hj.lvl, hj.leaf_width)
    for f in ("nodes", "leaves", "boxes"):
        a, b = getattr(hp, f), getattr(hj, f)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=f)
    c = hp.nodes.shape[0]
    assert c >= 2 and hp.nodes.shape[1] % 128 == 0
    # every triangle by its global id (spatial splits may reference one
    # in two leaves of a chunk); pad slots carry -1
    ids = hp.leaves[..., 9].view(np.int32).ravel()
    np.testing.assert_array_equal(np.unique(ids[ids >= 0]),
                                  np.arange(len(v0), dtype=np.int32))
    if target < width:
        # every chunk fits one leaf: a one-node wrapper roots it at node 0
        refs = hp.nodes[:, 0, 48:56].view(np.int32)
        assert (refs[:, 0] == -1).all() and hp.lvl == 2


# ------------------------------------------------------------ K5 vs JAX

@pytest.fixture(scope="module")
def soup600():
    """One soup and its forests, shared so the JAX side reuses its
    compiled launches."""
    v0, v1, v2 = random_tris(np.random.default_rng(11), m=600)
    o, d = random_rays(np.random.default_rng(12), b=256)
    return (v0, v1, v2), forests(v0, v1, v2), o, d


@pytest.mark.parametrize("mode", ["workqueue", "blocksched"])
@pytest.mark.parametrize("t_mode", ["scalar", "per_lane", "f32max"])
def test_forest_closest_matches_jax(soup600, interp, mode, t_mode):
    tris, (jft, pft), o, d = soup600
    assert pft.nodes.shape[0] >= 4
    t_max = tmax_of(t_mode, len(o), 13)
    rj = jtf.traverse_closest(jft, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), mode=mode)
    tf.reset_counts()
    rp = tf.traverse_closest(pft, torch.from_numpy(o), torch.from_numpy(d),
                             t_torch(t_max), mode=mode)
    assert tf.PLAIN_CALLS["closest"] > 0 and tf.LAUNCHES["closest"] == 0
    assert_hits_match(rp, rj)
    t_ref, prim_ref, _, _ = cpu_ref.intersect_closest(*tris, o, d)
    hit_ref = (prim_ref >= 0) & (t_ref < np.broadcast_to(t_max, t_ref.shape))
    np.testing.assert_array_equal(rp.prim.numpy() >= 0, hit_ref)


@pytest.mark.parametrize("mode", ["workqueue", "blocksched"])
def test_forest_any_matches_jax(soup600, interp, mode):
    tris, (jft, pft), o, d = soup600
    t_max = np.random.default_rng(14).uniform(0.05, 3.0, len(o)).astype(
        np.float32)
    bj = jtf.traverse_any(jft, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_max), mode=mode)
    bp = tf.traverse_any(pft, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(t_max), mode=mode)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(
        bp.numpy(), cpu_ref.intersect_any(*tris, o, d, t_max))
    assert 0 < int(bp.sum()) < len(o)


def test_forest_schedulers_agree_exactly(soup600):
    """The work queue and the passes at one and at eight visits per pass
    return the same bits, closest and any-hit."""
    _, (_, pft), o, d = soup600
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = t_torch(tmax_of("per_lane", len(o), 15))
    runs = [dict(mode="workqueue"), dict(mode="blocksched", blk=128, kk=1),
            dict(mode="blocksched", blk=128, kk=8), dict(mode="blocksched")]
    res, passes = [], []
    for kw in runs:
        n: list = []
        res.append((tf.traverse_closest(pft, o, d, t_max, rounds=n, **kw),
                    tf.traverse_any(pft, o, d, t_max, **kw)))
        passes.append(n[0])
    for (rc, ra) in res[1:]:
        for a, b in zip(rc, res[0][0]):
            assert torch.equal(a, b)
        assert torch.equal(ra, res[0][1])
    # one visit per pass takes more passes than eight
    assert passes[1] > passes[2] >= 1 and passes[0] >= 1
    with pytest.raises(ValueError, match="mode"):
        tf.traverse_closest(pft, o, d, t_max, mode="rounds")


@pytest.mark.parametrize("form", ["closest", "any"])
def test_queue_plain_matches_jax_workqueue(soup600, interp, form):
    """The work queue's plain version (queue_plain: the round loop over
    launch_plain) against the JAX package's _run_workqueue in interpret
    mode, on the same rays with per-lane t_max."""
    tris, (jft, pft), o, d = soup600
    any_hit = form == "any"
    t_max = tmax_of("per_lane", len(o), 16)
    if any_hit:
        t_max = np.minimum(t_max, np.float32(3.0))
    jo, jd, jt, b = jtf._prep(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), jtf.WQ_BLK)
    assert b == len(o) == jo.shape[1]
    rj = jtf._run_workqueue(jft, jo, jd, jt, any_hit)
    tf.reset_counts()
    n: list = []
    rp = tf.queue_plain(pft, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(t_max), any_hit, rounds=n)
    assert tf.PLAIN_CALLS[tf._form(any_hit)] == n[0] > 1
    assert sum(tf.LAUNCHES.values()) == 0
    if any_hit:
        np.testing.assert_array_equal(rp[1].numpy() > 0,
                                      np.asarray(rj[1][0]) > 0)
        np.testing.assert_array_equal(
            rp[1].numpy() > 0, cpu_ref.intersect_any(*tris, o, d, t_max))
        assert 0 < int((rp[1] > 0).sum()) < len(o)
    else:
        assert_hits_match(ts.Traversal(*rp),
                          ts.Traversal(*(x[0] for x in rj)))


def test_queue_results_are_per_ray(soup600):
    """The work queue's result for a ray depends on that ray alone, which
    lets K5's queue kernel walk each ray's chunks in its own thread: the
    plain queue on the rays reversed, and on one ray among pad rays,
    returns the same bits. On the CPU the entry point takes the plain
    queue; the queue kernel refuses CPU tensors."""
    _, (_, pft), o, d = soup600
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max = t_torch(tmax_of("per_lane", len(o), 17))
    bases = {}
    for any_hit in (False, True):
        base = bases[any_hit] = tf.queue_plain(pft, o, d, t_max, any_hit)
        rev = torch.arange(len(o) - 1, -1, -1)
        flip = tf.queue_plain(pft, o[rev], d[rev], t_max[rev], any_hit)
        for a, b in zip(base, flip):
            assert torch.equal(a, b[rev])
        for i in (0, 37, 200):
            oi, di, ti, _ = tf._prep(o[i:i + 1], d[i:i + 1], t_max[i:i + 1],
                                     tf.WQ_BLK)
            one = tf.queue_plain(pft, oi, di, ti, any_hit)
            assert all(torch.equal(a[i], b[0]) for a, b in zip(base, one))
    tf.reset_counts()
    r = tf.traverse_closest(pft, o, d, t_max)
    assert all(torch.equal(a, b) for a, b in zip(r, bases[False]))
    assert tf.PLAIN_CALLS["closest"] > 0 and tf.LAUNCHES["closest"] == 0
    with pytest.raises(ValueError, match="K5"):
        tf.queue_kernel(pft, o, d, t_max, False)


def test_forest_agrees_with_k1_plain():
    """K5's plain version against K1's plain version over the full
    hierarchy of the same scene, on rays from inside the kitchen: catches
    a table or merge fault without JAX."""
    host = load_scene("assets/kitchen_proxy.obj")
    host.build_bvh(use_sbvh=True)
    wbvh = host.to_device("cpu").wbvh
    hf = build_host_forest(host.v0, host.v1, host.v2, target_tris=4096)
    ft = forest_from_numpy({f: getattr(hf, f) for f in FIELDS}, "cpu")
    g = np.random.default_rng(21)
    lo, hi = host.bounds()
    o = torch.from_numpy((lo + (hi - lo) * g.random((1024, 3))).astype(
        np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(1024, 3)).astype(np.float32)), dim=1)
    k1, _ = ts.traverse_plain(wbvh, o, d, 3.4e38, False)
    k5 = tf.traverse_closest(ft, o, d, 3.4e38)
    hit = k1.prim >= 0
    assert bool(((k5.prim >= 0) == hit).all()) and int(hit.sum()) > 900
    assert not bool(((k5.prim != k1.prim) & (k5.t != k1.t)).any())
    assert torch.equal(k5.t[hit], k1.t[hit])
    t_max = torch.from_numpy(g.uniform(0.05, 2.0, 1024).astype(np.float32))
    _, k1a = ts.traverse_plain(wbvh, o, d, t_max, True)
    assert torch.equal(tf.traverse_any(ft, o, d, t_max), k1a)


def test_forest_diagonal_ray_misses():
    """A ray along exactly (1, 1, 1) hits the degenerate pad boxes at
    (3e37, 3e37, 3e37) with which the JAX scheduler pads its chunk list;
    there it returns a phantom hit (prim 0, t 0). The port schedules real
    chunks only, and the ray misses, as the oracle says."""
    v0, v1, v2 = random_tris(np.random.default_rng(1), m=600)
    _, pft = forests(v0, v1, v2, target_tris=128)
    o = np.array([[-5.0, -5.0, -3.0]], np.float32)
    d = np.full((1, 3), 1.0 / np.sqrt(3.0), np.float32)
    _, prim_ref, _, _ = cpu_ref.intersect_closest(v0, v1, v2, o, d)
    assert prim_ref[0] == -1
    # the fault's trigger: such a pad box counts as hit by this ray
    far = torch.full((1, 8), 3e37)
    _, hit = tf._chunk_slabs(far, torch.from_numpy(o),
                             ts._inv_dir(torch.from_numpy(d)),
                             torch.full((1,), float("inf")))
    assert bool(hit.all())
    for mode in ("workqueue", "blocksched"):
        r = tf.traverse_closest(pft, torch.from_numpy(o),
                                torch.from_numpy(d), 3.4e38, mode=mode)
        assert int(r.prim[0]) == -1 and float(r.t[0]) == np.float32(3.4e38)
        assert not bool(tf.traverse_any(pft, torch.from_numpy(o),
                                        torch.from_numpy(d), 50.0,
                                        mode=mode)[0])


# ------------------------------------------------------------ routing

def test_forest_knobs_in_fast_big_rule(monkeypatch):
    big = types.SimpleNamespace(v0=np.zeros((200_000, 3), np.float32))
    assert fast_big_eligible(big, "cuda")
    monkeypatch.setenv("FLUCTUS_FOREST", "treelet")
    assert not fast_big_eligible(big, "cuda")
    monkeypatch.setenv("FLUCTUS_FOREST", "brute")
    monkeypatch.setenv("FLUCTUS_PACKET_FOREST", "1")
    assert not fast_big_eligible(big, "cuda")
    monkeypatch.setenv("FLUCTUS_PACKET_FOREST", "0")
    monkeypatch.setenv("FLUCTUS_FOREST", "bvh")
    with pytest.raises(ValueError, match="FLUCTUS_FOREST"):
        fast_big_eligible(big, "cuda")


def test_forest_tables_by_knob(monkeypatch):
    """Over the table threshold (lowered here so the cornell box passes
    it): no knob keeps the hierarchy alone (K1); treelet adds the forest,
    sized by its two knobs; the packet forest adds its padded chunks
    (the chunk budget lowered too) and their id maps."""
    monkeypatch.setattr(scene_mod, "FOREST_TABLE_BYTES", 0)
    host = load_scene("assets/cornell_proxy.obj")
    host.build_bvh(use_sbvh=True)
    s = host.to_device("cpu")
    assert s.wbvh is not None and s.ftables is None and s.bforest is None
    monkeypatch.setenv("FLUCTUS_FOREST", "treelet")
    monkeypatch.setenv("FLUCTUS_FOREST_TARGET_TRIS", "256")
    monkeypatch.setenv("FLUCTUS_FOREST_LEAF_WIDTH", "8")
    s = host.to_device("cpu")
    hf = build_host_forest(host.v0, host.v1, host.v2, leaf_width=8,
                           target_tris=256)
    assert s.wbvh is not None and s.ftables.leaf_width == 8
    bits = lambda x: torch.as_tensor(x).contiguous().view(torch.int32)
    assert torch.equal(bits(s.ftables.nodes), bits(hf.nodes))
    assert torch.equal(bits(s.ftables.leaves), bits(hf.leaves))
    assert s.ftables.lvl == hf.lvl and s.ftables.nodes.shape[0] >= 2
    monkeypatch.setenv("FLUCTUS_PACKET_FOREST", "1")
    monkeypatch.setattr(scene_mod, "FOREST_CHUNK_BYTES", 16 << 10)
    s = host.to_device("cpu")
    hosts, maps = build_wide_forest(host.v0, host.v1, host.v2, build_binary,
                                    budget_bytes=16 << 10)
    assert s.wbvh is not None and s.ftables is None and s.bforest is None
    assert len(s.wforest) == len(s.wforest_maps) == len(hosts) >= 3
    n_max = max(h.nodes.shape[0] for h in hosts)
    l_max = max(h.leaves.shape[0] for h in hosts)
    for c, m, h, hm in zip(s.wforest, s.wforest_maps, hosts, maps):
        assert c.root_ref == 0 and c.depth == h.depth
        assert c.nodes.shape == (n_max, 56)
        assert c.leaves.shape == (l_max, 16, 10)
        n, l_ = h.nodes.shape[0], h.leaves.shape[0]
        assert torch.equal(bits(c.nodes[:n]), bits(h.nodes))
        assert torch.equal(bits(c.leaves[:l_]), bits(h.leaves))
        assert bool(torch.isinf(c.nodes[n:, 0:48:6]).all())
        assert bool((bits(c.leaves[l_:, :, 9]) == -1).all())
        assert m.dtype == torch.int32 and torch.equal(m, torch.as_tensor(hm))
    # under the threshold the knobs change nothing
    monkeypatch.setattr(scene_mod, "FOREST_TABLE_BYTES", 8 << 20)
    s = host.to_device("cpu")
    assert s.ftables is None and s.wbvh is not None


def test_treelet_session_traces_through_k5(monkeypatch):
    """create_session under FLUCTUS_FOREST=treelet builds the hierarchy and
    the forest, and the frame traces through K5's plain version only."""
    monkeypatch.setattr(scene_mod, "FOREST_TABLE_BYTES", 0)
    monkeypatch.setenv("FLUCTUS_FOREST", "treelet")
    monkeypatch.setenv("FLUCTUS_FOREST_TARGET_TRIS", "128")
    cfg = RenderConfig(width=8, height=8, max_bounces=2, use_area_light=True,
                       use_env_map=False)
    s = driver.create_session("assets/cornell_proxy.obj", cfg=cfg,
                              state_dir=None, device="cpu")
    assert s.host_scene.bvh is not None and s.scene.ftables is not None
    tf.reset_counts()
    ts.reset_counts()
    img = driver.render(s, 1)
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0.0
    assert tf.PLAIN_CALLS["closest"] > 0 and tf.PLAIN_CALLS["any"] > 0
    assert sum(ts.PLAIN_CALLS.values()) == 0


# ------------------------------------------------------------ the slice

def test_slice_lockstep_with_treelet_forest(interp):
    """A 16x16 cornell frame with the same treelet forest attached by hand
    to both packages' scenes: JAX traces through its K5, the port through
    K5's plain version."""
    jcfg = JaxConfig(width=16, height=16, max_bounces=4,
                     use_area_light=True, use_env_map=False, backend="mxu")
    js = jax_driver.create_session(
        "assets/cornell_proxy.obj", env_map=None, cfg=jcfg, use_sbvh=True,
        cache_dir=None, state_dir=None)
    js.params = js.params.replace(area_light=_cornell_light())
    h = js.host_scene
    hf = jax_build(h.v0, h.v1, h.v2, jax_sbvh, target_tris=512)
    js.scene = js.scene.replace(ftables=jtf.encode_forest(hf))
    arrays = scene_arrays(js.scene)
    arrays.update({f"ftables.{f}": getattr(hf, f) for f in FIELDS})
    scene = scene_from_numpy(arrays, device="cpu")
    assert scene.ftables is not None and scene.ftables.nodes.shape[0] >= 2
    params = params_from_numpy(params_arrays(js.params), device="cpu")
    cfg = RenderConfig(width=16, height=16, max_bounces=4,
                       use_area_light=True, use_env_map=False,
                       bsdf_types_mask=js.cfg.bsdf_types_mask)
    spp = 2
    want = np.asarray(jax_driver.render(js, spp, integrator="lockstep"))
    tf.reset_counts()
    ts.reset_counts()
    got = lockstep.render(scene, params, cfg, spp).numpy()
    assert tf.PLAIN_CALLS["closest"] > 0 and tf.PLAIN_CALLS["any"] > 0
    assert sum(ts.PLAIN_CALLS.values()) == 0
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
