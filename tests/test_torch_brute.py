"""Port parity of the big-scene path: the brute-chunk forest build
(accel/forest.py), the plain versions of K2 and K3 behind both schedulers
(ops/traverse_brute.py), the fast-big cutover rule and the lockstep slice
with a forest attached, against the JAX package on the same inputs.

The JAX brute kernels run in Pallas interpret mode, as
tests/test_traverse_brute.py runs them. Both packages get the same
tables: the JAX builder's arrays, carried across with
convert.brute_from_numpy. Prim ids must be equal except where two
triangles are hit at equal t; t is held at 1e-5 relative (XLA contracts
the Moller-Trumbore multiply-adds into FMAs, the port rounds each op),
u and v at 1e-5 absolute, any-hit flags and the exhaustion flag exactly."""
import types

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_brute as jtb
from fluctus_tpu.accel import cpu_ref
from fluctus_tpu.accel.forest import build_brute_forest as jax_build
from fluctus_tpu.core.types import BruteForest as JaxBrute
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.accel.forest import build_brute_forest
from fluctus_tpu_torch.convert import (
    brute_from_numpy, params_from_numpy, scene_from_numpy)
from fluctus_tpu_torch.core import rng as trng
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.fixtures import tie_forest
from fluctus_tpu_torch.integrators import common, lockstep
from fluctus_tpu_torch.ops import camera
from fluctus_tpu_torch.ops import traverse_brute as tb
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.render import driver
from fluctus_tpu_torch.scene import scene as scene_mod
from fluctus_tpu_torch.scene.scene import fast_big_eligible, load_scene

from golden_common import ATOL, RTOL, _cornell_light
from test_bvh import random_rays, random_tris
from torch_common import golden_stats, params_arrays, scene_arrays

T_REL = 1e-5
UV_ATOL = 1e-5
KITCHEN_SHARE = 0.995
KITCHEN_MEAN_REL = 1e-4
FIELDS = ("tris", "boxes", "boxes_t", "tboxes")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests issue many small torch ops; with several test processes
    sharing the cores, spreading each op over every core makes them tens of
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interp(monkeypatch):
    orig_call = pl.pallas_call
    monkeypatch.setattr(
        jtb.pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))


@pytest.fixture(params=["vlist", "rounds"])
def sched(request, monkeypatch):
    """Both schedulers, in both packages: the visit-list (K2, default) and
    the round loop (K3)."""
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", request.param)
    return request.param


def soup(seed, m):
    return random_tris(np.random.default_rng(seed), m=m)


def forests(v0, v1, v2, target_tris=128, tile=128):
    """The same tables for both packages, from the JAX builder."""
    h = jax_build(v0, v1, v2, target_tris=target_tris, tile=tile)
    jbf = JaxBrute(tris=jnp.asarray(h.tris), boxes=jnp.asarray(h.boxes),
                   boxes_t=jnp.asarray(h.boxes_t),
                   tboxes=jnp.asarray(h.tboxes), tile=h.tile)
    pbf = brute_from_numpy({f: getattr(h, f) for f in FIELDS + ("tile",)},
                           device="cpu")
    return jbf, pbf


def closest_both(jbf, pbf, o, d, t_max, **kw):
    tj = jnp.asarray(t_max)
    rj = jtb.traverse_closest(jbf, jnp.asarray(o), jnp.asarray(d), tj, **kw)
    rp = tb.traverse_closest(pbf, torch.from_numpy(o), torch.from_numpy(d),
                             torch.as_tensor(np.asarray(t_max)), **kw)
    return rj, rp


def any_both(jbf, pbf, o, d, t_max, **kw):
    bj = jtb.traverse_any(jbf, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_max), **kw)
    bp = tb.traverse_any(pbf, torch.from_numpy(o), torch.from_numpy(d),
                         torch.as_tensor(np.asarray(t_max)), **kw)
    return bj, bp


def assert_closest_matches(rp, rj):
    """Equal prims except at equal-t ties, t within 1e-5 relative on every
    lane (misses too), u/v within 1e-5 where the prims agree."""
    prim, prim_j = rp.prim.numpy(), np.asarray(rj.prim)
    t, t_j = rp.t.numpy(), np.asarray(rj.t)
    diff = prim != prim_j
    assert diff.mean() < 0.01
    np.testing.assert_allclose(t[diff], t_j[diff], rtol=T_REL,
                               err_msg="prim mismatches that are not ties")
    np.testing.assert_array_equal(prim >= 0, prim_j >= 0)
    np.testing.assert_allclose(t, t_j, rtol=T_REL)
    same = ~diff & (prim_j >= 0)
    np.testing.assert_allclose(rp.u.numpy()[same], np.asarray(rj.u)[same],
                               atol=UV_ATOL)
    np.testing.assert_allclose(rp.v.numpy()[same], np.asarray(rj.v)[same],
                               atol=UV_ATOL)


# ------------------------------------------------------------ forest build

def _scene_tris(name):
    h = load_scene(f"assets/{name}_proxy.obj")
    return h.v0, h.v1, h.v2


@pytest.mark.parametrize("source,target,tile", [
    ("cornell", 512, 128), ("kitchen", 4096, 128), ("soup", 64, 128),
    ("soup", 320, 128), ("soup", 4096, 128), ("soup", 320, 96)])
def test_forest_build_bit_equal(source, target, tile):
    v0, v1, v2 = _scene_tris(source) if source != "soup" else soup(3, 900)
    hj = jax_build(v0, v1, v2, target_tris=target, tile=tile)
    hp = build_brute_forest(v0, v1, v2, target_tris=target, tile=tile)
    assert hp.tile == hj.tile == tile
    for f in FIELDS:
        a, b = getattr(hp, f), getattr(hj, f)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=f)
    c, _, tp = hp.tris.shape
    assert tp % tile == 0
    # ids are f32 tid+1, every triangle exactly once; 0 marks a pad slot
    ids = hp.tris[:, 9].ravel()
    np.testing.assert_array_equal(np.sort(ids[ids > 0]),
                                  np.arange(1, len(v0) + 1, dtype=np.float32))
    # pad chunks and pad tiles carry inverted +-3e37 boxes
    assert (hp.boxes_t[0:3, c:] == np.float32(3e37)).all()
    assert (hp.boxes_t[3:6, c:] == np.float32(-3e37)).all()
    assert (hp.tboxes[:, 0:3, tp // tile:] == np.float32(3e37)).all()


# ------------------------------------------------------------ traversal

@pytest.fixture(scope="module")
def soup600():
    """One soup shared by the properties below, so the JAX side reuses its
    compiled launches."""
    v0, v1, v2 = soup(11, 600)
    o, d = random_rays(np.random.default_rng(12), b=256)
    return (v0, v1, v2), o, d


def test_brute_matches_jax_and_oracle(soup600, interp, sched):
    tris, o, d = soup600
    jbf, pbf = forests(*tris)
    assert pbf.tris.shape[0] >= 4
    rj, rp = closest_both(jbf, pbf, o, d, np.float32(1e30))
    assert_closest_matches(rp, rj)
    t_ref, prim_ref, _, _ = cpu_ref.intersect_closest(*tris, o, d)
    np.testing.assert_array_equal(rp.prim.numpy() >= 0, prim_ref >= 0)
    hit = prim_ref >= 0
    assert (rp.prim.numpy()[hit] == prim_ref[hit]).mean() > 0.99
    t_max = np.full(len(o), 2.5, np.float32)
    bj, bp = any_both(jbf, pbf, o, d, t_max)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(
        bp.numpy(), cpu_ref.intersect_any(*tris, o, d, t_max))


def test_brute_per_lane_tmax(soup600, interp, sched):
    tris, o, d = soup600
    jbf, pbf = forests(*tris)
    g = np.random.default_rng(13)
    t_max = np.where(g.random(len(o)) < 0.3, np.float32(3.4e38),
                     g.uniform(0.05, 3.0, len(o))).astype(np.float32)
    rj, rp = closest_both(jbf, pbf, o, d, t_max)
    assert_closest_matches(rp, rj)
    assert (rp.t.numpy() <= t_max).all()
    bj, bp = any_both(jbf, pbf, o, d, t_max)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))


def test_brute_tmax_above_big_sentinel(soup600, interp, sched):
    """t_max 3.4e38 (what trace_scene passes) fabricates no hit, and a miss
    reads 3e38, the kernels' sentinel, in both packages."""
    tris, o, d = soup600
    o = o.copy()
    o[128:] += 100.0                      # half the rays miss everything
    jbf, pbf = forests(*tris)
    rj, rp = closest_both(jbf, pbf, o, d, np.float32(3.4e38))
    assert_closest_matches(rp, rj)
    _, prim_ref, _, _ = cpu_ref.intersect_closest(*tris, o, d)
    np.testing.assert_array_equal(rp.prim.numpy() >= 0, prim_ref >= 0)
    assert (rp.prim.numpy()[128:] == -1).all()


def test_brute_single_chunk(interp, sched):
    tris = soup(14, 60)
    o, d = random_rays(np.random.default_rng(15), b=128)
    jbf, pbf = forests(*tris, target_tris=4096)
    assert pbf.tris.shape[0] == 1 and pbf.boxes_t.shape[1] == 128
    rj, rp = closest_both(jbf, pbf, o, d, np.float32(1e30))
    assert_closest_matches(rp, rj)
    bj, bp = any_both(jbf, pbf, o, d, np.full(128, 2.5, np.float32))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))


def test_brute_nondivisor_tile(interp, sched):
    """The round loop's 512-triangle tile, which does not divide the padded
    chunk width here, drops no triangle (it is fit to a divisor)."""
    tris = soup(16, 500)
    o, d = random_rays(np.random.default_rng(17), b=256)
    jbf, pbf = forests(*tris, target_tris=320, tile=128)
    assert pbf.tris.shape[2] % 512 != 0
    rj, rp = closest_both(jbf, pbf, o, d, np.float32(1e30))
    assert_closest_matches(rp, rj)
    _, prim_ref, _, _ = cpu_ref.intersect_closest(*tris, o, d)
    np.testing.assert_array_equal(rp.prim.numpy() >= 0, prim_ref >= 0)


def test_brute_round_cap_exhaustion(soup600, interp, sched, monkeypatch):
    """A round cap of 0 cuts the round-loop walk: both packages raise the
    flag, and the port raises without with_flag. The visit-list walk is
    exhaustive and never raises it."""
    tris, o, d = soup600
    jbf, pbf = forests(*tris)
    (rj, fj), (rp, fp) = closest_both(jbf, pbf, o, d, np.float32(1e30),
                                      with_flag=True)
    assert not bool(fj) and not fp
    assert_closest_matches(rp, rj)
    monkeypatch.setenv("FLUCTUS_BRUTE_ROUND_CAP", "0")
    (_, fj), (_, fp) = closest_both(jbf, pbf, o, d, np.float32(1e30),
                                    with_flag=True)
    (_, aj), (_, ap) = any_both(jbf, pbf, o, d,
                                np.full(len(o), 2.5, np.float32),
                                with_flag=True)
    assert bool(fj) == fp == bool(aj) == ap == (sched == "rounds")
    if sched == "rounds":
        with pytest.raises(RuntimeError, match="round cap"):
            tb.traverse_closest(pbf, torch.from_numpy(o),
                                torch.from_numpy(d), 1e30)


def _tie_layout_matches_jax(layout, gr):
    arrays, o, d, want = tie_forest(layout)
    jbf = JaxBrute(**{f: jnp.asarray(arrays[f]) for f in FIELDS},
                   tile=arrays["tile"])
    pbf = brute_from_numpy(arrays, device="cpu")
    assert tb._resolve_gr(pbf.tile, pbf.tris.shape[2]) == gr
    rj, rp = closest_both(jbf, pbf, o, d, np.float32(3.4e38))
    tie = want >= 0
    np.testing.assert_array_equal(rp.prim.numpy()[tie], want[tie])
    np.testing.assert_array_equal(np.asarray(rj.prim), rp.prim.numpy())
    np.testing.assert_allclose(rp.t.numpy(), np.asarray(rj.t), rtol=T_REL)
    t_max = np.full(len(o), 9.5, np.float32)
    bj, bp = any_both(jbf, pbf, o, d, t_max)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert bool(bp.numpy()[tie].all())


def test_brute_tie_layout_matches_jax(interp, monkeypatch):
    """Equal-t copies of one triangle in different team slices, pieces and
    pair slots of one 1,024-triangle group, and in a later visit
    (fixtures.LAYOUTS["group"]): the port's plain K2 and the JAX kernel
    both return the lowest slot of the chunk visited first; prims equal, t
    within the file's 1e-5 relative (XLA contracts the JAX side's FMAs)."""
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", "vlist")
    _tie_layout_matches_jax("group", 8)


def test_brute_tie_groups_layout_matches_jax(interp, monkeypatch):
    """Equal-t copies in different 128-triangle groups of one visit
    (fixtures.LAYOUTS["groups"], gr = 1 as on the conference): entries 0,
    1, 2 and 5, both CTAs, the same and a later piece; the lowest entry
    wins, as in the JAX kernel."""
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", "vlist")
    _tie_layout_matches_jax("groups", 1)


@pytest.mark.parametrize("layout,gr", [("group", 8), ("groups", 1)])
def test_brute_tie_layouts_rounds_match_jax(interp, monkeypatch, layout,
                                            gr):
    """The same tie forests through the round loop (FLUCTUS_BRUTE_SCHED=
    rounds): the port's plain K3 and the JAX `_launch` return the same
    prims, the lowest slot of the chunk visited first; K3 tests every tile
    of a visit in order, so a tie goes to the lowest tile and slot."""
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", "rounds")
    tb.reset_counts()
    _tie_layout_matches_jax(layout, gr)
    assert tb.PLAIN_CALLS["k3_closest"] > 0 and tb.PLAIN_CALLS["k3_any"] > 0
    assert tb.PLAIN_CALLS["k2_closest"] == 0


def test_k3_wrapper_refuses_other_blocks():
    """K3 runs a ray block of 128 rays on a cluster: its wrapper refuses
    another block before it looks at the tensors."""
    with pytest.raises(ValueError, match="K3: blk"):
        tb.launch_kernel(None, None, None, None, None, None, None, None,
                         False, 256, 128, 4, 1)


# ------------------------------------------------------------ brute vs K1

@pytest.fixture(scope="module")
def kitchen_both():
    """The kitchen's BVH8 (for K1's plain version) and its brute forest,
    and the frame's primary rays at 32x32 plus seeded bounce rays."""
    host = load_scene("assets/kitchen_proxy.obj")
    host.build_bvh(use_sbvh=True)
    wbvh = host.to_device("cpu").wbvh
    hb = build_brute_forest(host.v0, host.v1, host.v2, target_tris=4096)
    bf = brute_from_numpy({f: getattr(hb, f) for f in FIELDS + ("tile",)},
                          device="cpu")
    s = driver.create_session("assets/kitchen_proxy.obj",
                              cfg=RenderConfig(width=32, height=32),
                              state_dir="data/states", auto_frame=False,
                              device="cpu")
    cfg, p = s.cfg, s.params
    pix = torch.arange(32 * 32, dtype=torch.int32)
    u = [trng.uniform(pix, 0, 0, k) for k in range(4)]
    o_p, d_p = camera.generate_rays(p.camera, pix, 32, 32, *u,
                                    p.world_radius)
    tr, _ = ts.traverse_plain(wbvh, o_p, d_p, common.T_MAX, False)
    ok = tr.prim >= 0
    g = np.random.default_rng(21)
    d_b = torch.from_numpy(g.normal(size=(int(ok.sum()), 3))
                           .astype(np.float32))
    d_b = d_b / d_b.norm(dim=1, keepdim=True)
    o_b = o_p[ok] + tr.t[ok, None] * d_p[ok] + 1e-3 * d_b
    o = torch.cat([o_p, o_b]).contiguous()
    d = torch.cat([d_p, d_b]).contiguous()
    return wbvh, bf, o, d


def test_brute_agrees_with_k1_plain(kitchen_both, sched):
    """Brute traversal against the port's own K1 plain version on the
    kitchen's primary and bounce rays: catches a table fault without
    JAX."""
    wbvh, bf, o, d = kitchen_both
    k1, _ = ts.traverse_plain(wbvh, o, d, common.T_MAX, False)
    br = tb.traverse_closest(bf, o, d, common.T_MAX)
    diff = br.prim != k1.prim
    assert int((diff & (br.t != k1.t)).sum()) == 0
    hit = k1.prim >= 0
    assert bool(((br.prim >= 0) == hit).all()) and int(hit.sum()) > 1000
    np.testing.assert_allclose(br.t[hit].numpy(), k1.t[hit].numpy(),
                               rtol=1e-6)
    t_max = torch.from_numpy(np.random.default_rng(22).uniform(
        0.05, 2.0, o.shape[0]).astype(np.float32))
    _, k1a = ts.traverse_plain(wbvh, o, d, t_max, True)
    assert torch.equal(tb.traverse_any(bf, o, d, t_max), k1a)


# ------------------------------------------------------------ cutover

def test_fast_big_cutover_rule(monkeypatch):
    small = types.SimpleNamespace(v0=np.zeros((1000, 3), np.float32))
    big = types.SimpleNamespace(v0=np.zeros((200_000, 3), np.float32))
    edge = types.SimpleNamespace(v0=np.zeros(((8 << 20) // 68 + 1, 3)))
    cuda = torch.device("cuda")
    assert not fast_big_eligible(big, "cpu")       # the CPU keeps the BVH
    assert fast_big_eligible(big, cuda) and fast_big_eligible(edge, "cuda")
    assert not fast_big_eligible(small, cuda)
    assert not fast_big_eligible(
        types.SimpleNamespace(v0=np.zeros(((8 << 20) // 68, 3))), cuda)
    monkeypatch.setenv("FLUCTUS_FAST_BIG_MIN_TRIS", "500")
    assert fast_big_eligible(small, cuda)
    assert not fast_big_eligible(small, "cpu")
    monkeypatch.setenv("FLUCTUS_FAST_BIG", "0")
    assert not fast_big_eligible(big, cuda)


def test_fast_big_session_builds_no_hierarchy(monkeypatch):
    """On an eligible device, create_session uploads the brute forest alone
    (no SBVH build, wbvh None), sized by FLUCTUS_BRUTE_TARGET_TRIS, and
    renders through it. Eligibility is forced here, since the CPU is never
    eligible."""
    always = lambda host, device: True
    monkeypatch.setattr(scene_mod, "fast_big_eligible", always)
    monkeypatch.setattr(driver, "fast_big_eligible", always)
    monkeypatch.setenv("FLUCTUS_BRUTE_TARGET_TRIS", "128")
    cfg = RenderConfig(width=8, height=8, max_bounces=2, use_area_light=True,
                       use_env_map=False)
    s = driver.create_session("assets/cornell_proxy.obj", cfg=cfg,
                              state_dir=None, device="cpu")
    assert s.host_scene.bvh is None and s.scene.wbvh is None
    bf = s.scene.bforest
    hb = build_brute_forest(s.host_scene.v0, s.host_scene.v1,
                            s.host_scene.v2, target_tris=128)
    assert bf.tile == hb.tile and torch.equal(bf.tris,
                                              torch.from_numpy(hb.tris))
    tb.reset_counts()
    img = driver.render(s, 1)
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0.0
    assert tb.PLAIN_CALLS["k2_closest"] > 0 and tb.PLAIN_CALLS["k2_any"] > 0
    assert sum(tb.LAUNCHES.values()) == 0


# ------------------------------------------------------------ the slice

def _slice_sessions(name):
    """A JAX session with a brute forest attached (as golden_common's
    bforest_cfg4 attaches one), and the port's scene and params carried
    across from it, forest included."""
    if name == "cornell":
        jcfg = JaxConfig(width=16, height=16, max_bounces=4,
                         use_area_light=True, use_env_map=False,
                         backend="mxu")
        js = jax_driver.create_session(
            "assets/cornell_proxy.obj", env_map=None, cfg=jcfg,
            use_sbvh=True, cache_dir=None, state_dir=None)
        js.params = js.params.replace(area_light=_cornell_light())
        target = 512
    else:
        jcfg = JaxConfig(width=16, height=16, max_bounces=8,
                         use_area_light=True, use_env_map=False,
                         backend="mxu")
        js = jax_driver.create_session(
            "assets/kitchen_proxy.obj", env_map=None, cfg=jcfg,
            use_sbvh=True, cache_dir=None, state_dir="data/states",
            auto_frame=False)
        target = 4096
    h = js.host_scene
    jbf, _ = forests(h.v0, h.v1, h.v2, target_tris=target)
    js.scene = js.scene.replace(bforest=jbf)
    arrays = scene_arrays(js.scene)
    arrays.update({f"bforest.{f}": np.asarray(getattr(jbf, f))
                   for f in FIELDS})
    arrays["bforest.tile"] = jbf.tile
    scene = scene_from_numpy(arrays, device="cpu")
    params = params_from_numpy(params_arrays(js.params), device="cpu")
    cfg = RenderConfig(width=16, height=16, max_bounces=jcfg.max_bounces,
                       use_area_light=True, use_env_map=False,
                       bsdf_types_mask=js.cfg.bsdf_types_mask)
    return js, scene, params, cfg


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_slice_lockstep_with_brute_forest(name, interp):
    js, scene, params, cfg = _slice_sessions(name)
    assert scene.bforest is not None and scene.bforest.tris.shape[0] >= 2
    spp = 2
    want = np.asarray(jax_driver.render(js, spp, integrator="lockstep"))
    tb.reset_counts()
    got = lockstep.render(scene, params, cfg, spp).numpy()
    assert tb.PLAIN_CALLS["k2_closest"] > 0 and tb.PLAIN_CALLS["k2_any"] > 0
    assert got.shape == want.shape and np.isfinite(got).all()
    if name == "cornell":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        share, mean_rel = golden_stats(got, want, RTOL, ATOL)
        assert share >= KITCHEN_SHARE, share
        assert mean_rel <= KITCHEN_MEAN_REL, mean_rel
