"""Port parity of the packet path: ray sorting (ops/ray_sort.py), the split
tables and the plain version of K4 (ops/traverse_pallas.py), the backend
rules, and a lockstep slice under backend="pallas", against the JAX
package on the same inputs.

The JAX packet kernel runs in Pallas interpret mode, as
tests/test_traverse_packed.py runs it. Both packages get the same 8-wide
tables. Prim ids must be equal except where two triangles are hit at
equal t; t is held at 1e-5 relative (XLA contracts the Moller-Trumbore
multiply-adds into FMAs, the port rounds each op), u and v at 1e-4
absolute (torch_common.assert_hits_match says why); any-hit flags
exactly."""
import types

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_pallas as jtp
from fluctus_tpu.accel import bvh as jbvh, cpu_ref
from fluctus_tpu.accel.wide import build_wide as jax_build_wide
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.core.types import WideBVH as JaxWide
from fluctus_tpu.integrators import common as jcommon
from fluctus_tpu.ops import ray_sort as jray_sort
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.convert import params_from_numpy, scene_from_numpy
from fluctus_tpu_torch.core.types import RenderConfig, WideBVH
from fluctus_tpu_torch.integrators import common, lockstep
from fluctus_tpu_torch.ops import ray_sort
from fluctus_tpu_torch.ops import traverse_pallas as tp
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.render import driver

from golden_common import ATOL, RTOL, _cornell_light
from test_bvh import random_rays, random_tris
from torch_common import assert_hits_match, params_arrays, scene_arrays


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
        jtp.pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))


def both_wide(v0, v1, v2):
    """One 8-wide hierarchy for both packages (the JAX builder's rows)."""
    w = jax_build_wide(jbvh.build_bvh(v0, v1, v2), v0, v1, v2)
    jw = JaxWide(nodes=jnp.asarray(w.nodes), leaves=jnp.asarray(w.leaves),
                 root_ref=int(w.root_ref), depth=int(w.depth),
                 leaf_width=int(w.leaves.shape[1]))
    pw = WideBVH(nodes=torch.from_numpy(w.nodes),
                 leaves=torch.from_numpy(w.leaves), root_ref=int(w.root_ref),
                 depth=int(w.depth), leaf_width=int(w.leaves.shape[1]))
    return jw, pw


# ------------------------------------------------------------ host side

def test_ray_sort_keys_equal_jax():
    g = np.random.default_rng(1)
    o = g.uniform(-3, 3, (4096, 3)).astype(np.float32)
    o[:8] = [[-9, 0, 0], [9, 9, 9], [0, 0, 0]] + [[1, 1, 1]] * 5  # clamps
    d = g.normal(size=(4096, 3)).astype(np.float32)
    d[8:16] = 0.0                                     # zero components
    lo = np.array([-2.0, -2.5, -1.0], np.float32)
    hi = np.array([2.0, 2.5, 3.0], np.float32)
    want = np.asarray(jray_sort.ray_sort_keys(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi)))
    got = ray_sort.ray_sort_keys(*(torch.from_numpy(x) for x in (o, d, lo,
                                                                 hi)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # stable sort order equals jnp.argsort's, and the scatter-back restores
    order, inv = ray_sort.sort_order(*(torch.from_numpy(x)
                                       for x in (o, d, lo, hi)))
    np.testing.assert_array_equal(order.numpy(), np.argsort(want,
                                                            kind="stable"))
    assert torch.equal(order[inv], torch.arange(4096))


def test_split_tables_equal_jax():
    v0, v1, v2 = random_tris(np.random.default_rng(2), m=300)
    jw, pw = both_wide(v0, v1, v2)
    for got, want in zip(tp.split_tables(pw), jtp.split_tables(jw)):
        want = np.array(want)
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ K4 vs JAX

@pytest.fixture(scope="module")
def soup500():
    v0, v1, v2 = random_tris(np.random.default_rng(3), m=500)
    o, d = random_rays(np.random.default_rng(4), b=700)   # 2 packets, pad
    return both_wide(v0, v1, v2), (v0, v1, v2), o, d


@pytest.mark.parametrize("t_mode", ["scalar", "per_lane", "f32max"])
def test_packet_closest_matches_jax(soup500, interp, t_mode):
    (jw, pw), tris, o, d = soup500
    g = np.random.default_rng(5)
    t_max = {"scalar": np.full(len(o), 1e30, np.float32),
             "f32max": np.full(len(o), 3.4e38, np.float32),
             "per_lane": np.where(g.random(len(o)) < 0.3,
                                  np.float32(3.4e38),
                                  g.uniform(0.05, 3.0, len(o))
                                  ).astype(np.float32)}[t_mode]
    rj = jtp.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max))
    tp.reset_counts()
    rp = tp.traverse_closest(pw, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(t_max))
    assert tp.PLAIN_CALLS["closest"] == 1 and tp.LAUNCHES["closest"] == 0
    assert rp.prim.shape == (len(o),)
    assert_hits_match(rp, rj)
    _, prim_ref, _, _ = cpu_ref.intersect_closest(*tris, o, d)
    if t_mode != "per_lane":
        np.testing.assert_array_equal(rp.prim.numpy() >= 0, prim_ref >= 0)
    # and the port's own K1 plain walk on the same hierarchy
    k1, _ = ts.traverse_plain(pw, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t_max), False)
    diff = k1.prim != rp.prim
    assert not bool((diff & (k1.t != rp.t)).any())
    assert torch.equal(k1.t, rp.t)


def test_packet_any_matches_jax(soup500, interp):
    (jw, pw), tris, o, d = soup500
    t_max = np.random.default_rng(6).uniform(0.05, 3.0, len(o)).astype(
        np.float32)
    bj = jtp.traverse_any(jw, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_max))
    bp = tp.traverse_any(pw, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(t_max))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(
        bp.numpy(), cpu_ref.intersect_any(*tris, o, d, t_max))
    assert 0 < int(bp.sum()) < len(o)


def test_packet_leaf_root(interp):
    """A scene that fits one fat leaf (root_ref < 0)."""
    v0, v1, v2 = random_tris(np.random.default_rng(7), m=10)
    o, d = random_rays(np.random.default_rng(8), b=300)
    jw, pw = both_wide(v0, v1, v2)
    assert pw.root_ref < 0
    rj = jtp.traverse_closest(jw, jnp.asarray(o), jnp.asarray(d),
                              np.float32(1e30))
    rp = tp.traverse_closest(pw, torch.from_numpy(o), torch.from_numpy(d),
                             1e30)
    assert_hits_match(rp, rj)
    t_max = np.full(len(o), 2.5, np.float32)
    bj = jtp.traverse_any(jw, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_max))
    bp = tp.traverse_any(pw, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(t_max))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))


def test_packet_stats_count_visits(soup500):
    """The bound's counts: every visit's occupied slots and real triangles
    times the packet's real lanes."""
    (_, pw), _, o, d = soup500
    orig, dir_, tv, _ = tp._prep(torch.from_numpy(o[:512]),
                                 torch.from_numpy(d[:512]), 1e30)
    st: dict = {}
    tp.packet_plain(orig, dir_, tv, pw, False, stats=st)
    assert st["node_visits"] >= 1 and st["leaf_visits"] >= 1
    assert st["child_tests"] % 512 == 0 and st["tri_tests"] % 512 == 0
    assert st["node_visits"] <= st["child_tests"] // 512 \
        <= 8 * st["node_visits"]
    assert st["tri_tests"] // 512 <= pw.leaf_width * st["leaf_visits"]
    few: dict = {}
    tp.packet_plain(orig, dir_, tv, pw, False, n_real=100, stats=few)
    assert few["child_tests"] == st["child_tests"] // 512 * 100
    assert few["tri_tests"] == st["tri_tests"] // 512 * 100


def test_packet_stats_per_packet_visits(soup500):
    """The per-packet visit counts, which chip_smoke.py's k4-time turns
    into a distribution, sum to the call's totals, and a second call
    appends its packets."""
    (_, pw), _, o, d = soup500
    orig, dir_, tv, _ = tp._prep(torch.from_numpy(o), torch.from_numpy(d),
                                 1e30)
    st: dict = {}
    tp.packet_plain(orig, dir_, tv, pw, False, stats=st)
    nodes, leaves = st["packet_node_visits"], st["packet_leaf_visits"]
    assert nodes.shape == leaves.shape == (orig.shape[0] // 512,)
    assert int(nodes.sum()) == st["node_visits"]
    assert int(leaves.sum()) == st["leaf_visits"]
    assert bool((nodes >= 1).all()) and bool((leaves >= 1).all())
    tp.packet_plain(orig, dir_, tv, pw, True, stats=st)
    assert st["packet_node_visits"].shape == (2 * nodes.shape[0],)
    assert int(st["packet_node_visits"].sum()) == st["node_visits"]
    assert int(st["packet_leaf_visits"].sum()) == st["leaf_visits"]


@pytest.mark.parametrize("t_max", [3.4e38, 9.5])
def test_packet_wide_ties_match_winners_and_jax(interp, t_max):
    """The tie hierarchy of fluctus_tpu_torch/fixtures.py over two
    packets, its tie rays in every warp and every CTA of a packet: the
    plain version returns the copy K4's push order picks (in the leaves
    with equal entry distances, the higher child slot's, unlike K1), and
    agrees with JAX's packet kernel in interpret mode, any-hit flags
    too."""
    from fluctus_tpu_torch.convert import wide_from_numpy
    from fluctus_tpu_torch.fixtures import wide_tie_bvh
    arrays, o, d, want = wide_tie_bvh()
    pw = wide_from_numpy(arrays, device="cpu")
    jw = JaxWide(nodes=jnp.asarray(arrays["nodes"]),
                 leaves=jnp.asarray(arrays["leaves"]),
                 root_ref=arrays["root_ref"], depth=arrays["depth"],
                 leaf_width=arrays["leaf_width"])
    t = np.full(len(o), t_max, np.float32)
    rp = tp.traverse_closest(pw, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(t))
    tie = want["k4"] >= 0
    np.testing.assert_array_equal(rp.prim.numpy()[tie], want["k4"][tie])
    assert not np.array_equal(want["k4"], want["k1"])
    assert_hits_match(rp, jtp.traverse_closest(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)))
    bp = tp.traverse_any(pw, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(bp, np.asarray(jtp.traverse_any(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))))
    assert bp[tie].all()


def test_design_probe_sources():
    """The design probe's builds (scripts/probe_walk_design.py): every
    variant of K1 and K4 names constants that the sources hold once, and
    the clock64 build of K4 finds each of its anchors once in the shipped
    source."""
    from fluctus_tpu_torch.scripts import probe_walk_design as probe
    for kernel, variants in probe.VARIANTS.items():
        plain_src = probe.source_text(kernel, None, {}, False)
        assert '#include "/' in plain_src
        for consts in variants.values():
            src = probe.source_text(kernel, None, consts, False)
            for name, value in consts.items():
                v = str(value).lower() if isinstance(value, bool) else value
                assert f" {name} = {v};" in src
    import re
    shipped = probe.source_text("k4", None, {}, False)
    for pat, _, _ in probe.INSTRUMENT:      # the optional ones too
        assert len(re.findall(pat, shipped)) == 1, pat
    src = probe.source_text("k4", None, {}, True)
    assert src.count("clock64()") == 8 and "k4_prof_copy" in src
    assert probe.cluster_size(None) >= 1


# ------------------------------------------------------------ backend rules

def test_backend_rules(monkeypatch):
    assert common.resolve_backend("auto") == "mxu"
    assert common.resolve_backend("mxu") == "mxu"
    assert common.resolve_backend("pallas") == "pallas"
    # the JAX package's XLA walks keep their names (tests/
    # test_torch_backends.py holds them against JAX)
    for name in ("jnp", "packed", "wide"):
        assert common.resolve_backend(name) == name
        s = driver.create_session("assets/cornell_proxy.obj",
                                  cfg=RenderConfig(width=8, height=8,
                                                   backend=name),
                                  state_dir=None, device="cpu")
        assert s.cfg.backend == name
    with pytest.raises(ValueError, match="unknown backend"):
        common.resolve_backend("cuda")
    cfg = RenderConfig(width=8, height=8)
    s = driver.create_session("assets/cornell_proxy.obj", cfg=cfg,
                              state_dir=None, device="cpu")
    assert s.cfg.backend == "mxu"
    s = driver.create_session("assets/cornell_proxy.obj",
                              cfg=cfg.replace(backend="pallas"),
                              state_dir=None, device="cpu")
    assert s.cfg.backend == "pallas"
    # _check_backend_data, as in the JAX package: "pallas" on a scene that
    # holds only a brute forest raises; both packages name the same fix
    brute_only = types.SimpleNamespace(wbvh=None, bforest=object(),
                                       ftables=None)
    pcfg = RenderConfig(backend="pallas")
    with pytest.raises(ValueError, match="FLUCTUS_FAST_BIG=0"):
        common._check_backend_data(brute_only, pcfg)
    with pytest.raises(ValueError, match="FLUCTUS_FAST_BIG=0"):
        jcommon._check_backend_data(brute_only, JaxConfig(backend="pallas"))
    common._check_backend_data(brute_only, RenderConfig())
    # a forest scene takes its per-lane kernel under "pallas"
    forest = types.SimpleNamespace(wbvh=object(), bforest=None,
                                   ftables=object())
    assert not common._packets(forest, pcfg)
    assert common._packets(types.SimpleNamespace(
        wbvh=object(), bforest=None, ftables=None), pcfg)


# ------------------------------------------------------------ the slice

def test_slice_lockstep_pallas_backend(interp):
    """A 16x16 cornell frame under backend="pallas" in both packages: the
    port traces through K4's plain version only."""
    jcfg = JaxConfig(width=16, height=16, max_bounces=4,
                     use_area_light=True, use_env_map=False,
                     backend="pallas")
    js = jax_driver.create_session(
        "assets/cornell_proxy.obj", env_map=None, cfg=jcfg, use_sbvh=True,
        cache_dir=None, state_dir=None)
    js.params = js.params.replace(area_light=_cornell_light())
    assert js.cfg.backend == "pallas"
    scene = scene_from_numpy(scene_arrays(js.scene), device="cpu")
    params = params_from_numpy(params_arrays(js.params), device="cpu")
    cfg = RenderConfig(width=16, height=16, max_bounces=4,
                       use_area_light=True, use_env_map=False,
                       bsdf_types_mask=js.cfg.bsdf_types_mask,
                       backend="pallas")
    spp = 2
    want = np.asarray(jax_driver.render(js, spp, integrator="lockstep"))
    tp.reset_counts()
    ts.reset_counts()
    got = lockstep.render(scene, params, cfg, spp).numpy()
    assert tp.PLAIN_CALLS["closest"] > 0 and tp.PLAIN_CALLS["any"] > 0
    assert sum(ts.PLAIN_CALLS.values()) == 0
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
