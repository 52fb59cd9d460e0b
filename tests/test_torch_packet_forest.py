"""Port parity of the packet forest (FLUCTUS_PACKET_FOREST=1): the chunk
build (accel/wide.py `build_wide_forest`), the forest walks over K1's and
K4's plain versions (ops/traverse_stack.py, ops/traverse_pallas.py
`*_forest`) and a lockstep frame through each, against the JAX package's
`build_wide_forest` and `traverse_mxu` / `traverse_pallas` forests on the
same inputs.

The JAX kernels run in Pallas interpret mode by patching
`pl.pallas_call` inside the test. Both packages get the same chunk
tables. The builds must be bit-equal. Prim ids must be equal except
where two triangles are hit at equal t; t is held at 1e-5 relative, u
and v at 1e-4 absolute (torch_common.assert_hits_match); any-hit flags
exactly. Frames at the goldens' RTOL / ATOL.
"""
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_mxu as jtm
import fluctus_tpu.ops.traverse_pallas as jtp
from fluctus_tpu.accel import bvh as jbvh
from fluctus_tpu.accel import native as jnative
from fluctus_tpu.accel.wide import build_wide_forest as jax_forest
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.core.types import WideBVH as JaxWide
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.accel.forest import build_binary
from fluctus_tpu_torch.accel.wide import build_wide_forest
from fluctus_tpu_torch.convert import params_from_numpy, scene_from_numpy
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.integrators import common, lockstep
from fluctus_tpu_torch.ops import traverse_pallas as tp
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.scene.scene import load_scene, pad_forest

from golden_common import ATOL, RTOL, _cornell_light
from torch_common import assert_hits_match, params_arrays, scene_arrays

CORNELL = "assets/cornell_proxy.obj"
KITCHEN = "assets/kitchen_proxy.obj"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interp(monkeypatch):
    orig_call = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))


def jax_binary(native: bool):
    """The JAX package's per-chunk build (fluctus_tpu/scene/scene.py)."""
    if native:
        return lambda a, b, c: jnative.build_native(
            a, b, c, jbvh.MAX_LEAF, jbvh.MAX_DEPTH, 1e-5, True)
    return jbvh.build_bvh


def bits(x):
    return np.ascontiguousarray(x).view(np.int32)


@pytest.mark.parametrize("path,budget,native", [
    (CORNELL, 16 << 10, True), (KITCHEN, 256 << 10, True),
    (CORNELL, 24 << 10, False)])
def test_build_wide_forest_equals_jax(path, budget, native, monkeypatch):
    monkeypatch.setenv("FLUCTUS_NATIVE", "1" if native else "0")
    h = load_scene(path)
    want, want_maps = jax_forest(h.v0, h.v1, h.v2, jax_binary(native),
                                 budget_bytes=budget)
    got, maps = build_wide_forest(h.v0, h.v1, h.v2, build_binary,
                                  budget_bytes=budget)
    assert len(got) == len(want) >= 3
    for g, w, gm, wm in zip(got, want, maps, want_maps):
        np.testing.assert_array_equal(bits(g.nodes), bits(w.nodes))
        np.testing.assert_array_equal(bits(g.leaves), bits(w.leaves))
        assert (g.root_ref, g.depth, g.n_leaf_tris) == (
            w.root_ref, w.depth, w.n_leaf_tris)
        assert gm.dtype == np.int32
        np.testing.assert_array_equal(gm, wm)
    assert sorted(np.concatenate(maps).tolist()) == list(range(h.n_tris))


def both_forests(path=CORNELL, budget=16 << 10):
    """The same padded chunk tables and id maps for both packages."""
    h = load_scene(path)
    hosts, maps = jax_forest(h.v0, h.v1, h.v2, jax_binary(True),
                             budget_bytes=budget)
    chunks = pad_forest(hosts, torch.from_numpy)
    jchunks = tuple(JaxWide(nodes=jnp.asarray(c.nodes.numpy()),
                            leaves=jnp.asarray(c.leaves.numpy()),
                            root_ref=0, depth=c.depth,
                            leaf_width=c.leaf_width) for c in chunks)
    return (h, chunks, tuple(torch.from_numpy(m) for m in maps), jchunks,
            tuple(jnp.asarray(m) for m in maps))


def forest_rays(h, n=384, seed=3):
    """Rays from inside the scene's box, half under t_max 3.4e38 and half
    under 2."""
    g = np.random.default_rng(seed)
    lo, hi = h.bounds()
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.where(np.arange(n) % 2 == 0, 3.4e38, 2.0).astype(np.float32)
    return o, d, t


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_forest_walks_match_jax(interp, kernel):
    h, chunks, maps, jchunks, jmaps = both_forests()
    o, d, t = forest_rays(h)
    jmod = jtm if kernel == "k1" else jtp
    mod = ts if kernel == "k1" else tp
    to, td, tt = (torch.from_numpy(x) for x in (o, d, t))
    want = jmod.traverse_closest_forest(jchunks, jmaps, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(t))
    got = mod.traverse_closest_forest(chunks, maps, to, td, tt)
    assert_hits_match(got, want)
    assert int((got.prim >= 0).sum()) > len(o) // 4
    # the hits of the forest are the whole hierarchy's, up to ties
    h.build_bvh(use_sbvh=True)
    full = h.to_device("cpu").wbvh
    assert_hits_match(got, ts.traverse_closest(full, to, td, tt))
    want_any = jmod.traverse_any_forest(jchunks, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(t))
    got_any = mod.traverse_any_forest(chunks, to, td, tt)
    np.testing.assert_array_equal(got_any.numpy(), np.asarray(want_any))
    assert 0 < int(got_any.sum()) < len(o)


def test_forest_plain_forms_and_counts():
    """The plain forms are the same loops; each chunk is one call of the
    walk in either form."""
    h, chunks, maps, _, _ = both_forests()
    o, d, t = (torch.from_numpy(x) for x in forest_rays(h, 256, 5))
    ts.reset_counts()
    r = ts.traverse_closest_forest(chunks, maps, o, d, t)
    b = ts.traverse_any_forest(chunks, o, d, t)
    assert ts.PLAIN_CALLS == {"closest": len(chunks), "any": len(chunks)}
    p = ts.closest_forest_plain(chunks, maps, o, d, t)
    assert all(torch.equal(x, y) for x, y in zip(r, p))
    assert torch.equal(b, ts.any_forest_plain(chunks, o, d, t))
    tp.reset_counts()
    r4 = tp.traverse_closest_forest(chunks, maps, o, d, t,
                                    launch=tp.packet_plain)
    tp.traverse_any_forest(chunks, o, d, t, launch=tp.packet_plain)
    assert tp.PLAIN_CALLS == {"closest": len(chunks), "any": len(chunks)}
    assert r4.prim.dtype == torch.int32
    # a leaf-rooted chunk walks as well (the kernels have a leaf-root
    # branch; the JAX package takes its XLA walk there)
    leaf = ts.WideBVH(nodes=chunks[0].nodes[:1], leaves=chunks[0].leaves,
                      root_ref=-1, depth=1, leaf_width=16)
    got = ts.traverse_closest_forest((leaf,), maps[:1], o, d, t)
    want, _ = ts.traverse_plain(leaf, o, d, t, False)
    hit = want.prim >= 0
    assert torch.equal(got.prim[hit], maps[0][want.prim[hit].long()])


@pytest.mark.parametrize("backend,jax_backend,mod", [
    ("auto", "mxu", ts), ("pallas", "pallas", tp)])
def test_slice_lockstep_through_the_forest(interp, backend, jax_backend,
                                           mod):
    """A 16x16 cornell frame with the same packet forest attached to both
    packages' scenes (the JAX package builds its forest only above a
    literal 8 MB, so the forest goes in through `.replace`): the port
    traces through the forest walk of the backend's kernel only."""
    h, chunks, maps, jchunks, jmaps = both_forests()
    jcfg = JaxConfig(width=16, height=16, max_bounces=3,
                     use_area_light=True, use_env_map=False,
                     backend=jax_backend)
    js = jax_driver.create_session(CORNELL, env_map=None, cfg=jcfg,
                                   use_sbvh=True, cache_dir=None,
                                   state_dir=None)
    js.params = js.params.replace(area_light=_cornell_light())
    js.scene = js.scene.replace(wforest=jchunks, wforest_maps=jmaps)
    scene = scene_from_numpy(scene_arrays(js.scene), device="cpu")
    scene.wforest, scene.wforest_maps = chunks, maps
    params = params_from_numpy(params_arrays(js.params), device="cpu")
    cfg = RenderConfig(width=16, height=16, max_bounces=3,
                       use_area_light=True, use_env_map=False,
                       bsdf_types_mask=js.cfg.bsdf_types_mask,
                       backend=backend)
    assert common._packets(scene, cfg) == (backend == "pallas")
    want = np.asarray(jax_driver.render(js, 1, integrator="lockstep"))
    ts.reset_counts()
    tp.reset_counts()
    got = lockstep.render(scene, params, cfg, 1).numpy()
    other = tp if mod is ts else ts
    n = len(chunks)
    calls = mod.PLAIN_CALLS
    assert calls["closest"] > 0 and calls["any"] > 0
    assert calls["closest"] % n == 0 and calls["any"] % n == 0
    assert sum(other.PLAIN_CALLS.values()) == 0
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
