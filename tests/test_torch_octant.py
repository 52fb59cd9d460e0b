"""The opt-in octant ray sort, `FLUCTUS_TRAV_SORT=octant`
(fluctus_tpu_torch/ops/ray_sort.py::octant_apply, taken in
integrators/common.py::_closest_tr) against the JAX package's
`common._sorted_trav`.

The sort's permutation equals JAX's bit for bit; a closest K1 walk over
the full hierarchy (its plain version here) gives the same result sorted
or not, so a frame with the knob equals the frame without it, and equals
JAX's frame with the knob (backend "mxu", its Pallas kernel in interpret
mode) at the goldens' tolerance; every other walk ignores the knob."""
import types

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_mxu as tm
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.integrators import common as jax_common
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.integrators import common, lockstep
from fluctus_tpu_torch.ops import (ray_sort, traverse_brute,
                                   traverse_forest, traverse_pallas,
                                   traverse_stack, traverse_wide)
from fluctus_tpu_torch.render import driver

from golden_common import ATOL, RTOL, _cornell_light
from torch_common import cornell_light_torch, port_session

KNOB = "FLUCTUS_TRAV_SORT"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops; one thread each keeps the test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _directions(n, seed):
    """Seeded directions with exact +0 and -0 components among them."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3)).astype(np.float32)
    zero = g.random((n, 3)) < 0.2
    sign = np.where(g.random((n, 3)) < 0.5, -1.0, 1.0).astype(np.float32)
    d[zero] = sign[zero] * 0.0
    return d


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_octant_order_equals_jax(n):
    """order and rank equal JAX's `_sorted_trav`'s, read off its walk
    callback, on directions with +0 and -0 components."""
    d = _directions(n, seed=n)
    assert np.signbit(d).any() and (d == 0).any() or n == 1
    idx = np.arange(n, dtype=np.float32)
    orig = np.stack([idx, idx, idx], 1)
    seen = {}

    def run(o, _):
        seen["order"] = o[:, 0]
        return (jnp.arange(n, dtype=jnp.int32),)

    (rank,) = jax_common._sorted_trav(jnp.asarray(orig), jnp.asarray(d), run)
    order, got_rank = ray_sort.octant_order(torch.from_numpy(d))
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(seen["order"]).astype(np.int64))
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(rank))


@pytest.fixture(scope="module")
def cornell():
    return driver.create_session(
        "assets/cornell_proxy.obj", None,
        cfg=RenderConfig(width=16, height=16, max_bounces=2,
                         use_area_light=True, use_env_map=False),
        state_dir=None, device="cpu")


def _with_light(sess):
    import dataclasses
    sess.params = dataclasses.replace(sess.params,
                                      area_light=cornell_light_torch())
    return sess


@pytest.mark.parametrize("integrator", ["lockstep", "stream"])
def test_octant_frame_is_bit_equal(monkeypatch, cornell, integrator):
    """A 16x16 cornell frame at 1 spp, 2 bounces: with the knob, bit for
    bit the frame without it (the stream's fused extension + shadow call
    is sorted as a whole), and the knob's walk really ran."""
    s = _with_light(cornell)
    monkeypatch.delenv(KNOB, raising=False)
    want = driver.render(s, 1, integrator=integrator)
    calls = []
    orig = ray_sort.octant_apply
    monkeypatch.setattr(ray_sort, "octant_apply",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setenv(KNOB, "octant")
    got = driver.render(s, 1, integrator=integrator)
    assert calls
    assert torch.equal(got, want)


def test_octant_per_lane_t_max_is_bit_equal(monkeypatch):
    """Kitchen rays under a per-lane t_max: the sorted closest walk
    returns every field of the unsorted one, bit for bit."""
    from fluctus_tpu_torch.scene.scene import load_scene
    host = load_scene("assets/kitchen_proxy.obj")
    host.build_bvh(use_sbvh=True)
    scene = host.to_device("cpu")
    g = np.random.default_rng(3)
    lo, hi = host.bounds()
    n = 2048
    o = torch.from_numpy((lo + (hi - lo) * g.random((n, 3))).astype(
        np.float32))
    d = torch.from_numpy(_directions(n, 5))
    t = torch.from_numpy(np.where(g.random(n) < 0.3, 3.4e38, g.uniform(
        0.05, 3.0, n)).astype(np.float32))
    cfg = RenderConfig()
    monkeypatch.delenv(KNOB, raising=False)
    want = common._closest_tr(scene, cfg, o, d, t)
    monkeypatch.setenv(KNOB, "octant")
    got = common._closest_tr(scene, cfg, o, d, t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture
def interp(monkeypatch):
    orig_call = pl.pallas_call
    monkeypatch.setattr(
        tm.pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))


def test_octant_frame_matches_jax(monkeypatch, interp):
    """The same frame in both packages with the knob: JAX at backend
    "mxu" (its K1 in interpret mode, rays sorted by `_sorted_trav`), the
    port through K1's plain version, at RTOL 1e-3 / ATOL 1e-4 on every
    pixel, as tests/test_torch_render.py holds the cornell."""
    monkeypatch.setenv(KNOB, "octant")
    jcfg = JaxConfig(width=16, height=16, max_bounces=2,
                     use_area_light=True, use_env_map=False, backend="mxu")
    js = jax_driver.create_session(
        "assets/cornell_proxy.obj", env_map=None, cfg=jcfg, use_sbvh=True,
        cache_dir=None, state_dir=None)
    js.params = js.params.replace(area_light=_cornell_light())
    assert js.cfg.backend == "mxu"
    seen = []
    orig = jax_common._sorted_trav
    monkeypatch.setattr(jax_common, "_sorted_trav",
                        lambda *a: seen.append(1) or orig(*a))
    want = np.asarray(jax_driver.render(js, 1, integrator="lockstep"))
    assert seen
    scene, params, cfg = port_session(js.scene, js.params, js.cfg)
    traverse_stack.reset_counts()
    got = lockstep.render(scene, params, cfg, 1).numpy()
    assert traverse_stack.PLAIN_CALLS["closest"] > 0
    assert float(want.mean()) > 0.01
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


_WALKS = {
    "brute forest": (dict(bforest=object()), traverse_brute,
                     "traverse_closest", "mxu"),
    "treelet forest": (dict(ftables=object()), traverse_forest,
                       "traverse_closest", "mxu"),
    "packet forest": (dict(wforest=[object()]), traverse_stack,
                      "traverse_closest_forest", "mxu"),
    "packets": ({}, traverse_pallas, "traverse_closest", "pallas"),
    "packet forest, packets": (dict(wforest=[object()]), traverse_pallas,
                               "traverse_closest_forest", "pallas"),
    "XLA wide walk": ({}, traverse_wide, "traverse_closest", "wide"),
}


@pytest.mark.parametrize("walk", list(_WALKS) + ["any-hit"])
def test_other_walks_ignore_the_knob(monkeypatch, walk):
    """Forests, packets, the XLA walks and any-hit walks never sort by
    octant: only the closest K1 walk over the full hierarchy does."""
    monkeypatch.setenv(KNOB, "octant")
    monkeypatch.setattr(ray_sort, "octant_apply", lambda *a: pytest.fail(
        f"the {walk} walk sorted by octant"))
    scene = types.SimpleNamespace(bforest=None, ftables=None, wforest=None,
                                  wforest_maps=None, wbvh=object(), bvh=None,
                                  pbvh=None)
    o = torch.zeros(4, 3)
    d = torch.ones(4, 3)
    t = torch.full((4,), 3.4e38)
    if walk == "any-hit":
        monkeypatch.setattr(traverse_stack, "traverse_any",
                            lambda *a: "walked")
        assert common._any(scene, RenderConfig(), o, d, t) == "walked"
        return
    fields, module, name, backend = _WALKS[walk]
    for k, v in fields.items():
        setattr(scene, k, v)
    monkeypatch.setattr(module, name, lambda *a: "walked")
    monkeypatch.setattr(ray_sort, "sorted_apply",
                        lambda o, d, lo, hi, fn, *r: fn(o, d, *r))
    monkeypatch.setattr(traverse_pallas, "wbvh_bounds",
                        lambda w: (None, None))
    cfg = RenderConfig(backend=backend)
    assert common._closest_tr(scene, cfg, o, d, t) == "walked"


def test_full_hierarchy_closest_walk_takes_the_knob(monkeypatch):
    """The one walk that sorts: closest over the full hierarchy, and
    only under FLUCTUS_TRAV_SORT=octant (any other value is ignored)."""
    scene = types.SimpleNamespace(bforest=None, ftables=None, wforest=None,
                                  wforest_maps=None, wbvh=object(), bvh=None,
                                  pbvh=None)
    calls = []
    monkeypatch.setattr(ray_sort, "octant_apply",
                        lambda o, d, t, fn: calls.append(1) or "sorted")
    monkeypatch.setattr(traverse_stack, "traverse_closest",
                        lambda *a: "unsorted")
    args = (scene, RenderConfig(), torch.zeros(4, 3), torch.ones(4, 3),
            3.4e38)
    for value, want in ((None, "unsorted"), ("morton", "unsorted"),
                        ("octant", "sorted")):
        if value is None:
            monkeypatch.delenv(KNOB, raising=False)
        else:
            monkeypatch.setenv(KNOB, value)
        assert common._closest_tr(*args) == want
    assert len(calls) == 1
