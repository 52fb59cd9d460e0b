"""Port parity of the lockstep integrator and the driver: the port's
`sample_radiance` against the JAX package's (traversal backend "wide") on
one scene carried across with convert.scene_from_numpy, and the port's
renders against the committed JAX goldens.

Paths are chaotic: XLA's FMA contraction and approximate rsqrt/sin/cos
move a float32 result by a few ulps, and once in a while that flips a
discrete decision (a triangle edge, a shadow-ray hit, a lobe choice) and
the path goes elsewhere. Cornell (diffuse walls, one mirror, one GGX box,
4 bounces) shows no such flip and is held pixel for pixel at the goldens'
RTOL 1e-3 / ATOL 1e-4. The kitchen (mirrors, glass, glossy, 8 bounces)
flips 6 of 4096 pixels, so it is held at that tolerance on 99.5% of its
pixels and at 1e-4 mean relative error."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.integrators import lockstep as jax_lockstep
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.convert import params_from_numpy, scene_from_numpy
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.integrators import lockstep
from fluctus_tpu_torch.render import driver

from golden_common import ATOL, RTOL, _cornell_light, golden_path
from torch_common import (cornell_light_torch, golden_stats, params_arrays,
                          scene_arrays)

KITCHEN_SHARE = 0.995
KITCHEN_MEAN_REL = 1e-4


def _jax_session(name):
    if name == "cornell":
        cfg = JaxConfig(width=64, height=64, max_bounces=4,
                        use_area_light=True, use_env_map=False)
        s = jax_driver.create_session(
            "assets/cornell_proxy.obj", env_map=None, cfg=cfg, use_sbvh=True,
            cache_dir=None, state_dir=None)
        s.params = s.params.replace(area_light=_cornell_light())
        return s
    cfg = JaxConfig(width=64, height=64, max_bounces=8, use_area_light=True,
                    use_env_map=False)
    return jax_driver.create_session(
        "assets/kitchen_proxy.obj", env_map=None, cfg=cfg, use_sbvh=True,
        cache_dir=None, state_dir="data/states", auto_frame=False)


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_sample_radiance_matches_jax(name):
    js = _jax_session(name)
    assert js.cfg.backend == "wide"
    scene = scene_from_numpy(scene_arrays(js.scene), device="cpu")
    params = params_from_numpy(params_arrays(js.params), device="cpu")
    c = js.cfg
    cfg = RenderConfig(width=c.width, height=c.height,
                       max_bounces=c.max_bounces,
                       use_area_light=c.use_area_light, use_env_map=False,
                       bsdf_types_mask=c.bsdf_types_mask)
    pix = np.arange(0, 64 * 64, 4, dtype=np.uint32)    # 1024 pixels
    fn = jax.jit(lambda sc, pa, p, k: jax_lockstep.sample_radiance(
        sc, pa, c, p, k, early_exit=True))
    for smp in (0, 5):
        want = np.asarray(fn(js.scene, js.params, jnp.asarray(pix),
                             jnp.uint32(smp)))
        got = lockstep.sample_radiance(
            scene, params, cfg, torch.from_numpy(pix.astype(np.int32)),
            smp).numpy()
        share, mean_rel = golden_stats(got, want, RTOL, ATOL)
        if name == "cornell":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        else:
            assert share >= KITCHEN_SHARE and mean_rel <= KITCHEN_MEAN_REL, \
                (share, mean_rel)


def test_convert_carries_every_leaf():
    js = _jax_session("cornell")
    arrays = scene_arrays(js.scene)
    scene = scene_from_numpy(arrays, device="cpu")
    np.testing.assert_array_equal(scene.wbvh.nodes.numpy(),
                                  arrays["wbvh.nodes"])
    np.testing.assert_array_equal(scene.atlas.offset.numpy(),
                                  arrays["atlas.offset"])
    assert scene.wbvh.depth == js.scene.wbvh.depth
    params = params_from_numpy(params_arrays(js.params), device="cpu")
    np.testing.assert_array_equal(params.area_light.emission.numpy(),
                                  np.asarray(js.params.area_light.emission))


def _port_golden(name):
    cfg = RenderConfig(width=64, height=64, use_area_light=True,
                       use_env_map=False,
                       max_bounces=4 if name == "cornell_area" else 8)
    if name == "cornell_area":
        s = driver.create_session("assets/cornell_proxy.obj", cfg=cfg,
                                  state_dir=None, device="cpu")
        s.params = dataclasses.replace(s.params,
                                       area_light=cornell_light_torch())
        return driver.render(s, 8).numpy()
    s = driver.create_session("assets/kitchen_proxy.obj", cfg=cfg,
                              state_dir="data/states", auto_frame=False,
                              device="cpu")
    return driver.render(s, 4).numpy()


def test_golden_cornell_area():
    gold = np.load(golden_path("cornell_area"))["img"]
    np.testing.assert_allclose(_port_golden("cornell_area"), gold,
                               rtol=RTOL, atol=ATOL)


def test_golden_kitchen_cfg3():
    gold = np.load(golden_path("kitchen_cfg3"))["img"]
    img = _port_golden("kitchen_cfg3")
    assert img.shape == gold.shape and np.isfinite(img).all()
    share, mean_rel = golden_stats(img, gold, RTOL, ATOL)
    assert share >= KITCHEN_SHARE, share
    assert mean_rel <= KITCHEN_MEAN_REL, mean_rel


def test_render_ldr_and_stream_refusal():
    cfg = RenderConfig(width=8, height=8, max_bounces=2, use_area_light=True,
                       use_env_map=False)
    s = driver.create_session("assets/cornell_proxy.obj", cfg=cfg,
                              state_dir=None, device="cpu")
    s.params = dataclasses.replace(s.params, area_light=cornell_light_torch())
    ldr = driver.render_ldr(s, 1)
    assert ldr.shape == (8, 8, 3) and bool(torch.isfinite(ldr).all())
    img = driver.render(s, 1, integrator="stream")
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    # env-map lighting is ported: with the 1x1 black map a session holds
    # when none is loaded, the stream renders, picking the env map for
    # half its NEE draws (they add nothing)
    env = dataclasses.replace(s, cfg=s.cfg.replace(use_env_map=True))
    img = driver.render(env, 1, integrator="stream")
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert tuple(s.scene.envmap.image.shape) == (1, 1, 3)


def test_cuda_entry_point_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.create_session("assets/cornell_proxy.obj")
