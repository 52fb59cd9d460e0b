"""Port against the JAX package on env-lit renders, both on the CPU
(the JAX package's traversal backend "wide", the port's plain K1), each
package loading the same seeded HDR through its own create_session:

- the luxball proxy (BASELINE config 2: ideal dielectric shell, glossy
  core and floor, MIS env map, thin-lens DoF with aperture 0.06), 32x32,
  4 bounces, 4 spp, through the lockstep and the stream;
- the cornell proxy with the env map and its area light, where the
  stream's next-event estimation picks the env map with probability 0.5
  and the area-light quad blocks env shadow rays.

Held as the kitchen is (tests/test_torch_render.py): the share of pixels
within the goldens' RTOL 1e-3 / ATOL 1e-4 at least SHARE and the mean
relative error at most MEAN_REL. A float32 ulp of XLA's FMA contraction
or of its atan2/acos/sin/cos can flip a discrete choice and send a path
elsewhere; at these sizes no pixel has flipped (share 1.0)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.integrators import lockstep as jlockstep
from fluctus_tpu.integrators import wavefront as jwf
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.fixtures import sky_env
from fluctus_tpu_torch.integrators import lockstep, wavefront
from fluctus_tpu_torch.io.hdr import write_hdr
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.render import driver

from golden_common import ATOL, RTOL, _cornell_light
from torch_common import cornell_light_torch, golden_stats

SHARE = 0.995
MEAN_REL = 1e-4
N, SPP, POOL, SEG = 32, 4, 300, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("env") / "sky.hdr")
    write_hdr(path, sky_env(64, 32, seed=3, sun_texels=1.5))
    return path


@functools.lru_cache(maxsize=None)
def sessions(name, sky):
    """The JAX session and the port's, each from its own create_session
    with the same scene and env file."""
    area = name == "cornell"
    scene = f"assets/{name}_proxy.obj"
    jcfg = JaxConfig(width=N, height=N, max_bounces=4, use_area_light=area,
                     pool_size=POOL)
    js = jax_driver.create_session(scene, sky, jcfg, cache_dir=None,
                                   state_dir=None)
    cfg = RenderConfig(width=N, height=N, max_bounces=4, use_area_light=area,
                       pool_size=POOL)
    s = driver.create_session(scene, sky, cfg, state_dir=None, device="cpu")
    if area:
        js.params = js.params.replace(area_light=_cornell_light())
        s.params = dataclasses.replace(s.params,
                                       area_light=cornell_light_torch())
    else:
        js.params = js.params.replace(camera=js.params.camera.replace(
            aperture_size=jnp.float32(0.06)))
        s.params = dataclasses.replace(s.params, camera=dataclasses.replace(
            s.params.camera, aperture_size=torch.tensor(0.06)))
    assert js.cfg.use_env_map and s.cfg.use_env_map
    return js, s


def hold(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    share, mean_rel = golden_stats(got, want, RTOL, ATOL)
    assert share >= SHARE and mean_rel <= MEAN_REL, (share, mean_rel)
    assert float(want.mean()) > 0.01


@pytest.mark.parametrize("name", ["luxball", "cornell"])
def test_env_lit_lockstep_matches_jax(name, sky):
    js, s = sessions(name, sky)
    want = np.asarray(jlockstep.render(js.scene, js.params, js.cfg, SPP))
    ts.reset_counts()
    got = driver.render(s, SPP, integrator="lockstep").numpy()
    hold(got, want)
    assert ts.PLAIN_CALLS["closest"] > 0 and ts.PLAIN_CALLS["any"] > 0


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("name", ["luxball", "cornell"])
def test_env_lit_stream_matches_jax(name, deferred, sky):
    js, s = sessions(name, sky)
    want, cnt_j = jwf.render_stream(js.scene, js.params, js.cfg, SPP,
                                    segments_per_launch=SEG,
                                    deferred=deferred)
    got, cnt = wavefront.render_stream(s.scene, s.params, s.cfg, SPP,
                                       segments_per_launch=SEG,
                                       deferred=deferred)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    hold(got.numpy(), np.asarray(want))


def test_auto_integrator_choice_matches_jax(sky):
    """The openness probe of both packages on the env-lit luxball gives
    the same rates, so render(integrator="auto") on the card picks what
    the JAX package's picks on its accelerator (on a CPU session both take
    the lockstep)."""
    js, s = sessions("luxball", sky)
    cfg = js.cfg
    n_pix = cfg.width * cfg.height
    pix = np.arange(0, n_pix, max(1, n_pix // 4096))
    hj, ej = jax.jit(jax_driver._openness_probe, static_argnames="cfg")(
        js.scene, js.params, cfg, jnp.asarray(pix, jnp.uint32))
    h, e = driver._openness_probe(s.scene, s.params, s.cfg,
                                  torch.from_numpy(pix))
    assert abs(float(h) - float(hj)) < 1e-6 and abs(float(e) - float(ej)) \
        < 1e-6
    want = jax_driver.integrator_decision(float(hj), float(ej),
                                          cfg.max_bounces)
    assert driver.integrator_decision(float(h), float(e),
                                      s.cfg.max_bounces) == want
    assert driver.choose_integrator(s) == "lockstep"       # a CPU session


@pytest.mark.parametrize("name", ["luxball", "cornell"])
def test_packet_backend_renders_the_same_env_lit_frame(name, sky):
    """backend "pallas" (the plain K4) renders the env-lit frame the plain
    K1 renders, bit for bit: the two agree on every hit of these scenes
    (no equal-t ties), so chip_smoke.py's golden-env holds the card's K4
    render against the CPU render through K1."""
    _, s = sessions(name, sky)
    small = dataclasses.replace(s, cfg=s.cfg.replace(width=16, height=16))
    packet = dataclasses.replace(small, cfg=small.cfg.replace(
        backend="pallas"))
    a = driver.render(small, 2, integrator="lockstep")
    b = driver.render(packet, 2, integrator="lockstep")
    assert torch.equal(a, b) and float(a.mean()) > 0.01
