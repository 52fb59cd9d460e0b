"""Port parity of the auxiliary surfaces against the JAX package, on the
CPU, each session carried across from the JAX one (tests/torch_common.py)
so both trace the same hierarchy:

- `ops/denoise.py::atrous_denoise` on seeded inputs at rtol 1e-4 / atol
  1e-5 (XLA fuses the exp/sum chains, so not bit for bit);
- `driver.render_aux` (depth at rtol 1e-6, the miss lanes exactly and
  their env colour at rtol 1e-5, a hit's albedo and normal at atol 1e-6
  except at equal-t ties), `render_denoised` (rtol 1e-3 / atol
  1e-4), `render_preview` and the progressive accumulator (the goldens'
  RTOL / ATOL), on the env-lit plane of tests/test_integrator.py, the
  area-lit cornell proxy and the env-lit luxball proxy (which has misses),
  all at 24x24 (the plane's camera moved off the quad's diagonal, see
  `sessions`);
- the progressive accumulator equal to the one-shot render bit for bit;
- `state.save_state` writing the JAX package's file, each package's
  `load_state` reading the other's, and `pick` / `pick_dof_depth`."""
import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.core.types import default_params as jax_default_params
from fluctus_tpu.ops.denoise import atrous_denoise as jax_atrous
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu.render import state as jax_state
from fluctus_tpu_torch.core.types import default_params
from fluctus_tpu_torch.fixtures import sky_env
from fluctus_tpu_torch.integrators import lockstep
from fluctus_tpu_torch.io.hdr import write_hdr
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.ops.denoise import atrous_denoise
from fluctus_tpu_torch.render import driver, state

from golden_common import ATOL, RTOL, _cornell_light
from test_integrator import _plane_render_session
from torch_common import port_session

N = 24
NAMES = ("plane", "cornell", "luxball")


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("env") / "sky.hdr")
    write_hdr(path, sky_env(64, 32, seed=5, sun_texels=1.5))
    return path


@functools.lru_cache(maxsize=None)
def sessions(name, sky):
    """(JAX RenderSession, the port's carried across from it)."""
    if name == "plane":
        # off the quad's diagonal: a centre ray along the edge its two
        # triangles share falls, in XLA's FMA-contracted Moller test, in
        # neither (7 of 24 misses on the diagonal; the port hits both)
        js = _plane_render_session()
        js.params = js.params.replace(camera=js.params.camera.replace(
            pos=jnp.array([0.01, 3.0, 0.003], jnp.float32)))
    else:
        area = name == "cornell"
        cfg = JaxConfig(width=N, height=N, max_bounces=2,
                        use_area_light=area, use_env_map=not area)
        js = jax_driver.create_session(
            f"assets/{name}_proxy.obj", env_map=None if area else sky,
            cfg=cfg, cache_dir=None, state_dir=None)
        if area:
            js.params = js.params.replace(area_light=_cornell_light())
    scene, params, cfg = port_session(js.scene, js.params, js.cfg)
    return js, driver.RenderSession(host_scene=None, scene=scene,
                                    params=params, cfg=cfg)


def _seeded(h=20, w=28, seed=0):
    g = np.random.default_rng(seed)
    color = g.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32)
    albedo = g.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    n = g.normal(size=(h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[g.random((h, w)) < 0.1] = 0.0          # misses
    depth = g.uniform(0.1, 2.0, (h, w)).astype(np.float32)
    return color, albedo, n.astype(np.float32), depth


@pytest.mark.parametrize("iterations", [1, 2, 3, 4])
@pytest.mark.parametrize("blend", [0.0, 0.5, 1.0])
def test_atrous_denoise_matches_jax(iterations, blend):
    arrays = _seeded(seed=iterations)
    got = atrous_denoise(*(torch.from_numpy(a) for a in arrays),
                         iterations=iterations, blend=blend).numpy()
    want = np.asarray(jax_atrous(*(jnp.asarray(a) for a in arrays),
                                 iterations=iterations, blend=blend))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if blend == 0.0:
        np.testing.assert_array_equal(got, arrays[0])


@pytest.mark.parametrize("name", NAMES)
def test_render_aux_matches_jax(name, sky):
    js, s = sessions(name, sky)
    ts.reset_counts()
    albedo, normal, depth = (x.numpy() for x in driver.render_aux(s))
    assert ts.PLAIN_CALLS == {"closest": 1, "any": 0}   # one tile
    ja, jn, jd = (np.asarray(x) for x in jax_driver.render_aux(js))
    assert albedo.shape == (N, N, 3) and depth.shape == (N, N)
    miss = jd == 2.0
    np.testing.assert_array_equal(depth == 2.0, miss)
    np.testing.assert_array_equal(normal[miss], 0.0)
    np.testing.assert_allclose(depth, jd, rtol=1e-6)
    # the env colour of a miss: XLA's atan2 and acos move its lookup by
    # a few ulps
    np.testing.assert_allclose(albedo[miss], ja[miss], rtol=1e-5)
    # a hit's features differ only where the walks stopped on two
    # triangles at equal t (cornell: 2 pixels where the floor meets a wall)
    tie = ~miss & ((np.abs(albedo - ja).max(-1) > 1e-6)
                   | (np.abs(normal - jn).max(-1) > 1e-6))
    assert tie.mean() < 0.01
    hit = ~miss & ~tie
    np.testing.assert_allclose(albedo[hit], ja[hit], atol=1e-6)
    np.testing.assert_allclose(normal[hit], jn[hit], atol=1e-6)
    if name == "luxball":
        assert 0 < miss.sum() < miss.size and albedo[miss].max() > 0.0


@pytest.mark.parametrize("name", NAMES)
def test_render_denoised_matches_jax(name, sky):
    """The port's denoised frame against JAX's denoiser over JAX's frame
    and the port's feature buffers, and, where the buffers hold no
    equal-t tie (a tie's features reach every pixel of a 24x24 frame
    through the filter's 30-pixel footprint; cornell has two), against
    JAX's render_denoised itself."""
    js, s = sessions(name, sky)
    got = driver.render_denoised(s, 2, blend=0.7, integrator="lockstep")
    aux = driver.render_aux(s)
    img = driver.render(s, 2, integrator="lockstep")
    assert torch.equal(got, atrous_denoise(img, *aux, blend=0.7))
    jimg = jax_driver.render(js, 2, integrator="lockstep")
    want = jax_atrous(jnp.asarray(jimg), *(jnp.asarray(x.numpy())
                                           for x in aux), blend=0.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    jaux = jax_driver.render_aux(js)
    if all(np.array_equal(x.numpy(), np.asarray(y))
           or np.allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
           for x, y in zip(aux, jaux)):
        want = jax_driver.render_denoised(js, 2, blend=0.7,
                                          integrator="lockstep")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    else:
        assert name == "cornell"


def test_denoised_frame_is_nearer_the_converged_one(tmp_path):
    """test_render_denoised_end_to_end's check on an in-repo scene: the
    env-lit luxball at 64x64, 2 bounces, under a sky without the sun
    disc (the teapot's night.hdr has none): the denoised 2 spp frame's
    MSE against a 32 spp frame below 0.6 x the raw frame's."""
    from fluctus_tpu_torch.core.types import RenderConfig
    path = str(tmp_path / "sky.hdr")
    write_hdr(path, sky_env(256, 128, seed=11, sun_radiance=0.0))
    s = driver.create_session("assets/luxball_proxy.obj", path,
                              cfg=RenderConfig(width=64, height=64,
                                               max_bounces=2),
                              state_dir=None, cache_dir=None, device="cpu")
    raw = driver.render(s, 2, integrator="lockstep")
    den = driver.render_denoised(s, 2, integrator="lockstep")
    ref = driver.render(s, 32, integrator="lockstep")
    assert den.shape == raw.shape
    mse_raw = float(((raw - ref) ** 2).mean())
    mse_den = float(((den - ref) ** 2).mean())
    assert mse_den < 0.6 * mse_raw, (mse_den, mse_raw)


@pytest.mark.parametrize("name", ["plane", "luxball"])
def test_progressive_matches_oneshot_and_jax(name, sky, tmp_path):
    js, s = sessions(name, sky)
    prog = driver.ProgressiveRender(s, samples_per_launch=4)
    prog.add(4)
    assert prog.add(4) == 8
    one = lockstep.render(s.scene, s.params, s.cfg, 8, samples_per_launch=4)
    assert torch.equal(prog.image(), one)
    jprog = jax_driver.ProgressiveRender(js, samples_per_launch=4)
    jprog.add(4)
    jprog.add(4)
    np.testing.assert_allclose(prog.image().numpy(), jprog.image(),
                               rtol=RTOL, atol=ATOL)
    # an increment that is no multiple of the group folds as the one-shot
    prog6 = driver.ProgressiveRender(s, samples_per_launch=4)
    prog6.add(6)
    assert torch.equal(prog6.image(), lockstep.render(
        s.scene, s.params, s.cfg, 6, samples_per_launch=3))
    # a parameter change resets, and so does a new env image
    s2 = dataclasses.replace(s)
    prog.session = s2
    s2.params = dataclasses.replace(s.params,
                                    env_strength=torch.tensor(2.0))
    assert prog.add(4) == 4
    assert prog.add(4) == 8
    s2.scene = dataclasses.replace(s.scene, envmap=dataclasses.replace(
        s.scene.envmap, image=s.scene.envmap.image * 0.5))
    assert prog.add(4) == 4
    out = tmp_path / "prog.png"
    img = driver.render_progressive(s, iterations=2, spp_increment=4,
                                    export_every=1, export_path=str(out))
    assert out.exists() and img.shape == (N, N, 3)
    hdr = tmp_path / "prog.hdr"
    driver.render_progressive(s, iterations=1, spp_increment=4,
                              export_path=str(hdr), hdr=True)
    assert hdr.exists()


@pytest.mark.parametrize("name", NAMES)
def test_render_preview_matches_jax(name, sky):
    js, s = sessions(name, sky)
    s = dataclasses.replace(s, cfg=s.cfg.replace(max_bounces=4))
    js = dataclasses.replace(js, cfg=js.cfg.replace(max_bounces=4))
    got = driver.render_preview(s, 1)
    want = jax_driver.render_preview(js, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, lockstep.render(
        s.scene, s.params, s.cfg.replace(max_bounces=2), 1))


def test_save_state_writes_the_jax_file(tmp_path):
    jp = jax_default_params(world_radius=3.0)
    jp = jp.replace(camera=jp.camera.replace(
        pos=jnp.array([1.0, 2.0, 3.0], jnp.float32), fov=jnp.float32(45.0),
        aperture_size=jnp.float32(0.02), focal_dist=jnp.float32(1.7)),
        env_strength=jnp.float32(2.5), exposure=jnp.float32(0.8))
    p = default_params(world_radius=3.0, device="cpu")
    p = dataclasses.replace(p, camera=dataclasses.replace(
        p.camera, pos=torch.tensor([1.0, 2.0, 3.0]),
        fov=torch.tensor(45.0), aperture_size=torch.tensor(0.02),
        focal_dist=torch.tensor(1.7)), env_strength=torch.tensor(2.5),
        exposure=torch.tensor(0.8))
    path = state.save_state(p, "abc123", state_dir=str(tmp_path / "port"))
    jpath = jax_state.save_state(jp, "abc123",
                                 state_dir=str(tmp_path / "jax"))
    assert path.endswith("state_abc123.json")
    with open(path) as f, open(jpath) as g:
        text, jtext = f.read(), g.read()
    assert text == jtext and json.loads(text)["exposure"] == \
        pytest.approx(0.8)
    # each package reads the other's file
    back = state.load_state(default_params(device="cpu"), "abc123",
                            state_dir=str(tmp_path / "jax"))
    jback = jax_state.load_state(jax_default_params(), "abc123",
                                 state_dir=str(tmp_path / "port"))
    for rec, jrec in ((back.camera, jback.camera),
                      (back.area_light, jback.area_light)):
        for f in dataclasses.fields(rec):
            np.testing.assert_array_equal(
                getattr(rec, f.name).numpy(),
                np.asarray(getattr(jrec, f.name)))
    assert float(back.env_strength) == float(jback.env_strength) == 2.5


def test_pick_focus_matches_jax(sky):
    """test_pick_focus's case (the plane's centre at t = 3) and seeded
    NDC points on the cornell and luxball proxies: t and prim as JAX's
    (prim except at equal-t ties)."""
    js, s = sessions("plane", sky)
    t, prim = state.pick(s.scene, s.params, s.cfg, 0.5, 0.5)
    jt, jprim = jax_state.pick(js.scene, js.params, js.cfg, 0.5, 0.5)
    assert prim >= 0 and prim == jprim
    np.testing.assert_allclose(t, 3.0, rtol=1e-4)
    np.testing.assert_allclose(t, jt, rtol=1e-6)
    p2 = state.pick_dof_depth(s.scene, s.params, s.cfg)
    assert float(p2.camera.focal_dist) == np.float32(t)
    g = np.random.default_rng(2)
    hits = 0
    for name in ("cornell", "luxball"):
        js, s = sessions(name, sky)
        for nx, ny in g.uniform(0.4, 0.6, (3, 2)):
            t, prim = state.pick(s.scene, s.params, s.cfg, nx, ny)
            jt, jprim = jax_state.pick(js.scene, js.params, js.cfg, nx, ny)
            assert (prim >= 0) == (jprim >= 0)
            np.testing.assert_allclose(t, jt, rtol=1e-5)
            assert prim == jprim or t == pytest.approx(jt, rel=1e-5)
            hits += prim >= 0
            p2 = state.pick_dof_depth(s.scene, s.params, s.cfg, nx, ny)
            want = np.float32(t) if prim >= 0 else \
                float(s.params.camera.focal_dist)
            assert float(p2.camera.focal_dist) == want
    assert hits >= 4
