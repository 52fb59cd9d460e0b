"""Port parity of env-map lighting: the HDR reader and writer
(fluctus_tpu_torch/io/hdr.py), the host tables (scene/envmap.py), the
device ops (ops/envmap.py) and the env-lit plane checks of
tests/test_integrator.py and tests/test_wavefront.py on the port.

Alias tables are bit-equal to the JAX package's (the same NumPy
arithmetic and worklist order), and so are the alias draws' texel
indices. Directions, radiance and pdfs go through atan2, acos, sin and
cos, which PyTorch and XLA's CPU backend approximate differently (on
200,000 random directions: u equal, v within 1.2e-6 from acos):
directions and uv are held at ENV_ATOL_DIR; bilinear radiance at
EVAL_RTOL, whose worst case is a lookup across the sun disc's edge, where
the weight's 1e-6 meets a 1000x contrast (seen: 7.5e-4; 6.7e-6 on a
smooth map); pdfs at PDF_RTOL, whose worst case is near a pole, where
sin(pi v) is small (seen: 1.25e-4)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluctus_tpu.core.types import EnvMap as JaxEnvMap
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.io import hdr as jhdr
from fluctus_tpu.ops import envmap as jenv
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu.scene import envmap as jenv_host
from fluctus_tpu_torch.convert import (envmap_from_numpy, params_from_numpy,
                                       scene_from_numpy)
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.fixtures import sky_env
from fluctus_tpu_torch.integrators import lockstep, wavefront
from fluctus_tpu_torch.io import hdr
from fluctus_tpu_torch.ops import envmap as env_ops
from fluctus_tpu_torch.render import driver
from fluctus_tpu_torch.scene import envmap as env_host

from helpers import big_quad, diffuse_material, make_host_scene
from torch_common import params_arrays, scene_arrays

ENV_ATOL_DIR = 2e-6
EVAL_RTOL = 1e-3
PDF_RTOL = 2e-4
RHO = 0.6
RHO_LIN = RHO ** 2.2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_env(image):
    """The JAX EnvMap and the port's, from one image's JAX host tables."""
    h = jenv_host.compute_tables(np.asarray(image, np.float32))
    fields = dict(image=h.image, pdf_table=h.pdf_table,
                  prob_table=h.prob_table, alias_table=h.alias_table)
    return (JaxEnvMap(**{k: jnp.asarray(v) for k, v in fields.items()}),
            envmap_from_numpy(fields, device="cpu"))


def images():
    g = np.random.default_rng(7)
    return {"random": g.uniform(0.1, 4.0, (8, 16, 3)).astype(np.float32),
            "sky": sky_env(64, 32, seed=1, sun_texels=1.5),
            "black": np.zeros((4, 8, 3), np.float32),
            "one hot": np.pad(np.ones((1, 1, 3), np.float32),
                              ((3, 4), (5, 2), (0, 0)))}


# ------------------------------------------------------------ host side

@pytest.mark.parametrize("name", ["random", "sky", "black", "one hot"])
def test_alias_tables_bit_equal_jax(name):
    img = images()[name]
    got = env_host.compute_tables(img)
    want = jenv_host.compute_tables(img)
    for f in ("image", "pdf_table", "prob_table", "alias_table"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_dummy_env_equals_jax():
    got, want = env_host.dummy(), jenv_host.dummy()
    assert got.image.shape == (1, 1, 3)
    assert np.allclose(got.pdf_table, 1.0)
    for f in ("image", "pdf_table", "prob_table", "alias_table"):
        assert np.array_equal(getattr(got, f), getattr(want, f))


def _rle_hdr(path, img):
    """A Radiance file with RLE scanlines (runs and literals), as other
    writers make them; the writers of both packages write flat ones."""
    rgbe = jhdr.float_to_rgbe(img)
    h, w, _ = img.shape
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                    + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, row[x]])
                    x += run
                else:
                    n = min(w - x, 128)
                    out += bytes([n]) + bytes(row[x:x + n])
                    x += n
    with open(path, "wb") as f:
        f.write(bytes(out))


def test_hdr_roundtrip_both_ways(tmp_path):
    """Files written by either package read bit-equal in both, flat and
    RLE scanlines, within RGBE's shared-exponent rounding of the source."""
    g = np.random.default_rng(5)
    img = (g.uniform(0, 1, (12, 20, 3)) ** 2 * 8).astype(np.float32)
    img[3, :10] = 2.5                       # runs for the RLE writer
    p_port, p_jax, p_rle = (str(tmp_path / n) for n in
                            ("port.hdr", "jax.hdr", "rle.hdr"))
    hdr.write_hdr(p_port, img)
    jhdr.write_hdr(p_jax, img)
    _rle_hdr(p_rle, img)
    with open(p_port, "rb") as a, open(p_jax, "rb") as b:
        assert a.read() == b.read()
    back = hdr.read_hdr(p_port)
    for p in (p_port, p_jax, p_rle):
        np.testing.assert_array_equal(hdr.read_hdr(p), jhdr.read_hdr(p))
        np.testing.assert_array_equal(hdr.read_hdr(p), back)
    tol = img.max(axis=-1, keepdims=True) / 128.0 + 1e-6
    assert back.shape == img.shape and (np.abs(back - img) <= tol).all()
    with open(p_port, "rb") as f:
        bad = str(tmp_path / "bad.hdr")
        with open(bad, "wb") as o:
            o.write(b"#?NOTHDR" + f.read()[8:])
    with pytest.raises(ValueError, match="Radiance"):
        hdr.read_hdr(bad)


# ------------------------------------------------------------ device ops

def test_uv_direction_roundtrip_and_jax():
    u = np.linspace(0.05, 0.95, 13, dtype=np.float32)
    uu, vv = (x.ravel() for x in np.meshgrid(u, u))
    d = env_ops.uv_to_direction(torch.from_numpy(uu), torch.from_numpy(vv))
    uv = env_ops.direction_to_uv(d).numpy()
    np.testing.assert_allclose(uv[:, 0], uu, atol=1e-5)
    np.testing.assert_allclose(uv[:, 1], vv, atol=1e-5)
    dj = np.asarray(jenv.uv_to_direction(jnp.asarray(uu), jnp.asarray(vv)))
    np.testing.assert_allclose(d.numpy(), dj, atol=ENV_ATOL_DIR)
    g = np.random.default_rng(2)
    dirs = g.normal(size=(4096, 3)).astype(np.float32)
    dirs[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, 0], [1e-30, 0, 0]]
    np.testing.assert_allclose(
        env_ops.direction_to_uv(torch.from_numpy(dirs)).numpy(),
        np.asarray(jenv.direction_to_uv(jnp.asarray(dirs))),
        atol=ENV_ATOL_DIR)


@pytest.mark.parametrize("name", ["random", "sky"])
def test_eval_and_pdf_match_jax(name):
    je, pe = both_env(images()[name])
    g = np.random.default_rng(4)
    dirs = g.normal(size=(4096, 3)).astype(np.float32)
    dirs[:3] = [[0, 1, 0], [0, -1, 0], [0, 0, 0]]
    td, jd = torch.from_numpy(dirs), jnp.asarray(dirs)
    np.testing.assert_allclose(env_ops.eval_dir(pe, td).numpy(),
                               np.asarray(jenv.eval_dir(je, jd)),
                               rtol=EVAL_RTOL, atol=1e-6)
    np.testing.assert_allclose(env_ops.pdf_dir(pe, td).numpy(),
                               np.asarray(jenv.pdf_dir(je, jd)),
                               rtol=PDF_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", ["random", "sky", "black"])
def test_alias_draws_match_jax(name):
    """The alias draw picks the same texel (the radiance of a texel is
    unique in these images, so equal radiance is an equal index), and
    the direction and pdf agree within the stated tolerances."""
    je, pe = both_env(images()[name])
    g = np.random.default_rng(3)
    u = g.uniform(size=8192).astype(np.float32)
    u[:2] = [0.0, np.float32(1.0) - np.float32(2 ** -24)]
    L, pdf, rad = env_ops.sample_alias_radiance(pe, torch.from_numpy(u))
    Lj, pdfj, radj = jenv.sample_alias_radiance(je, jnp.asarray(u))
    np.testing.assert_array_equal(rad.numpy(), np.asarray(radj))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), atol=ENV_ATOL_DIR)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdfj), rtol=PDF_RTOL)
    L2, pdf2 = env_ops.sample_alias(pe, torch.from_numpy(u))
    assert torch.equal(L2, L) and torch.equal(pdf2, pdf)
    uv_ind = env_ops._alias_draw(pe, torch.from_numpy(u))[0].numpy()
    h, w = pe.image.shape[:2]
    r = u * (w * h)
    i = np.minimum(np.floor(r).astype(np.int32), w * h - 1)
    want = np.where((r - i) < np.asarray(je.prob_table)[i], i,
                    np.asarray(je.alias_table)[i])
    np.testing.assert_array_equal(uv_ind, want)


def test_alias_tables_preserve_distribution():
    """Sampling by the port's alias tables reproduces the pdf (chi-square
    on texel counts, as tests/test_envmap.py)."""
    g = np.random.default_rng(7)
    _, pe = both_env(images()["random"])
    n = 1 << 17
    idx = env_ops._alias_draw(pe, torch.from_numpy(
        g.uniform(size=n).astype(np.float32)))[0].numpy()
    counts = np.bincount(idx, minlength=128)
    expected = pe.pdf_table.numpy() / 128 * n
    chi2 = ((counts - expected) ** 2 / np.maximum(expected, 1)).sum()
    assert chi2 < 2.5 * 128, chi2


def test_sample_pdf_consistency_and_integral():
    """The pdf of an alias draw equals pdf_dir at its direction, and the
    alias estimate of the integral of Li over the sphere matches the true
    one (pdf normalisation with the sin(theta) Jacobian)."""
    g = np.random.default_rng(11)
    img = g.uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32)
    _, pe = both_env(img)
    u = torch.from_numpy(g.uniform(size=1 << 16).astype(np.float32))
    L, pdf = env_ops.sample_alias(pe, u)
    np.testing.assert_allclose(env_ops.pdf_dir(pe, L[:4096]).numpy(),
                               pdf[:4096].numpy(), rtol=1e-3, atol=1e-6)
    li = env_ops.eval_dir(pe, L)
    est = (li / torch.clamp(pdf, min=1e-12)[:, None]).mean(0).numpy()
    h, w = img.shape[:2]
    v = (np.arange(h) + 0.5) / h
    true = (img * np.sin(np.pi * v)[:, None, None]).sum((0, 1)) \
        * (2 * np.pi / w) * (np.pi / h)
    np.testing.assert_allclose(est, true, rtol=0.1)


# ------------------------------------------------------------ the plane

def plane(sample_impl=True, sample_expl=True, env_val=1.0, max_bounces=2):
    """tests/test_integrator.py::plane_session carried to the port: a
    Lambertian plane (albedo RHO) under a constant env map, seen from
    above."""
    v0, v1, v2 = big_quad(y=0.0, half=500.0)
    env = np.full((32, 64, 3), env_val, np.float32)
    host = make_host_scene(v0, v1, v2,
                           materials=[diffuse_material((RHO, RHO, RHO))],
                           env_image=env)
    host.build_bvh(cache_dir=None, use_sbvh=False)
    js = host.to_device()
    scene = scene_from_numpy(scene_arrays(js), device="cpu")
    from fluctus_tpu.core.types import default_params
    jp = default_params(world_radius=host.world_radius())
    jp = jp.replace(camera=jp.camera.replace(
        pos=jnp.array([0.0, 3.0, 0.0], jnp.float32),
        dir=jnp.array([0.0, -1.0, 0.0], jnp.float32),
        up=jnp.array([0.0, 0.0, -1.0], jnp.float32),
        right=jnp.array([1.0, 0.0, 0.0], jnp.float32)))
    params = params_from_numpy(params_arrays(jp), device="cpu")
    cfg = RenderConfig(width=24, height=24, max_bounces=max_bounces,
                       use_env_map=True, use_area_light=False,
                       sample_impl=sample_impl, sample_expl=sample_expl,
                       bsdf_types_mask=host.material_types_mask,
                       pool_size=1 << 12)
    return scene, params, cfg


def mean(scene, params, cfg, spp):
    return float(lockstep.render(scene, params, cfg, spp).mean())


def test_furnace_diffuse_plane_mis_unbiased():
    np.testing.assert_allclose(mean(*plane(), 48), RHO_LIN, rtol=0.03)


def test_sampling_modes_converge_to_same_value():
    means = {name: mean(*plane(sample_impl=si, sample_expl=se), 64)
             for name, (si, se) in {"mis": (True, True),
                                    "expl": (False, True),
                                    "impl": (True, False)}.items()}
    assert abs(means["mis"] - RHO_LIN) < 0.02
    assert abs(means["expl"] - RHO_LIN) < 0.02
    assert abs(means["impl"] - RHO_LIN) < 0.06


def test_env_only_miss_shows_environment():
    scene, params, cfg = plane(env_val=0.25)
    cam = dataclasses.replace(params.camera,
                              dir=torch.tensor([0.0, 1.0, 0.0]),
                              up=torch.tensor([0.0, 0.0, 1.0]))
    params = dataclasses.replace(params, camera=cam)
    np.testing.assert_allclose(mean(scene, params, cfg, 4), 0.25, rtol=1e-3)


@pytest.mark.parametrize("deferred", [False, True])
def test_stream_matches_lockstep_env_lit(deferred):
    """tests/test_wavefront.py::test_stream_bitmatches_lockstep on the
    port: with the env map the only light, the stream's NEE picks it with
    probability 1 and its shadow ray is as long as the lockstep's."""
    scene, params, cfg = plane()
    img_s, cnt = wavefront.render_stream(scene, params, cfg, 4,
                                         deferred=deferred)
    img_l = lockstep.render(scene, params, cfg, 4)
    np.testing.assert_allclose(img_s.numpy(), img_l.numpy(), atol=1e-5)
    assert int(cnt[0]) == 24 * 24 * 4


# ------------------------------------------------------------ create_session

def test_create_session_env_map_equals_jax(tmp_path):
    """create_session(path, env_path) in both packages (the same
    positional order): equal use_env_map and tables; without a map, or
    with use_env_map off, the env map is off and the 1x1 black map is
    uploaded; env_strength of a state file reaches the port's params."""
    path = str(tmp_path / "sky.hdr")
    hdr.write_hdr(path, sky_env(64, 32, seed=2, sun_texels=1.5))
    jcfg = JaxConfig(width=16, height=16, max_bounces=2)
    js = jax_driver.create_session("assets/luxball_proxy.obj", path,
                                   jcfg, cache_dir=None, state_dir=None)
    s = driver.create_session("assets/luxball_proxy.obj", path,
                              RenderConfig(width=16, height=16,
                                           max_bounces=2),
                              state_dir=None, device="cpu")
    assert s.cfg.use_env_map and js.cfg.use_env_map
    for f in ("image", "pdf_table", "prob_table", "alias_table"):
        a = getattr(s.scene.envmap, f).numpy()
        b = np.asarray(getattr(js.scene.envmap, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    off = driver.create_session("assets/luxball_proxy.obj", path,
                                RenderConfig(use_env_map=False),
                                state_dir=None, device="cpu")
    none = driver.create_session("assets/luxball_proxy.obj",
                                 state_dir=None, device="cpu")
    assert not off.cfg.use_env_map and not none.cfg.use_env_map
    assert tuple(none.scene.envmap.image.shape) == (1, 1, 3)
    assert float(none.scene.envmap.image.abs().sum()) == 0.0
    # a state file's env_strength reaches the params
    import json
    import shutil
    shutil.copy("data/states/state_c68e332cfae81cc6.json",
                tmp_path / "state_c68e332cfae81cc6.json")
    st = json.loads((tmp_path / "state_c68e332cfae81cc6.json").read_text())
    st["env_strength"] = 2.5
    (tmp_path / "state_c68e332cfae81cc6.json").write_text(json.dumps(st))
    k = driver.create_session("assets/kitchen_proxy.obj", path,
                              RenderConfig(width=8, height=8),
                              state_dir=str(tmp_path), auto_frame=False,
                              device="cpu")
    assert float(k.params.env_strength) == 2.5
