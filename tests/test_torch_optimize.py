"""The port's inverse-rendering loop (fluctus_tpu_torch/render/optimize.py)
against the JAX package's (fluctus_tpu/render/optimize.py): the spp
schedule, the stratified pixels' PRNG (core/jaxrand.py against
jax.random), one Adam step against optax's, the lockstep loss history
against JAX's run on the same target file, and the checks of
tests/test_optimize.py on the port (minibatch recovery, resume, the
stream method)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluctus_tpu.integrators import lockstep as jlockstep
from fluctus_tpu.io.hdr import write_hdr
from fluctus_tpu.render import optimize as joptimize
from fluctus_tpu.render.driver import RenderSession as JaxSession
from fluctus_tpu_torch.core import jaxrand
from fluctus_tpu_torch.render import optimize
from fluctus_tpu_torch.render.driver import RenderSession

from test_integrator import plane_session
from torch_common import port_session


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    """The plane of tests/test_optimize.py, its target rendered by the JAX
    package with kd x 0.5 and written as .hdr; returns (path, JAX
    session, port session, true kd)."""
    scene, params, cfg = plane_session(max_bounces=1)
    kd_true = scene.materials.kd * 0.5
    pix = jnp.arange(cfg.width * cfg.height, dtype=jnp.uint32)
    img = jlockstep.sample_radiance(
        scene.replace(materials=scene.materials.replace(kd=kd_true)),
        params, cfg, pix, jnp.uint32(0))
    path = str(tmp_path_factory.mktemp("target") / "target.hdr")
    write_hdr(path, np.asarray(img).reshape(cfg.height, cfg.width, 3))
    js = JaxSession(host_scene=None, scene=scene, params=params, cfg=cfg)
    ps = RenderSession(None, *port_session(scene, params, cfg))
    return path, js, ps, torch.from_numpy(np.asarray(kd_true))


@pytest.mark.parametrize("steps,spp", [(100, 8), (10, 2), (7, 4), (1, 16),
                                       (33, 5)])
def test_spp_schedule_matches_jax(steps, spp):
    assert optimize.spp_schedule(steps, spp) == \
        joptimize.spp_schedule(steps, spp)


def test_jax_threefry_setting():
    """core/jaxrand.py computes the bits of jax_threefry_partitionable =
    True, JAX 0.9's default, which this JAX runs with."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0x0F17, 0, 123456789])
def test_jaxrand_matches_jax_random(seed):
    """fold_in and randint bit for bit against jax.random over many steps
    and spans (spans past 2^16, where the uint32 products wrap, too)."""
    key = jax.random.PRNGKey(seed)
    pkey = jaxrand.prng_key(seed)
    for step in list(range(40)) + [1000, 65537, 2 ** 31 + 7, 2 ** 32 - 1]:
        kj = jax.random.fold_in(key, step)
        kp = jaxrand.fold_in(pkey, step)
        np.testing.assert_array_equal(kp.numpy(),
                                      np.asarray(kj).astype(np.int64))
        for span in (2, 9, 37, 1000, 65535, 100003, 2 ** 31 - 1):
            for n in (1, 64, 257):
                want = np.asarray(jax.random.randint(kj, (n,), 0, span))
                got = jaxrand.randint(kp, n, 0, span).numpy()
                np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        jaxrand.split(pkey, 3).numpy(),
        np.asarray(jax.random.split(key, 3)).astype(np.int64))


def test_stratified_pixels_match_jax():
    """The port's minibatch pixels are the JAX package's, step by step
    (its stratified_pixels closure, restated over jax.random)."""
    n_pix, mb = 576, 64
    stride = n_pix // mb
    for step in range(12):
        key = jax.random.fold_in(jax.random.PRNGKey(0x0F17), step)
        want = (np.arange(mb) * stride
                + np.asarray(jax.random.randint(key, (mb,), 0, stride)))
        got = optimize.stratified_pixels(n_pix, mb, step, "cpu").numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        optimize.stratified_pixels(n_pix, n_pix, 3, "cpu").numpy(),
        np.arange(n_pix))


def test_adam_step_matches_optax():
    """torch.optim.Adam with optax.adam's defaults: one step from a given
    gradient moves each parameter by optax's update to rtol 1e-5. The two
    round apart: optax forms 1 - 0.999^t in float32 (1.3e-5 off at t =
    1), PyTorch in double, so an update differs by up to 6.4e-6 of itself
    (ROADMAP Queue 3, recorded); on the parameters that is up to 3.6e-7,
    more than rtol 1e-6 of a parameter below 0.36."""
    import optax
    g = np.random.default_rng(3)
    p0 = g.normal(size=(64, 3)).astype(np.float32)
    grad = g.normal(size=(64, 3)).astype(np.float32)
    tx = optax.adam(0.05)
    upd, _ = tx.update(jnp.asarray(grad), tx.init(jnp.asarray(p0)))
    pt = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([pt], lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    pt.grad = torch.from_numpy(grad)
    opt.step()
    step = pt.detach().double().numpy() - p0.astype(np.float64)
    np.testing.assert_allclose(step, np.asarray(upd), rtol=1e-5)
    np.testing.assert_allclose(pt.detach().numpy(),
                               np.asarray(optax.apply_updates(
                                   jnp.asarray(p0), upd)), atol=4e-7)


def test_lockstep_history_matches_jax(target, tmp_path):
    """run_optimization(method="lockstep") at 24^2, 1 bounce, 1 spp, 10
    steps, lr 0.05: the port's loss history is JAX's within rtol 1e-3,
    and both write loss_history.npy and opt_kd.npy."""
    path, js, ps, _ = target
    kw = dict(steps=10, lr=0.05, spp=1, checkpoint_every=0, log_every=100,
              method="lockstep")
    dj, hj = joptimize.run_optimization(js, path, out_dir=str(
        tmp_path / "jax"), **kw)
    dp, hp = optimize.run_optimization(ps, path, out_dir=str(
        tmp_path / "port"), **kw)
    assert len(hp) == 10 and hp[-1] < hp[0]
    np.testing.assert_allclose(hp, hj, rtol=1e-3)
    np.testing.assert_allclose(dp["kd"].numpy(), np.asarray(dj["kd"]),
                               rtol=1e-3)
    for d in ("jax", "port"):
        for name in ("loss_history.npy", "opt_kd.npy"):
            assert os.path.exists(tmp_path / d / name)


def test_minibatch_recovers_kd(target, tmp_path):
    """tests/test_optimize.py::test_optimize_minibatch_recovers_kd on the
    port: stratified minibatches, the paired-sample loss and the spp
    schedule bring kd within 0.35 of its first error."""
    path, _, ps, kd_true = target
    err0 = float((ps.scene.materials.kd - kd_true).abs().max())
    diff, hist = optimize.run_optimization(
        ps, path, steps=40, lr=0.05, spp=4, minibatch=64,
        out_dir=str(tmp_path / "mb"), checkpoint_every=0, log_every=100)
    err1 = float((diff["kd"] - kd_true).abs().max())
    assert err1 < err0 * 0.35, (err0, err1)


def test_resume_merges_history(target, tmp_path):
    """A run checkpointing every 3 steps, then a longer run on the same
    out_dir: it resumes after the last checkpoint (the diff tensors and
    Adam's state) and returns the merged history, as the JAX package's
    orbax resume does."""
    path, _, ps, _ = target
    out = str(tmp_path / "opt")
    kw = dict(lr=0.05, spp=1, out_dir=out, checkpoint_every=3,
              log_every=100)
    d1, h1 = optimize.run_optimization(ps, path, steps=6, **kw)
    assert os.path.exists(os.path.join(out, "ckpt", optimize.CKPT_NAME))
    d2, h2 = optimize.run_optimization(ps, path, steps=8, **kw)
    assert len(h2) == 8 and h2[:6] == h1
    d3, h3 = optimize.run_optimization(ps, path, steps=8, resume=False,
                                       **kw)
    np.testing.assert_allclose(h3, h2, rtol=1e-6)
    np.testing.assert_allclose(d3["kd"].numpy(), d2["kd"].numpy(),
                               rtol=1e-6)


def test_stream_method_lowers_loss(target, tmp_path):
    """run_optimization(method="stream") (plan, radiance pass, weighted
    fold, the re-plan guard) lowers the loss as the lockstep does."""
    path, _, ps, _ = target
    diff, hist = optimize.run_optimization(
        ps, path, steps=15, lr=0.05, spp=2, minibatch=128,
        out_dir=str(tmp_path / "s"), checkpoint_every=0, log_every=100,
        method="stream")
    assert len(hist) == 15 and hist[-1] < hist[0]
    assert np.isfinite(hist).all()
