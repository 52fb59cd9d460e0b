"""Gradients of the port against the JAX package's on the same inputs:
`parallel/mesh.py::loss_fn` (the checkpointed lockstep), the stream's loss
half (`stream_loss`, `stream_loss_deferred`, `stream_radiance`,
`plan_stream_segments`), the finite-difference checks of
tests/test_gradients.py on the port's own gradient, the optimizer's
weighted-fold construction, and the tape: no traversal runs in a
backward.

Scenes: tests/test_integrator.py::plane_session (env-lit Lambertian plane),
tests/test_gradients.py::_camera_grad_session (tilted camera, area light by
NEE only) and the glossy plane of test_fd_gradient_ni_glossy, carried to
the port with tests/torch_common.py::port_session. Tolerances: the
material and env leaves rtol 1e-4 / atol 1e-6; the camera leaves rtol
1e-3 / atol 1e-5 (XLA approximates tan and rsqrt on the CPU, the port
rounds each op)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluctus_tpu.integrators import lockstep as jlockstep
from fluctus_tpu.integrators import wavefront as jwavefront
from fluctus_tpu.parallel import mesh as jmesh
from fluctus_tpu_torch.convert import diff_from_numpy, diff_to_numpy
from fluctus_tpu_torch.integrators import common, lockstep, wavefront
from fluctus_tpu_torch.ops import traverse_stack
from fluctus_tpu_torch.parallel import mesh

from test_gradients import _camera_grad_session
from test_integrator import plane_session
from torch_common import port_session

MAT_TOL = dict(rtol=1e-4, atol=1e-6)
CAM_TOL = dict(rtol=1e-3, atol=1e-5)
STREAM_TOL = dict(rtol=2e-4, atol=1e-7)


def glossy_session():
    """The glossy plane of test_fd_gradient_ni_glossy (JAX side)."""
    from fluctus_tpu.core.types import BXDF_GLOSSY, RenderConfig
    from fluctus_tpu.core.types import default_params
    from fluctus_tpu.scene.loaders.obj import MtlMaterial
    from helpers import big_quad, make_host_scene

    v0, v1, v2 = big_quad(y=0.0, half=500.0)
    glossy = MtlMaterial(name="g", kd=(0.4, 0.4, 0.4), ks=(0.3, 0.3, 0.3),
                         ns=120.0, ni=1.6, bsdf_type=BXDF_GLOSSY)
    host = make_host_scene(v0, v1, v2, materials=[glossy],
                           env_image=np.full((32, 64, 3), 1.0, np.float32))
    host.build_bvh(cache_dir=None, use_sbvh=False)
    cfg = RenderConfig(width=24, height=24, max_bounces=1,
                       sample_impl=False,
                       bsdf_types_mask=host.material_types_mask)
    params = default_params(world_radius=host.world_radius())
    cam = params.camera.replace(
        pos=jnp.array([0.0, 3.0, 0.0], jnp.float32),
        dir=jnp.array([0.0, -1.0, 0.0], jnp.float32),
        up=jnp.array([0.0, 0.0, -1.0], jnp.float32),
        right=jnp.array([1.0, 0.0, 0.0], jnp.float32))
    return host.to_device(), params.replace(camera=cam), cfg


def camera_dof_session():
    """_camera_grad_session with the thin lens open (aperture 0.02), as in
    test_fd_gradient_camera_focal_aperture."""
    scene, params, cfg = _camera_grad_session()
    cam = params.camera.replace(aperture_size=jnp.float32(0.02),
                                focal_dist=jnp.float32(2.5))
    return scene, params.replace(camera=cam), cfg


# session -> (builder, the leaves of diff_params)
SESSIONS = {
    "plane": (lambda: plane_session(max_bounces=1),
              ("kd", "env_image", "env_strength")),
    "glossy": (glossy_session, ("ni",)),
    "camera": (camera_dof_session,
               ("kd", "cam_pos", "cam_fov", "cam_aperture_size",
                "cam_focal_dist")),
}
CASES = [(s, leaf) for s, (_, leaves) in SESSIONS.items() for leaf in leaves]
_GETTERS = {
    "kd": lambda s, p: s.materials.kd, "ni": lambda s, p: s.materials.ni,
    "env_image": lambda s, p: s.envmap.image,
    "env_strength": lambda s, p: p.env_strength,
    "cam_pos": lambda s, p: p.camera.pos,
    "cam_fov": lambda s, p: p.camera.fov,
    "cam_aperture_size": lambda s, p: p.camera.aperture_size,
    "cam_focal_dist": lambda s, p: p.camera.focal_dist}

_cache = {}


def loss_grads(session: str):
    """(JAX loss, JAX grads, port loss, port grads) of loss_fn over every
    pixel at sample 0 against a constant target, once per session."""
    if session not in _cache:
        build, leaves = SESSIONS[session]
        js, jp, jc = build()
        n = jc.width * jc.height
        pix = jnp.arange(n, dtype=jnp.uint32)
        target = np.full((n, 3), 0.1, np.float32)
        dj = {k: _GETTERS[k](js, jp) for k in leaves}
        lj, gj = jax.value_and_grad(jmesh.loss_fn)(
            dj, js, jp, jc, pix, jnp.uint32(0), jnp.asarray(target))
        s, p, c = port_session(js, jp, jc)
        dp = diff_from_numpy({k: np.asarray(v) for k, v in dj.items()},
                             "cpu")
        lp, gp = mesh.value_and_grad(mesh.loss_fn, dp, s, p, c,
                                     torch.arange(n), 0,
                                     torch.from_numpy(target))
        _cache[session] = (float(lj), {k: np.asarray(v)
                                       for k, v in gj.items()},
                           float(lp), diff_to_numpy(gp))
    return _cache[session]


@pytest.mark.parametrize("session,leaf", CASES,
                         ids=[f"{s}-{k}" for s, k in CASES])
def test_loss_fn_gradient_matches_jax(session, leaf):
    lj, gj, lp, gp = loss_grads(session)
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    assert np.isfinite(gp[leaf]).all()
    assert np.abs(gj[leaf]).sum() > 0.0
    tol = CAM_TOL if leaf.startswith("cam_") else MAT_TOL
    np.testing.assert_allclose(gp[leaf], gj[leaf], **tol)


# ------------------------------------------------ the port's own gradient

def _mean(scene, params, cfg, spp=2):
    n = cfg.width * cfg.height
    pix = torch.arange(n)
    return sum(lockstep.sample_radiance(scene, params, cfg, pix, k).mean()
               for k in range(spp)) / spp


def _fd_case(name):
    """(f(x) on the port, x0, h, rtol, atol) for the FD checks of
    tests/test_gradients.py."""
    if name in ("kd", "env_emission", "env_strength"):
        s, p, c = port_session(*plane_session(max_bounces=1))

        def f(x):
            if name == "kd":
                m = dataclasses.replace(s.materials, kd=s.materials.kd * x)
                return _mean(dataclasses.replace(s, materials=m), p, c)
            if name == "env_emission":
                e = dataclasses.replace(s.envmap, image=s.envmap.image * x)
                return _mean(dataclasses.replace(s, envmap=e), p, c)
            return _mean(s, dataclasses.replace(p, env_strength=x), c)
        return f, torch.tensor(1.0), 1e-2, 2e-2, 0.0
    if name == "ni":
        s, p, c = port_session(*glossy_session())

        def f(x):
            m = dataclasses.replace(s.materials, ni=s.materials.ni * x)
            return _mean(dataclasses.replace(s, materials=m), p, c, spp=1)
        return f, torch.tensor(1.0), 5e-3, 3e-2, 1e-5
    s, p, c = port_session(*camera_dof_session())
    field, x0, h, atol = {
        "cam_fov": ("fov", torch.tensor(60.0), 0.5, 1e-5),
        "cam_pos": ("pos", torch.tensor([0.0, 3.0, 0.0]), 1e-2, 2e-4),
        "cam_aperture_size": ("aperture_size", torch.tensor(0.02), 1e-3,
                              1e-4),
        "cam_focal_dist": ("focal_dist", torch.tensor(2.5), 1e-3, 1e-4)}[name]

    def f(x):
        cam = dataclasses.replace(p.camera, **{field: x})
        return _mean(s, dataclasses.replace(p, camera=cam), c)
    return f, x0, h, 3e-2, atol


@pytest.mark.parametrize("name", ["kd", "env_emission", "env_strength", "ni",
                                  "cam_fov", "cam_pos", "cam_aperture_size",
                                  "cam_focal_dist"])
def test_port_gradient_passes_fd_check(name):
    """Central finite differences against the port's autograd, at the
    tolerances of tests/test_gradients.py."""
    f, x0, h, rtol, atol = _fd_case(name)
    x = x0.clone().requires_grad_(True)
    g, = torch.autograd.grad(f(x), x)
    assert float(g.abs().sum()) > 0.0
    with torch.no_grad():
        for axis in range(x0.numel()):
            e = torch.zeros_like(x0).reshape(-1)
            e[axis] = h
            e = e.reshape(x0.shape)
            fd = (f(x0 + e) - f(x0 - e)) / (2 * h)
            np.testing.assert_allclose(float(g.reshape(-1)[axis]), float(fd),
                                       rtol=rtol, atol=atol)


# ------------------------------------------------------------ the stream

N_RAYS, POOL = 256, 64


def _stream_inputs():
    js, jp, jc = plane_session(max_bounces=3)
    n_pix = jc.width * jc.height
    pix = jnp.arange(N_RAYS, dtype=jnp.uint32) * (n_pix // N_RAYS)
    target = np.full((N_RAYS, 3), 0.1, np.float32)
    return (js, jp, jc), port_session(js, jp, jc), pix, target


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["immediate", "deferred"])
def test_stream_loss_matches_jax(deferred):
    """stream_loss and stream_loss_deferred: JAX's segment count from
    plan_stream_segments exactly, JAX's value and kd gradient."""
    (js, jp, jc), (s, p, c), pix, target = _stream_inputs()
    tp = torch.from_numpy(np.asarray(pix).astype(np.int64))
    kj, dj = jwavefront.plan_stream_segments(js, jp, jc, pix, jnp.uint32(0),
                                             POOL, deferred=deferred)
    kp, dp = wavefront.plan_stream_segments(s, p, c, tp, 0, POOL,
                                            deferred=deferred)
    assert (kp, dp) == (int(kj), int(dj)) and dp == N_RAYS

    def lj(d):
        return jmesh.loss_fn_stream(d, js, jp, jc, pix, jnp.uint32(0),
                                    jnp.asarray(target), POOL, int(kj) + 2,
                                    deferred=deferred)
    (l_j, nd_j), g_j = jax.value_and_grad(lj, has_aux=True)(
        {"kd": js.materials.kd})
    (l_p, nd_p), g_p = mesh.value_and_grad(
        mesh.loss_fn_stream,
        diff_from_numpy({"kd": np.asarray(js.materials.kd)}, "cpu"), s, p,
        c, tp, 0, torch.from_numpy(target), POOL, kp + 2, deferred,
        has_aux=True)
    assert int(nd_p) == int(nd_j) == N_RAYS
    np.testing.assert_allclose(float(l_p), float(l_j), **STREAM_TOL)
    np.testing.assert_allclose(g_p["kd"].numpy(), np.asarray(g_j["kd"]),
                               **STREAM_TOL)


def test_stream_radiance_matches_jax():
    """Per-ray radiance over four samples of each listed pixel: the
    port's index_copy_ by ray id against JAX's sort of write-once rows."""
    (js, jp, jc), (s, p, c), pix, _ = _stream_inputs()
    pix2 = jnp.tile(pix, 4)
    samp = jnp.repeat(jnp.arange(4, dtype=jnp.uint32), N_RAYS)
    k, _ = jwavefront.plan_stream_segments(js, jp, jc, pix2, samp, POOL,
                                           deferred=True)
    rj, nj = jwavefront.stream_radiance(js, jp, jc, pix2, samp, POOL,
                                        int(k) + 1)
    rp, n_p = wavefront.stream_radiance(
        s, p, c, torch.from_numpy(np.asarray(pix2).astype(np.int64)),
        torch.from_numpy(np.asarray(samp).astype(np.int64)), POOL,
        int(k) + 1)
    assert int(n_p) == int(nj) == 4 * N_RAYS
    assert float(rp.abs().sum()) > 0.0
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=1e-5,
                               atol=1e-7)


def test_stream_step_weighted_fold_matches_lockstep_pair():
    """The stream optimizer step's gradient (weights from a forward
    stream_radiance pass, folded through the weighted deferred
    stream_loss) equals the gradient of the lockstep paired-sample loss,
    as tests/test_optimize.py::test_stream_step_gradient_matches_lockstep_pair
    holds it in JAX."""
    from fluctus_tpu_torch.render import optimize

    s, p, c = port_session(*plane_session(max_bounces=1))
    n_pix = c.width * c.height
    mb, spp = 64, 2
    pix = torch.arange(mb) * (n_pix // mb)
    target = torch.full((n_pix, 3), 0.2)
    diff = {"kd": s.materials.kd.clone()}
    l_ref, g_ref = optimize.lockstep_grad(diff, s, p, c, pix, target, 0,
                                          spp)
    pix2 = pix.repeat(2 * spp)
    samp = torch.arange(2 * spp).repeat_interleave(mb)
    k, drained = wavefront.plan_stream_segments(s, p, c, pix2, samp, 256,
                                                deferred=True)
    assert drained == 2 * spp * mb
    l_st, g_st, nd, n_total = optimize.stream_grad(
        diff, s, p, c, pix, target, 0, spp, k + 1, 256)
    assert nd == n_total == 2 * spp * mb
    np.testing.assert_allclose(float(l_st), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(g_st["kd"].numpy(), g_ref["kd"].numpy(),
                               rtol=1e-4, atol=1e-7)


# ------------------------------------------------------------ the tape

def _counting(monkeypatch):
    """Count the calls of the plain traversals (K1's plain versions on
    these CPU scenes); the count list is [closest, any]."""
    calls = [0, 0]
    closest, any_ = traverse_stack.traverse_closest, \
        traverse_stack.traverse_any

    def c(*a, **k):
        assert not any(isinstance(x, torch.Tensor) and x.requires_grad
                       for x in a)
        calls[0] += 1
        return closest(*a, **k)

    def y(*a, **k):
        assert not any(isinstance(x, torch.Tensor) and x.requires_grad
                       for x in a)
        calls[1] += 1
        return any_(*a, **k)
    monkeypatch.setattr(traverse_stack, "traverse_closest", c)
    monkeypatch.setattr(traverse_stack, "traverse_any", y)
    return calls


def test_six_bounce_backward_launches_no_traversal(monkeypatch):
    """tests/test_gradients.py::test_grad_memory_path_replay on the port:
    6 bounces (max_bounces 5) forward, then the backward, which replays
    the tape and calls no traversal; the stream's loss likewise."""
    s, p, c = port_session(*plane_session(max_bounces=5))
    calls = _counting(monkeypatch)
    kd = s.materials.kd.clone().requires_grad_(True)
    sg = dataclasses.replace(
        s, materials=dataclasses.replace(s.materials, kd=kd))
    loss = lockstep.sample_radiance(sg, p, c, torch.arange(576), 0).mean()
    fwd = list(calls)
    assert fwd[0] > 0 and fwd[1] > 0
    g, = torch.autograd.grad(loss, kd)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0
    assert calls == fwd, "the backward traced"

    pix = torch.arange(256) * 2
    wl, nd = wavefront.stream_loss_deferred(
        sg, p, c, pix, 0, torch.full((256, 3), 0.1), 64, 64)
    fwd = list(calls)
    g, = torch.autograd.grad(wl, kd)
    assert int(nd) == 256 and float(g.abs().sum()) > 0.0
    assert calls == fwd, "the stream's backward traced"


def test_forward_only_takes_no_checkpoint(monkeypatch):
    """Renders where nothing requires grad run no checkpoint and no tape;
    where a leaf requires grad every bounce is checkpointed."""
    s, p, c = port_session(*plane_session(max_bounces=2))
    n = []

    def count(body, *args):
        n.append(1)
        return body(*args)
    monkeypatch.setattr(common, "checkpointed", count)
    lockstep.render(s, p, c, 1)
    wavefront.render_stream(s, p, c.replace(pool_size=256), 1)
    assert not n
    kd = s.materials.kd.clone().requires_grad_(True)
    sg = dataclasses.replace(
        s, materials=dataclasses.replace(s.materials, kd=kd))
    lockstep.sample_radiance(sg, p, c, torch.arange(64), 0)
    bounces = len(n)
    assert bounces >= 2       # the camera ray's vertex and the sky bounce
    with torch.no_grad():
        lockstep.sample_radiance(sg, p, c, torch.arange(64), 0)
    assert len(n) == bounces


def test_hit_from_traversal_carries_camera_gradients(monkeypatch):
    """The traversal sees detached rays and its result is a constant;
    t, u, v and the hit point are recomputed from the rays as given and
    carry their gradient."""
    s, p, c = port_session(*plane_session(max_bounces=1))
    calls = _counting(monkeypatch)
    o = torch.tensor([[0.1, 3.0, 0.2], [0.0, 3.0, 0.0]], requires_grad=True)
    d = torch.tensor([[0.0, -1.0, 0.0], [0.6, -0.8, 0.0]],
                     requires_grad=True)
    hit = common.trace_scene(s, p, c, o, d)
    assert calls[0] == 1
    assert hit.t.requires_grad and hit.p.requires_grad
    assert not hit.prim.requires_grad
    g_o, g_d = torch.autograd.grad(hit.t.sum(), (o, d))
    # t = -o.y / d.y on the plane y = 0
    np.testing.assert_allclose(g_o[:, 1].numpy(), [1.0, 1.25], rtol=1e-6)
    np.testing.assert_allclose(g_d[:, 1].numpy(), [3.0, 3.0 / 0.64],
                               rtol=1e-5)
