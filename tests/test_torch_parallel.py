"""The port's data parallelism (fluctus_tpu_torch/parallel/) against the
JAX package's, as tests/test_parallel.py runs it: JAX on the 8 virtual
CPU devices of tests/conftest.py, the port on a mesh of 8 CPU shards, both
on the env-lit plane of tests/test_integrator.py::plane_session carried
across with tests/torch_common.py::port_session.

Tolerances: images rtol 1e-5 / atol 1e-6 (XLA contracts FMAs, the port
rounds each op; the sharded stream also sums a pixel's samples in another
order than the whole-frame stream); per-shard counters exactly; losses
rtol 1e-5, kd rtol 1e-4 / atol 1e-7 (tests/test_parallel.py's). Across
the port's own forms (a mesh against none, ranks against the in-process
mesh) the lockstep image is bit-equal and gradients agree to rtol 1e-6.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from fluctus_tpu.integrators import wavefront as jwavefront
from fluctus_tpu.parallel import mesh as jmesh
from fluctus_tpu_torch import fixtures
from fluctus_tpu_torch.integrators import lockstep, wavefront
from fluctus_tpu_torch.parallel import distributed, mesh as pmesh

from test_integrator import plane_session
from torch_common import port_session

IMG_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sessions(size=24, max_bounces=2):
    """(JAX scene, params, cfg) of the plane at size^2 and the port's."""
    scene, params, cfg = plane_session(max_bounces=max_bounces)
    cfg = cfg.replace(width=size, height=size)
    return (scene, params, cfg), port_session(scene, params, cfg)


def cpu_mesh(n=8):
    return pmesh.make_mesh(["cpu"] * n)


def test_make_mesh_orders_shards():
    m = cpu_mesh(3)
    assert m.size == 3 and m.local == 3 and m.world == 1
    assert [m.shard(i) for i in range(3)] == [0, 1, 2]
    assert pmesh.Mesh(m.devices, rank=2, world=4).shard(1) == 7
    assert [pmesh.stripe(23 * 23, m, d) for d in range(3)] == [
        (0, 177), (177, 354), (354, 531)]
    distributed.initialize(None, 1, 0)        # one process: a no-op
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("size", [24, 23])
def test_render_sharded_matches_jax(size):
    (js, jp, jc), (s, p, c) = sessions(size)
    want = jmesh.render_sharded(js, jp, jc, 2,
                                jmesh.make_mesh(jax.devices()[:8]))
    got = pmesh.render_sharded(s, p, c, 2, cpu_mesh())
    assert got.shape == (size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMG_TOL)
    # the stripes sum each pixel's samples as the whole frame does
    assert torch.equal(got, lockstep.render(s, p, c, 2))


@pytest.mark.parametrize("size", [24, 23])
def test_render_stream_sharded_matches_jax(size):
    (js, jp, jc), (s, p, c) = sessions(size)
    want, wc = jmesh.render_stream_sharded(
        js, jp, jc, 2, jmesh.make_mesh(jax.devices()[:8]))
    got, gc = pmesh.render_stream_sharded(s, p, c, 2, cpu_mesh())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMG_TOL)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc, np.int64))
    n_loc = -(-size * size // 8)
    assert int(gc[:, 0].sum()) == n_loc * 8 * 2
    single, _ = wavefront.render_stream(s, p, c, 2)
    np.testing.assert_allclose(got.numpy(), single.numpy(), **IMG_TOL)


def test_one_shard_stream_is_the_single_device_stream():
    """With one shard the stripe is the frame, so the shard parameters at
    pix_base 0 leave the stream bit-equal to render_stream."""
    _, (s, p, c) = sessions(23)
    img, counters = wavefront.render_stream(s, p, c, 2)
    got, gc = pmesh.render_stream_sharded(s, p, c, 2, cpu_mesh(1))
    assert torch.equal(got, img) and torch.equal(gc[0], counters)
    st, ct = wavefront.init_stream_state(p, c, 64)
    st2, ct2 = wavefront.init_stream_state(p, c, 64, pix_base=0,
                                           n_pix_local=23 * 23)
    assert torch.equal(st.pixel_index, st2.pixel_index)
    assert torch.equal(st.dir, st2.dir) and torch.equal(ct, ct2)


def grad_inputs(jc):
    n = jc.width * jc.height
    return (jnp.arange(n, dtype=jnp.uint32), jnp.zeros((n, 3), jnp.float32),
            torch.arange(n), torch.zeros(n, 3))


def test_grad_step_mesh_matches_jax():
    (js, jp, jc), (s, p, c) = sessions(max_bounces=1)
    jidx, jtgt, idx, tgt = grad_inputs(jc)
    m = jmesh.make_mesh(jax.devices()[:8])
    s8, p8 = jmesh.place(js, jp, m)
    jl, jn = jmesh.grad_step(
        jax.device_put({"kd": js.materials.kd}, jmesh.replicated(m)), s8, p8,
        jc, jax.device_put(jidx, jmesh.ray_sharded(m)), jnp.uint32(0),
        jax.device_put(jtgt, jmesh.ray_sharded(m)))
    diff = {"kd": s.materials.kd}
    loss, new = pmesh.grad_step(diff, s, p, c, idx, 0, tgt, mesh=cpu_mesh())
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(new["kd"].numpy(), np.asarray(jn["kd"]),
                               rtol=1e-5)
    loss1, new1 = pmesh.grad_step(diff, s, p, c, idx, 0, tgt)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-6)
    np.testing.assert_allclose(new["kd"].numpy(), new1["kd"].numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="equal stripes"):
        pmesh.grad_step(diff, s, p, c, idx[:-1], 0, tgt[:-1],
                        mesh=cpu_mesh())


def test_grad_step_stream_matches_jax():
    (js, jp, jc), (s, p, c) = sessions(max_bounces=1)
    jidx, jtgt, idx, tgt = grad_inputs(jc)
    n = idx.shape[0]
    m = jmesh.make_mesh(jax.devices()[:8])
    s8, p8 = jmesh.place(js, jp, m)
    k, _ = jwavefront.plan_stream_segments(
        js, jp, jc, jnp.arange(n // 8, dtype=jnp.uint32), jnp.uint32(0), 128,
        deferred=True)
    # jitted, so that JAX compiles the shard_map once instead of running
    # the stream's scan op by op
    step = jax.jit(jmesh.grad_step_stream, static_argnames=(
        "cfg", "pool", "n_segments", "mesh"))
    jl, jn, jnd = step(
        {"kd": js.materials.kd}, s8, p8, jc,
        jax.device_put(jidx, jmesh.ray_sharded(m)), jnp.uint32(0),
        jax.device_put(jtgt, jmesh.ray_sharded(m)), pool=128,
        n_segments=int(k) + 2, mesh=m)
    loss, new, nd = pmesh.grad_step_stream(
        {"kd": s.materials.kd}, s, p, c, idx, 0, tgt, 128, int(k) + 2,
        cpu_mesh())
    assert int(nd) == int(jnd) == n
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(new["kd"].numpy(), np.asarray(jn["kd"]),
                               rtol=1e-4, atol=1e-7)
    # and JAX's unsharded lockstep step, as tests/test_parallel.py holds
    jl1, jn1 = jmesh.grad_step({"kd": js.materials.kd}, js, jp, jc, jidx,
                               jnp.uint32(0), jtgt)
    np.testing.assert_allclose(float(loss), float(jl1), rtol=1e-5)
    np.testing.assert_allclose(new["kd"].numpy(), np.asarray(jn1["kd"]),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("integrator", ["lockstep", "stream"])
def test_scaling_benchmark(integrator):
    _, (s, p, c) = sessions()
    res = distributed.scaling_benchmark(s, p, c, spp=2,
                                        device_counts=[1, 2, 4],
                                        integrator=integrator,
                                        devices=["cpu"] * 4)
    assert [r["devices"] for r in res] == [1, 2, 4]
    assert all(r["mrays_s"] > 0 and r["wall_s"] > 0 for r in res)
    assert res[0]["efficiency"] == 1.0
    assert all(0.0 < r["shard_ray_balance"] <= 1.0 for r in res)
    if integrator == "lockstep":
        assert all(r["shard_ray_balance"] == 1.0 for r in res)


def test_scaling_benchmark_refuses_a_replicated_layout(monkeypatch):
    """A layout that gives every shard the whole frame must fail the
    partition assert before anything is timed."""
    _, (s, p, c) = sessions()
    monkeypatch.setattr(pmesh, "stripe",
                        lambda n, mesh, d: (0, n + (-n) % mesh.size))
    with pytest.raises(AssertionError, match="not partitioned"):
        distributed.scaling_benchmark(s, p, c, spp=1, device_counts=[2],
                                      devices=["cpu"] * 2)


def test_gloo_ranks_match_the_in_process_mesh(tmp_path):
    """Two spawned ranks in a gloo group (file:// rendezvous), one CPU
    shard each, against the in-process 2-shard mesh on the same spec:
    the all-gathered image bit-equal, the all-reduced stream step's loss
    and leaves within rtol 1e-6."""
    spec = {"device": "cpu", "scene": None, "size": 24, "max_bounces": 1,
            "spp": 2, "grad_rays": 576, "leaves": ["kd", "env_strength"],
            "pool": 128}
    out = str(tmp_path / "rank0.pt")
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mp.spawn(fixtures.rank_worker, nprocs=2, args=(
            2, f"file://{tmp_path / 'rendezvous'}", out, spec))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    got = torch.load(out)
    want = fixtures.sharded_run(fixtures.rank_session(spec), spec,
                                cpu_mesh(2))
    assert got["mesh_size"] == 2 and int(got["n_done"]) == 576
    assert torch.equal(got["img"], want["img"])
    for k in ("loss", "kd", "env_strength"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6)
