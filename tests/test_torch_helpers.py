"""The port's last public helpers against the JAX package's, on seeded
inputs: the RNG's uniform2 and uniform4, empty_hit, the BSDF constants
and samplers.PI, the yaw/pitch camera basis and the NumPy brute-force
oracle bit for bit; Schlick's and the conductor Fresnel terms within one
float32 ulp (the port rounds its square roots correctly and forms the
fifth power as XLA does, so they are bit-equal on these inputs); the native
builder's `available` and build stats as JAX reports them; and one
stream segment (`wavefront.stream_iteration`) on the cornell at JAX's
stream tolerance."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops; one thread each keeps the test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b):
    """float32 ulps between a and b, elementwise."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _counters(n=4096, seed=0):
    g = np.random.default_rng(seed)
    return [g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(4)]


def _uniforms(k):
    import jax.numpy as jnp

    from fluctus_tpu.core import rng as jrng
    from fluctus_tpu_torch.core import rng
    c = _counters(seed=k)
    want = getattr(jrng, f"uniform{k}")(*(jnp.asarray(x) for x in c))
    got = getattr(rng, f"uniform{k}")(
        *(torch.from_numpy(x.astype(np.int64)) for x in c))
    assert len(got) == len(want) == k
    for g_, w in zip(got, want):
        assert g_.dtype == torch.float32
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


def _empty_hit():
    from fluctus_tpu.core.types import empty_hit as jax_empty
    from fluctus_tpu_torch.core.types import empty_hit
    for shape, kw in (((5,), {}), ((2, 3), dict(t_max=7.5))):
        want, got = jax_empty(shape, **kw), empty_hit(shape, **kw)
        for f in ("t", "prim", "p", "n", "uv", "mat_id", "area_light"):
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _constants():
    from fluctus_tpu.core import samplers as jsamplers
    from fluctus_tpu.core import types as jtypes
    from fluctus_tpu_torch.core import samplers, types
    assert types.BXDF_SINGULAR_MASK == jtypes.BXDF_SINGULAR_MASK
    assert types.NUM_BSDF_TYPES == jtypes.NUM_BSDF_TYPES == 7
    assert np.float32(samplers.PI) == np.float32(jsamplers.PI)
    assert np.float32(samplers.PI).tobytes() == \
        np.asarray(jsamplers.PI).tobytes()


def _camera_basis():
    from fluctus_tpu.ops.camera import camera_basis_from_rotation as jax_cb
    from fluctus_tpu_torch.ops.camera import camera_basis_from_rotation
    g = np.random.default_rng(2)
    for yaw, pitch in [(0, 0), (90, 0), (-45, 30)] + [
            tuple(g.uniform(-180, 180, 2)) for _ in range(8)]:
        for kw in ({}, dict(world_right=(1.0, 0.2, 0.0),
                            world_up=(0.0, 1.0, 0.3))):
            got = camera_basis_from_rotation(yaw, pitch, **kw)
            want = jax_cb(yaw, pitch, **kw)
            for a, b in zip(got, want):
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _fresnel(name):
    import jax.numpy as jnp

    from fluctus_tpu.ops import fresnel as jf
    from fluctus_tpu_torch.ops import fresnel
    g = np.random.default_rng(3)
    n = 4096
    cos_i = g.uniform(-1, 1, n).astype(np.float32)
    cos_i[:4] = (0.0, 1.0, -1.0, 1e-7)
    eta_i = g.uniform(1.0, 1.8, n).astype(np.float32)
    eta_t = g.uniform(1.0, 1.8, n).astype(np.float32)
    if name == "schlick":
        args = (cos_i, eta_i, eta_t)
        want = jf.schlick_dielectric(*(jnp.asarray(a) for a in args))
        got = fresnel.schlick_dielectric(*(torch.from_numpy(a)
                                           for a in args))
    else:
        eta3 = g.uniform(0.1, 3.0, (n, 3)).astype(np.float32)
        k3 = g.uniform(0.0, 5.0, (n, 3)).astype(np.float32)
        args = (cos_i, eta_i[:, None].repeat(3, 1), eta3, k3)
        want = jf.fresnel_conductor(*(jnp.asarray(a) for a in args))
        got = fresnel.fresnel_conductor(*(torch.from_numpy(a)
                                          for a in args))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), np.asarray(want)).max() <= 1


def _oracle(which):
    from fluctus_tpu.accel import cpu_ref as jref
    from fluctus_tpu_torch.accel import cpu_ref
    g = np.random.default_rng(4)
    m, b = 300, 500
    v0 = g.uniform(-1, 1, (m, 3))
    v1 = v0 + g.uniform(-0.3, 0.3, (m, 3))
    v2 = v0 + g.uniform(-0.3, 0.3, (m, 3))
    o = g.uniform(-2, 2, (b, 3))
    d = g.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = g.uniform(0.1, 3.0, b)
    if which == "closest":
        for kw in ({}, dict(t_max=1.5)):
            got = cpu_ref.intersect_closest(v0, v1, v2, o, d, **kw)
            for a, w in zip(got, jref.intersect_closest(v0, v1, v2, o, d,
                                                        **kw)):
                assert a.dtype == w.dtype
                np.testing.assert_array_equal(a, w)
        assert (cpu_ref.intersect_closest(v0, v1, v2, o, d)[1] >= 0).any()
    else:
        got = cpu_ref.intersect_any(v0, v1, v2, o, d, t)
        np.testing.assert_array_equal(
            got, jref.intersect_any(v0, v1, v2, o, d, t))
        assert 0 < got.sum() < b


def _native(capsys, monkeypatch):
    from fluctus_tpu.accel import native as jnative
    from fluctus_tpu_torch.accel import native
    from fluctus_tpu_torch.scene.scene import load_scene
    assert native.available() is True
    assert jnative.available() is True
    host = load_scene("assets/cornell_proxy.obj")
    v0, v1, v2 = (np.asarray(a, np.float32) for a in (host.v0, host.v1,
                                                       host.v2))
    monkeypatch.setenv("FLUCTUS_BUILD_STATS", "1")
    for spatial in (False, True):
        capsys.readouterr()
        want = jnative.build_native(v0, v1, v2, 4, 64, 1e-5, spatial)
        jax_out = capsys.readouterr().out
        got = native.build_native(v0, v1, v2, 4, 64, 1e-5, spatial)
        assert got.stats == want.stats
        assert capsys.readouterr().out == jax_out
        assert ("[sbvh]" in jax_out) == spatial
    monkeypatch.setattr(native, "get_lib", lambda: (_ for _ in ()).throw(
        RuntimeError("no compiler")))
    assert native.available() is False


def _stream_iteration():
    from fluctus_tpu.integrators import wavefront as jwf
    from fluctus_tpu_torch.integrators import wavefront
    from test_torch_stream import ATOL, RTOL, _pair
    js, scene, params, cfg = _pair("cornell")
    pool, spp = 300, 2
    jstate, jcnt = jwf.init_stream_state(js.params, js.cfg, pool)
    state, cnt = wavefront.init_stream_state(params, cfg, pool)
    jstate, jcnt, jrow = jwf.stream_iteration(js.scene, js.params, js.cfg,
                                              jstate, jcnt, spp)
    state, cnt, row = wavefront.stream_iteration(scene, params, cfg, state,
                                                 cnt, spp)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert int(cnt[1]) > 0
    for f in ("orig", "dir", "throughput", "radiance"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    for f in ("pixel_index", "sample_index", "path_len", "alive"):
        np.testing.assert_array_equal(
            getattr(state, f).numpy().astype(np.int64),
            np.asarray(getattr(jstate, f)).astype(np.int64), err_msg=f)
    got = [np.asarray(r) for r in row]
    want = [np.asarray(r) for r in (jrow if isinstance(jrow, tuple)
                                    else (jrow,))]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64))
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


HELPERS = {
    "rng.uniform2": lambda **_: _uniforms(2),
    "rng.uniform4": lambda **_: _uniforms(4),
    "types.empty_hit": lambda **_: _empty_hit(),
    "types and samplers constants": lambda **_: _constants(),
    "camera.camera_basis_from_rotation": lambda **_: _camera_basis(),
    "fresnel.schlick_dielectric": lambda **_: _fresnel("schlick"),
    "fresnel.fresnel_conductor": lambda **_: _fresnel("conductor"),
    "cpu_ref.intersect_closest": lambda **_: _oracle("closest"),
    "cpu_ref.intersect_any": lambda **_: _oracle("any"),
    "native.available and build stats": lambda capsys, monkeypatch, **_:
        _native(capsys, monkeypatch),
    "wavefront.stream_iteration": lambda **_: _stream_iteration(),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_helper_equals_jax(name, capsys, monkeypatch):
    HELPERS[name](capsys=capsys, monkeypatch=monkeypatch)
