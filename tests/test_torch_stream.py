"""Port parity of the streaming wavefront, the fused extension + shadow
call, the integrator choice, the benchmark harness and the probes P1 and
P2, against the JAX package on the same inputs.

Scenes are the in-repository cornell and kitchen proxies, area-lit (the
env-lit plane of the JAX `plane_session` helper is held in
tests/test_torch_envmap.py), carried across with convert.scene_from_numpy. The stream's counters
(spawns, extension rays, shadow rays) must equal JAX's exactly; images
agree within rtol 1e-4 / atol 1e-5 (the sample sums run in another
order, and XLA contracts multiply-adds into FMAs).

The stream is held against the lockstep integrator at atol 1e-5 with
next-event estimation off: then both trace the same paths with the same
random numbers. With it on they differ by design, in the JAX package as
in the port: the wavefront samples the light as the reference's
wf_logic.cl:272 does, with the light distance shortened by 0.995, which
moves the area light's solid-angle pdf by 1 %."""
import dataclasses
import functools
import importlib.util
import os
import types

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluctus_tpu.ops.traverse_brute as jtb
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.integrators import common as jcommon
from fluctus_tpu.integrators import wavefront as jwf
from fluctus_tpu.render import benchmark as jbm
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.convert import params_from_numpy, scene_from_numpy
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.integrators import common, lockstep, wavefront
from fluctus_tpu_torch.ops import probes
from fluctus_tpu_torch.ops import traverse_brute as tb
from fluctus_tpu_torch.ops import traverse_forest as tf
from fluctus_tpu_torch.ops import traverse_pallas as tp
from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.render import benchmark as bm
from fluctus_tpu_torch.render import driver

from golden_common import _cornell_light
from test_torch_brute import forests
from test_torch_forest import forests as treelet_forests
from torch_common import (REPO, assert_hits_match, cornell_light_torch,
                          params_arrays, scene_arrays)

RTOL, ATOL = 1e-4, 1e-5
POOL = 300            # smaller than the 32x32 image
SEG = 4               # segments per launch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops; one thread each keeps the test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interp(monkeypatch):
    orig_call = pl.pallas_call
    monkeypatch.setattr(
        jtb.pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))


@functools.lru_cache(maxsize=None)
def _pair(name, backend="wide"):
    """A JAX session at 32x32, 2 bounces, and the port's scene, params and
    config carried across from it."""
    jcfg = JaxConfig(width=32, height=32, max_bounces=2,
                     use_area_light=True, use_env_map=False,
                     pool_size=POOL, backend=backend)
    if name == "cornell":
        js = jax_driver.create_session(
            "assets/cornell_proxy.obj", env_map=None, cfg=jcfg,
            use_sbvh=True, cache_dir=None, state_dir=None)
        js.params = js.params.replace(area_light=_cornell_light())
    else:
        js = jax_driver.create_session(
            "assets/kitchen_proxy.obj", env_map=None, cfg=jcfg,
            use_sbvh=True, cache_dir=None, state_dir="data/states",
            auto_frame=False)
    scene = scene_from_numpy(scene_arrays(js.scene), device="cpu")
    params = params_from_numpy(params_arrays(js.params), device="cpu")
    cfg = RenderConfig(width=32, height=32, max_bounces=2,
                       use_area_light=True, use_env_map=False,
                       bsdf_types_mask=js.cfg.bsdf_types_mask,
                       pool_size=POOL)
    return js, scene, params, cfg


# ------------------------------------------------------------ the stream

@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_stream_matches_jax(name, deferred):
    js, scene, params, cfg = _pair(name)
    want, cnt_j = jwf.render_stream(js.scene, js.params, js.cfg, 2,
                                    segments_per_launch=SEG,
                                    deferred=deferred)
    ts.reset_counts()
    got, cnt = wavefront.render_stream(scene, params, cfg, 2,
                                       segments_per_launch=SEG,
                                       deferred=deferred)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert int(cnt[0]) == 32 * 32 * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # deferred: every shadow ray rides in the closest call
    assert ts.PLAIN_CALLS["closest"] > 0
    assert (ts.PLAIN_CALLS["any"] == 0) == deferred


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_stream_matches_lockstep_without_nee(name):
    _, scene, params, cfg = _pair(name)
    cfg = cfg.replace(sample_expl=False)
    img_l = lockstep.render(scene, params, cfg, 2)
    for deferred in (False, True):
        img_s, cnt = wavefront.render_stream(scene, params, cfg, 2,
                                             segments_per_launch=SEG,
                                             deferred=deferred)
        np.testing.assert_allclose(img_s.numpy(), img_l.numpy(), atol=1e-5)
        assert int(cnt[0]) == 32 * 32 * 2


def test_stream_deferred_matches_immediate_with_roulette():
    _, scene, params, cfg = _pair("kitchen")
    cfg = cfg.replace(use_roulette=True)
    img_i, cnt_i = wavefront.render_stream(scene, params, cfg, 2,
                                           segments_per_launch=SEG)
    img_d, cnt_d = wavefront.render_stream(scene, params, cfg, 2,
                                           segments_per_launch=SEG,
                                           deferred=True)
    np.testing.assert_allclose(img_d.numpy(), img_i.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(cnt_d, cnt_i)


def test_stream_roulette_keeps_exact_spp():
    """Roulette changes path lengths, not the spawn budget: every sample
    spawns once and drains (render_stream raises otherwise)."""
    _, scene, params, cfg = _pair("cornell")
    cfg = cfg.replace(use_roulette=True, max_bounces=1)
    img, cnt = wavefront.render_stream(scene, params, cfg, 4,
                                       segments_per_launch=SEG)
    assert int(cnt[0]) == 32 * 32 * 4
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0


def test_stream_refuses_env_map():
    """Env maps are ported, so the stream no longer refuses one: with the
    env map on beside the area light (the scene's 1x1 black map) it
    matches the JAX stream, counters exactly, the env map picked for half
    the NEE draws."""
    js, scene, params, cfg = _pair("cornell")
    want, cnt_j = jwf.render_stream(js.scene, js.params,
                                    js.cfg.replace(use_env_map=True), 1,
                                    segments_per_launch=SEG)
    got, cnt = wavefront.render_stream(scene, params,
                                       cfg.replace(use_env_map=True), 1,
                                       segments_per_launch=SEG)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bucket_rows_quantum_padding():
    """As tests/test_wavefront.py: pad to the launch quantum, never to a
    power of two; padding rows carry pixel -1."""
    q = 96
    rows = [torch.zeros(3 * q) for _ in range(3)] + [
        torch.zeros(3 * q, dtype=torch.int64)]
    assert wavefront.bucket_rows(rows, total=200, quantum=q)[0].shape[0] \
        == 3 * q
    out = wavefront.bucket_rows(rows, total=4 * q - 5, quantum=q)
    assert out[0].shape[0] == 4 * q
    assert int(out[3][-1]) == -1


def test_bin_rows_matches_jax():
    g = np.random.default_rng(3)
    n_pix, spp, extra = 50, 4, 77
    pix = np.concatenate([np.repeat(np.arange(n_pix), spp),
                          np.full(extra, -1)]).astype(np.int32)
    g.shuffle(pix)
    rgb = g.random((3, pix.shape[0])).astype(np.float32)
    img_j, n_j = jwf._bin_rows(tuple(jnp.asarray(c) for c in rgb)
                               + (jnp.asarray(pix),), n_pix, spp)
    img, n = wavefront._bin_rows(tuple(torch.from_numpy(c) for c in rgb)
                                 + (torch.from_numpy(pix).long(),),
                                 n_pix, spp)
    assert int(n) == int(n_j) == n_pix * spp
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=1e-6)


def test_scatter_reference_matches_jax():
    js, scene, params, cfg = _pair("cornell")
    jcfg = js.cfg.replace(pool_size=256)
    want = jwf.render_scatter_reference(js.scene, js.params, jcfg, 1)
    got = wavefront.render_scatter_reference(scene, params,
                                             cfg.replace(pool_size=256), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_wavefront_iteration_accounts_samples():
    """As tests/test_wavefront.py:41-55: the splatted weight equals the
    samples-done counter."""
    _, scene, params, cfg = _pair("cornell")
    cfg = cfg.replace(pool_size=512)
    n_pix = cfg.width * cfg.height
    state = wavefront.init_state(params, cfg)
    fb = torch.zeros((n_pix, 4))
    counters = torch.tensor([cfg.pool_size % n_pix,
                             (cfg.pool_size + n_pix - 1) // n_pix, 0])
    for _ in range(6):
        state, fb, counters = wavefront.wavefront_iteration(
            scene, params, cfg, state, fb, counters)
    assert int(fb[:, 3].sum()) == int(counters[2]) > 0


# ------------------------------------------------------------ fused call

def _probe_rays(js, n, seed):
    """Extension rays from inside the scene's bounds and shadow rays with
    per-lane lengths, from a seed."""
    g = np.random.default_rng(seed)
    lo, hi = js.host_scene.bounds()
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    so = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    sd = g.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    sl = g.uniform(0.0, float(np.linalg.norm(hi - lo)) * 0.5,
                   n).astype(np.float32)
    return o, d, so, sd, sl


def _hit_view(hit):
    return types.SimpleNamespace(
        t=torch.as_tensor(np.asarray(hit.t)),
        prim=torch.as_tensor(np.asarray(hit.prim)),
        u=torch.as_tensor(np.asarray(hit.uv)[:, 0]),
        v=torch.as_tensor(np.asarray(hit.uv)[:, 1]))


def _fused_both(js, scene, params, cfg, rays):
    o, d, so, sd, sl = rays
    hj, bj = jcommon.trace_scene_with_shadow(
        js.scene, js.params, js.cfg, *(jnp.asarray(x) for x in rays))
    hp, bp = common.trace_scene_with_shadow(
        scene, params, cfg, *(torch.from_numpy(x) for x in rays))
    return hj, bj, hp, bp


def _assert_fused_match(hj, bj, hp, bp):
    assert_hits_match(_hit_view(hp), _hit_view(hj))
    np.testing.assert_array_equal(hp.area_light.numpy(),
                                  np.asarray(hj.area_light))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert 0 < int(bp.sum()) < bp.shape[0]


def test_fused_call_matches_jax_on_hierarchy():
    js, scene, params, cfg = _pair("cornell")
    rays = _probe_rays(js, 2048, 5)
    ts.reset_counts()
    hj, bj, hp, bp = _fused_both(js, scene, params, cfg, rays)
    assert ts.PLAIN_CALLS == {"closest": 1, "any": 0}     # one fused call
    _assert_fused_match(hj, bj, hp, bp)


def test_fused_call_matches_jax_on_brute_forest(interp):
    js, scene, params, cfg = _pair("cornell", backend="mxu")
    h = js.host_scene
    jbf, pbf = forests(h.v0, h.v1, h.v2, target_tris=256)
    jsess = types.SimpleNamespace(scene=js.scene.replace(bforest=jbf),
                                  params=js.params, cfg=js.cfg)
    pscene = dataclasses.replace(scene, bforest=pbf)
    rays = _probe_rays(js, 1024, 6)
    tb.reset_counts()
    hj, bj, hp, bp = _fused_both(jsess, pscene, params, cfg, rays)
    assert tb.PLAIN_CALLS["k2_closest"] > 0 and tb.PLAIN_CALLS["k2_any"] == 0
    _assert_fused_match(hj, bj, hp, bp)


@pytest.mark.parametrize("forest", [False, True, "treelet"])
def test_fused_and_two_call_forms_agree(forest):
    """The fused closest call under per-lane t_max blocks exactly where
    the two-call form (closest, then any-hit under the same lengths)
    does, and finds the same hits, on every traversal the fused call
    takes: K1 and K4 (backend "pallas") on the hierarchy, K2 on a brute
    forest and K5 on a treelet forest."""
    js, scene, params, cfg = _pair("kitchen")
    h = js.host_scene
    if forest == "treelet":
        _, ft = treelet_forests(h.v0, h.v1, h.v2, target_tris=512)
        scene = dataclasses.replace(scene, ftables=ft)
        mods = {"mxu": (tf, "closest", "any")}
    elif forest:
        _, pbf = forests(h.v0, h.v1, h.v2, target_tris=4096)
        scene = dataclasses.replace(scene, bforest=pbf)
        mods = {"mxu": (tb, "k2_closest", "k2_any")}
    else:
        mods = {"mxu": (ts, "closest", "any"),
                "pallas": (tp, "closest", "any")}
    o, d, so, sd, sl = (torch.from_numpy(x)
                        for x in _probe_rays(js, 1024, 7))
    lens = torch.clamp(sl, min=1e-6)
    for backend, (mod, closest, any_) in mods.items():
        c = cfg.replace(backend=backend)
        mod.reset_counts()
        h1, b1 = common.trace_scene_with_shadow(
            scene, params, c, o, d, so, sd, sl, check_area_quad=False)
        assert mod.PLAIN_CALLS[closest] > 0 and mod.PLAIN_CALLS[any_] == 0
        h2 = common.trace_scene(scene, params, c, o, d)
        b2 = common._shadow_blocked(scene, params, c, so, sd, lens,
                                    check_area_quad=False)
        assert mod.PLAIN_CALLS[any_] > 0
        assert torch.equal(b1, b2) and 0 < int(b1.sum()) < 1024
        assert_hits_match(_hit_view(h1), _hit_view(h2))


# ----------------------------------------------------------- integrator choice

@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("max_bounces", [1, 4, 8])
def test_integrator_decision_matches_jax(max_bounces, nee):
    for h in (0.0, 0.2, 0.5, 0.8, 1.0):
        for e in (0.0, 0.05, 0.2, 0.5, 1.0):
            assert driver.integrator_decision(h, e, max_bounces, nee) == \
                jax_driver.integrator_decision(h, e, max_bounces, nee), \
                (h, e)


def test_openness_probe_matches_jax():
    js, scene, params, cfg = _pair("kitchen")
    pix = np.arange(0, 32 * 32, 3, dtype=np.uint32)
    hj, ej = jax_driver._openness_probe(js.scene, js.params, js.cfg,
                                        jnp.asarray(pix))
    h, e = driver._openness_probe(scene, params, cfg,
                                  torch.from_numpy(pix.astype(np.int64)))
    assert float(h) == pytest.approx(float(hj), abs=2.0 / pix.shape[0])
    assert float(e) == pytest.approx(float(ej), abs=0.02)


def test_auto_integrator_on_cpu_is_lockstep():
    s = _cornell_session(8)
    assert driver.choose_integrator(s) == "lockstep"
    img = driver.render(s, 1)
    assert s.integrator_choice == "lockstep"
    assert torch.equal(img, driver.render(s, 1, integrator="lockstep"))
    with pytest.raises(ValueError, match="unknown integrator"):
        driver.render(s, 1, integrator="bogus")


def test_params_digest_follows_the_camera():
    import dataclasses
    s = _cornell_session(8)
    d0 = driver._params_digest(s.params)
    cam = dataclasses.replace(s.params.camera,
                              pos=s.params.camera.pos + 1.0)
    assert driver._params_digest(
        dataclasses.replace(s.params, camera=cam)) != d0
    assert driver._params_digest(s.params) == d0


# ------------------------------------------------------------ benchmark

def _cornell_session(size):
    import dataclasses
    cfg = RenderConfig(width=size, height=size, max_bounces=2,
                       use_area_light=True, use_env_map=False,
                       tile_size=1 << 10)
    s = driver.create_session("assets/cornell_proxy.obj", cfg=cfg,
                              state_dir=None, device="cpu")
    s.params = dataclasses.replace(s.params, area_light=cornell_light_torch())
    return s


def _check(result, csv_path):
    """tests/test_benchmark.py::_check."""
    for k in ("primary_mrays_s", "extension_mrays_s", "shadow_mrays_s",
              "total_mrays_s", "samples_mrays_s", "samples_per_pixel"):
        assert k in result
        assert np.isfinite(result[k])
    assert result["total_mrays_s"] > 0
    assert result["samples_per_pixel"] > 0
    lines = open(csv_path).read().splitlines()
    assert lines[0] == bm.CSV_HEADER == jbm.CSV_HEADER
    assert len(lines) >= 2
    assert all(len(ln.split(";")) == 7 for ln in lines[1:])


def test_run_benchmark_lockstep(tmp_path):
    csv = str(tmp_path / "b.csv")
    r = bm.run_benchmark(_cornell_session(32), duration_s=0.5,
                         scene_name="cornell", csv_path=csv)
    _check(r, csv)
    # analytic accounting: extension = (bounces + 1) x primary
    assert abs(r["extension_mrays_s"] / r["primary_mrays_s"] - 3.0) < 1e-6


def test_run_benchmark_stream(tmp_path):
    csv = str(tmp_path / "bs.csv")
    s = _cornell_session(32)
    r = bm.run_benchmark_stream(s, duration_s=0.5, scene_name="cornell",
                                csv_path=csv, spp_per_frame=2)
    _check(r, csv)
    # actual queue accounting: extension rays >= spawned paths
    assert r["extension_mrays_s"] >= r["primary_mrays_s"] * 0.99
    m = driver.mrays_benchmark(s, duration_s=0.1, integrator="stream")
    assert m["integrator"] == "stream" and m["total_mrays_s"] > 0


def test_report_text_matches_jax(tmp_path):
    r = {"scene": "kitchen", "primary_mrays_s": 1.25,
         "extension_mrays_s": 4.2, "shadow_mrays_s": 2.105,
         "samples_mrays_s": 0.5, "total_mrays_s": 7.3}
    assert bm.summary_line(r) == jbm.summary_line(r)
    bm.write_txt_report(str(tmp_path / "p.txt"), [r, r])
    jbm.write_txt_report(str(tmp_path / "j.txt"), [r, r])
    assert (tmp_path / "p.txt").read_text() == \
        (tmp_path / "j.txt").read_text()


# ------------------------------------------------------------ probes

def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_p1_plain_matches_jax_kernel(monkeypatch):
    mod = _script("probe_pallas_floor")
    orig_call = mod.pl.pallas_call
    monkeypatch.setattr(
        mod.pl, "pallas_call",
        lambda *a, **k: orig_call(*a, **{**k, "interpret": True}))
    x = np.random.default_rng(1).random((8, 128)).astype(np.float32)
    np.testing.assert_array_equal(
        probes.copy_plus_one(torch.from_numpy(x)).numpy(),
        np.asarray(mod.copy1(jnp.asarray(x))))
    np.testing.assert_array_equal(
        probes.copy_plus_one(torch.from_numpy(np.tile(x, (64, 1)))).numpy(),
        np.asarray(mod.copy64(jnp.asarray(x))))


def test_p2_plain_matches_jax_kernel():
    """XLA on the CPU contracts the JAX kernel's multiply-add into an FMA:
    one rounding per step, as the fused plain version, which agrees
    exactly. The unfused plain version rounds twice a step: on the JAX
    probe's own input (ones) both forms add the same two ulps every step
    and agree exactly; on random input the unfused form may part by one
    rounding per step, 8 * iters * 2**-23 relative."""
    mod = _script("measure_mfu")
    iters = 4
    rand = np.random.default_rng(2).random((8, 128)) + 0.5
    for x, rtol in ((np.ones((8, 128)), 0.0), (rand, 8 * iters * 2.0 ** -23)):
        x = x.astype(np.float32)
        want = pl.pallas_call(
            functools.partial(mod._fma_kernel, iters=iters),
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            interpret=True)(jnp.asarray(x))
        np.testing.assert_array_equal(
            probes.fma_chain(torch.from_numpy(x), iters, True).numpy(),
            np.asarray(want))
        np.testing.assert_allclose(
            probes.fma_chain(torch.from_numpy(x), iters, False).numpy(),
            np.asarray(want), rtol=rtol, atol=0.0)
