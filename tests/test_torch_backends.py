"""Port parity of the XLA traversal backends ("jnp", "packed", "wide"):
`accel/pack.py::pack_bvh` against the JAX package's arrays bit for bit,
the three walks against their JAX counterparts on the same hierarchy and
rays (prim ids equal except at equal-t ties, t at 1e-5 relative, any-hit
flags equal), the lockstep under each backend against JAX's under the
same backend at the goldens' tolerance, and the upload rule: a session
uploads the binary or packed tables only when its backend names them.

The binary chain of `fixtures.binary_chain_bvh` needs more stack than the
JAX walks' 96 entries: JAX's packed walk then returns a farther hit (and
its binary walk does not end); the port's stacks grow."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluctus_tpu.accel.bvh import BuiltBVH as JaxBuilt
from fluctus_tpu.accel.pack import pack_bvh as jax_pack
from fluctus_tpu.core.types import FlatBVH as JaxFlat
from fluctus_tpu.core.types import PackedBVH as JaxPacked
from fluctus_tpu.core.types import RenderConfig as JaxConfig
from fluctus_tpu.core.types import WideBVH as JaxWide
from fluctus_tpu.integrators import lockstep as jax_lockstep
from fluctus_tpu.ops import traverse as jtr
from fluctus_tpu.ops import traverse_packed as jtp
from fluctus_tpu.ops import traverse_wide as jtw
from fluctus_tpu.render import driver as jax_driver
from fluctus_tpu_torch.accel.bvh import BuiltBVH
from fluctus_tpu_torch.accel.pack import pack_bvh
from fluctus_tpu_torch.core.types import FlatBVH, PackedBVH, RenderConfig
from fluctus_tpu_torch.integrators import lockstep
from fluctus_tpu_torch.ops import traverse, traverse_packed, traverse_wide
from fluctus_tpu_torch.render import driver
from fluctus_tpu_torch.scene.scene import load_scene

from golden_common import ATOL, RTOL, _cornell_light
from test_torch_traverse import rays
from torch_common import assert_hits_match, port_session

PACK_FIELDS = ("child_boxes", "child_refs", "leaf_tris", "leaf_ids")
FLAT_FIELDS = ("node_lo", "node_hi", "node_right", "node_count",
               "node_parent", "prim_idx")


def _tables(built, v0, v1, v2):
    """(port FlatBVH, port PackedBVH, JAX FlatBVH, JAX PackedBVH) of one
    BuiltBVH's arrays."""
    flat = {f: getattr(built, f) for f in FLAT_FIELDS}
    pk = pack_bvh(BuiltBVH(**flat, depth=built.depth), v0, v1, v2)
    return (FlatBVH(**{k: torch.from_numpy(v) for k, v in flat.items()}),
            PackedBVH(*(torch.from_numpy(getattr(pk, f))
                        for f in PACK_FIELDS), root_ref=pk.root_ref),
            JaxFlat(**{k: jnp.asarray(v) for k, v in flat.items()}),
            JaxPacked(*(jnp.asarray(getattr(pk, f)) for f in PACK_FIELDS),
                      root_ref=jnp.asarray(pk.root_ref, jnp.int32)))


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in ("cornell", "kitchen"):
        host = load_scene(f"assets/{name}_proxy.obj")
        host.build_bvh(cache_dir=None, use_sbvh=True)
        out[name] = (host, host.to_device("cpu").wbvh,
                     _tables(host.bvh, host.v0, host.v1, host.v2))
    return out


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_pack_bvh_equals_jax(scenes, name):
    host = scenes[name][0]
    b = host.bvh
    got = pack_bvh(b, host.v0, host.v1, host.v2)
    want = jax_pack(JaxBuilt(**{f: getattr(b, f) for f in FLAT_FIELDS},
                             depth=b.depth), host.v0, host.v1, host.v2)
    for f in PACK_FIELDS:
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype and a.shape == w.shape, f
        assert a.tobytes() == w.tobytes(), f
    assert got.root_ref == want.root_ref


def _walks(scenes, name, backend):
    """(port closest, port any, JAX closest, JAX any) over (o, d, t)."""
    host, w, (flat, packed, jflat, jpacked) = scenes[name]
    if backend == "jnp":
        g = [torch.from_numpy(x) for x in (host.v0, host.v1, host.v2)]
        jg = [jnp.asarray(x) for x in (host.v0, host.v1, host.v2)]
        return (lambda o, d, t: traverse.traverse_closest(flat, *g, o, d, t),
                lambda o, d, t: traverse.traverse_any(flat, *g, o, d, t),
                lambda o, d, t: jtr.traverse_closest(jflat, *jg, o, d, t),
                lambda o, d, t: jtr.traverse_any(jflat, *jg, o, d, t))
    if backend == "packed":
        return (lambda o, d, t: traverse_packed.traverse_closest(packed, o,
                                                                 d, t),
                lambda o, d, t: traverse_packed.traverse_any(packed, o, d, t),
                lambda o, d, t: jtp.traverse_closest(jpacked, o, d, t),
                lambda o, d, t: jtp.traverse_any(jpacked, o, d, t))
    jw = JaxWide(nodes=jnp.asarray(w.nodes.numpy()),
                 leaves=jnp.asarray(w.leaves.numpy()), root_ref=w.root_ref,
                 depth=w.depth, leaf_width=w.leaf_width)
    return (lambda o, d, t: traverse_wide.traverse_closest(w, o, d, t),
            lambda o, d, t: traverse_wide.traverse_any(w, o, d, t),
            lambda o, d, t: jtw.traverse_closest(jw, o, d, t),
            lambda o, d, t: jtw.traverse_any(jw, o, d, t))


@pytest.mark.parametrize("backend", ["jnp", "packed", "wide"])
@pytest.mark.parametrize("name", ["cornell", "kitchen"])
@pytest.mark.parametrize("t_max_mode", ["f32max", "per_lane"])
def test_walk_matches_jax(scenes, backend, name, t_max_mode):
    host = scenes[name][0]
    o, d, t = rays(host, 384, seed=11, t_max_mode=t_max_mode)
    closest, any_hit, j_closest, j_any = _walks(scenes, name, backend)
    to = [torch.from_numpy(x) for x in (o, d, t)]
    jo = [jnp.asarray(x) for x in (o, d, t)]
    got = closest(*to)
    assert_hits_match(got, j_closest(*jo))
    assert int((got.prim >= 0).sum()) > 100
    blocked = any_hit(*to).numpy()
    np.testing.assert_array_equal(blocked, np.asarray(j_any(*jo)))
    if t_max_mode == "per_lane":
        assert 0 < blocked.sum() < len(blocked)


@pytest.mark.parametrize("t_max", [3.4e38, 9.5])
def test_wide_walk_on_tie_fixture(t_max):
    """traverse_wide on `fixtures.wide_tie_bvh`: the copy the sequential
    rule picks on every tie ray, and JAX's traverse_wide up to ties."""
    from fluctus_tpu_torch.convert import wide_from_numpy
    from fluctus_tpu_torch.fixtures import wide_tie_bvh
    arrays, o, d, want = wide_tie_bvh()
    w = wide_from_numpy(arrays, device="cpu")
    jw = JaxWide(nodes=jnp.asarray(arrays["nodes"]),
                 leaves=jnp.asarray(arrays["leaves"]),
                 root_ref=arrays["root_ref"], depth=arrays["depth"],
                 leaf_width=arrays["leaf_width"])
    t = np.full(len(o), t_max, np.float32)
    got = traverse_wide.traverse_closest(w, torch.from_numpy(o),
                                         torch.from_numpy(d),
                                         torch.from_numpy(t))
    tie = want["k1"] >= 0
    np.testing.assert_array_equal(got.prim.numpy()[tie], want["k1"][tie])
    assert_hits_match(got, jtw.traverse_closest(
        jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)))
    np.testing.assert_array_equal(
        traverse_wide.traverse_any(w, torch.from_numpy(o),
                                   torch.from_numpy(d),
                                   torch.from_numpy(t)).numpy(),
        np.asarray(jtw.traverse_any(jw, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t))))


@pytest.mark.parametrize("depth,near", [(40, 30), (110, 100)])
def test_binary_chain_past_the_jax_stack(depth, near):
    """A hierarchy needing depth + 1 stack entries: both port walks find
    the nearest triangle at every depth. JAX's packed walk agrees within
    its 96 entries and, past them, clamps its pushes onto the top entry
    and returns a farther triangle (ROADMAP Queue 3); its binary walk
    runs at depth 40 and is not run past 96, where it does not end."""
    from fluctus_tpu_torch.fixtures import binary_chain_bvh
    arrays, v0, v1, v2, o, d = binary_chain_bvh(depth, near)
    built = JaxBuilt(**arrays)
    flat, packed, jflat, jpacked = _tables(built, v0, v1, v2)
    to, do = torch.from_numpy(o), torch.from_numpy(d)
    g = [torch.from_numpy(x) for x in (v0, v1, v2)]
    for r in (traverse.traverse_closest(flat, *g, to, do, 3.4e38),
              traverse_packed.traverse_closest(packed, to, do, 3.4e38)):
        assert int(r.prim[0]) == near and float(r.t[0]) == 1.0
    assert bool(traverse.traverse_any(flat, *g, to, do, 1.5)[0])
    assert not bool(traverse_packed.traverse_any(packed, to, do, 0.5)[0])
    jt = jnp.full((1,), 3.4e38, jnp.float32)
    j = jtp.traverse_closest(jpacked, jnp.asarray(o), jnp.asarray(d), jt)
    if depth + 1 <= jtp.STACK_DEPTH:
        assert int(j.prim[0]) == near
        jb = jtr.traverse_closest(jflat, *(jnp.asarray(x)
                                           for x in (v0, v1, v2)),
                                  jnp.asarray(o), jnp.asarray(d), jt)
        assert int(jb.prim[0]) == near
    else:
        assert int(j.prim[0]) != near and float(j.t[0]) > 1.0


def _cornell_jax(backend):
    cfg = JaxConfig(width=16, height=16, max_bounces=2, use_area_light=True,
                    use_env_map=False, backend=backend)
    s = jax_driver.create_session("assets/cornell_proxy.obj", env_map=None,
                                  cfg=cfg, use_sbvh=True, cache_dir=None,
                                  state_dir=None)
    s.params = s.params.replace(area_light=_cornell_light())
    return s


@pytest.mark.parametrize("backend", ["jnp", "packed", "wide"])
def test_lockstep_under_backend_matches_jax(backend):
    js = _cornell_jax(backend)
    scene, params, cfg = port_session(js.scene, js.params, js.cfg)
    cfg = cfg.replace(backend=backend)
    got = lockstep.render(scene, params, cfg, 2).numpy()
    want = np.asarray(jax_lockstep.render(js.scene, js.params, js.cfg, 2))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got.mean() > 0.0


def test_upload_follows_the_backend():
    """A default session uploads neither table (as at the parent); "jnp"
    uploads the binary hierarchy, "packed" its packed rows, equal to the
    JAX session's, "wide" neither. A brute-forest-only scene still raises
    the JAX package's error under every one of them."""
    import types
    from fluctus_tpu_torch.integrators import common
    cfg = RenderConfig(width=8, height=8)
    s = driver.create_session("assets/cornell_proxy.obj", cfg=cfg,
                              state_dir=None, cache_dir=None, device="cpu")
    assert s.scene.bvh is None and s.scene.pbvh is None
    assert s.cfg.backend == "mxu"
    js = _cornell_jax("wide")
    for backend in ("jnp", "packed", "wide"):
        s = driver.create_session("assets/cornell_proxy.obj",
                                  cfg=cfg.replace(backend=backend),
                                  state_dir=None, cache_dir=None,
                                  device="cpu")
        assert s.cfg.backend == backend
        assert (s.scene.bvh is not None) == (backend == "jnp")
        assert (s.scene.pbvh is not None) == (backend == "packed")
        if backend == "jnp":
            for f in FLAT_FIELDS:
                np.testing.assert_array_equal(
                    getattr(s.scene.bvh, f).numpy(),
                    np.asarray(getattr(js.scene.bvh, f)))
        if backend == "packed":
            for f in PACK_FIELDS:
                np.testing.assert_array_equal(
                    getattr(s.scene.pbvh, f).numpy(),
                    np.asarray(getattr(js.scene.pbvh, f)))
            assert s.scene.pbvh.root_ref == int(js.scene.pbvh.root_ref)
        brute_only = types.SimpleNamespace(wbvh=None, bforest=object(),
                                           ftables=None, bvh=None, pbvh=None)
        with pytest.raises(ValueError, match="FLUCTUS_FAST_BIG=0"):
            common._check_backend_data(brute_only, s.cfg)
