"""Port against the JAX package on the hierarchy: the NumPy SAH and SBVH
builders bit for bit, the npz hierarchy cache (each package reads what the
other wrote), create_session's cache and FLUCTUS_NATIVE=0, the treelet
forest's per-chunk build under FLUCTUS_NATIVE=0, and the native scene hash
against the xxhash package."""
import os

import numpy as np
import pytest
import xxhash

from fluctus_tpu.accel import bvh as jbvh
from fluctus_tpu.accel import forest as jforest
from fluctus_tpu.accel import native as jnative
from fluctus_tpu.accel import sbvh as jsbvh
from fluctus_tpu.scene import scene as jscene
from fluctus_tpu_torch.accel import bvh, forest, sbvh
from fluctus_tpu_torch.accel import native
from fluctus_tpu_torch.core.types import RenderConfig
from fluctus_tpu_torch.render import driver
from fluctus_tpu_torch.scene import scene
from fluctus_tpu_torch.scene import xxh64

FIELDS = ("node_lo", "node_hi", "node_right", "node_count", "node_parent",
          "prim_idx")
CORNELL = "assets/cornell_proxy.obj"


def soup(n, seed):
    """Seeded clustered triangles (many overlaps, so SBVH splits)."""
    g = np.random.default_rng(seed)
    c = g.uniform(-4, 4, (n, 3)) * np.array([1.0, 0.3, 1.0])
    v = [(c + g.normal(0, s, (n, 3))).astype(np.float32)
         for s in (0.2, 0.5, 0.2)]
    return v


def same_bvh(a, b):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.depth == b.depth


@pytest.mark.parametrize("n,seed", [(1, 0), (9, 1), (700, 2), (2000, 3)])
def test_sah_builder_equals_jax(n, seed):
    v = soup(n, seed)
    got, want = bvh.build_bvh(*v), jbvh.build_bvh(*v)
    same_bvh(got, want)
    bvh.validate(got)
    assert bvh.sah_cost(got) == jbvh.sah_cost(want)


@pytest.mark.parametrize("n,seed", [(40, 4), (300, 5)])
def test_sbvh_builder_equals_jax(n, seed):
    v = soup(n, seed)
    got, want = sbvh.build_sbvh(*v), jsbvh.build_sbvh(*v)
    same_bvh(got, want)
    bvh.validate(got)
    assert len(got.prim_idx) >= n


def forbid(monkeypatch, module, name):
    def no(*a, **k):
        raise AssertionError(f"{name} ran: the hierarchy was not cached")
    monkeypatch.setattr(module, name, no)


def test_cache_roundtrip(tmp_path, monkeypatch):
    host = scene.load_scene(CORNELL)
    host.build_bvh(cache_dir=str(tmp_path))
    built = host.bvh
    name = f"hierarchy_sbvh_v{bvh.BUILDER_VERSION}_{host.hash}.npz"
    assert os.listdir(tmp_path) == [name]       # no temporary left behind
    forbid(monkeypatch, native, "build_native")
    host.bvh = None
    host.build_bvh(cache_dir=str(tmp_path))
    same_bvh(host.bvh, built)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("use_sbvh", [True, False])
def test_cache_shared_with_jax(tmp_path, monkeypatch, writer, use_sbvh):
    """A cache file written by either package loads in the other, and
    both packages' builds of it are the same tree."""
    jhost, host = jscene.load_scene(CORNELL), scene.load_scene(CORNELL)
    cache = str(tmp_path)
    if writer == "jax":
        jhost.build_bvh(cache_dir=cache, use_sbvh=use_sbvh)
        forbid(monkeypatch, native, "build_native")
        host.build_bvh(cache_dir=cache, use_sbvh=use_sbvh)
    else:
        host.build_bvh(cache_dir=cache, use_sbvh=use_sbvh)
        forbid(monkeypatch, jnative, "build_native")
        forbid(monkeypatch, jbvh, "build_bvh")
        jhost.build_bvh(cache_dir=cache, use_sbvh=use_sbvh)
    same_bvh(host.bvh, jhost.bvh)
    assert len(os.listdir(cache)) == 1


def test_create_session_reads_its_cache(tmp_path, monkeypatch):
    cfg = RenderConfig(width=8, height=8, max_bounces=1)
    first = driver.create_session(CORNELL, cfg=cfg, cache_dir=str(tmp_path),
                                  state_dir=None, device="cpu")
    forbid(monkeypatch, native, "build_native")
    second = driver.create_session(CORNELL, cfg=cfg,
                                   cache_dir=str(tmp_path), state_dir=None,
                                   device="cpu")
    same_bvh(second.host_scene.bvh, first.host_scene.bvh)
    import torch
    for k in ("nodes", "leaves"):      # NaN pads: compare the bits
        a, b = (getattr(x.scene.wbvh, k).view(torch.int32)
                for x in (first, second))
        assert torch.equal(a, b), k


@pytest.mark.parametrize("use_sbvh", [False, True])
def test_native_off_session_equals_jax(monkeypatch, use_sbvh):
    """FLUCTUS_NATIVE=0: create_session builds with the NumPy builder the
    JAX package uses under the same knob (on a 300-triangle crop of the
    cornell for the SBVH, whose NumPy build is slow)."""
    monkeypatch.setenv("FLUCTUS_NATIVE", "0")
    forbid(monkeypatch, native, "build_native")
    if not use_sbvh:
        cfg = RenderConfig(width=8, height=8, max_bounces=1)
        s = driver.create_session(CORNELL, cfg=cfg, use_sbvh=False,
                                  cache_dir=None, state_dir=None,
                                  device="cpu")
        jhost = jscene.load_scene(CORNELL)
        jhost.build_bvh(cache_dir=None, use_sbvh=False)
        same_bvh(s.host_scene.bvh, jhost.bvh)
        assert s.scene.wbvh is not None
        return
    host, jhost = scene.load_scene(CORNELL), jscene.load_scene(CORNELL)
    for h in (host, jhost):
        for k in ("v0", "v1", "v2"):
            setattr(h, k, getattr(h, k)[:300])
    host.build_bvh(cache_dir=None, use_sbvh=True)
    jhost.build_bvh(cache_dir=None, use_sbvh=True)
    same_bvh(host.bvh, jhost.bvh)


def test_forest_chunks_native_off_equal_jax(monkeypatch):
    """The treelet forest's per-chunk build follows the JAX package's
    build_binary: NumPy SAH under FLUCTUS_NATIVE=0."""
    monkeypatch.setenv("FLUCTUS_NATIVE", "0")
    forbid(monkeypatch, native, "build_native")
    v = soup(600, 6)
    got = forest.build_host_forest(*v, target_tris=256)
    want = jforest.build_host_forest(*v, jbvh.build_bvh, target_tris=256)
    for k in ("nodes", "leaves", "boxes"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.lvl == want.lvl


LENGTHS = [0, 1, 3, 4, 7, 8, 15, 16, 31, 32, 33, 63, 64, 65, 100,
           (1 << 20) - 1, 1 << 20, (1 << 20) + 37, 3 * (1 << 20) + 5]


@pytest.mark.parametrize("n", LENGTHS)
def test_native_file_hash_equals_xxhash(tmp_path, n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    path = tmp_path / "f.bin"
    path.write_bytes(data)
    want = xxhash.xxh64(data).hexdigest()
    assert xxh64.file_hash(str(path)) == want
    if n < 4096:       # the plain Python version, held on the short ones
        assert xxh64.xxh64_hexdigest(data) == want


def test_file_hash_of_a_scene_keys_the_same_state():
    assert xxh64.file_hash(CORNELL) == jscene.file_hash(CORNELL)
    with pytest.raises(OSError):
        xxh64.file_hash("assets/no_such_scene.obj")


def test_unreadable_cache_file_is_rebuilt(tmp_path):
    """A cache file that cannot be read (cut short, as one the JAX package
    is still writing in place) is built and written again."""
    host = scene.load_scene(CORNELL)
    name = f"hierarchy_sbvh_v{bvh.BUILDER_VERSION}_{host.hash}.npz"
    (tmp_path / name).write_bytes(b"PK\x03\x04 cut short")
    host.build_bvh(cache_dir=str(tmp_path))
    fresh = scene.load_scene(CORNELL)
    fresh.build_bvh(cache_dir=None)
    same_bvh(host.bvh, fresh.bvh)
    host.bvh = None
    host.build_bvh(cache_dir=str(tmp_path))      # now read back
    same_bvh(host.bvh, fresh.bvh)
