"""Port parity: OBJ/MTL loading, texture atlas, SBVH build and the 8-wide
collapse, array for array against the JAX package's host side."""
import numpy as np
import pytest

from fluctus_tpu.accel.wide import build_wide as jax_build_wide
from fluctus_tpu.scene.scene import load_scene as jax_load_scene
from fluctus_tpu_torch.accel.wide import build_wide
from fluctus_tpu_torch.scene.scene import load_scene

SCENES = ["assets/cornell_proxy.obj", "assets/kitchen_proxy.obj"]
GEOM = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id")


@pytest.fixture(scope="module")
def kitchen_pair():
    return (jax_load_scene("assets/kitchen_proxy.obj"),
            load_scene("assets/kitchen_proxy.obj"))


def test_kitchen_geometry_and_materials(kitchen_pair):
    ref, got = kitchen_pair
    for k in GEOM:
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    assert got.hash == ref.hash
    assert got.material_types_mask == ref.material_types_mask
    assert [m.name for m in got.materials] == [m.name for m in
                                                ref.materials]
    want = ref.material_arrays()
    have = got.material_arrays()
    for i, k in enumerate(("kd", "ks", "ke", "ns", "ni", "map_kd", "map_ks",
                           "map_n", "bsdf_id")):
        np.testing.assert_array_equal(have[k], want[i], err_msg=k)


def test_kitchen_textures_loaded_into_same_atlas(kitchen_pair):
    ref, got = kitchen_pair
    assert (got.map_kd >= 0).sum() == 2 and (got.map_n >= 0).sum() == 1
    for a, b in zip(got.textures.pack(), ref.textures.pack()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", SCENES)
def test_sbvh_and_wide_rows_bit_equal(path):
    ref = jax_load_scene(path)
    got = load_scene(path)
    ref.build_bvh(cache_dir=None, use_sbvh=True)
    got.build_bvh(use_sbvh=True)
    for k in ("node_lo", "node_hi", "node_right", "node_count",
              "node_parent", "prim_idx"):
        np.testing.assert_array_equal(getattr(got.bvh, k),
                                      getattr(ref.bvh, k), err_msg=k)
    w_ref = jax_build_wide(ref.bvh, ref.v0, ref.v1, ref.v2)
    w_got = build_wide(got.bvh, got.v0, got.v1, got.v2)
    np.testing.assert_array_equal(w_got.nodes.view(np.int32),
                                  w_ref.nodes.view(np.int32))
    np.testing.assert_array_equal(w_got.leaves.view(np.int32),
                                  w_ref.leaves.view(np.int32))
    assert (w_got.root_ref, w_got.depth) == (w_ref.root_ref, w_ref.depth)


def test_missing_texture_stays_unset(tmp_path):
    obj = tmp_path / "t.obj"
    (tmp_path / "t.mtl").write_text("newmtl a\nKd 1 0 0\nmap_Kd nope.png\n")
    obj.write_text("mtllib t.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl a\n"
                   "f 1 2 3\n")
    s = load_scene(str(obj))
    assert s.map_kd.tolist() == [-1, -1]
