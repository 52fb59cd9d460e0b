"""Port against the JAX package on the scene loaders: PLY, PBRT (with its
parse cache) and PBF, array for array and material for material, and
files written by one package read by the other."""
import dataclasses
import struct

import numpy as np
import pytest

from fluctus_tpu.scene.loaders import pbf as jpbf
from fluctus_tpu.scene.loaders import pbrt as jpbrt
from fluctus_tpu.scene.loaders import ply as jply
from fluctus_tpu.scene.scene import load_scene as jax_load_scene
from fluctus_tpu_torch.scene.loaders import pbf, pbrt, ply
from fluctus_tpu_torch.scene.scene import load_scene

from test_pbrt import PBRT_BOOK_SCENE, PBRT_SCENE

GEOM = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id")


def same_arrays(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))


def same_materials(got, want):
    assert [dataclasses.astuple(m) for m in got] == \
        [dataclasses.astuple(m) for m in want]


def same_hint(got, want):
    if want is None:
        assert got is None
        return
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def same_result(got, want):
    """The 12-tuple of load_pbrt / load_pbf."""
    same_arrays(got[:10], want[:10])
    same_materials(got[10], want[10])
    same_hint(got[11], want[11])


# ------------------------------------------------------------------ PLY

def write_ply(path, fmt, faces, normals, extra, seed):
    """A small PLY: 12 vertices (x, y, z, [nx, ny, nz], [a uchar red, a
    double w]) and `faces` ("tri", "quad" or "mixed")."""
    g = np.random.default_rng(seed)
    nv = 12
    cols = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals:
        cols += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if extra:
        cols = [("red", "u1")] + cols + [("w", "f8")]
    v = np.zeros(nv, np.dtype([(n, "<" + t) for n, t in cols]))
    for n, t in cols:
        v[n] = (g.integers(0, 255, nv) if t == "u1"
                else g.normal(size=nv))
    sizes = {"tri": [3] * 6, "quad": [4] * 5,
             "mixed": [3, 4, 3, 5, 4, 3]}[faces]
    rows = [g.choice(nv, k, replace=False) for k in sizes]
    ply_type = {"f4": "float", "f8": "double", "u1": "uchar"}
    head = [f"ply", f"format {fmt} 1.0", f"element vertex {nv}"]
    head += [f"property {ply_type[t]} {n}" for n, t in cols]
    head += [f"element face {len(rows)}",
             "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if fmt == "ascii":
            for r in v:
                f.write((" ".join(repr(x.item()) for x in r) + "\n")
                        .encode())
            for r in rows:
                f.write((f"{len(r)} " + " ".join(map(str, r)) + "\n")
                        .encode())
        else:
            f.write(v.tobytes())
            for r in rows:
                f.write(struct.pack("<B", len(r)))
                f.write(np.asarray(r, "<i4").tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
@pytest.mark.parametrize("faces,normals,extra", [
    ("tri", True, False), ("quad", False, False), ("mixed", False, True),
    ("quad", True, True)])
def test_ply_equals_jax(tmp_path, fmt, faces, normals, extra):
    path = str(tmp_path / "m.ply")
    write_ply(path, fmt, faces, normals, extra, seed=len(faces) + normals)
    got, want = ply.load_ply(path), jply.load_ply(path)
    same_arrays(got, want)
    n_tris = {"tri": 6, "quad": 10, "mixed": 1 + 2 + 1 + 3 + 2 + 1}[faces]
    assert len(got[0]) == n_tris


def test_ply_through_load_scene(tmp_path):
    from fluctus_tpu_torch.fixtures import sphere_grid_ply
    path = str(tmp_path / "grid.ply")
    n_tris, n_verts = sphere_grid_ply(path, 2, 1, seed=4)
    assert (n_tris, n_verts) == (8 * 80, 8 * 42)
    got, want = load_scene(path), jax_load_scene(path)
    for k in GEOM:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.hash == want.hash and got.area_light_hint is None
    have, ref = got.material_arrays(), want.material_arrays()
    for i, k in enumerate(("kd", "ks", "ke", "ns", "ni", "map_kd", "map_ks",
                           "map_n", "bsdf_id")):
        np.testing.assert_array_equal(have[k], ref[i], err_msg=k)


# ----------------------------------------------------------------- PBRT

ROUGH = """
WorldBegin
Material "plastic" "rgb Kd" [.5 .5 .5] "rgb Ks" [.5 .5 .5] "float roughness" [0.1]
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
Material "metal" "float roughness" [0.3] "rgb eta" [0.2 0.9 1.1]
Shape "trianglemesh" "point3 P" [0 0 1 1 0 1 0 1 1] "integer indices" [0 1 2]
Material "disney" "rgb color" [0.3 0.2 0.1] "float metallic" [0.5]
Shape "trianglemesh" "point3 P" [0 0 2 1 0 2 0 1 2] "integer indices" [0 1 2]
Material "uber" "float uroughness" [0.2] "float vroughness" [0.4]
Shape "trianglemesh" "point3 P" [0 0 3 1 0 3 0 1 3] "integer indices" [0 1 2]
Material "hair"
Shape "trianglemesh" "point3 P" [0 0 4 1 0 4 0 1 4] "integer indices" [0 1 2]
WorldEnd
"""

XFORM = """
WorldBegin
AttributeBegin
  Transform [0 1 0 0  -1 0 0 0  0 0 2 0  1 2 3 1]
  Material "matte" "rgb Kd" [0.2 0.4 0.6]
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0 0 0 1]
    "integer indices" [0 1 2 0 2 3] "normal N" [0 0 1 0 0 1 0 0 1 1 0 0]
    "float uv" [0 0 1 0 0 1 1 1]
AttributeEnd
TransformBegin
  Translate 0.5 -1 2
  ConcatTransform [1 0 0 0  0 0.5 0 0  0 0 1 0  0 0 0 1]
  Rotate 33 1 1 0
  Shape "trianglemesh" "point3 P" [0 0 0 2 0 0 0 2 0]
    "integer indices" [0 1 2]
TransformEnd
ObjectBegin "thing"
  Scale 1 2 3
  Shape "sphere" "float radius" [0.5]
ObjectEnd
Shape "disk" "float radius" [1] "float innerradius" [0.25] "float height" [2]
Shape "curve" "point3 P" [0 0 0 1 1 1]
WorldEnd
"""

NAMED = """
WorldBegin
Texture "wood" "spectrum" "imagemap" "string filename" "wood.png"
Texture "spec" "spectrum" "imagemap" "string filename" "missing.png"
MakeNamedMaterial "floor" "string type" "matte" "texture Kd" "wood"
  "rgb Kd" [0.8 0.7 0.6]
MakeNamedMaterial "coat" "string type" "plastic" "texture Ks" "spec"
  "rgb Ks" [0.1 0.2 0.3] "rgb Kd" [0.4 0.4 0.4] "float roughness" [0.05]
NamedMaterial "floor"
Shape "trianglemesh" "point3 P" [0 0 0 4 0 0 4 0 4 0 0 4]
  "integer indices" [0 1 2 0 2 3] "float uv" [0 0 1 0 1 1 0 1]
AttributeBegin
  NamedMaterial "coat"
  Shape "trianglemesh" "point3 P" [0 1 0 1 1 0 0 1 1] "integer indices" [0 1 2]
AttributeEnd
NamedMaterial "nothing"
Shape "trianglemesh" "point3 P" [0 2 0 1 2 0 0 2 1] "integer indices" [0 1 2]
WorldEnd
"""


def write_scene(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


SCENES = {"scene": PBRT_SCENE, "book": PBRT_BOOK_SCENE, "rough": ROUGH,
          "xform": XFORM, "named": NAMED}


@pytest.mark.parametrize("name", list(SCENES))
def test_pbrt_equals_jax(tmp_path, name):
    path = write_scene(tmp_path, f"{name}.pbrt", SCENES[name])
    got = pbrt.load_pbrt(path, cache_dir=None)
    same_result(got, jpbrt.load_pbrt(path, cache_dir=None))
    if name == "book":
        np.testing.assert_allclose(got[11]["pos"], [0, 7.9, 0], atol=1e-6)
        np.testing.assert_allclose(got[11]["emission"], [12, 11, 9])
    if name == "rough":
        assert got[10][0].ns == pytest.approx(4500.0)


def test_pbrt_include_and_plymesh_under_rotation(tmp_path):
    write_ply(str(tmp_path / "part.ply"), "binary_little_endian", "quad",
              True, False, seed=9)
    (tmp_path / "inc").mkdir()
    (tmp_path / "inc" / "mats.pbrt").write_text(
        'Material "mirror" "rgb Kr" [0.9 0.8 0.7]\n')
    path = write_scene(tmp_path, "top.pbrt", """
WorldBegin
Include "inc/mats.pbrt"
AttributeBegin
  Rotate 40 0.3 1 0.2
  Translate 1 0 -2
  Shape "plymesh" "string filename" "part.ply"
AttributeEnd
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
WorldEnd
""")
    got = pbrt.load_pbrt(path, cache_dir=None)
    same_result(got, jpbrt.load_pbrt(path, cache_dir=None))
    assert len(got[0]) == 10 + 1 and set(got[9]) == {1}


def test_pbrt_through_load_scene(tmp_path, monkeypatch):
    from PIL import Image
    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (5, 7, 3), dtype=np.uint8)).save(tmp_path / "wood.png")
    path = write_scene(tmp_path, "named.pbrt", NAMED)
    monkeypatch.chdir(tmp_path)      # the default parse cache lands here
    got, want = load_scene(path), jax_load_scene(path)
    for k in GEOM:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    have, ref = got.material_arrays(), want.material_arrays()
    for i, k in enumerate(("kd", "ks", "ke", "ns", "ni", "map_kd", "map_ks",
                           "map_n", "bsdf_id")):
        np.testing.assert_array_equal(have[k], ref[i], err_msg=k)
    assert list(have["map_kd"]) == [-1, 0, -1]     # missing.png stays -1
    assert list(have["map_ks"]) == [-1, -1, -1]
    assert list(have["map_n"]) == [-1] * 3
    for a, b in zip(got.textures.pack(), want.textures.pack()):
        np.testing.assert_array_equal(a, b)
    assert (tmp_path / "data" / "pbf_cache").is_dir()


def forbid(monkeypatch, module, name):
    def no(*a, **k):
        raise AssertionError(f"{name} ran: the cache was not read")
    monkeypatch.setattr(module, name, no)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pbrt_parse_cache_shared(tmp_path, monkeypatch, writer):
    """A parse cache written by one package is read by the other."""
    path = write_scene(tmp_path, "book.pbrt", PBRT_BOOK_SCENE)
    cache = str(tmp_path / "cache")
    write, read = (jpbrt, pbrt) if writer == "jax" else (pbrt, jpbrt)
    fresh = write.load_pbrt(path, cache_dir=cache)
    forbid(monkeypatch, read, "_parse_pbrt")
    cached = read.load_pbrt(path, cache_dir=cache)
    same_arrays(cached[:10], fresh[:10])
    same_materials(cached[10], fresh[10])
    for k in fresh[11]:
        np.testing.assert_array_equal(cached[11][k], fresh[11][k])
    assert [p.name for p in (tmp_path / "cache").iterdir()] == \
        [f"pbf_v2_{jax_load_scene.__globals__['file_hash'](path)}.npz"]


# ------------------------------------------------------------------ PBF

LIGHT = """
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 4 3]
  Shape "trianglemesh"
    "point3 P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "point3 P" [-5 0 -5  5 0 -5  5 0 5]
  "integer indices" [0 1 2]
WorldEnd
"""


@pytest.mark.parametrize("text", [PBRT_SCENE, PBRT_BOOK_SCENE, LIGHT],
                         ids=["scene", "book", "light"])
def test_pbf_roundtrip_equals_jax(tmp_path, text):
    """write_pbf writes the JAX package's bytes, and load_pbf reads
    either package's file as the JAX package reads it (the emissive quad
    hint included)."""
    src = write_scene(tmp_path, "s.pbrt", text)
    res = pbrt.load_pbrt(src, cache_dir=None)
    mine, theirs = str(tmp_path / "port.pbf"), str(tmp_path / "jax.pbf")
    pbf.write_pbf(mine, *res[:10], res[10], res[11])
    jres = jpbrt.load_pbrt(src, cache_dir=None)
    jpbf.write_pbf(theirs, *jres[:10], jres[10], jres[11])
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    want = jpbf.load_pbf(theirs)
    same_result(pbf.load_pbf(theirs), want)
    same_result(pbf.load_pbf(mine), jpbf.load_pbf(mine))
    if text is LIGHT:
        np.testing.assert_allclose(want[11]["pos"], [0, 3, 0], atol=1e-5)


def test_pbf_convert_and_load_scene(tmp_path):
    src = write_scene(tmp_path, "book.pbrt", PBRT_BOOK_SCENE)
    dst = str(tmp_path / "book.pbf")
    pbf.convert_pbrt_to_pbf(src, dst)
    jdst = str(tmp_path / "jbook.pbf")
    jpbf.convert_pbrt_to_pbf(src, jdst)
    assert open(dst, "rb").read() == open(jdst, "rb").read()
    got, want = load_scene(dst), jax_load_scene(dst)
    for k in GEOM:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    same_hint(got.area_light_hint, want.area_light_hint)
    assert got.material_types_mask == want.material_types_mask


def test_pbf_rejects_wrong_version(tmp_path):
    bad = tmp_path / "bad.pbf"
    bad.write_bytes(struct.pack("<I", (9 << 16) | 0) + b"\0" * 16)
    with pytest.raises(ValueError, match="format 9"):
        pbf.load_pbf(str(bad))
    trunc = tmp_path / "trunc.pbf"
    trunc.write_bytes(struct.pack("<IQ", pbf.FORMAT_TAG, 100) + b"\0" * 8)
    with pytest.raises(ValueError, match="truncated"):
        pbf.load_pbf(str(trunc))


def test_pbf_skips_unknown_entity(tmp_path):
    src = write_scene(tmp_path, "scene.pbrt", PBRT_SCENE)
    dst = tmp_path / "scene.pbf"
    pbf.convert_pbrt_to_pbf(src, str(dst))
    unknown = struct.pack("<i", 999) + b"\xAB" * 11
    dst.write_bytes(dst.read_bytes() + struct.pack("<Q", len(unknown))
                    + unknown)
    got = pbf.load_pbf(str(dst))
    same_result(got, jpbf.load_pbf(str(dst)))
    assert len(got[0]) == 4
