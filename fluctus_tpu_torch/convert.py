"""Carry a scene and its parameters across from the JAX package.

The JAX package's `DeviceScene` and `RenderParams` are handed over as a flat
dict of NumPy arrays keyed by dotted field path ("geom.v0", "wbvh.nodes",
"camera.pos", "envmap.image", ...), which the caller builds with
`np.asarray` on each leaf;
a `BruteForest` as a dict keyed by its field names ("tris", "boxes",
"boxes_t", "tboxes", "tile"); a treelet forest as the JAX `HostForest`'s
fields ("nodes", "leaves", "boxes", "lvl", "leaf_width").
This is the renderer's counterpart of loading a model's weights: both
packages then trace the same hierarchy under the same camera.
"""
from __future__ import annotations

import numpy as np
import torch

from fluctus_tpu_torch.core.types import (
    AreaLight, BruteForest, Camera, DeviceScene, EnvMap, FlatBVH,
    ForestTables, Geometry, Materials, PackedBVH, RenderParams, TextureAtlas,
    WideBVH)

GEOM_KEYS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
             "mat_id")
MATERIAL_KEYS = ("kd", "ks", "ke", "ns", "ni", "map_kd", "map_ks", "map_n",
                 "bsdf_id")
ATLAS_KEYS = ("data", "offset", "width", "height")
CAMERA_KEYS = ("pos", "dir", "up", "right", "fov", "aperture_size",
               "focal_dist")
LIGHT_KEYS = ("pos", "right", "up", "normal", "emission", "size")
ENV_KEYS = ("image", "pdf_table", "prob_table", "alias_table")
FLAT_KEYS = ("node_lo", "node_hi", "node_right", "node_count",
             "node_parent", "prim_idx")
PACKED_KEYS = ("child_boxes", "child_refs", "leaf_tris", "leaf_ids")


def _t(a, device):
    a = np.asarray(a)
    if a.dtype.kind in "iu" and a.dtype != np.uint8:
        a = a.astype(np.int64)     # indices and descriptors
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def wide_from_numpy(arrays: dict, device="cuda") -> WideBVH:
    """WideBVH from accel/wide.py's rows as NumPy arrays (keys nodes,
    leaves, root_ref, depth, leaf_width)."""
    return WideBVH(
        nodes=_t(np.asarray(arrays["nodes"], np.float32), device),
        leaves=_t(np.asarray(arrays["leaves"], np.float32), device),
        root_ref=int(arrays["root_ref"]), depth=int(arrays["depth"]),
        leaf_width=int(arrays["leaf_width"]))


def brute_from_numpy(arrays: dict, device="cuda") -> BruteForest:
    """BruteForest from the JAX BruteForest's fields as NumPy arrays."""
    def f32(key):
        return _t(np.asarray(arrays[key], np.float32), device)

    tboxes = arrays.get("tboxes")
    return BruteForest(tris=f32("tris"), boxes=f32("boxes"),
                       boxes_t=f32("boxes_t"),
                       tboxes=None if tboxes is None else f32("tboxes"),
                       tile=int(arrays["tile"]))


def forest_from_numpy(arrays: dict, device="cuda") -> ForestTables:
    """ForestTables from a JAX HostForest's f32 staging arrays (the tables
    before the JAX package's bf16 encode)."""
    def f32(key):
        return _t(np.asarray(arrays[key], np.float32), device)

    return ForestTables(nodes=f32("nodes"), leaves=f32("leaves"),
                        boxes=f32("boxes"), lvl=int(arrays["lvl"]),
                        leaf_width=int(arrays["leaf_width"]))


def envmap_from_numpy(arrays: dict, device="cuda") -> EnvMap:
    """EnvMap from the JAX EnvMap's (or a HostEnvMap's) fields as NumPy
    arrays: image f32, pdf_table and prob_table f32, alias_table int32."""
    return EnvMap(
        image=torch.as_tensor(np.ascontiguousarray(arrays["image"],
                                                   np.float32),
                              device=device),
        pdf_table=torch.as_tensor(np.asarray(arrays["pdf_table"],
                                             np.float32), device=device),
        prob_table=torch.as_tensor(np.asarray(arrays["prob_table"],
                                              np.float32), device=device),
        alias_table=torch.as_tensor(np.asarray(arrays["alias_table"],
                                               np.int32), device=device))


def _prefixed(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def scene_from_numpy(arrays: dict, device="cuda") -> DeviceScene:
    """DeviceScene from the JAX scene's leaves (see module docstring). The
    "wbvh.*" keys may be absent (a fast-big scene); "bforest.*" keys, where
    present, carry a brute forest, "ftables.*" keys a treelet forest,
    "bvh.*" keys (FLAT_KEYS) the binary hierarchy and "pbvh.*" keys
    (PACKED_KEYS and root_ref) its packed rows.
    The "envmap.*" keys (ENV_KEYS) are required: a JAX scene always
    carries an env map, the 1x1 black one when none is loaded."""
    def group(prefix, keys):
        return {k: _t(arrays[f"{prefix}.{k}"], device) for k in keys}

    wbvh = bforest = ftables = None
    if "wbvh.nodes" in arrays:
        wbvh = wide_from_numpy(_prefixed(arrays, "wbvh."), device)
    if "bforest.tris" in arrays:
        bforest = brute_from_numpy(_prefixed(arrays, "bforest."), device)
    if "ftables.nodes" in arrays:
        ftables = forest_from_numpy(_prefixed(arrays, "ftables."), device)
    bvh = pbvh = None
    if "bvh.node_lo" in arrays:
        bvh = FlatBVH(**{k: torch.as_tensor(np.ascontiguousarray(
            arrays[f"bvh.{k}"]), device=device) for k in FLAT_KEYS})
    if "pbvh.child_boxes" in arrays:
        pbvh = PackedBVH(**{k: torch.as_tensor(np.ascontiguousarray(
            arrays[f"pbvh.{k}"]), device=device) for k in PACKED_KEYS},
            root_ref=int(arrays["pbvh.root_ref"]))
    return DeviceScene(geom=Geometry(**group("geom", GEOM_KEYS)),
                       wbvh=wbvh,
                       materials=Materials(**group("materials",
                                                   MATERIAL_KEYS)),
                       atlas=TextureAtlas(**group("atlas", ATLAS_KEYS)),
                       envmap=envmap_from_numpy(_prefixed(arrays, "envmap."),
                                                device),
                       bforest=bforest, ftables=ftables, bvh=bvh, pbvh=pbvh)


def params_from_numpy(arrays: dict, device="cuda") -> RenderParams:
    """RenderParams from the JAX params' leaves ("camera.*",
    "area_light.*", "env_strength", "world_radius", "exposure")."""
    def f32(key):
        return torch.as_tensor(np.asarray(arrays[key], np.float32),
                               device=device)

    return RenderParams(
        camera=Camera(**{k: f32(f"camera.{k}") for k in CAMERA_KEYS}),
        area_light=AreaLight(**{k: f32(f"area_light.{k}")
                                for k in LIGHT_KEYS}),
        env_strength=f32("env_strength"),
        world_radius=f32("world_radius"),
        exposure=f32("exposure"))


DIFF_KEYS = ("kd", "ks", "ns", "ni", "env_image", "env_strength") + tuple(
    f"cam_{k}" for k in CAMERA_KEYS)


def diff_from_numpy(arrays: dict, device="cuda") -> dict:
    """The differentiable-leaf dict that `parallel.mesh.graft` takes, from
    the JAX one as NumPy arrays (keys of DIFF_KEYS: kd, ks, ns, ni,
    env_image, env_strength and the cam_* fields), as f32 tensors."""
    unknown = set(arrays) - set(DIFF_KEYS)
    if unknown:
        raise KeyError(f"not a differentiable leaf: {sorted(unknown)}")
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in arrays.items()}


def diff_to_numpy(diff: dict) -> dict:
    """diff_from_numpy's inverse: the same keys as f32 NumPy arrays."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in diff.items()}
