"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""
from __future__ import annotations

import dataclasses
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scene_arrays(scene) -> dict:
    """JAX DeviceScene -> the dotted-key dict of NumPy arrays that
    fluctus_tpu_torch.convert.scene_from_numpy takes (the binary and packed
    tables of the XLA backends included)."""
    out = {}
    for group in ("geom", "materials", "atlas", "envmap"):
        rec = getattr(scene, group)
        for f in dataclasses.fields(rec):
            out[f"{group}.{f.name}"] = np.asarray(getattr(rec, f.name))
    w = scene.wbvh
    out.update({"wbvh.nodes": np.asarray(w.nodes),
                "wbvh.leaves": np.asarray(w.leaves),
                "wbvh.root_ref": w.root_ref, "wbvh.depth": w.depth,
                "wbvh.leaf_width": w.leaf_width})
    for name in ("bvh", "pbvh"):
        rec = getattr(scene, name, None)
        if rec is not None:
            for f in dataclasses.fields(rec):
                out[f"{name}.{f.name}"] = np.asarray(getattr(rec, f.name))
    return out


def params_arrays(params) -> dict:
    """JAX RenderParams -> dotted-key dict for params_from_numpy."""
    out = {}
    for group in ("camera", "area_light"):
        rec = getattr(params, group)
        for f in dataclasses.fields(rec):
            out[f"{group}.{f.name}"] = np.asarray(getattr(rec, f.name))
    for k in ("env_strength", "world_radius", "exposure"):
        out[k] = np.asarray(getattr(params, k))
    return out


def cornell_light_torch(device="cpu"):
    """tests/golden_common.py::_cornell_light for the port."""
    import torch
    from fluctus_tpu_torch.core.types import AreaLight

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return AreaLight(pos=t([0.0, 3.95, 0.0]), right=t([1.0, 0.0, 0.0]),
                     up=t([0.0, 0.0, -1.0]), normal=t([0.0, -1.0, 0.0]),
                     emission=t([15.0, 15.0, 15.0]), size=t([1.0, 1.0]))


def golden_stats(img, gold, rtol, atol):
    """(share of pixels within rtol/atol, mean relative error)."""
    within = np.isclose(img, gold, rtol=rtol, atol=atol).all(-1)
    return float(within.mean()), float(np.abs(img - gold).mean()
                                       / np.abs(gold).mean())


def assert_hits_match(rp, rj, t_rel=1e-5, uv_atol=1e-4):
    """A port Traversal `rp` against a JAX one `rj`: prim ids equal except
    where the two hit at equal t (a tie), the same lanes hit, t within
    `t_rel` relative on every lane (misses too), u and v within `uv_atol`
    where the prims agree. u and v are divided by the determinant, so the
    few-ulp differences of XLA's FMA-contracted dot products grow on
    triangles seen edge-on; t is not."""
    prim, prim_j = rp.prim.numpy(), np.asarray(rj.prim)
    t, t_j = rp.t.numpy(), np.asarray(rj.t)
    diff = prim != prim_j
    assert diff.mean() < 0.01
    np.testing.assert_allclose(t[diff], t_j[diff], rtol=t_rel,
                               err_msg="prim mismatches that are not ties")
    np.testing.assert_array_equal(prim >= 0, prim_j >= 0)
    np.testing.assert_allclose(t, t_j, rtol=t_rel)
    same = ~diff & (prim_j >= 0)
    np.testing.assert_allclose(rp.u.numpy()[same], np.asarray(rj.u)[same],
                               atol=uv_atol)
    np.testing.assert_allclose(rp.v.numpy()[same], np.asarray(rj.v)[same],
                               atol=uv_atol)


def port_session(scene, params, cfg, device="cpu"):
    """A JAX (scene, params, cfg) carried to the port: the same arrays and
    the same static configuration."""
    from fluctus_tpu_torch.convert import params_from_numpy, scene_from_numpy
    from fluctus_tpu_torch.core.types import RenderConfig

    keys = ("width", "height", "max_bounces", "use_env_map",
            "use_area_light", "sample_impl", "sample_expl", "use_roulette",
            "tonemap_op", "bsdf_types_mask", "tile_size", "pool_size")
    return (scene_from_numpy(scene_arrays(scene), device),
            params_from_numpy(params_arrays(params), device),
            RenderConfig(**{k: getattr(cfg, k) for k in keys}))
