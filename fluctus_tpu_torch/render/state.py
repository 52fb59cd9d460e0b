"""Saved camera and light state, keyed by scene hash, and picking
(counterpart of `fluctus_tpu/render/state.py`; reference:
src/tracer.cpp:634-687 iterateStateItems, :689-718 pickDofDepth,
src/kernel_pick.cl).

The state file is the JAX package's JSON (`state_<hash>.json`, the same
keys, `indent=1`): either package reads the other's."""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from fluctus_tpu_torch.core.types import (
    AreaLight, Camera, DeviceScene, RenderConfig, RenderParams)

STATE_DIR = "data/states"


def _arr(x: torch.Tensor):
    return x.detach().cpu().numpy().tolist()


def save_state(params: RenderParams, scene_hash: str,
               state_dir: str = STATE_DIR) -> str:
    """Write the camera, area light, env strength and exposure to
    `state_dir/state_<hash>.json`; returns its path."""
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, f"state_{scene_hash}.json")
    cam, al = params.camera, params.area_light
    data = {
        "camera": {
            "pos": _arr(cam.pos), "dir": _arr(cam.dir), "up": _arr(cam.up),
            "right": _arr(cam.right), "fov": float(cam.fov),
            "aperture_size": float(cam.aperture_size),
            "focal_dist": float(cam.focal_dist),
        },
        "area_light": {
            "pos": _arr(al.pos), "right": _arr(al.right), "up": _arr(al.up),
            "normal": _arr(al.normal), "emission": _arr(al.emission),
            "size": _arr(al.size),
        },
        "env_strength": float(params.env_strength),
        "exposure": float(params.exposure),
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return path


def load_state(params: RenderParams, scene_hash: str,
               state_dir: str = STATE_DIR) -> RenderParams:
    """params updated from `state_<hash>.json`, or unchanged when there is
    no such file (reference behaviour on a missing state)."""
    path = os.path.join(state_dir, f"state_{scene_hash}.json")
    if not os.path.exists(path):
        return params
    with open(path) as f:
        d = json.load(f)
    dev = params.camera.pos.device

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    c, a = d["camera"], d["area_light"]
    cam = Camera(pos=t(c["pos"]), dir=t(c["dir"]), up=t(c["up"]),
                 right=t(c["right"]), fov=t(c["fov"]),
                 aperture_size=t(c["aperture_size"]),
                 focal_dist=t(c["focal_dist"]))
    al = AreaLight(pos=t(a["pos"]), right=t(a["right"]), up=t(a["up"]),
                   normal=t(a["normal"]), emission=t(a["emission"]),
                   size=t(a["size"]))
    return dataclasses.replace(params, camera=cam, area_light=al,
                               env_strength=t(d["env_strength"]),
                               exposure=t(d["exposure"]))


def pick(scene: DeviceScene, params: RenderParams, cfg: RenderConfig,
         ndc_x: float, ndc_y: float) -> tuple[float, int]:
    """(t, prim) of one ray through the NDC point (ndc_x, ndc_y), y up:
    the reference's picking path (kernel_pick.cl via
    CLContext::pickSingle). A closest traversal of a batch of one ray
    (K1 on the card)."""
    from fluctus_tpu_torch.core import vecmath as vm
    from fluctus_tpu_torch.integrators import common
    from fluctus_tpu_torch.ops.camera import fov_scale

    cam = params.camera
    scr_x = (2.0 * ndc_x - 1.0) * (cfg.width / cfg.height)
    scr_y = 2.0 * ndc_y - 1.0
    scale = fov_scale(cam.fov)
    target = (cam.pos + cam.right * scr_x * scale + cam.up * scr_y * scale
              + cam.dir)
    d = vm.normalize(target - cam.pos)[None, :]
    o = cam.pos.expand(1, 3)
    hit = common.trace_scene(scene, params, cfg, o, d)
    return float(hit.t[0]), int(hit.prim[0])


def pick_dof_depth(scene: DeviceScene, params: RenderParams,
                   cfg: RenderConfig, ndc_x: float = 0.5,
                   ndc_y: float = 0.5) -> RenderParams:
    """Click to focus: the camera's focal distance becomes the picked t on
    a hit (reference: src/tracer.cpp:706-718)."""
    t, prim = pick(scene, params, cfg, ndc_x, ndc_y)
    if prim >= 0:
        cam = dataclasses.replace(params.camera, focal_dist=torch.tensor(
            t, dtype=torch.float32, device=params.camera.pos.device))
        params = dataclasses.replace(params, camera=cam)
    return params
