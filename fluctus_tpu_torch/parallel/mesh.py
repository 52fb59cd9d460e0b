"""Scene-parameter losses and gradient steps (counterpart of the
single-device half of `fluctus_tpu/parallel/mesh.py`: `_CAM_FIELDS`,
`graft`, `loss_fn`, `grad_step` and `loss_fn_stream`).

The multi-device half (`make_mesh`, `place`, `render_sharded`,
`render_stream_sharded`, `grad_step_stream`) is not ported yet: it waits
for the port's `parallel/` on `torch.distributed` (ROADMAP Queue 1 item
6). The module keeps the JAX module's path so that each function
sits where its counterpart does.
"""
from __future__ import annotations

import dataclasses

import torch

from fluctus_tpu_torch.core.types import DeviceScene, RenderParams
from fluctus_tpu_torch.integrators import lockstep, wavefront

# camera leaves graftable by loss_fn: diff_params key "cam_<field>"
_CAM_FIELDS = ("pos", "dir", "up", "right", "fov", "aperture_size",
               "focal_dist")


def graft(diff_params: dict, scene: DeviceScene, params: RenderParams):
    """(scene, params) with the differentiable leaves of `diff_params` in
    place: any of kd, ks, ns, ni (materials), env_image, env_strength and
    the camera fields cam_pos, cam_dir, cam_up, cam_right, cam_fov,
    cam_aperture_size, cam_focal_dist (BASELINE config 5's parameter
    surface; reference: Camera inside RenderParams, src/geom.h:163-180).
    Gradients flow through the shading and camera math with visibility
    frozen (integrators/common.py)."""
    mats = dataclasses.replace(
        scene.materials, **{k: diff_params[k] for k in ("kd", "ks", "ns", "ni")
                            if k in diff_params})
    env = scene.envmap
    if "env_image" in diff_params:
        env = dataclasses.replace(env, image=diff_params["env_image"])
    scene = dataclasses.replace(scene, materials=mats, envmap=env)
    cam = dataclasses.replace(
        params.camera, **{f: diff_params[f"cam_{f}"] for f in _CAM_FIELDS
                          if f"cam_{f}" in diff_params})
    params = dataclasses.replace(params, camera=cam)
    if "env_strength" in diff_params:
        params = dataclasses.replace(params,
                                     env_strength=diff_params["env_strength"])
    return scene, params


def loss_fn(diff_params: dict, scene: DeviceScene, params: RenderParams,
            cfg, pixel_idx, sample_idx, target) -> torch.Tensor:
    """L2 image loss of one lockstep sample per listed pixel, with the
    leaves of `diff_params` grafted in (see graft)."""
    scene, params = graft(diff_params, scene, params)
    radiance = lockstep.sample_radiance(scene, params, cfg, pixel_idx,
                                        sample_idx)
    return torch.mean((radiance - target) ** 2)


def value_and_grad(fn, diff_params: dict, *args, has_aux: bool = False):
    """(fn's value, {key: gradient}) with respect to the leaves of
    `diff_params`, taken as fresh leaves (jax.value_and_grad's contract).
    With has_aux, fn returns (value, aux) and the value is (value, aux)."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in diff_params.items()}
    with torch.enable_grad():
        out = fn(leaves, *args)
        val = out[0] if has_aux else out
        grads = torch.autograd.grad(val, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(leaves, grads)}
    if has_aux:
        return (out[0].detach(), out[1]), grads
    return val.detach(), grads


def grad_step(diff_params: dict, scene: DeviceScene, params: RenderParams,
              cfg, pixel_idx, sample_idx, target, lr: float = 1e-2):
    """One SGD step on the scene parameters; returns (loss, new
    diff_params)."""
    loss, grads = value_and_grad(loss_fn, diff_params, scene, params, cfg,
                                 pixel_idx, sample_idx, target)
    return loss, {k: (v.detach() - lr * grads[k])
                  for k, v in diff_params.items()}


def loss_fn_stream(diff_params: dict, scene: DeviceScene,
                   params: RenderParams, cfg, pixel_idx, sample_idx,
                   target, pool: int, n_segments: int,
                   deferred: bool = False, weight=None):
    """L2 image loss through the differentiable streaming wavefront
    (wavefront.stream_loss, or stream_loss_deferred): the value of
    loss_fn (the same counter RNG) at the traced work of the paths'
    real lengths. With `weight`, the weighted-fold form. Returns (loss,
    n_done); n_done must equal len(pixel_idx) (size n_segments with
    wavefront.plan_stream_segments)."""
    scene, params = graft(diff_params, scene, params)
    fn = (wavefront.stream_loss_deferred if deferred
          else wavefront.stream_loss)
    return fn(scene, params, cfg, pixel_idx, sample_idx, target, pool,
              n_segments, weight=weight)
