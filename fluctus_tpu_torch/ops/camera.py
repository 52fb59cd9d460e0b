"""Camera ray generation: jittered pinhole + thin lens
(counterpart of `fluctus_tpu/ops/camera.py`; reference:
src/wf_raygen.cl:25-66).
"""
from __future__ import annotations

import math

import torch

from fluctus_tpu_torch.core import samplers, vecmath as vm
from fluctus_tpu_torch.core.types import Camera


def fov_scale(fov: torch.Tensor) -> torch.Tensor:
    """tan(fov/2) as float32, evaluated in float64 from the float32 angle."""
    half = (0.5 * fov) * float(torch.tensor(math.pi / 180.0,
                                            dtype=torch.float32))
    return torch.tan(half.double()).float()


def generate_rays(camera: Camera, pixel_idx: torch.Tensor, width: int,
                  height: int, u_aa_x, u_aa_y, u_lens_r, u_lens_th,
                  world_radius):
    """Primary rays for linear pixel indices; returns (orig, dir), (B, 3).

    Row 0 of the stored image looks toward +up, as in the JAX package."""
    pix = pixel_idx.to(torch.int64)
    x = (pix % width).to(torch.float32) + u_aa_x
    y = (pix // width).to(torch.float32) + u_aa_y
    ndc_x = x / width
    ndc_y = y / height
    scr_x = 2.0 * ndc_x - 1.0
    scr_y = 1.0 - 2.0 * ndc_y
    scr_x = scr_x * (width / height)
    scale = fov_scale(camera.fov)
    scr_x = scr_x * scale
    scr_y = scr_y * scale

    orig = camera.pos.expand(pix.shape[0], 3)
    target = (orig + camera.right * scr_x[:, None]
              + camera.up * scr_y[:, None] + camera.dir)
    dir = vm.normalize(target - orig)

    fp = camera.pos + dir * camera.focal_dist
    dx, dy = samplers.uniform_disk(u_lens_r, u_lens_th)
    orig = orig + world_radius * camera.aperture_size * (
        camera.right * dx[:, None] + camera.up * dy[:, None])
    dir = vm.normalize(fp - orig)
    return orig, dir


def camera_basis_from_rotation(yaw_deg, pitch_deg,
                               world_right=(1.0, 0.0, 0.0),
                               world_up=(0.0, 1.0, 0.0), device="cpu"):
    """(right, up, dir) float32 from yaw and pitch, as the reference builds
    its rotation matrix (src/tracer.cpp:803-818): the rotation about
    `world_right` by the pitch times the one about `world_up` by the yaw,
    in float64; the camera looks down -z of the rotated frame."""
    import numpy as np

    def rot(axis, rad):
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(rad), np.sin(rad)
        x, y, z = axis
        return np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s,
             x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c),
             y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
             c + z * z * (1 - c)],
        ])

    r = rot(world_right, np.deg2rad(pitch_deg)) @ rot(world_up,
                                                      np.deg2rad(yaw_deg))
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (r[0], r[1], -r[2]))
