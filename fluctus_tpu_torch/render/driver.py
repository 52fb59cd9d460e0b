"""Render driver: scene set-up, camera framing, frame renders, display
export (counterpart of `fluctus_tpu/render/driver.py`; reference:
src/tracer.cpp).

Entry points run on the CUDA card unless the caller passes device="cpu";
with no card and no such request they raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from fluctus_tpu_torch.core.types import (
    DeviceScene, RenderConfig, RenderParams, default_params)
from fluctus_tpu_torch.integrators import common, lockstep
from fluctus_tpu_torch.ops import tonemap as tm
from fluctus_tpu_torch.scene.scene import (
    HostScene, fast_big_eligible, load_scene)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclass
class RenderSession:
    """A loaded scene, its device tensors and the frame parameters."""
    host_scene: HostScene
    scene: DeviceScene
    params: RenderParams
    cfg: RenderConfig

    @property
    def device(self) -> torch.device:
        return self.scene.device


def auto_frame_camera(params: RenderParams, host: HostScene) -> RenderParams:
    """Put the camera 1.2 diagonals in front of the scene centre on +z,
    looking down -z."""
    lo, hi = host.bounds()
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - lo) * 0.5)
    dev = params.camera.pos.device

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    pos = center + np.array([0.0, 0.0, 2.4 * radius], np.float32)
    cam = dataclasses.replace(
        params.camera, pos=t(pos.tolist()), dir=t([0.0, 0.0, -1.0]),
        up=t([0.0, 1.0, 0.0]), right=t([1.0, 0.0, 0.0]),
        focal_dist=t(np.float32(2.4 * radius)))
    return dataclasses.replace(params, camera=cam)


def create_session(scene_path: str, cfg: RenderConfig | None = None,
                   use_sbvh: bool = True, auto_frame: bool = True,
                   state_dir: str | None = "data/states",
                   device="cuda") -> RenderSession:
    """Load the scene, build the hierarchy (none above the fast-big
    cutover: the upload builds the brute-chunk forest instead), upload it,
    derive parameters and restore the scene's saved state (reference:
    Tracer::init, src/tracer.cpp:55-80, loadState :634-687). The
    traversal backend resolves as `common.resolve_backend` says: "auto"
    to the per-lane kernels, "pallas" to the packet kernel K4."""
    dev = resolve_device(device)
    cfg = cfg or RenderConfig()
    backend = common.resolve_backend(cfg.backend)
    host = load_scene(scene_path)
    if not fast_big_eligible(host, dev):
        host.build_bvh(use_sbvh=use_sbvh)
    scene = host.to_device(dev)
    # no env map on this path: lighting comes from the area light
    cfg = cfg.replace(backend=backend,
                      bsdf_types_mask=host.material_types_mask,
                      use_env_map=False)
    params = default_params(world_radius=host.world_radius(), device=dev)
    if auto_frame:
        params = auto_frame_camera(params, host)
    if state_dir:
        from fluctus_tpu_torch.render.state import load_state
        params = load_state(params, host.hash, state_dir=state_dir)
    return RenderSession(host_scene=host, scene=scene, params=params,
                         cfg=cfg)


def render(session: RenderSession, spp: int,
           integrator: str = "lockstep") -> torch.Tensor:
    """Linear-radiance frame (H, W, 3) at exactly `spp`, on the session's
    device."""
    if integrator == "stream":
        raise NotImplementedError(
            "the streaming wavefront integrator is not ported yet "
            "(ROADMAP Queue 1, streaming wavefront)")
    if integrator != "lockstep":
        raise ValueError(f"unknown integrator {integrator!r}")
    return lockstep.render(session.scene, session.params, session.cfg, spp)


def render_ldr(session: RenderSession, spp: int,
               integrator: str = "lockstep") -> torch.Tensor:
    """Frame after exposure, tonemap and display gamma."""
    img = render(session, spp, integrator=integrator)
    w = torch.ones(img.shape[:2], dtype=torch.float32, device=img.device)
    return tm.postprocess(img, w, session.params.exposure,
                          session.cfg.tonemap_op)
