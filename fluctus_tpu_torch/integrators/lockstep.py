"""Lockstep integrator: exact-spp path tracing with every lane in step
(counterpart of `fluctus_tpu/integrators/lockstep.py`; reference:
src/tracer.cpp:95-169 renderSingle and the mk_*.cl microkernels).

The JAX package runs the bounces as a `lax.while_loop` (forward) or a
checkpointed `lax.scan` (gradients); here it is a Python loop that stops
once every lane has terminated, each bounce checkpointed when autograd
records it. Russian roulette is off, as in the reference's exact-spp
export.
"""
from __future__ import annotations

import torch

from fluctus_tpu_torch.core import rng, vecmath as vm
from fluctus_tpu_torch.core.types import (
    DeviceScene, RenderConfig, RenderParams)
from fluctus_tpu_torch.integrators import common
from fluctus_tpu_torch.ops import bsdf as bsdf_mod
from fluctus_tpu_torch.ops import camera as cam_ops
from fluctus_tpu_torch.ops import envmap as env_ops

LIGHT_PICK_PROB = 1.0   # every light sampled (reference: mk_sample_bsdf.cl:73)
# samples are summed in groups of this size: the order of the JAX
# package's fused launches, so both sum a pixel's samples alike
SAMPLES_PER_LAUNCH = 16


def sample_radiance(scene: DeviceScene, params: RenderParams,
                    cfg: RenderConfig, pixel_idx: torch.Tensor,
                    sample_idx) -> torch.Tensor:
    """One complete path per pixel index; returns (B, 3) radiance. The
    bounce loop ends after max_bounces + 1 vertices or as soon as no lane
    is alive (the JAX package's early_exit=True).

    Differentiable: where autograd records the call (`common.grad_needed`)
    each bounce runs under `common.checkpointed`, so the backward
    re-shades a bounce from its saved traversal results and never traces
    again (the JAX package's checkpointed scan). Dead lanes add nothing,
    so the early exit gives the value and the gradient of JAX's
    fixed-trip scan. A forward-only call takes no checkpoint."""
    pix = pixel_idx
    samp = sample_idx
    dev = pix.device
    u_ax = rng.uniform(pix, samp, 0, rng.Streams.AA_X)
    u_ay = rng.uniform(pix, samp, 0, rng.Streams.AA_Y)
    u_lr = rng.uniform(pix, samp, 0, rng.Streams.LENS_R)
    u_lt = rng.uniform(pix, samp, 0, rng.Streams.LENS_TH)
    orig, dir = cam_ops.generate_rays(params.camera, pix, cfg.width,
                                      cfg.height, u_ax, u_ay, u_lr, u_lt,
                                      params.world_radius)
    b = pix.shape[0]
    carry = (orig, dir,
             torch.ones((b, 3), dtype=torch.float32, device=dev),
             torch.zeros((b, 3), dtype=torch.float32, device=dev),
             torch.ones(b, dtype=torch.float32, device=dev),
             torch.ones(b, dtype=torch.bool, device=dev),
             torch.ones(b, dtype=torch.bool, device=dev))
    diff = common.grad_needed(scene, params)

    for bounce in range(cfg.max_bounces + 1):
        if not bool(carry[6].any()):
            break

        def body(*c, bounce=bounce):
            return _bounce(scene, params, cfg, pix, samp, bounce, c)

        carry = common.checkpointed(body, *carry) if diff else body(*carry)
    return carry[3]


def _bounce(scene: DeviceScene, params: RenderParams, cfg: RenderConfig,
            pix, samp, bounce: int, carry):
    """One vertex of every lane's path: trace, implicit light hits,
    next-event estimation and continuation (reference: mk_next_vertex.cl,
    mk_sample_bsdf.cl). carry: (orig, dir, throughput, ei, last_pdf_w,
    last_specular, alive)."""
    orig, dir, throughput, ei, last_pdf_w, last_specular, alive = carry
    types = cfg.bsdf_types_mask
    zero3 = torch.zeros_like(ei)
    path_len = bounce + 1
    t_orig, t_dir = common.neutralize_rays(orig, dir, alive)
    hit = common.trace_scene(scene, params, cfg, t_orig, t_dir)
    miss = hit.prim < 0

    # implicit env hit (mk_next_vertex.cl:72-96); without implicit
    # sampling only the camera ray sees the env map
    if cfg.use_env_map:
        bg = env_ops.eval_dir(scene.envmap, dir) * params.env_strength
        if not cfg.sample_impl:
            bg = (1.0 if path_len == 1 else 0.0) * bg
        w_env = common.implicit_env_weight(
            scene, params, cfg, dir, last_pdf_w, last_specular,
            path_len, LIGHT_PICK_PROB)
        ei = ei + vm.where3(miss & alive,
                            w_env[..., None] * throughput * bg, zero3)

    # implicit area-light hit (mk_next_vertex.cl:98-117)
    if cfg.use_area_light and cfg.sample_impl:
        w_area = common.implicit_area_weight(
            params, cfg, hit, orig, dir, last_pdf_w, last_specular,
            path_len, LIGHT_PICK_PROB)
        ei = ei + vm.where3(
            hit.area_light & alive,
            w_area[..., None] * throughput * params.area_light.emission,
            zero3)
    alive = alive & ~miss & ~hit.area_light

    # shading context + NEE (mk_sample_bsdf.cl)
    ctx = common.make_shading_ctx(scene, hit, dir)
    sh_orig = hit.p - common.OFFSET_SHADOW * dir
    singular = bsdf_mod.is_singular(ctx.bsdf_id)
    nee_mask = alive & ~singular
    if cfg.sample_expl and cfg.use_env_map:
        c = common.nee_env(scene, params, cfg, ctx, sh_orig, dir, types,
                           pix, samp, bounce, LIGHT_PICK_PROB,
                           active=nee_mask)
        ei = ei + vm.where3(nee_mask, throughput * c, zero3)
    if cfg.sample_expl and cfg.use_area_light:
        c = common.nee_area(scene, params, cfg, ctx, sh_orig, dir, types,
                            pix, samp, bounce, LIGHT_PICK_PROB,
                            active=nee_mask)
        ei = ei + vm.where3(nee_mask, throughput * c, zero3)

    # continuation (mk_sample_bsdf.cl:158-199)
    u1 = rng.uniform(pix, samp, bounce, rng.Streams.BSDF_U)
    u2 = rng.uniform(pix, samp, bounce, rng.Streams.BSDF_V)
    ul = rng.uniform(pix, samp, bounce, rng.Streams.BSDF_LOBE)
    s = bsdf_mod.bsdf_sample(ctx, dir, u1, u2, ul, types)
    wo = vm.normalize(s.wo)
    cos_th = vm.dot(ctx.n, wo)
    ok = (s.pdf != 0.0) & ~vm.is_zero(s.f)
    new_t = throughput * s.f \
        * (cos_th / torch.where(ok, s.pdf, 1.0))[..., None]
    throughput = vm.where3(alive & ok, new_t, throughput)
    alive = alive & ok & ~vm.is_zero(throughput)

    orig = hit.p + common.OFFSET_CONT * wo
    dir = vm.where3(alive, wo, dir)
    last_pdf_w = torch.where(alive, s.pdf, last_pdf_w)
    last_specular = torch.where(alive, singular, last_specular)
    return orig, dir, throughput, ei, last_pdf_w, last_specular, alive


def _render_tile_spp(scene: DeviceScene, params: RenderParams,
                     cfg: RenderConfig, pixel_idx: torch.Tensor,
                     sample0: int, n_samples: int) -> torch.Tensor:
    """Sum of samples sample0 .. sample0 + n_samples - 1 of the pixels
    `pixel_idx`, (B, 3): one launch of the JAX package's fused samples."""
    acc = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32,
                      device=pixel_idx.device)
    for k in range(n_samples):
        acc = acc + sample_radiance(scene, params, cfg, pixel_idx,
                                    sample0 + k)
    return acc


def accumulate(scene: DeviceScene, params: RenderParams, cfg: RenderConfig,
               acc: torch.Tensor, sample0: int, spp: int,
               samples_per_launch: int = SAMPLES_PER_LAUNCH) -> None:
    """Add samples sample0 .. sample0 + spp - 1 of every pixel into `acc`
    ((n_pix, 3), in place). Pixels go in tiles of cfg.tile_size rays,
    samples in groups of `samples_per_launch`, each group summed before it
    is added to the tile's running sum (the JAX package's fused launches).
    The one fold of `render` and of the driver's progressive accumulator,
    so their sums agree bit for bit."""
    n_pix = cfg.width * cfg.height
    tile = min(cfg.tile_size, n_pix)
    stop = sample0 + spp
    for start in range(0, n_pix, tile):
        idx = torch.arange(start, min(start + tile, n_pix), device=acc.device,
                           dtype=torch.int32)
        t = acc[start:start + idx.shape[0]]
        s = sample0
        while s < stop:
            k = min(samples_per_launch, stop - s)
            t = t + _render_tile_spp(scene, params, cfg, idx, s, k)
            s += k
        acc[start:start + idx.shape[0]] = t


def render(scene: DeviceScene, params: RenderParams, cfg: RenderConfig,
           spp: int, samples_per_launch: int = SAMPLES_PER_LAUNCH
           ) -> torch.Tensor:
    """cfg.width x cfg.height at exactly `spp` samples per pixel; returns
    (H, W, 3) float32 linear radiance (`accumulate` on a zero sum)."""
    acc = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                      device=scene.device)
    accumulate(scene, params, cfg, acc, 0, spp, samples_per_launch)
    return (acc / spp).reshape(cfg.height, cfg.width, 3)
