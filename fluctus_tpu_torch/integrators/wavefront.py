"""Wavefront integrators over a persistent path pool: the streaming
wavefront with scatter-free binning, and the reference-parity scatter form
(counterpart of the image half of `fluctus_tpu/integrators/wavefront.py`;
reference: src/tracer.cpp:222-299, src/wf_logic.cl, src/wf_raygen.cl,
src/wf_extrays.cl, src/wf_shadowrays.cl, src/wf_mat_*.cl).

- A pool of `cfg.pool_size` paths is decoupled from the image: a path
  that terminates respawns on the next (pixel, sample) of a striding
  counter (wf_raygen.cl:25). Respawn ranks are an exclusive prefix sum
  over the terminated mask, `cumsum(terminate) - terminate`: no atomics.
- Spawn id s is pixel `s % n_pix`, sample `s // n_pix`: the RNG key of the
  lockstep integrator's sample, so a path's random numbers are the
  lockstep path's. The wavefront's light sampling is the reference's
  (`_nee_single_light`: the light distance shortened by 0.995,
  wf_logic.cl:272), so with next-event estimation on its estimate of a
  pixel differs slightly from the lockstep integrator's.
- Lights: the env map, the area light or both. Next-event estimation
  picks one light per vertex, the env map with probability 0.5 when both
  are on (`_nee_single_light`), and the implicit hits weigh by the same
  pick probabilities.
- The stream emits each completed sample as a row (r, g, b, pixel) and
  bins the rows at the end: a stable sort by pixel puts exactly `spp`
  rows per pixel side by side, and a reshape-sum averages them.
- The deferred form traces a segment's shadow rays in the next segment's
  closest call (`common.trace_scene_with_shadow`), as the reference
  resolves them one segment late (wf_logic.cl:134-156).

The JAX package runs a launch of segments as one `lax.scan` program; here
a launch is a Python loop over segments that carries the same state, all
on the device. The only host reads are the drain checks of `render_stream`
and the final sample count.

The loss half (`stream_loss`, `stream_loss_deferred`, `stream_radiance`,
`plan_stream_segments`) runs one sample per listed (pixel, sample) ray
through a small pool: a finished lane folds its squared error, or its
weighted radiance, into a scalar and respawns on the next ray id, so the
traced work follows the paths' real lengths. Each segment of a
differentiated loss runs under `common.checkpointed` (the JAX package's
checkpointed scan; `FLUCTUS_STREAM_SAVE=all` keeps every intermediate
instead), so the backward never traces.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from fluctus_tpu_torch.core import rng, samplers, vecmath as vm
from fluctus_tpu_torch.core.types import (
    DeviceScene, PathState, RenderConfig, RenderParams)
from fluctus_tpu_torch.integrators import common
from fluctus_tpu_torch.ops import bsdf as bsdf_mod
from fluctus_tpu_torch.ops import camera as cam_ops
from fluctus_tpu_torch.ops import envmap as env_ops

# sort key of an empty sample row (the JAX package's pix = -1 as uint32)
EMPTY_KEY = (1 << 32) - 1
NEE_SHORTEN = 0.995   # reference: wf_logic.cl:272


def _nee_on(cfg: RenderConfig) -> bool:
    return cfg.sample_expl and (cfg.use_env_map or cfg.use_area_light)


def _raygen(params: RenderParams, cfg: RenderConfig, pixel_idx, spawn_id):
    """Camera ray for a pixel index and the sample's RNG key
    (reference: wf_raygen.cl)."""
    u_ax = rng.uniform(pixel_idx, spawn_id, 0, rng.Streams.AA_X)
    u_ay = rng.uniform(pixel_idx, spawn_id, 0, rng.Streams.AA_Y)
    u_lr = rng.uniform(pixel_idx, spawn_id, 0, rng.Streams.LENS_R)
    u_lt = rng.uniform(pixel_idx, spawn_id, 0, rng.Streams.LENS_TH)
    return cam_ops.generate_rays(params.camera, pixel_idx, cfg.width,
                                 cfg.height, u_ax, u_ay, u_lr, u_lt,
                                 params.world_radius)


def _fresh_state(params, cfg, pixel, sample) -> PathState:
    """Every lane starts a path on (pixel, sample)."""
    n = pixel.shape[0]
    dev = pixel.device
    orig, dir = _raygen(params, cfg, pixel, sample)
    return PathState(
        orig=orig, dir=dir,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        pixel_index=pixel, sample_index=sample,
        path_len=torch.zeros(n, dtype=torch.int64, device=dev),
        last_pdf_w=torch.ones(n, dtype=torch.float32, device=dev),
        last_specular=torch.ones(n, dtype=torch.bool, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev))


def init_state(params: RenderParams, cfg: RenderConfig) -> PathState:
    """wf_reset + first raygen: lane i starts a path on pixel i % n_pix
    (reference: wf_reset.cl:62-65)."""
    n_pix = cfg.width * cfg.height
    lane = torch.arange(cfg.pool_size, dtype=torch.int64,
                        device=params.camera.pos.device)
    return _fresh_state(params, cfg, lane % n_pix, lane // n_pix)


def _env_prob(cfg: RenderConfig) -> float:
    """Probability that a wavefront NEE draw picks the env map: 0, 0.5 or
    1 (the reference's envMapProb)."""
    use_env = 1 if cfg.use_env_map else 0
    use_area = 1 if cfg.use_area_light else 0
    return use_env / max(1, use_env + use_area)


def _nee_single_light(scene, params, cfg, ctx, sh_orig, wi, types, pix, samp,
                      bounce, defer: bool = False):
    """Wavefront next-event estimation: one light, one shadow ray
    (reference: wf_logic.cl:215-303, wf_shadowrays.cl). The env map is
    picked with probability `_env_prob` (a LIGHT_PICK draw when both
    lights are on), else the area light; an env ray is 2 x world_radius
    long, an area ray ends at 0.995 of the light distance. Returns the
    unoccluded candidate and either the per-lane pick probability or,
    with `defer`, the shadow ray (orig, dir, length) for the caller to
    trace."""
    dev = wi.device
    env_prob = _env_prob(cfg)
    if cfg.use_area_light:
        u_pick = rng.uniform(pix, samp, bounce, rng.Streams.LIGHT_PICK)
        pick_env = u_pick < env_prob
    else:
        pick_env = torch.full(pix.shape, bool(cfg.use_env_map),
                              dtype=torch.bool, device=dev)

    b = wi.shape[0]
    ldir = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    llen = torch.zeros(b, dtype=torch.float32, device=dev)
    emission = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    direct_pdf_w = torch.zeros(b, dtype=torch.float32, device=dev)
    pick_prob = torch.ones(b, dtype=torch.float32, device=dev)
    valid = torch.zeros(b, dtype=torch.bool, device=dev)

    if cfg.use_env_map:
        u = rng.uniform(pix, samp, bounce, rng.Streams.LIGHT_U)
        L, pdf_env, rad = env_ops.sample_alias_radiance(scene.envmap, u)
        L = vm.normalize(L)
        li = rad * params.env_strength
        ldir = vm.where3(pick_env, L, ldir)
        llen = torch.where(pick_env, 2.0 * params.world_radius, llen)
        emission = vm.where3(pick_env, li, emission)
        direct_pdf_w = torch.where(pick_env, pdf_env, direct_pdf_w)
        pick_prob = torch.where(pick_env, env_prob, pick_prob)
        valid = valid | (pick_env & (pdf_env != 0.0))

    if cfg.use_area_light:
        al = params.area_light
        u1 = rng.uniform(pix, samp, bounce, rng.Streams.LIGHT_AREA_U)
        u2 = rng.uniform(pix, samp, bounce, rng.Streams.LIGHT_AREA_V)
        pos_l, pdf_a = samplers.sample_area_light(al.pos, al.right, al.up,
                                                  al.size, u1, u2)
        delta = pos_l - sh_orig
        dist = vm.length(delta)
        L = vm.normalize(delta)
        cos_light = torch.clamp(vm.dot(al.normal, -L), min=0.0)
        pdf_w = samplers.pdf_area_to_solid_angle(pdf_a, dist * NEE_SHORTEN,
                                                 cos_light)
        pick_area = ~pick_env
        ldir = vm.where3(pick_area, L, ldir)
        llen = torch.where(pick_area, dist * NEE_SHORTEN, llen)
        emission = vm.where3(pick_area, al.emission.expand_as(emission),
                             emission)
        direct_pdf_w = torch.where(pick_area, pdf_w, direct_pdf_w)
        pick_prob = torch.where(pick_area, 1.0 - env_prob, pick_prob)
        valid = valid | (pick_area & (cos_light > 0.0))

    f = bsdf_mod.bsdf_eval(ctx, wi, ldir, types)
    cos_th = torch.clamp(vm.dot(ldir, ctx.n), min=0.0)
    bsdf_pdf_w = torch.clamp(bsdf_mod.bsdf_pdf(ctx, wi, ldir, types),
                             min=0.0)
    # only lanes whose contribution can be nonzero trace (the reference
    # checks the light quad on every shadow ray; the 0.995 shortening
    # keeps an area ray off its own emitter)
    live = valid & (cos_th > 0.0) & ~vm.is_zero(f)
    sh_o, ldir_t = common.neutralize_rays(sh_orig, ldir, live)
    weight = 1.0
    if cfg.sample_impl:
        weight = (direct_pdf_w * pick_prob) / torch.clamp(
            direct_pdf_w * pick_prob + bsdf_pdf_w, min=1e-20)
    denom = torch.clamp(pick_prob * direct_pdf_w, min=1e-20)
    contrib = f * emission * (weight * cos_th / denom)[..., None]
    cand = vm.where3(valid & (direct_pdf_w > 0.0), contrib,
                     torch.zeros_like(contrib))
    lens = torch.clamp(llen, min=1e-6)
    if defer:
        return cand, (sh_o, ldir_t, lens)
    blocked = common._shadow_blocked(scene, params, cfg, sh_o, ldir_t, lens,
                                     check_area_quad=True)
    return vm.where3(~blocked, cand, torch.zeros_like(cand)), pick_prob


def _pend_init(pool: int, device) -> tuple:
    """Pending shadow state that traces as misses and adds nothing."""
    z3 = torch.zeros((pool, 3), dtype=torch.float32, device=device)
    up = z3.clone()
    up[:, 2] = 1.0
    o, d = common.neutralize_rays(z3, up, torch.zeros(pool, dtype=torch.bool,
                                                      device=device))
    return (o, d, torch.full((pool,), 1e-6, dtype=torch.float32,
                             device=device), z3)


def _segment_core(scene: DeviceScene, params: RenderParams,
                  cfg: RenderConfig, state: PathState, pend=None):
    """The path logic of one segment, shared by every wavefront driver:
    extension trace, the bounce cap and Russian roulette, implicit
    light hits, next-event estimation and continuation sampling
    (reference: wf_extrays.cl, wf_logic.cl, wf_mat_*.cl, wf_shadowrays.cl).

    pend (deferred form): the previous segment's shadow rays and
    candidates (sh_o, sh_d, sh_len, contrib), traced in the same call as
    this segment's extension rays. Returns, besides the vertex results,
    `resolved` (the previous candidates where unblocked) and `pend2`
    (this segment's)."""
    types = cfg.bsdf_types_mask
    pix = state.pixel_index
    samp = state.sample_index
    bounce = state.path_len
    zero3 = torch.zeros_like(state.radiance)

    # extension trace (wf_extrays.cl); inactive lanes trace misses
    t_orig, t_dir = common.neutralize_rays(state.orig, state.dir,
                                           state.alive)
    if pend is not None:
        hit, blocked_prev = common.trace_scene_with_shadow(
            scene, params, cfg, t_orig, t_dir, pend[0], pend[1], pend[2])
        resolved = vm.where3(~blocked_prev, pend[3],
                             torch.zeros_like(pend[3]))
    else:
        hit = common.trace_scene(scene, params, cfg, t_orig, t_dir)
    path_len = state.path_len + 1

    t = state.throughput
    ei = state.radiance
    # the pick probability of the previous NEE draw, for the MIS weights
    env_prob = _env_prob(cfg)

    # bounce cap and Russian roulette (wf_logic.cl:60-69): the last traced
    # vertex is still shaded, as in the lockstep integrator; roulette only
    # extends paths past the cap
    cut = path_len >= (cfg.max_bounces + 1)
    rr_term = cut
    t_cont = t
    if cfg.use_roulette:
        cont_prob = torch.clamp(vm.luminance(t), 0.01, 0.5)
        u_rr = rng.uniform(pix, samp, bounce, rng.Streams.ROULETTE)
        survive = u_rr <= cont_prob
        t_cont = vm.where3(cut & survive, t / cont_prob[..., None], t)
        rr_term = cut & ~survive

    # implicit env hit (mk_next_vertex.cl:72-96)
    miss = hit.prim < 0
    if cfg.use_env_map:
        bg = env_ops.eval_dir(scene.envmap, state.dir) * params.env_strength
        if not cfg.sample_impl:
            bg = torch.where(path_len == 1, 1.0, 0.0)[..., None] * bg
        w_env = common.implicit_env_weight(
            scene, params, cfg, state.dir, state.last_pdf_w,
            state.last_specular, path_len, env_prob)
        ei = ei + vm.where3(miss, w_env[..., None] * t * bg, zero3)

    # implicit area-light hit (mk_next_vertex.cl:98-117)
    if cfg.use_area_light and cfg.sample_impl:
        w_area = common.implicit_area_weight(
            params, cfg, hit, state.orig, state.dir, state.last_pdf_w,
            state.last_specular, path_len, 1.0 - env_prob)
        add = w_area[..., None] * t * params.area_light.emission
        ei = ei + vm.where3(hit.area_light, add, zero3)

    # shading and next-event estimation at the hit vertex
    live_vertex = ~miss & ~hit.area_light
    ctx = common.make_shading_ctx(scene, hit, state.dir)
    sh_orig = hit.p - common.OFFSET_SHADOW * state.dir
    singular = bsdf_mod.is_singular(ctx.bsdf_id)
    nee_mask = live_vertex & ~singular
    if _nee_on(cfg) and pend is None:
        contrib, _ = _nee_single_light(scene, params, cfg, ctx, sh_orig,
                                       state.dir, types, pix, samp, bounce)
        ei = ei + vm.where3(nee_mask, t * contrib, zero3)
    elif pend is not None:
        if _nee_on(cfg):
            cand, (sh_o2, sh_d2, sh_l2) = _nee_single_light(
                scene, params, cfg, ctx, sh_orig, state.dir, types, pix,
                samp, bounce, defer=True)
            sh_o2, sh_d2 = common.neutralize_rays(sh_o2, sh_d2, nee_mask)
            pend2 = (sh_o2, sh_d2, sh_l2,
                     vm.where3(nee_mask, t * cand, torch.zeros_like(cand)))
        else:
            pend2 = _pend_init(pix.shape[0], pix.device)

    terminate = ~live_vertex | rr_term
    t = t_cont

    u1 = rng.uniform(pix, samp, bounce, rng.Streams.BSDF_U)
    u2 = rng.uniform(pix, samp, bounce, rng.Streams.BSDF_V)
    ul = rng.uniform(pix, samp, bounce, rng.Streams.BSDF_LOBE)
    s = bsdf_mod.bsdf_sample(ctx, state.dir, u1, u2, ul, types)
    wo = vm.normalize(s.wo)
    cos_th = vm.dot(ctx.n, wo)
    ok = (s.pdf != 0.0) & ~vm.is_zero(s.f)
    new_t = t * s.f * (cos_th / torch.where(ok, s.pdf, 1.0))[..., None]
    terminate = terminate | ~ok | vm.is_zero(new_t)
    out = (hit, terminate, ei, wo, new_t, s.pdf, singular, path_len)
    if pend is not None:
        return out + (resolved, pend2)
    return out


def _next_state(state, terminate, keep, r_orig, r_dir, new_pix, new_samp,
                hit, wo, new_t, ei, s_pdf, singular, path_len) -> PathState:
    """Lanes that terminated start the respawned path; the others carry
    the continuation. `keep` is the next `alive`."""
    return PathState(
        orig=vm.where3(terminate, r_orig, hit.p + common.OFFSET_CONT * wo),
        dir=vm.where3(terminate, r_dir, wo),
        throughput=vm.where3(terminate, torch.ones_like(new_t), new_t),
        radiance=vm.where3(terminate, torch.zeros_like(ei), ei),
        pixel_index=torch.where(terminate, new_pix, state.pixel_index),
        sample_index=torch.where(terminate, new_samp, state.sample_index),
        path_len=torch.where(terminate, 0, path_len),
        last_pdf_w=torch.where(terminate, 1.0, s_pdf),
        last_specular=torch.where(terminate, True, singular),
        alive=keep)


def _exclusive_rank(mask):
    m = mask.to(torch.int64)
    return torch.cumsum(m, 0) - m


# ------------------------------------------------------------ scatter form

def wavefront_iteration(scene: DeviceScene, params: RenderParams,
                        cfg: RenderConfig, state: PathState,
                        framebuffer: torch.Tensor, counters: torch.Tensor):
    """One segment over the whole pool with the reference's policy:
    terminated paths splat to their pixel with `index_add_` (the
    reference's float atomics, src/utils.cl:244-312) and respawn on the
    next pixel of a striding counter (wf_raygen.cl:25). `framebuffer`
    (n_pix, 4: RGB and sample count) is updated in place, where the JAX
    package donates it. counters: [pixel counter, spawn counter, samples
    done], int64. Returns (state, framebuffer, counters)."""
    n_pix = cfg.width * cfg.height
    pix = state.pixel_index

    hit, terminate, ei, wo, new_t, s_pdf, singular, path_len = \
        _segment_core(scene, params, cfg, state)

    # splat terminated paths (wf_logic.cl:158-177)
    splat = terminate & (path_len > 0)
    fb_pix = torch.where(splat, pix, 0)
    add = torch.cat([vm.where3(splat, ei, torch.zeros_like(ei)),
                     splat.to(torch.float32)[:, None]], 1)
    framebuffer.index_add_(0, fb_pix, add)

    # respawn (wf_raygen.cl and the host's pixel striding)
    rank = _exclusive_rank(terminate)
    n_respawn = terminate.sum()
    new_pix = (counters[0] + rank) % n_pix
    new_spawn = counters[1] + rank
    r_orig, r_dir = _raygen(params, cfg, new_pix, new_spawn)
    state = _next_state(state, terminate, torch.ones_like(state.alive),
                        r_orig, r_dir, new_pix, new_spawn, hit, wo, new_t,
                        ei, s_pdf, singular, path_len)
    counters = torch.stack([(counters[0] + n_respawn) % n_pix,
                            counters[1] + n_respawn,
                            counters[2] + splat.sum()])
    return state, framebuffer, counters


def render_scatter_reference(scene: DeviceScene, params: RenderParams,
                             cfg: RenderConfig, spp: int,
                             max_iters: int | None = None) -> torch.Tensor:
    """The reference-parity form, not a production path: renders with the
    per-segment splat until the image holds spp samples per pixel on
    average (the reference's interactive accumulation). Returns the
    (H, W, 3) framebuffer divided by its sample counts."""
    n_pix = cfg.width * cfg.height
    target = n_pix * spp
    state = init_state(params, cfg)
    dev = state.orig.device
    fb = torch.zeros((n_pix, 4), dtype=torch.float32, device=dev)
    # the pool pre-spawned pool_size paths
    counters = torch.tensor([cfg.pool_size % n_pix,
                             (cfg.pool_size + n_pix - 1) // n_pix, 0],
                            dtype=torch.int64, device=dev)
    it = 0
    limit = max_iters if max_iters is not None else 10_000
    while it < limit:
        state, fb, counters = wavefront_iteration(scene, params, cfg, state,
                                                  fb, counters)
        it += 1
        if (it % 8 == 0 or it >= limit) and int(counters[2]) >= target:
            break
    img = fb[:, :3] / torch.clamp(fb[:, 3:4], min=1.0)
    return img.reshape(cfg.height, cfg.width, 3)


# ------------------------------------------------------------ stream form

def _respawn_budget(params, cfg, state, counters, spp, terminate, active,
                    seg, pix_base=0, n_pix_local=None):
    """Striding respawn under an exact spawn budget of n_pix * spp over
    the pixels [pix_base, pix_base + n_pix) (n_pix = n_pix_local, the
    whole frame by default), and the counters [spawns, extension rays,
    shadow rays]."""
    n_pix = _n_pix(cfg, n_pix_local)
    hit, _, ei, wo, new_t, s_pdf, singular, path_len = seg
    rank = _exclusive_rank(terminate)
    new_spawn = counters[0] + rank
    can_spawn = terminate & (new_spawn < n_pix * spp)
    new_pix = torch.where(can_spawn, pix_base + new_spawn % n_pix, 0)
    new_samp = torch.where(can_spawn, new_spawn // n_pix, 0)
    r_orig, r_dir = _raygen(params, cfg, new_pix, new_samp)
    keep = torch.where(terminate, can_spawn, active)
    state = _next_state(state, terminate, keep, r_orig, r_dir, new_pix,
                        new_samp, hit, wo, new_t, ei, s_pdf, singular,
                        path_len)
    n_act = active.sum()
    counters = counters + torch.stack([
        can_spawn.sum(), n_act, n_act if _nee_on(cfg) else n_act * 0])
    return state, counters


def _rows(has, pix, ei):
    """One sample row per lane: (r, g, b, pixel), pixel -1 where `has` is
    false."""
    z = torch.zeros_like(ei[:, 0])
    return (torch.where(has, ei[:, 0], z), torch.where(has, ei[:, 1], z),
            torch.where(has, ei[:, 2], z), torch.where(has, pix, -1))


def _n_pix(cfg: RenderConfig, n_pix_local=None) -> int:
    return cfg.width * cfg.height if n_pix_local is None else n_pix_local


def _stream_segment(scene: DeviceScene, params: RenderParams,
                    cfg: RenderConfig, state: PathState,
                    counters: torch.Tensor, spp: int, pix_base=0,
                    n_pix_local: int | None = None):
    """One streaming segment. counters: [spawn counter, extension rays,
    shadow rays], int64. Returns (state, counters, row): the segment's
    completed samples as one (r, g, b, pixel) row per lane, pixel -1
    where the lane finished no sample. Under sharding a shard streams
    its own pixels [pix_base, pix_base + n_pix_local) under a spawn
    budget of its own; the defaults cover the frame."""
    active = state.alive
    seg = _segment_core(scene, params, cfg, state)
    terminate = seg[1] & active
    done = terminate & (seg[7] > 0)
    row = _rows(done, state.pixel_index, seg[2])
    state, counters = _respawn_budget(params, cfg, state, counters, spp,
                                      terminate, active, seg, pix_base,
                                      n_pix_local)
    return state, counters, row


def _stream_segment_d(scene: DeviceScene, params: RenderParams,
                      cfg: RenderConfig, state: PathState,
                      counters: torch.Tensor, spp: int, pend, fin_pix,
                      fin_ei, pix_base=0, n_pix_local: int | None = None):
    """Deferred-shadow streaming segment: the previous segment's shadow
    rays trace in this segment's closest call, and a completed sample's
    row is emitted one segment late, once its last shadow ray has
    resolved (reference: wf_logic.cl:134-156). Returns (state, counters,
    pend, fin_pix, fin_ei, row). pix_base / n_pix_local as in
    _stream_segment."""
    active = state.alive
    (hit, terminate, ei, wo, new_t, s_pdf, singular, path_len, resolved,
     pend2) = _segment_core(scene, params, cfg, state, pend=pend)
    # the resolved candidate goes to the finished sample that awaits it,
    # else to the live path that drew it
    fin_has = fin_pix >= 0
    row = _rows(fin_has, fin_pix, fin_ei + resolved)
    ei = ei + vm.where3(~fin_has, resolved, torch.zeros_like(resolved))

    terminate = terminate & active
    done = terminate & (path_len > 0)
    fin_pix_n = torch.where(done, state.pixel_index, -1)
    fin_ei_n = vm.where3(done, ei, torch.zeros_like(ei))
    seg = (hit, terminate, ei, wo, new_t, s_pdf, singular, path_len)
    state, counters = _respawn_budget(params, cfg, state, counters, spp,
                                      terminate, active, seg, pix_base,
                                      n_pix_local)
    return state, counters, pend2, fin_pix_n, fin_ei_n, row


def _stack_rows(rows):
    return tuple(torch.stack([r[i] for r in rows]) for i in range(4))


def stream_iteration(scene, params, cfg, state, counters, spp: int):
    """One streaming segment over the whole frame, the public entry of
    the JAX package's `stream_iteration`: `_stream_segment` as it is.
    Returns (state, counters, row)."""
    return _stream_segment(scene, params, cfg, state, counters, spp)


def stream_rounds(scene, params, cfg, state, counters, spp: int,
                  n_seg: int, pix_base=0, n_pix_local: int | None = None):
    """n_seg segments, one launch of the stream. Returns (state, counters,
    rows) with rows (r, g, b, pixel), each (n_seg, pool)."""
    rows = []
    for _ in range(n_seg):
        state, counters, row = _stream_segment(scene, params, cfg, state,
                                               counters, spp, pix_base,
                                               n_pix_local)
        rows.append(row)
    return state, counters, _stack_rows(rows)


def stream_rounds_deferred(scene, params, cfg, state, counters, pend,
                           fin_pix, fin_ei, spp: int, n_seg: int):
    """n_seg deferred segments; also returns the pending shadow state and
    the finished samples that await it, for the next launch."""
    rows = []
    for _ in range(n_seg):
        state, counters, pend, fin_pix, fin_ei, row = _stream_segment_d(
            scene, params, cfg, state, counters, spp, pend, fin_pix, fin_ei)
        rows.append(row)
    return state, counters, pend, fin_pix, fin_ei, _stack_rows(rows)


def init_stream_state(params: RenderParams, cfg: RenderConfig, pool: int,
                      pix_base=0, n_pix_local: int | None = None):
    """Pre-spawn a full pool over the pixels [pix_base, pix_base +
    n_pix_local) (the whole frame by default); returns (state, counters)
    with counters[0] already counting the pre-spawns."""
    n_pix = _n_pix(cfg, n_pix_local)
    dev = params.camera.pos.device
    lane = torch.arange(pool, dtype=torch.int64, device=dev)
    state = _fresh_state(params, cfg, pix_base + lane % n_pix,
                         lane // n_pix)
    counters = torch.tensor([pool, 0, 0], dtype=torch.int64, device=dev)
    return state, counters


def render_stream(scene: DeviceScene, params: RenderParams,
                  cfg: RenderConfig, spp: int, segments_per_launch: int = 8,
                  deferred: bool = False):
    """Render exactly `spp` samples per pixel with the streaming wavefront.
    Returns ((H, W, 3) image, counters [spawns, extension rays, shadow
    rays], int64). deferred=True traces each segment's extension rays and
    the previous segment's shadow rays in one traversal call.

    The drain test (is any path alive, or any finished sample waiting for
    its shadow ray) is read every `segments_per_launch` segments, one
    launch late while launches take under 0.25 s, as in the JAX package:
    so whole launches run past the drain, and the rows come in multiples
    of pool * segments_per_launch, which `bucket_rows` pads to."""
    # without next-event estimation there are no shadow rays to defer
    if deferred and not _nee_on(cfg):
        deferred = False
    n_pix = cfg.width * cfg.height
    total = n_pix * spp
    pool = min(cfg.pool_size, total)
    dev = params.camera.pos.device

    state, counters = init_stream_state(params, cfg, pool)
    pend = _pend_init(pool, dev)
    fin_pix = torch.full((pool,), -1, dtype=torch.int64, device=dev)
    fin_ei = torch.zeros((pool, 3), dtype=torch.float32, device=dev)

    # every segment completes a sample or advances every live path a
    # bounce; roulette extends past max_bounces with survival <= 0.5
    cap = (total // pool + cfg.max_bounces + 2) * 8 + 64
    it = 0
    chunks = []
    pending = []   # lagged drain tests: read an older one while the
    #                newest launch is queued
    t_prev = 0.0
    while it < cap:
        t0 = time.perf_counter()
        if deferred:
            state, counters, pend, fin_pix, fin_ei, rows = \
                stream_rounds_deferred(scene, params, cfg, state, counters,
                                       pend, fin_pix, fin_ei, spp,
                                       segments_per_launch)
            drained = state.alive.any() | (fin_pix >= 0).any()
        else:
            state, counters, rows = stream_rounds(
                scene, params, cfg, state, counters, spp,
                segments_per_launch)
            drained = state.alive.any()
        chunks.append(rows)
        it += segments_per_launch
        if t_prev > 0.25:
            # slow launches: a lagged test would run one whole launch past
            # the drain for nothing
            pending.clear()
            done = not bool(drained)
        else:
            pending.append(drained)
            done = len(pending) >= 2 and not bool(pending.pop(0))
        t_prev = time.perf_counter() - t0
        if done:
            break

    rows = [torch.cat([c[i].reshape(-1) for c in chunks]) for i in range(4)]
    img, n_done = _bin_rows(
        bucket_rows(rows, total, pool * segments_per_launch), n_pix, spp)
    if int(n_done) != total:
        raise RuntimeError(
            f"stream drain incomplete: {int(n_done)}/{total} samples "
            f"(cap {cap})")
    return img.reshape(cfg.height, cfg.width, 3), counters


def bucket_rows(rows, total: int, quantum: int = 1):
    """Pad (r, g, b, pixel) sample rows to a multiple of `quantum` that is
    at least `total`; padding rows carry pixel -1. The quantum is one
    launch's rows (pool * segments_per_launch)."""
    n_rows = rows[0].shape[0]
    bucket = max(n_rows, -(-total // quantum) * quantum)
    pad = bucket - n_rows
    if pad:
        rows = [torch.cat([r, torch.zeros(pad, dtype=r.dtype,
                                          device=r.device)])
                for r in rows[:3]] + [
            torch.cat([rows[3], torch.full((pad,), -1, dtype=rows[3].dtype,
                                           device=rows[3].device)])]
    return tuple(rows)


def _bin_rows(rows, n_pix: int, spp: int):
    """Stable sort of the rows by pixel, empty rows (pixel -1) last as
    2**32 - 1; with exact spp the first n_pix * spp sorted rows are
    groups of spp per pixel, summed by a reshape. Returns ((n_pix, 3)
    image, number of non-empty rows)."""
    r, g, b, pix = rows
    keys = torch.where(pix < 0, EMPTY_KEY, pix.to(torch.int64))
    order = torch.sort(keys, stable=True).indices
    total = n_pix * spp
    sel = order[:total]
    img = torch.stack([c[sel].reshape(n_pix, spp).sum(1) for c in (r, g, b)],
                      1) / spp
    n_done = (keys != EMPTY_KEY).sum()
    return img, n_done


# ------------------------------------------------------------ loss half
#
# The differentiable stream: a pool far smaller than the ray list, each
# terminated lane respawning at once on the next ray id, so the traced
# work is the sum of the path lengths rather than the lockstep's
# n x (max_bounces + 1). The loss is separable per ray, so a finished
# lane folds its term into a scalar the moment it finishes: no binning,
# no scatter in the differentiated graph. The counter RNG keys a ray by
# (pixel, sample), so its radiance is the lockstep's.

# segments between the drain checks of the loss and the planner
_DRAIN_EVERY = 4


def _sample_vec(sample_idx, n: int, device) -> torch.Tensor:
    """Per-ray sample ids: a scalar broadcasts (one sample per pixel); an
    (n,) tensor gives each listed ray its own sample id, so one batch can
    hold several samples of a pixel."""
    return torch.broadcast_to(torch.as_tensor(sample_idx, dtype=torch.int64,
                                              device=device), (n,))


def _fold_loss(loss_acc, ei, done, ray_id, target, weight, n: int):
    """Fold the finished lanes into the scalar. L2 (weight None):
    sum((ei - target[ray])^2). Weighted: sum(weight[ray] . ei) with the
    weights constant, the term from which the optimizer assembles the
    paired-sample gradient (render/optimize.py)."""
    idx = torch.clamp(ray_id, max=n - 1)
    if weight is None:
        diff = ei - target[idx]
        return loss_acc + torch.where(done[:, None], diff * diff, 0.0).sum()
    w = weight.detach()[idx]
    return loss_acc + torch.where(done[:, None], w * ei, 0.0).sum()


def _stream_loss_init(params, cfg, pixel_idx, sample_idx, pool: int):
    """The pool's first rays: lane i takes ray i, lanes past the list
    start dead. Returns (state, ray_id, counter, loss_acc, n_done)."""
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    sample_vec = _sample_vec(sample_idx, n, dev)
    lane = torch.arange(pool, dtype=torch.int64, device=dev)
    ray0 = torch.clamp(lane, max=n - 1)
    state = _fresh_state(params, cfg, pixel_idx[ray0].to(torch.int64),
                         sample_vec[ray0])
    state.alive = lane < n
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return (state, ray0, zero + min(pool, n),
            torch.zeros((), dtype=torch.float32, device=dev), zero)


def _loss_advance(params, cfg, pixel_idx, sample_vec, state, ray_id,
                  counter, seg, terminate, n: int):
    """Respawn the terminated lanes on the next ray ids, in lane order
    (the exclusive rank over the terminated mask); returns (state, ray_id,
    counter)."""
    hit, _, ei, wo, new_t, s_pdf, singular, path_len = seg
    new_ray = counter + _exclusive_rank(terminate)
    can = terminate & (new_ray < n)
    new_ray_c = torch.where(can, new_ray, 0)
    new_pix = pixel_idx[new_ray_c].to(torch.int64)
    samp = sample_vec[new_ray_c]
    r_orig, r_dir = _raygen(params, cfg, new_pix, samp)
    keep = torch.where(terminate, can, state.alive)
    state = _next_state(state, terminate, keep, r_orig, r_dir, new_pix,
                        samp, hit, wo, new_t, ei, s_pdf, singular, path_len)
    return (state, torch.where(terminate, new_ray_c, ray_id),
            counter + can.sum())


def _stream_loss_segment(scene, params, cfg, pixel_idx, sample_idx, target,
                         carry, weight=None):
    """One pooled segment: advance every live lane a bounce, fold the
    finished lanes (_fold_loss), respawn from the ray list."""
    n = pixel_idx.shape[0]
    sample_vec = _sample_vec(sample_idx, n, pixel_idx.device)
    state, ray_id, counter, loss_acc, n_done = carry
    seg = _segment_core(scene, params, cfg, state)
    terminate = seg[1] & state.alive
    done = terminate & (seg[7] > 0)
    loss_acc = _fold_loss(loss_acc, seg[2], done, ray_id, target, weight, n)
    n_done = n_done + done.sum()
    state, ray_id, counter = _loss_advance(
        params, cfg, pixel_idx, sample_vec, state, ray_id, counter, seg,
        terminate, n)
    return (state, ray_id, counter, loss_acc, n_done)


def _stream_loss_segment_d(scene, params, cfg, pixel_idx, sample_idx,
                           target, carry, weight=None):
    """Deferred-shadow form of _stream_loss_segment: the previous
    segment's shadow rays trace in this segment's closest call, and a
    finished ray folds one segment late, once its last shadow ray has
    resolved (reference: wf_logic.cl:134-156)."""
    n = pixel_idx.shape[0]
    sample_vec = _sample_vec(sample_idx, n, pixel_idx.device)
    (state, ray_id, counter, loss_acc, n_done, pend, fin_ray,
     fin_ei) = carry
    (hit, terminate, ei, wo, new_t, s_pdf, singular, path_len, resolved,
     pend2) = _segment_core(scene, params, cfg, state, pend=pend)

    # the resolved candidate goes to the finished ray that awaits it, else
    # to the live path that drew it
    fin_has = fin_ray >= 0
    loss_acc = _fold_loss(loss_acc, fin_ei + resolved, fin_has,
                          torch.clamp(fin_ray, 0, n - 1), target, weight, n)
    n_done = n_done + fin_has.sum()
    ei = ei + vm.where3(~fin_has, resolved, torch.zeros_like(resolved))

    terminate = terminate & state.alive
    done = terminate & (path_len > 0)
    fin_ray_n = torch.where(done, ray_id, -1)
    fin_ei_n = vm.where3(done, ei, torch.zeros_like(ei))
    seg = (hit, terminate, ei, wo, new_t, s_pdf, singular, path_len)
    state, ray_id, counter = _loss_advance(
        params, cfg, pixel_idx, sample_vec, state, ray_id, counter, seg,
        terminate, n)
    return (state, ray_id, counter, loss_acc, n_done, pend2, fin_ray_n,
            fin_ei_n)


def _save_all() -> bool:
    """FLUCTUS_STREAM_SAVE=all: no checkpoint, every intermediate kept
    (the backward then only transposes; more memory, less compute)."""
    return os.environ.get("FLUCTUS_STREAM_SAVE", "named") == "all"


def _deferred_carry(base, pool: int, device):
    return base + (_pend_init(pool, device),
                   torch.full((pool,), -1, dtype=torch.int64, device=device),
                   torch.zeros((pool, 3), dtype=torch.float32,
                               device=device))


def _drained(carry, deferred: bool) -> torch.Tensor:
    """No lane alive (and, deferred, no finished ray awaiting its shadow
    ray): every later segment adds nothing."""
    more = carry[0].alive.any()
    if deferred:
        more = more | (carry[6] >= 0).any()
    return ~more


_counting = threading.local()


@contextlib.contextmanager
def count_loss_rays():
    """Count, on the device, the rays the loss segments trace inside the
    block: each segment's live lanes as extension rays and, with
    next-event estimation on, as many shadow rays (the stream's counters'
    rule). Yields a one-element list holding the 0-d int64 total."""
    box = [0]
    prev = getattr(_counting, "box", None)
    _counting.box = box
    try:
        yield box
    finally:
        _counting.box = prev


def _run_segments(scene, params, cfg, pixel_idx, sample_idx, target, carry,
                  n_segments: int, weight, deferred: bool):
    """Up to n_segments segments, each checkpointed where autograd records
    it, stopping early once drained (exact: a drained segment adds
    nothing to the loss or the count)."""
    seg = _stream_loss_segment_d if deferred else _stream_loss_segment
    ckpt = common.grad_needed(scene, params) and not _save_all()
    box = getattr(_counting, "box", None)

    def body(c):
        return seg(scene, params, cfg, pixel_idx, sample_idx, target, c,
                   weight=weight)

    for k in range(n_segments):
        if box is not None:
            box[0] = box[0] + carry[0].alive.sum() * (2 if _nee_on(cfg)
                                                      else 1)
        carry = common.checkpointed(body, carry) if ckpt else body(carry)
        if (k + 1) % _DRAIN_EVERY == 0 and bool(_drained(carry, deferred)):
            break
    return carry


def stream_loss(scene: DeviceScene, params: RenderParams, cfg: RenderConfig,
                pixel_idx, sample_idx, target, pool: int, n_segments: int,
                weight=None):
    """Differentiable loss over one sample per listed pixel through the
    pooled stream. Default: the mean squared error against target[ray],
    over 3n. With `weight` (n, 3): the raw sum of weight[k] . radiance_k,
    the weights constant (render/optimize.py). Returns (loss, n_done);
    n_done must equal len(pixel_idx), or rays were left out (size
    n_segments with plan_stream_segments)."""
    n = pixel_idx.shape[0]
    carry = _stream_loss_init(params, cfg, pixel_idx, sample_idx, pool)
    carry = _run_segments(scene, params, cfg, pixel_idx, sample_idx, target,
                          carry, n_segments, weight, deferred=False)
    loss_acc, n_done = carry[3], carry[4]
    if weight is not None:
        return loss_acc, n_done
    return loss_acc / float(n * 3), n_done


def stream_loss_deferred(scene: DeviceScene, params: RenderParams,
                         cfg: RenderConfig, pixel_idx, sample_idx, target,
                         pool: int, n_segments: int, weight=None):
    """stream_loss with one fused traversal call a segment (the shadow
    rays deferred a segment). The same estimator: the same RNG streams and
    MIS weights; the shadow resolve and the summation order shift. Size
    n_segments with plan_stream_segments(deferred=True). Without
    next-event estimation there is nothing to defer, and it is
    stream_loss."""
    if not _nee_on(cfg):
        return stream_loss(scene, params, cfg, pixel_idx, sample_idx,
                           target, pool, n_segments, weight=weight)
    n = pixel_idx.shape[0]
    carry = _deferred_carry(
        _stream_loss_init(params, cfg, pixel_idx, sample_idx, pool), pool,
        pixel_idx.device)
    carry = _run_segments(scene, params, cfg, pixel_idx, sample_idx, target,
                          carry, n_segments, weight, deferred=True)
    loss_acc, n_done = carry[3], carry[4]
    if weight is not None:
        return loss_acc, n_done
    return loss_acc / float(n * 3), n_done


@torch.no_grad()
def stream_radiance(scene: DeviceScene, params: RenderParams,
                    cfg: RenderConfig, pixel_idx, sample_idx, pool: int,
                    n_segments: int):
    """Forward-only radiance of each listed (pixel, sample) ray through the
    pooled stream. Returns ((n, 3) radiance in list order, n_done). Each
    ray id finishes exactly once, so a finished lane's radiance goes to
    its row by `index_copy_` (the JAX package's stable sort of write-once
    rows gives the same rows); unfinished lanes write a spare row n. Not
    differentiable by design: the optimizer takes its gradient through
    the weighted stream_loss fold, with weights from this pass."""
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    sample_vec = _sample_vec(sample_idx, n, dev)
    state, ray_id, counter, _, n_done = _stream_loss_init(
        params, cfg, pixel_idx, sample_idx, pool)
    out = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)
    for k in range(n_segments):
        seg = _segment_core(scene, params, cfg, state)
        terminate = seg[1] & state.alive
        done = terminate & (seg[7] > 0)
        out.index_copy_(0, torch.where(done, ray_id, n), seg[2])
        n_done = n_done + done.sum()
        state, ray_id, counter = _loss_advance(
            params, cfg, pixel_idx, sample_vec, state, ray_id, counter, seg,
            terminate, n)
        if (k + 1) % _DRAIN_EVERY == 0 and not bool(state.alive.any()):
            break
    return out[:n], n_done


@torch.no_grad()
def plan_stream_segments(scene: DeviceScene, params: RenderParams,
                         cfg: RenderConfig, pixel_idx, sample_idx,
                         pool: int, cap: int = 4096,
                         deferred: bool = False):
    """The number of segments that drains the ray list at this pool size:
    the loss segments, forward only, until no lane is alive (deferred: and
    no finished ray awaits its shadow ray), at most `cap`. The drain is
    read every few segments; the count is the first segment after which
    it held, as the JAX package's while loop counts. Returns (segments,
    n_done) as ints."""
    if deferred and not _nee_on(cfg):
        deferred = False   # stream_loss_deferred is then stream_loss
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    carry = _stream_loss_init(params, cfg, pixel_idx, sample_idx, pool)
    if deferred:
        carry = _deferred_carry(carry, pool, dev)
    seg = _stream_loss_segment_d if deferred else _stream_loss_segment
    if bool(_drained(carry, deferred)):
        return 0, int(carry[4])
    flags = []
    k = 0
    while k < cap:
        carry = seg(scene, params, cfg, pixel_idx, sample_idx, target, carry)
        flags.append(_drained(carry, deferred))
        k += 1
        if k % _DRAIN_EVERY == 0 or k == cap:
            hit = torch.stack(flags).nonzero()
            if hit.numel():
                return k - len(flags) + int(hit[0, 0]) + 1, int(carry[4])
            flags = []
    return k, int(carry[4])
