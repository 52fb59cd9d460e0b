"""Render driver: scene set-up, camera framing, frame renders, display
export, the denoiser's feature buffers, denoised, progressive and preview
renders (counterpart of `fluctus_tpu/render/driver.py`; reference:
src/tracer.cpp).

Entry points run on the CUDA card unless the caller passes device="cpu";
with no card and no such request they raise.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from fluctus_tpu_torch.core import samplers
from fluctus_tpu_torch.core.types import (
    AreaLight, DeviceScene, RenderConfig, RenderParams, default_params)
from fluctus_tpu_torch.integrators import common, lockstep, wavefront
from fluctus_tpu_torch.ops import camera as cam_ops
from fluctus_tpu_torch.ops import envmap as env_ops
from fluctus_tpu_torch.ops import tonemap as tm
from fluctus_tpu_torch.scene.scene import (
    DEFAULT_CACHE_DIR, HostScene, fast_big_eligible, load_scene)


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
    integrator_choice: str | None = None  # cached choose_integrator result
    _choice_key: tuple | None = None      # (params digest, cfg) at choice

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


def create_session(scene_path: str, env_map: str | None = None,
                   cfg: RenderConfig | None = None, use_sbvh: bool = True,
                   cache_dir: str | None = DEFAULT_CACHE_DIR,
                   auto_frame: bool = True,
                   state_dir: str | None = "data/states",
                   device="cuda") -> RenderSession:
    """Load the scene (.obj, .ply, .pbrt or .pbf) and, with `env_map`, a
    Radiance .hdr env map and its sampling tables; load or build the
    hierarchy through the cache in `cache_dir` (None: no cache; none at
    all above the fast-big cutover, where the upload builds the
    brute-chunk forest instead), upload it, derive parameters and restore
    the scene's saved state (reference: Tracer::init, src/tracer.cpp:55-80,
    loadState :634-687). The parameters come in the JAX package's order,
    `device` last, so `create_session(path, env_path)` means the same in
    both. The env map lights the scene when `cfg.use_env_map` is set and a
    map was loaded; a PBRT or PBF quad emitter becomes the area light and
    turns `cfg.use_area_light` on, before framing and the saved state, as
    in the JAX package. The traversal backend resolves as
    `common.resolve_backend` says: "auto" to the per-lane kernels,
    "pallas" to the packet kernel K4, "jnp", "packed" and "wide" to the
    XLA walks, whose tables are uploaded only then."""
    dev = resolve_device(device)
    cfg = cfg or RenderConfig()
    backend = common.resolve_backend(cfg.backend)
    host = load_scene(scene_path, env_map=env_map)
    if not fast_big_eligible(host, dev):
        host.build_bvh(cache_dir=cache_dir, use_sbvh=use_sbvh)
    scene = host.to_device(dev, backend=backend)
    cfg = cfg.replace(backend=backend,
                      bsdf_types_mask=host.material_types_mask,
                      use_env_map=cfg.use_env_map
                      and host.envmap is not None)
    params = default_params(world_radius=host.world_radius(), device=dev)
    if host.area_light_hint is not None:
        # the reference skips PBRT area lights (src/scene.cpp:620-621)
        al = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              for k, v in host.area_light_hint.items()}
        params = dataclasses.replace(params, area_light=AreaLight(**al))
        cfg = cfg.replace(use_area_light=True)
    if auto_frame:
        params = auto_frame_camera(params, host)
    if state_dir:
        from fluctus_tpu_torch.render.state import load_state
        params = load_state(params, host.hash, state_dir=state_dir)
    return RenderSession(host_scene=host, scene=scene, params=params,
                         cfg=cfg)


def _openness_probe(scene: DeviceScene, params: RenderParams,
                    cfg: RenderConfig, pix: torch.Tensor):
    """(primary hit rate, bounce escape rate) on probe pixels: primary rays
    through the pixel centres, then one deterministic low-discrepancy
    cosine bounce from each hit. Returns two 0-d tensors."""
    half = torch.full(pix.shape, 0.5, dtype=torch.float32, device=pix.device)
    zero = torch.zeros(pix.shape, dtype=torch.float32, device=pix.device)
    orig, dir = cam_ops.generate_rays(params.camera, pix, cfg.width,
                                      cfg.height, half, half, zero, zero,
                                      params.world_radius)
    hit = common.trace_scene(scene, params, cfg, orig, dir)
    hit_mask = hit.prim >= 0
    ctx = common.make_shading_ctx(scene, hit, dir)
    f = pix.to(torch.float32)
    u = torch.remainder(f * 0.7548777, 1.0)
    v = torch.remainder(f * 0.5698403, 1.0)
    d2, _ = samplers.cosine_hemisphere(ctx.n, u, v)
    hit2 = common.trace_scene(scene, params, cfg,
                              hit.p + common.OFFSET_CONT * d2, d2)
    esc = hit_mask & (hit2.prim < 0)
    n_hit = hit_mask.sum()
    return (n_hit / pix.shape[0],
            esc.sum() / torch.clamp(n_hit, min=1))


def integrator_decision(hit_rate: float, escape_rate: float,
                        max_bounces: int, nee: bool = True) -> str:
    """The rule behind choose_integrator (the JAX package's, calibrated on
    its TPU protocol sweep). Without next-event estimation: lockstep.
    With it: the expected traced segments per path, 1 + h * min(1/e, mb),
    against the lockstep's mb + 1 trips: the stream where that is at most
    0.55 (mb + 1)."""
    if not nee:
        return "lockstep"
    mb = max_bounces
    mean_len = 1.0 + hit_rate * min(
        1.0 / max(escape_rate, 1.0 / (mb + 1.0)), float(mb))
    return "stream" if mean_len <= 0.55 * (mb + 1) else "lockstep"


def choose_integrator(session: RenderSession, n_probe: int = 4096) -> str:
    """Integrator for the session's scene from an openness probe of about
    n_probe pixels (primary hit rate h, bounce escape rate e) and
    integrator_decision. A CPU session takes the lockstep, as the JAX
    package does on its CPU backend."""
    if session.device.type == "cpu":
        return "lockstep"
    cfg = session.cfg
    n_pix = cfg.width * cfg.height
    stride = max(1, n_pix // n_probe)
    pix = torch.arange(0, n_pix, stride, dtype=torch.int64,
                       device=session.device)
    h, e = _openness_probe(session.scene, session.params, cfg, pix)
    nee = bool(cfg.sample_expl and (cfg.use_env_map or cfg.use_area_light))
    return integrator_decision(float(h), float(e), cfg.max_bounces, nee)


def _tensor_leaves(rec):
    if isinstance(rec, torch.Tensor):
        yield rec
    elif dataclasses.is_dataclass(rec):
        for f in dataclasses.fields(rec):
            yield from _tensor_leaves(getattr(rec, f.name))


def _params_digest(params: RenderParams, *extra: torch.Tensor) -> bytes:
    """Content hash of every tensor leaf of the parameters and of `extra`:
    with the config, the key of the cached integrator choice, so a moved
    camera or light probes again."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in (*_tensor_leaves(params), *extra):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.digest()


def _cached_choice(session: RenderSession) -> str:
    key = (_params_digest(session.params), session.cfg)
    if session.integrator_choice is None or session._choice_key != key:
        session.integrator_choice = choose_integrator(session)
        session._choice_key = key
    return session.integrator_choice


def stream_pool(cfg: RenderConfig) -> int:
    """Stream pool size: n_pix / 16 within [2^12, 2^16], at most
    cfg.pool_size (the JAX package's rule, tuned on its 512^2 frame)."""
    n_pix = cfg.width * cfg.height
    return min(cfg.pool_size, int(np.clip(n_pix // 16, 1 << 12, 1 << 16)))


def render_stream(session: RenderSession, spp: int, deferred: bool = True):
    """The driver's streaming wavefront: pool `stream_pool`, 32 segments
    per launch, deferred shadow rays. Returns ((H, W, 3) image, counters
    [spawns, extension rays, shadow rays])."""
    cfg = session.cfg.replace(pool_size=stream_pool(session.cfg))
    return wavefront.render_stream(session.scene, session.params, cfg, spp,
                                   segments_per_launch=32, deferred=deferred)


def render(session: RenderSession, spp: int,
           integrator: str = "auto") -> torch.Tensor:
    """Linear-radiance frame (H, W, 3) at exactly `spp`, on the session's
    device. integrator: "lockstep", "stream" (`render_stream`) or "auto"
    (an openness probe picks per scene; see choose_integrator)."""
    if integrator == "auto":
        integrator = _cached_choice(session)
    if integrator == "stream":
        return render_stream(session, spp)[0]
    if integrator != "lockstep":
        raise ValueError(f"unknown integrator {integrator!r}")
    return lockstep.render(session.scene, session.params, session.cfg, spp)


def render_ldr(session: RenderSession, spp: int,
               integrator: str = "auto") -> torch.Tensor:
    """Frame after exposure, tonemap and display gamma."""
    return display_frame(session, render(session, spp, integrator=integrator))


def mrays_benchmark(session: RenderSession, duration_s: float = 10.0,
                    integrator: str = "auto") -> dict:
    """MRays/s of the session's integrator through render/benchmark.py:
    the lockstep counts every lane at every bounce, the stream counts the
    rays its queues really traced (reference: src/clcontext.cpp:648-656,
    src/tracer.cpp:333-345)."""
    from fluctus_tpu_torch.render import benchmark as bm

    if integrator == "auto":
        integrator = _cached_choice(session)
    run = (bm.run_benchmark_stream if integrator == "stream"
           else bm.run_benchmark)
    out = run(session, duration_s=duration_s)
    out["integrator"] = integrator
    return out


def display_frame(session: RenderSession, img: torch.Tensor) -> torch.Tensor:
    """Exposure, tonemap and display gamma of a linear frame."""
    w = torch.ones(img.shape[:2], dtype=torch.float32, device=img.device)
    return tm.postprocess(img, w, session.params.exposure,
                          session.cfg.tonemap_op)


@dataclass
class ProgressiveRender:
    """One accumulator refined by sample increments (reference:
    Tracer::update's refinement loop, src/tracer.cpp:189-358, reset when
    the camera or parameters change :203-218).

    `add` continues the sample indices where the last increment stopped
    and folds them onto the accumulator through `lockstep.accumulate`, the
    one-shot render's own fold, so K increments of N spp equal one
    `lockstep.render(K * N, samples_per_launch=...)` bit for bit when N is
    a multiple of the group size (the JAX package's
    test_progressive_matches_oneshot)."""
    session: RenderSession
    samples_per_launch: int = 16
    acc: torch.Tensor | None = None     # (n_pix, 3) radiance sum
    spp_done: int = 0
    _digest: bytes | None = None

    def reset(self) -> None:
        cfg = self.session.cfg
        self.acc = torch.zeros((cfg.width * cfg.height, 3),
                               dtype=torch.float32,
                               device=self.session.device)
        self.spp_done = 0

    def add(self, spp_increment: int) -> int:
        """Accumulate `spp_increment` more samples a pixel, first resetting
        if any parameter or the env image changed since the last add.
        Returns the samples a pixel so far."""
        sess = self.session
        d = _params_digest(sess.params, sess.scene.envmap.image)
        if self.acc is None or d != self._digest:
            self.reset()
            self._digest = d
        spl = self.samples_per_launch
        if spp_increment % spl:
            # group boundaries aligned with the one-shot fold
            spl = max(1, min(spl, spp_increment))
            while spp_increment % spl:
                spl -= 1
        lockstep.accumulate(sess.scene, sess.params, sess.cfg, self.acc,
                            self.spp_done, spp_increment, spl)
        self.spp_done += spp_increment
        return self.spp_done

    def image(self) -> torch.Tensor:
        """The current linear-radiance estimate (H, W, 3)."""
        cfg = self.session.cfg
        if self.acc is None or self.spp_done == 0:
            return torch.zeros((cfg.height, cfg.width, 3),
                               dtype=torch.float32,
                               device=self.session.device)
        return (self.acc / self.spp_done).reshape(cfg.height, cfg.width, 3)


def render_progressive(session: RenderSession, iterations: int,
                       spp_increment: int = 4, export_every: int = 0,
                       export_path: str | None = None, hdr: bool = False,
                       callback=None) -> torch.Tensor:
    """`iterations` increments of a ProgressiveRender, writing the current
    estimate to `export_path` every `export_every` iterations and after
    the last (reference: saveImage every 1000 iterations,
    src/tracer.cpp:356-357). Returns the final linear frame."""
    prog = ProgressiveRender(session)
    for it in range(1, iterations + 1):
        prog.add(spp_increment)
        if callback is not None:
            callback(it, prog)
        if export_every and export_path and it % export_every == 0:
            _export_progressive(session, prog, export_path, hdr)
    if export_path and (not export_every or iterations % export_every):
        _export_progressive(session, prog, export_path, hdr)
    return prog.image()


def _export_progressive(session, prog, path, hdr):
    from fluctus_tpu_torch.io.image import save_image
    img = prog.image()
    if not hdr:
        img = display_frame(session, img)
    save_image(path, img.cpu().numpy())


def render_preview(session: RenderSession, spp: int = 1) -> torch.Tensor:
    """Lockstep frame with the bounces clamped to 2, as the reference's
    first frame after a camera move (src/tracer.cpp:228-241)."""
    cfg = session.cfg.replace(max_bounces=min(2, session.cfg.max_bounces))
    return lockstep.render(session.scene, session.params, cfg, spp)


def _aux_tile(scene: DeviceScene, params: RenderParams, cfg: RenderConfig,
              pix: torch.Tensor):
    half = torch.full(pix.shape, 0.5, dtype=torch.float32, device=pix.device)
    zero = torch.zeros(pix.shape, dtype=torch.float32, device=pix.device)
    orig, dir = cam_ops.generate_rays(params.camera, pix, cfg.width,
                                      cfg.height, half, half, zero, zero,
                                      params.world_radius)
    hit = common.trace_scene(scene, params, cfg, orig, dir)
    ctx = common.make_shading_ctx(scene, hit, dir)
    missed = hit.prim < 0
    albedo = ctx.kd
    if cfg.use_env_map:
        bg = env_ops.eval_dir(scene.envmap, dir) * params.env_strength
        albedo = torch.where(missed[:, None], bg, albedo)
    normal = torch.where(missed[:, None], 0.0, ctx.n)
    depth = torch.where(missed, 2.0,
                        hit.t / torch.clamp(params.world_radius, min=1e-6))
    return albedo, normal, depth


def render_aux(session: RenderSession):
    """The denoiser's feature buffers from the primary hit of a ray
    through each pixel centre, with no lens offset: albedo (H, W, 3) (the
    env colour on a miss when the env map lights the scene), normal (H, W,
    3) (zero on a miss) and depth (H, W) in world radii (2 on a miss)
    (reference: the albedo and normal buffers fed to the OptiX denoiser,
    src/denoiser/OptixDenoiser.cpp:86-159). One closest traversal a tile
    of cfg.tile_size pixels."""
    scene, params, cfg = session.scene, session.params, session.cfg
    n_pix = cfg.width * cfg.height
    tile = min(cfg.tile_size, n_pix)
    outs = []
    for start in range(0, n_pix, tile):
        pix = torch.arange(start, min(start + tile, n_pix),
                           dtype=torch.int32, device=session.device)
        outs.append(_aux_tile(scene, params, cfg, pix))
    shape = (cfg.height, cfg.width)
    albedo, normal, depth = (torch.cat(o) for o in zip(*outs))
    return (albedo.reshape(shape + (3,)), normal.reshape(shape + (3,)),
            depth.reshape(shape))


def render_denoised(session: RenderSession, spp: int, blend: float = 1.0,
                    integrator: str = "auto",
                    iterations: int = 4) -> torch.Tensor:
    """`render`, then the A-trous denoiser over the `render_aux` buffers
    (in place of the reference's OptiX denoiser path). Returns linear
    radiance (H, W, 3)."""
    from fluctus_tpu_torch.ops.denoise import atrous_denoise

    img = render(session, spp, integrator=integrator)
    albedo, normal, depth = render_aux(session)
    return atrous_denoise(img, albedo, normal, depth, iterations=iterations,
                          blend=blend)
