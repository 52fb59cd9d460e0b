"""Path-tracing stages shared by the integrators (counterpart of
`fluctus_tpu/integrators/common.py`; reference: wf_logic.cl,
mk_next_vertex.cl, mk_sample_bsdf.cl).

Visibility is frozen, as in the JAX package: every traversal call gets
detached rays and its result is a constant, and `hit_from_traversal`
recomputes t, u and v on the frozen triangle so that gradients reach the
camera. `checkpointed` runs a bounce or segment body under
`torch.utils.checkpoint` with a tape of its traversal results (the JAX
checkpoint policy `save_only_these_names("trace", "shadow")`): the
recomputation in the backward replays them and launches no traversal.

Traversal goes, in the JAX package's order, through `ops.traverse_brute`
(kernels K2 and K3) on a scene that carries a brute forest,
`ops.traverse_forest` (K5) on one with a treelet forest, and otherwise
`ops.traverse_stack` (K1), or `ops.traverse_pallas` (K4) under
`backend="pallas"`, over the packet forest chunk by chunk where the scene
carries one: the kernels on a CUDA scene, their plain versions on a CPU
scene. The JAX package falls back from its per-lane forest to the packet
kernel's when a chunk's tables pass its VMEM test
(`traverse_mxu.forest_fits_vmem`); K1 reads its tables from device
memory, so the port keeps K1 there. `FLUCTUS_TRAV_SORT=octant` sorts
the rays of a closest K1 walk over the full hierarchy by direction
octant and unsorts the result (the JAX `_sorted_trav`), and only that
walk: forests, packets, the XLA walks and any-hit walks ignore it. The
port's fused extension + shadow call is such a closest walk, so its
shadow half is sorted too, where JAX walks it unsorted through any-hit;
a permutation and its inverse change no hit. The sort sits inside the
taped call, so the tape holds the unsorted result. The JAX package's
XLA walks, `backend="jnp"` (`ops.traverse`), `"packed"`
(`ops.traverse_packed`) and `"wide"` (`ops.traverse_wide`),
are plain PyTorch on either device and taken only when named. Every
stochastic decision draws from the counter-based RNG keyed by (pixel,
sample, bounce, stream).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import torch
import torch.utils.checkpoint

from fluctus_tpu_torch.core import rng, samplers, vecmath as vm
from fluctus_tpu_torch.core.types import (
    DeviceScene, Hit, RenderConfig, RenderParams)
from fluctus_tpu_torch.ops import bsdf as bsdf_mod
from fluctus_tpu_torch.ops import envmap as env_ops
from fluctus_tpu_torch.ops import texture as tex_ops
from fluctus_tpu_torch.ops import (
    ray_sort, traverse, traverse_brute, traverse_forest, traverse_packed,
    traverse_pallas, traverse_stack, traverse_wide)
from fluctus_tpu_torch.ops.intersect import ray_area_light
from fluctus_tpu_torch.ops.traverse_stack import Traversal

T_MAX = 3.4e38
OFFSET_SHADOW = 1e-3   # reference: wf_logic.cl:184 (orig = P - 1e-3*dir)
OFFSET_CONT = 1e-4     # reference: wf_mat_diffuse.cl:54 (P + 1e-4*newDir)


BACKENDS = ("auto", "mxu", "pallas", "jnp", "packed", "wide")
XLA_BACKENDS = ("jnp", "packed", "wide")


def resolve_backend(name: str) -> str:
    """"auto" and "mxu" -> "mxu" (the per-lane kernels K1/K2/K3/K5);
    "pallas" -> "pallas" (the packet kernel K4); "jnp", "packed" and
    "wide" stay as named (the JAX package's XLA walks, plain PyTorch)."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}")
    return "mxu" if name == "auto" else name


def _check_backend_data(scene, cfg):
    if cfg.backend in XLA_BACKENDS + ("pallas",) and scene.wbvh is None:
        raise ValueError(
            f"backend '{cfg.backend}' needs the full hierarchy, but this "
            "scene was uploaded via the fast big-scene path (brute forest "
            "only). Use backend='mxu' or set FLUCTUS_FAST_BIG=0.")
    table = {"jnp": "bvh", "packed": "pbvh"}.get(cfg.backend)
    if table and getattr(scene, table) is None:
        raise ValueError(
            f"backend '{cfg.backend}' needs the scene's `{table}` tables: "
            f"upload with to_device(..., backend='{cfg.backend}')")


def _packets(scene, cfg) -> bool:
    """Whether traversal takes K4: backend "pallas" on a scene without a
    brute or treelet forest (such a scene takes its per-lane kernel, as
    in the JAX package). On a scene with the packet forest (`wforest`)
    K4 traces it chunk by chunk."""
    _check_backend_data(scene, cfg)
    return (resolve_backend(cfg.backend) == "pallas"
            and scene.bforest is None and scene.ftables is None)


class _Tape:
    """The traversal results of one checkpointed body, in call order."""

    def __init__(self):
        self.results = []
        self.pos = 0
        self.replay = False


_active = threading.local()


@contextlib.contextmanager
def _using(tape: _Tape, replay: bool):
    prev = getattr(_active, "tape", None)
    _active.tape = tape
    tape.replay, tape.pos = replay, 0
    try:
        yield
    finally:
        _active.tape = prev


def _taped(fn, *args):
    """fn(*args), a traversal: recorded on the active tape, or, inside a
    recomputation, the result the forward call produced, in call order,
    with nothing launched."""
    tape = getattr(_active, "tape", None)
    if tape is None:
        return fn(*args)
    if tape.replay:
        out = tape.results[tape.pos]
        tape.pos += 1
        return out
    out = fn(*args)
    tape.results.append(out)
    return out


def checkpointed(body, *args):
    """body(*args) under `torch.utils.checkpoint` (non-reentrant): the
    backward recomputes the shading of the body and replays its traversal
    results from a tape, so it launches no traversal kernel (the JAX
    package's checkpoint policy `save_only_these_names("trace",
    "shadow")`)."""
    tape = _Tape()
    return torch.utils.checkpoint.checkpoint(
        body, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (_using(tape, False), _using(tape, True)))


def _tensor_leaves(rec):
    if isinstance(rec, torch.Tensor):
        yield rec
    elif dataclasses.is_dataclass(rec):
        for f in dataclasses.fields(rec):
            yield from _tensor_leaves(getattr(rec, f.name))


def grad_needed(scene: DeviceScene, params: RenderParams) -> bool:
    """Whether autograd records a render of (scene, params): grad mode on
    and some leaf requiring grad. Forward-only renders take no checkpoint
    and no tape."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for rec in (scene, params)
        for t in _tensor_leaves(rec))


def _detached(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def _traverse_closest_tr(scene, cfg, orig, dir, t_max) -> Traversal:
    """Closest-hit traversal under a scalar or per-lane t_max, on detached
    rays (visibility carries no gradient)."""
    return _taped(_closest_tr, scene, cfg, orig.detach().contiguous(),
                  dir.detach().contiguous(), _detached(t_max))


def _closest_tr(scene, cfg, orig, dir, t_max) -> Traversal:
    if cfg.backend in XLA_BACKENDS:
        return _xla_walk(scene, cfg, orig, dir, t_max, any_hit=False)
    if _packets(scene, cfg):
        t_vec = torch.broadcast_to(torch.as_tensor(
            t_max, dtype=torch.float32, device=orig.device), orig.shape[:1])
        if scene.wforest:
            fn = lambda o, d, t: traverse_pallas.traverse_closest_forest(
                scene.wforest, scene.wforest_maps, o, d, t)
        else:
            fn = lambda o, d, t: traverse_pallas.traverse_closest(
                scene.wbvh, o, d, t)
        # rays sorted by the whole scene's bounds, forest or not
        return ray_sort.sorted_apply(
            orig, dir, *traverse_pallas.wbvh_bounds(scene.wbvh), fn, t_vec)
    if scene.bforest is not None:
        return traverse_brute.traverse_closest(scene.bforest, orig, dir,
                                               t_max)
    if scene.ftables is not None:
        return traverse_forest.traverse_closest(scene.ftables, orig, dir,
                                                t_max)
    if scene.wforest:
        return traverse_stack.traverse_closest_forest(
            scene.wforest, scene.wforest_maps, orig, dir, t_max)
    if os.environ.get("FLUCTUS_TRAV_SORT") == "octant":
        return ray_sort.octant_apply(
            orig, dir, t_max, lambda o, d, t:
            traverse_stack.traverse_closest(scene.wbvh, o, d, t))
    return traverse_stack.traverse_closest(scene.wbvh, orig, dir, t_max)


def _xla_walk(scene, cfg, orig, dir, t_max, any_hit: bool):
    """The JAX package's XLA walks (its `common.py:160-176` dispatch):
    "jnp" the binary stack walk, "packed" the child-pair walk, "wide" the
    restart-trail walk; closest Traversal or any-hit flags."""
    _check_backend_data(scene, cfg)
    if cfg.backend == "jnp":
        g = scene.geom
        fn = traverse.traverse_any if any_hit else traverse.traverse_closest
        return fn(scene.bvh, g.v0, g.v1, g.v2, orig, dir, t_max)
    mod = traverse_packed if cfg.backend == "packed" else traverse_wide
    tables = scene.pbvh if cfg.backend == "packed" else scene.wbvh
    fn = mod.traverse_any if any_hit else mod.traverse_closest
    return fn(tables, orig, dir, t_max)


def _traverse_any(scene, cfg, orig, dir, lens) -> torch.Tensor:
    """Any-hit traversal under the per-lane distance `lens`, on detached
    rays."""
    return _taped(_any, scene, cfg, orig.detach().contiguous(),
                  dir.detach().contiguous(), lens.detach())


def _any(scene, cfg, orig, dir, lens) -> torch.Tensor:
    if cfg.backend in XLA_BACKENDS:
        return _xla_walk(scene, cfg, orig, dir, lens, any_hit=True)
    if _packets(scene, cfg):
        if scene.wforest:
            fn = lambda o, d, t: traverse_pallas.traverse_any_forest(
                scene.wforest, o, d, t)
        else:
            fn = lambda o, d, t: traverse_pallas.traverse_any(scene.wbvh, o,
                                                              d, t)
        return ray_sort.sorted_apply(
            orig, dir, *traverse_pallas.wbvh_bounds(scene.wbvh), fn, lens)
    if scene.bforest is not None:
        return traverse_brute.traverse_any(scene.bforest, orig, dir, lens)
    if scene.ftables is not None:
        return traverse_forest.traverse_any(scene.ftables, orig, dir, lens)
    if scene.wforest:
        return traverse_stack.traverse_any_forest(scene.wforest, orig, dir,
                                                  lens)
    return traverse_stack.traverse_any(scene.wbvh, orig, dir, lens)


def trace_scene(scene: DeviceScene, params: RenderParams, cfg: RenderConfig,
                orig, dir) -> Hit:
    """Closest hit + area-light quad + attribute interpolation
    (reference: src/mk_next_vertex.cl:38-43)."""
    tr = _traverse_closest_tr(scene, cfg, orig, dir, T_MAX)
    return hit_from_traversal(scene, params, cfg, orig, dir, tr)


def fused_rays(orig, dir, sh_orig, sh_dir, sh_len):
    """The rays of the fused call, detached: [ext ; shadow] origins and
    directions, and t_max T_MAX for the extension rays, max(sh_len, 1e-6)
    for the shadow rays."""
    t_ext = torch.full((orig.shape[0],), T_MAX, dtype=torch.float32,
                       device=orig.device)
    return (torch.cat([orig.detach(), sh_orig.detach()]).contiguous(),
            torch.cat([dir.detach(), sh_dir.detach()]).contiguous(),
            torch.cat([t_ext, torch.clamp(sh_len.detach(), min=1e-6)]))


def trace_scene_with_shadow(scene: DeviceScene, params: RenderParams,
                            cfg: RenderConfig, orig, dir, sh_orig, sh_dir,
                            sh_len, check_area_quad: bool = True):
    """Extension hits and shadow flags of two independent ray sets
    (counterpart of the JAX `common.trace_scene_with_shadow`). Returns
    (hit, blocked).

    One closest call over [ext ; shadow] rays, the extension rays under
    T_MAX and the shadow rays under t_max = max(sh_len, 1e-6), so a
    shadow ray is blocked exactly when it returns a triangle. Every
    traversal kernel of the port takes a per-lane t_max in closest form
    (K1, K2, K4 and K5), so the port fuses on every scene and backend.
    The JAX package keeps a second form (closest, then any-hit) for its
    treelet forest, its packet backend and tables that fail `_mxu_ok`, a
    test of whether they fit the TPU core's VMEM; that test has no
    meaning on the card."""
    b = orig.shape[0]
    o2, d2, t2 = fused_rays(orig, dir, sh_orig, sh_dir, sh_len)
    lens = t2[b:]
    tr2 = _traverse_closest_tr(scene, cfg, o2, d2, t2)
    tr = Traversal(*(x[:b] for x in tr2))
    blocked = tr2.prim[b:] >= 0
    hit = hit_from_traversal(scene, params, cfg, orig, dir, tr)
    if check_area_quad and cfg.use_area_light:
        al = params.area_light
        q_hit, _ = ray_area_light(sh_orig, sh_dir, al.pos, al.right, al.up,
                                  al.normal, al.size, lens)
        blocked = blocked | q_hit
    return hit, blocked


def hit_from_traversal(scene: DeviceScene, params: RenderParams,
                       cfg: RenderConfig, orig, dir, tr: Traversal) -> Hit:
    """Hit record from a traversal, then the area-light quad. Only the
    prim id (visibility) is frozen: t/u/v are recomputed with
    Moller-Trumbore on the frozen triangle from the rays as given, so
    gradients with respect to the ray origin and direction (the camera)
    flow through the hit point, as in the JAX package; the values agree
    with the traversal's up to roundoff. The traversal result itself
    carries no gradient."""
    g = scene.geom
    prim = tr.prim.to(torch.int64)
    hit_tri = prim >= 0
    p_safe = torch.clamp(prim, min=0)

    a = g.v0[p_safe]
    e1 = g.v1[p_safe] - a
    e2 = g.v2[p_safe] - a
    pvec = vm.cross(dir, e2)
    det = vm.dot(e1, pvec)
    safe = hit_tri & (torch.abs(det) > 1e-20)
    inv_det = 1.0 / torch.where(safe, det, 1.0)
    tvec = orig - a
    u_d = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v_d = vm.dot(dir, qvec) * inv_det
    t_d = vm.dot(e2, qvec) * inv_det
    # miss lanes keep a finite dummy t (orig + t_max*dir would overflow)
    t_hit = torch.where(safe, t_d, torch.where(hit_tri, tr.t, 1.0))
    u = torch.where(safe, u_d, tr.u)[:, None]
    v = torch.where(safe, v_d, tr.v)[:, None]
    w = 1.0 - u - v
    n = vm.normalize(w * g.n0[p_safe] + u * g.n1[p_safe] + v * g.n2[p_safe])
    uv = w * g.uv0[p_safe] + u * g.uv1[p_safe] + v * g.uv2[p_safe]
    # neutralized miss lanes start at 3e37; clamp so squared distances
    # downstream stay finite (identity inside any real scene)
    p = torch.clamp(orig + t_hit[:, None] * dir, -1e15, 1e15)
    mat_id = torch.where(hit_tri, g.mat_id[p_safe], 0)
    hit = Hit(t=torch.where(safe, t_d, tr.t), prim=prim, p=p, n=n, uv=uv,
              mat_id=mat_id, area_light=torch.zeros_like(hit_tri))

    if cfg.use_area_light and cfg.sample_impl:
        al = params.area_light
        al_hit, al_t = ray_area_light(orig, dir, al.pos, al.right, al.up,
                                      al.normal, al.size, hit.t)
        hit = Hit(t=torch.where(al_hit, al_t, hit.t),
                  prim=torch.where(al_hit, 0, hit.prim),
                  p=vm.where3(al_hit, orig + al_t[:, None] * dir, hit.p),
                  n=vm.where3(al_hit, al.normal.expand_as(hit.n), hit.n),
                  uv=hit.uv, mat_id=torch.where(al_hit, 0, hit.mat_id),
                  area_light=al_hit)
    return hit


def make_shading_ctx(scene: DeviceScene, hit: Hit, dir):
    """Material, textures, normal map and backface flip
    (reference: wf_logic.cl:180-184, mk_sample_bsdf.cl:47-54)."""
    m = scene.materials
    mid = hit.mat_id
    map_n = m.map_n[mid]
    n = tex_ops.tangent_space_normal(scene.geom, scene.atlas, hit.prim,
                                     hit.uv, hit.n, map_n)
    backface = vm.dot(n, dir) > 0.0
    n = vm.where3(backface, -n, n)
    kd = tex_ops.mat_albedo(scene.atlas, m.kd[mid], m.map_kd[mid], hit.uv)
    ks = tex_ops.mat_float3(scene.atlas, m.ks[mid], m.map_ks[mid], hit.uv)
    return bsdf_mod.ShadingCtx(n=n, backface=backface, kd=kd, ks=ks,
                               ns=m.ns[mid], ni=m.ni[mid],
                               bsdf_id=m.bsdf_id[mid])


def _shadow_blocked(scene, params, cfg, orig, ldir, lens, check_area_quad):
    """Occlusion before the per-lane distance `lens`, optionally counting
    the area-light quad as a blocker (reference: mk_sample_bsdf.cl:88-93)."""
    lens = torch.broadcast_to(torch.as_tensor(lens, dtype=torch.float32,
                                              device=orig.device),
                              orig.shape[:1])
    blocked = _traverse_any(scene, cfg, orig, ldir, lens)
    if check_area_quad and cfg.use_area_light:
        al = params.area_light
        q_hit, _ = ray_area_light(orig, ldir, al.pos, al.right, al.up,
                                  al.normal, al.size, lens)
        blocked = blocked | q_hit
    return blocked


def neutralize_rays(orig, dir, active):
    """Inactive lanes get rays that miss everything at once."""
    far = torch.full_like(orig, 3.0e37)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dir.dtype,
                      device=dir.device).expand_as(dir)
    return vm.where3(active, orig, far), vm.where3(active, dir, up)


def nee_env(scene, params, cfg, ctx, sh_orig, wi, types_mask, pix, samp,
            bounce, light_pick_prob, active=None):
    """Next-event estimation against the env map by alias sampling
    (reference: mk_sample_bsdf.cl:71-117). The shadow ray is 2 x
    world_radius long and the area-light quad blocks it."""
    u = rng.uniform(pix, samp, bounce, rng.Streams.LIGHT_U)
    L, direct_pdf_w, rad = env_ops.sample_alias_radiance(scene.envmap, u)
    L = vm.normalize(L)
    len_l = 2.0 * params.world_radius * torch.ones(
        wi.shape[0], dtype=torch.float32, device=wi.device)

    f = bsdf_mod.bsdf_eval(ctx, wi, L, types_mask)
    cos_th = torch.clamp(vm.dot(L, ctx.n), min=0.0)
    bsdf_pdf_w = torch.clamp(bsdf_mod.bsdf_pdf(ctx, wi, L, types_mask),
                             min=0.0)
    # trace only lanes whose contribution can be nonzero: about half the
    # draws of a full-sphere map land below a diffuse surface's hemisphere
    live = (cos_th > 0.0) & ~vm.is_zero(f) & (direct_pdf_w != 0.0)
    if active is not None:
        live = live & active
    sh_o, L_t = neutralize_rays(sh_orig, L, live)
    blocked = _shadow_blocked(scene, params, cfg, sh_o, L_t, len_l,
                              check_area_quad=True)
    weight = 1.0
    if cfg.sample_impl:
        weight = (direct_pdf_w * light_pick_prob) / torch.clamp(
            direct_pdf_w * light_pick_prob + bsdf_pdf_w, min=1e-20)
    li = rad * params.env_strength
    denom = torch.clamp(light_pick_prob * direct_pdf_w, min=1e-20)
    contrib = f * li * (weight * cos_th / denom)[..., None]
    ok = ~blocked & (direct_pdf_w != 0.0)
    return vm.where3(ok, contrib, torch.zeros_like(contrib))


def nee_area(scene, params, cfg, ctx, sh_orig, wi, types_mask, pix, samp,
             bounce, light_pick_prob, shorten=1.0, active=None):
    """Next-event estimation against the rectangular area light
    (reference: mk_sample_bsdf.cl:120-155)."""
    al = params.area_light
    u1 = rng.uniform(pix, samp, bounce, rng.Streams.LIGHT_AREA_U)
    u2 = rng.uniform(pix, samp, bounce, rng.Streams.LIGHT_AREA_V)
    pos_l, pdf_a = samplers.sample_area_light(al.pos, al.right, al.up,
                                              al.size, u1, u2)
    delta = pos_l - sh_orig
    dist = vm.length(delta)
    L = vm.normalize(delta)
    len_l = dist * shorten

    cos_light = torch.clamp(vm.dot(al.normal, -L), min=0.0)
    f = bsdf_mod.bsdf_eval(ctx, wi, L, types_mask)
    cos_th = torch.clamp(vm.dot(L, ctx.n), min=0.0)
    direct_pdf_w = samplers.pdf_area_to_solid_angle(pdf_a, len_l, cos_light)
    bsdf_pdf_w = torch.clamp(bsdf_mod.bsdf_pdf(ctx, wi, L, types_mask),
                             min=0.0)
    # trace only lanes whose contribution can be nonzero
    live = (cos_th > 0.0) & ~vm.is_zero(f) & (cos_light > 0.0)
    if active is not None:
        live = live & active
    sh_o, L_t = neutralize_rays(sh_orig, L, live)
    blocked = _shadow_blocked(scene, params, cfg, sh_o, L_t, len_l,
                              check_area_quad=False)
    weight = 1.0
    if cfg.sample_impl:
        weight = (direct_pdf_w * light_pick_prob) / torch.clamp(
            direct_pdf_w * light_pick_prob + bsdf_pdf_w, min=1e-20)
    denom = torch.clamp(light_pick_prob * direct_pdf_w, min=1e-20)
    contrib = al.emission * (f * (weight * cos_th / denom)[..., None])
    ok = ~blocked & (cos_light > 0.0)
    return vm.where3(ok, contrib, torch.zeros_like(contrib))


def implicit_env_weight(scene, params, cfg, dir, last_pdf_w, last_specular,
                        path_len, light_pick_prob):
    """MIS weight of an implicit env-map hit
    (reference: wf_logic.cl:84-107, mk_next_vertex.cl:74-96)."""
    if not (cfg.sample_impl and cfg.sample_expl and cfg.use_env_map):
        return torch.ones(dir.shape[0], dtype=torch.float32,
                          device=dir.device)
    direct_pdf_w = env_ops.pdf_dir(scene.envmap, dir)
    actual = last_pdf_w * light_pick_prob
    w = actual / torch.clamp(actual + direct_pdf_w, min=1e-20)
    return torch.where((path_len > 1) & ~last_specular, w, 1.0)


def implicit_area_weight(params, cfg, hit: Hit, orig, dir, last_pdf_w,
                         last_specular, path_len, light_pick_prob):
    """MIS weight of an implicit area-light hit
    (reference: wf_logic.cl:109-132, mk_next_vertex.cl:98-117)."""
    if not cfg.sample_expl:
        return torch.ones(dir.shape[0], dtype=torch.float32,
                          device=dir.device)
    al = params.area_light
    pdf_a = 1.0 / (4.0 * al.size[0] * al.size[1])
    dist = vm.length(hit.p - orig)
    cos_l = vm.dot(vm.normalize(-dir), hit.n)
    direct_pdf_w = samplers.pdf_area_to_solid_angle(pdf_a, dist, cos_l)
    w = last_pdf_w / torch.clamp(
        last_pdf_w + direct_pdf_w * light_pick_prob, min=1e-20)
    return torch.where((path_len > 1) & ~last_specular, w, 1.0)
