"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds kernels K1, K2+K3, K5, K4 and the probes P1+P2 from
fluctus_tpu_torch/csrc (one nvcc per source, started together, and the
fastcall extension every launch goes through). Kitchen: holds K1 against
its plain PyTorch version on the scene's rays and on the wide tie
hierarchy of fluctus_tpu_torch/fixtures.py, times it and its design
steps (scripts/probe_walk_design.py's builds; with FLUCTUS_PARENT_TREE
set to another checkout's root, that checkout's K1 and K4 too, in the
same call); holds P1 and P2 against
theirs and runs the launch-floor and peak-rate probes (P1 at 1 and 64
blocks, in turns with PyTorch's own x + 1.0, and the host steps of one P1
launch; K1 at 1k and 64k rays; P2 fused and unfused, the bf16 matmul, the
HBM bandwidth); renders the kitchen (lockstep, 512x512,
8 bounces, 16 spp) through the port's entry points, checks that the frame
went through K1, and holds two small renders against the committed
goldens. The stream: holds it against the lockstep without next-event
estimation and deferred against immediate with it (64x64), runs the
integrator choice's openness probe on the kitchen, renders the
kitchen through driver.render(integrator="stream") (512x512, 8 bounces,
4 spp) through K1's closest form only, holds the two golden sessions'
stream renders against the same stream on the host's CPU, holds one
fused call of each stream render ([extension ; shadow] rays with per-lane
t_max) through its kernel against the plain version, and runs both
benchmark harnesses for about 8 s each. Then the packet path: holds K4
against its plain version (on the tie hierarchy too), times it and its
design steps beside K1 with the packets' visit counts, renders the kitchen under
backend="pallas" (512x512, 8 bounces, 4 spp) through K4 only, and holds
the same two goldens through K4. The env map: writes a seeded 1024x512
sky with the port's write_hdr and opens the luxball (BASELINE config 2:
MIS env map, thin-lens DoF) with it through create_session, renders it
(512x512, 4 bounces, 8 spp) through the lockstep (K1 in both forms) and
the stream (K1's fused closest call), and holds 64x64 env-lit renders of
the luxball and of the cornell with env and area light, through K1 (the
lockstep and the stream) and K4, against the same renders on the host's
CPU. Gradients: grad-check holds the gradients of parallel/mesh.py's
loss_fn and deferred loss_fn_stream (kd, env_image, env_strength, ni,
cam_pos, cam_fov) on the CPU tests' planes (env-lit; area-lit by NEE under
a tilted camera) and the 64x64 env-lit luxball, on the card through K1
and through K4 (backend "pallas"), against the same code on the host's
CPU, and counts the traversal launches of each forward and backward (the
backward must launch none); grad-step runs one stream optimizer step on
the 512x512 luxball (4 bounces, env_image and kd differentiable, 4 spp,
the full frame), checkpointed and under FLUCTUS_STREAM_SAVE=all, with the
seconds of its parts, fwd+bwd MRays/s and peak memory, then one lockstep
step at minibatch 4096; optimize runs render/optimize.py's
run_optimization (method "auto", the stream) for 3 steps against a
target rendered with kd x 0.5, and resumes it to 4. Conference (232k
triangles, above the
fast-big cutover, so its session holds a brute-chunk forest and no
hierarchy): holds K2 and K3 against their plain versions through the same
schedulers (both also on the forests of equal-t copies that pin their
ties), times them beside K1 on a full hierarchy of the same scene
(with K2's resident warps per SM and its rate on an all-live slab),
renders the conference (lockstep, 512x512, 6 bounces, 4 spp) and checks
that it went through K2 only, holds the conference golden through K2 and,
under FLUCTUS_BRUTE_SCHED=rounds, through K3, and holds its stream
through the fused K2 call against the same stream through K1 over the
full hierarchy, with one of its fused calls held through K2 against the
plain version. Then the treelet path: a FLUCTUS_FOREST=treelet session
of the conference (SBVH hierarchy and treelet forest), K5 against its
plain version (the work queue in one launch against the round loop over
the plain version; the per-launch kernel under the round loop and the
passes) and against K1 on the session's hierarchy, K5's times (the queue
beside the per-round design it replaced, the rays as given and sorted),
the same frame through K5 only, one K5 launch per traversal call, and the
conference golden through K5. Last, deep-stack: K1, K4 and K5 on
hierarchies of wide depth 40 (fluctus_tpu_torch/fixtures.py's chains),
bit-equal to their plain versions. Then the scene formats, in a temporary
working directory: BASELINE config 4's stand-in written as a 6.3M-triangle
binary PLY (fixtures.sphere_grid_ply, grid 17) and opened with the sky
through create_session (session-ply: load, hash and brute-forest seconds),
K2 bit-equal to its plain version on 4,096 of its primary rays, its
env-lit frame (lockstep, 512x512, 2 bounces, 4 spp) through K2 only, and
the grid-3 PLY at 64x64 through K1 against the CPU (golden-ply); the
kitchen written as PBRT with the saved state's ceiling light as its
AreaLightSource quad (session-pbrt, with its parse cache), its frame
(lockstep, 512x512, 8 bounces, 4 spp) through K1 only, K1 bit-equal on
its rays, its PBF conversion with host arrays equal to the PBRT route's,
and 64x64 stream renders of both through K1 and K4 against the CPU (pbf);
the PBRT frame written as PNG and HDR and read back (save-image); the
conference under FLUCTUS_FAST_BIG=0 cold and warm through the hierarchy
cache (session-cache); the kitchen's NumPy-built SAH hierarchy
(FLUCTUS_NATIVE=0) through K1 bit-equal to plain (native-off); and a
2048x2048 BC7 DDS texture through scene/native/bcn.cpp (dds), and one
512x512 file of each of PCX, DCX, QOI, SGI (raw and RLE), MSP (versions 1
and 2), XBM, DIB, PSD (raw and PackBits) and Sun raster (raw and RLE)
through the texture dispatch (formats). The auxiliary surfaces: the
kitchen's denoiser buffers through K1 at 512x512 (one closest launch a
tile) and K4 at 64x64, each against the plain walk on the card (aux), and
K1 timed against its plain version on those tiles' rays (aux-time); its
denoised 4 spp frame, and the denoised 128x128 luxball nearer a 64 spp
frame than the raw one (denoise); two progressive increments of the
luxball bit-equal to the one-shot frame, the reset, the PNG export and
the 2-bounce preview (progressive); the kitchen's centre pick, one K1
launch of one ray, the focus and the saved state (pick); and the command
line, `python3 -m fluctus_tpu_torch.cli` render (plain, --hdr, --denoise,
--progressive), benchmark, optimize and convert on the kitchen, and
render under the backends jnp, packed and wide against auto (cli). The
packet forest: the conference under FLUCTUS_PACKET_FOREST=1 (its set-up
seconds by step and its 8 chunks: session-pforest), both forest walks,
K1's and K4's, one launch a chunk, bit-equal to the same loops over
their plain versions on 65,536 rays and against K1 over the full
hierarchy up to ties (pforest-check), timed with their bounds
(pforest-time), the conference golden and the 512x512 frame through each
forest only (frame-pforest-k1, frame-pforest-k4). Parallel: the env-lit
luxball at 512x512, 8 spp on a 4-shard mesh over the card,
render_sharded and render_stream_sharded against the single-device
renders, the spawn counters, grad_step with and without the mesh and
grad_step_stream against grad_step at minibatch 4,096, and
scaling_benchmark at 1, 2 and 4 shards (parallel, parallel-scaling;
shards share the card, so efficiency is no scaling figure); then two
processes in a gloo group, one shard each on the card, against the
in-process 2-shard mesh (parallel-ranks). Every other session passes
cache_dir=None. Each phase prints one line with its
wall time; the last three lines are the kernels record, the card and the
device record.
Any failed check raises, so the script exits non-zero. It needs a CUDA
device and the repository around it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
KITCHEN = os.path.join(REPO, "assets", "kitchen_proxy.obj")
CORNELL = os.path.join(REPO, "assets", "cornell_proxy.obj")
CONFERENCE = os.path.join(REPO, "assets", "conference_proxy.obj")
LUXBALL = os.path.join(REPO, "assets", "luxball_proxy.obj")
ENV_SEED = 11          # the seeded 1024x512 sky of the env-lit phases
DEEP_DEPTH = 40        # wide depth of the deep-stack hierarchies
STATES = os.path.join(REPO, "data", "states")
GOLDENS = os.path.join(REPO, "tests", "goldens")

# H100 SXM peaks (NVIDIA data sheet), for the roofline bound of K1. The
# 67 TFLOP/s f32 peak counts an FMA as 2 FLOPs; K1 is built with
# -fmad=false, so each add, mul, min, max and compare is one FP32-pipe
# instruction, issued at half that rate.
HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2
# instructions per occupied child slab test and per real triangle test,
# counted from the source (the division counted as one): 6 sub + 6 mul +
# 10 min/max + 4 compares = 26; Moller-Trumbore 2 cross (18) + 4 dots (20)
# + 3 sub + 1 div + 2 mul + 11 compares/logic = 55
OPS_PER_CHILD = 26
OPS_PER_TRI = 55
NODE_ROW_BYTES = 56 * 4
# golden limits on the card (see PERF.md): per-image share of pixels within
# the goldens' RTOL/ATOL, and per-image mean relative error. cornell_area
# matches on every pixel; the kitchen, as on the CPU, differs on a few
# pixels where op order flips a path.
RTOL, ATOL = 1e-3, 1e-4
GOLDEN_LIMITS = {"cornell_area": (1.0, 1e-4), "kitchen_cfg3": (0.995, 1e-4),
                 "conference": (0.995, 1e-4), "luxball_env": (0.995, 1e-4),
                 "cornell_env": (0.995, 1e-4), "ply_grid3": (0.995, 1e-4),
                 "kitchen_pbrt": (0.995, 1e-4)}
T_REL_TOL = 1e-5

_T0 = time.perf_counter()


def say(phase: str, t_start: float, msg: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t_start:8.2f}s  {msg}",
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def larger(t_bytes, t_ops):
    """The bound and what binds it: the larger of the byte time and the
    operation time."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kitchen_cfg(width, height, max_bounces=8):
    from fluctus_tpu_torch.core.types import RenderConfig
    return RenderConfig(width=width, height=height, max_bounces=max_bounces,
                        use_area_light=True, use_env_map=False)


def kernel_rays(sess, n_extra: int, seed: int):
    """The frame's primary rays plus seeded bounce rays (closest form) and
    shadow rays toward the area light with per-lane t_max (any-hit form)."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.core import rng
    from fluctus_tpu_torch.integrators import common
    from fluctus_tpu_torch.ops import camera

    cfg, p = sess.cfg, sess.params
    dev = sess.device
    pix = torch.arange(cfg.width * cfg.height, device=dev,
                       dtype=torch.int32)
    u = [rng.uniform(pix, 0, 0, k) for k in range(4)]
    o_p, d_p = camera.generate_rays(p.camera, pix, cfg.width, cfg.height,
                                    *u, p.world_radius)
    hit = common.trace_scene(sess.scene, p, cfg, o_p, d_p)
    ok = (hit.prim >= 0).nonzero()[:, 0]
    g = np.random.default_rng(seed)
    sel = torch.as_tensor(g.integers(0, ok.numel(), n_extra), device=dev)
    base = hit.p[ok[sel]]
    d_in = d_p[ok[sel]]
    n = hit.n[ok[sel]]
    n = torch.where((n * d_in).sum(1, keepdim=True) > 0, -n, n)
    d = torch.as_tensor(g.normal(size=(n_extra, 3)).astype(np.float32),
                        device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    d = torch.where((d * n).sum(1, keepdim=True) < 0, -d, d)
    o_b = base + common.OFFSET_CONT * d
    al = p.area_light
    uv = torch.as_tensor(g.uniform(-1, 1, (n_extra, 2)).astype(np.float32),
                         device=dev)
    lp = al.pos + (uv[:, :1] * al.size[0]) * al.right \
        + (uv[:, 1:] * al.size[1]) * al.up
    o_s = base - common.OFFSET_SHADOW * d_in
    delta = lp - o_s
    dist = delta.norm(dim=1)
    d_s = delta / dist[:, None]
    t_s = dist * torch.as_tensor(
        g.uniform(0.5, 1.0, n_extra).astype(np.float32), device=dev)
    t_c = torch.full((o_p.shape[0] + n_extra,), common.T_MAX,
                     dtype=torch.float32, device=dev)
    return (torch.cat([o_p, o_b]).contiguous(),
            torch.cat([d_p, d]).contiguous(), t_c,
            o_s.contiguous(), d_s.contiguous(), t_s.contiguous())


def bound_ms(bvh, n_rays, stats, any_hit):
    """Least time for the work: bytes moved (inputs read once, outputs
    written once) over HBM bandwidth, or the slab tests of the occupied
    child slots and the Moller tests of the real triangles that these
    rays' visits need, over the f32 instruction rate; the larger."""
    table = (bvh.nodes.numel() + bvh.leaves.numel()) * 4
    io = n_rays * (28 + (1 if any_hit else 16))
    ops = (stats["child_tests"] * OPS_PER_CHILD
           + stats["tri_tests"] * OPS_PER_TRI)
    t_bytes = (table + io) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_INSTR_PER_S * 1e3
    return larger(t_bytes, t_ops)


def phase_kernel(sess, n_extra=1 << 17, tile=1 << 16):
    """K1 against its plain version on the card, both forms, and timings
    at the main path's launch shape (tile rays per launch)."""
    import torch
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch.timing import time_launches

    t0 = time.perf_counter()
    bvh = sess.scene.wbvh
    o, d, t_c, o_s, d_s, t_s = kernel_rays(sess, n_extra, seed=7)
    kc = ts.traverse_kernel(bvh, o, d, t_c, any_hit=False)
    ka = ts.traverse_kernel(bvh, o_s, d_s, t_s, any_hit=True)
    pc, _ = ts.traverse_plain(bvh, o, d, t_c, any_hit=False)
    _, pa = ts.traverse_plain(bvh, o_s, d_s, t_s, any_hit=True)
    torch.cuda.synchronize()

    diff = kc.prim != pc.prim
    ties = diff & (kc.t == pc.t)
    hit = (kc.prim >= 0) & (pc.prim >= 0)
    t_abs = (kc.t - pc.t).abs()
    t_rel = float((t_abs / pc.t.abs().clamp(min=1e-30))[hit].max())
    t_max_abs = float(t_abs[hit].max())
    n_mismatch = int((diff & ~ties).sum())
    any_mismatch = int((ka != pa).sum())
    say("k1-check", t0,
        f"closest: {o.shape[0]} rays, {int((kc.prim >= 0).sum())} hits, "
        f"prim mismatches {n_mismatch} (+{int(ties.sum())} equal-t ties), "
        f"max rel t err {t_rel:.3e}, max abs t err {t_max_abs:.3e}; "
        f"any-hit: {o_s.shape[0]} rays, {int(ka.sum())} blocked, "
        f"flag mismatches {any_mismatch}")
    check(n_mismatch == 0, "K1 closest prim ids differ from the plain "
          "version")
    check(t_rel <= T_REL_TOL, f"K1 t error {t_rel} > {T_REL_TOL}")
    check(any_mismatch == 0, "K1 any-hit flags differ from the plain "
          "version")

    # timings at the main path's launch shape: tiles of `tile` rays, the
    # closest form on primary and bounce rays, the any-hit form on shadow
    # rays; plain and kernel on the same inputs, in turns
    t1 = time.perf_counter()
    n_p = o.shape[0] - n_extra
    sets = {"closest": [(o[:tile], d[:tile], t_c[:tile]),
                        (o[n_p:n_p + tile], d[n_p:n_p + tile],
                         t_c[n_p:n_p + tile])],
            "any": [(o_s[:tile], d_s[:tile], t_s[:tile])]}
    out = {}
    for form, rays in sets.items():
        anyh = form == "any"
        stats: dict = {}
        k_ms = p_ms = 0.0
        for (ro, rd, rt) in rays:
            ts.traverse_plain(bvh, ro, rd, rt, anyh, stats=stats)
            run_p = lambda: ts.traverse_plain(bvh, ro, rd, rt, anyh)
            run_k = lambda: ts.traverse_kernel(bvh, ro, rd, rt, anyh)
            p1 = time_launches(run_p, 2, 1)
            k1 = time_launches(run_k, 20, 1)
            k2 = time_launches(run_k, 20, 1)
            p2 = time_launches(run_p, 2, 1)
            k_ms += (k1 + k2) / 2
            p_ms += (p1 + p2) / 2
        n = len(rays)
        b_ms, b_by = bound_ms(bvh, tile * n, stats, anyh)
        out[form] = dict(ms=k_ms / n, plain_ms=p_ms / n, bound_ms=b_ms / n,
                         bound_by=b_by,
                         node_rows_per_ray=stats["node_visits"] / (tile * n),
                         leaf_rows_per_ray=stats["leaf_visits"] / (tile * n),
                         child_tests_per_ray=stats["child_tests"] / (tile * n),
                         tri_tests_per_ray=stats["tri_tests"] / (tile * n),
                         max_abs_err=t_max_abs if form == "closest"
                         else float(any_mismatch > 0))
        r = out[form]
        row_bytes = (r["node_rows_per_ray"] * NODE_ROW_BYTES
                     + r["leaf_rows_per_ray"] * bvh.leaf_width * 40) * tile
        say("k1-time", t1,
            f"{form}: {r['ms']:.3f} ms per {tile}-ray launch (plain "
            f"{r['plain_ms']:.1f} ms), bound {r['bound_ms']:.4f} ms by "
            f"{b_by}; rows per ray: {r['node_rows_per_ray']:.2f} node, "
            f"{r['leaf_rows_per_ray']:.2f} leaf, tests per ray: "
            f"{r['child_tests_per_ray']:.2f} child slab, "
            f"{r['tri_tests_per_ray']:.2f} triangle; "
            f"{row_bytes / 1e6:.1f} MB of row fetches per launch "
            f"({row_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at HBM rate)")
    return out


def phase_wide_ties(kernel: str):
    """K1 ("k1") or K4 ("k4") against its plain version on the tie
    hierarchy of fluctus_tpu_torch/fixtures.py (equal-t copies of one
    triangle in slots a K1 team deals to different lanes, in two leaves
    entered in a known order, and in two leaves with equal entry
    distances; tie rays in every warp and every CTA of a K4 packet): both
    forms bit-equal, and every tie ray hits the copy the kernel's
    sequential rule picks."""
    import torch
    from fluctus_tpu_torch.convert import wide_from_numpy
    from fluctus_tpu_torch.fixtures import WIDE_TIES, wide_tie_bvh
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts

    t0 = time.perf_counter()
    arrays, o, d, want = wide_tie_bvh()
    w = wide_from_numpy(arrays, device="cuda")
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    want = want[kernel]
    tie = torch.from_numpy(want >= 0).cuda()
    for t_max in (3.4e38, 9.5):
        t = torch.full((o.shape[0],), t_max, device="cuda")
        if kernel == "k1":
            k = ts.traverse_kernel(w, o, d, t, any_hit=False)
            p, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
            ka = ts.traverse_kernel(w, o, d, t, any_hit=True)
            pa = ts.traverse_plain(w, o, d, t, any_hit=True)[1]
        else:
            k = tp.traverse_closest(w, o, d, t, launch=tp.packet_kernel)
            p = tp.traverse_closest(w, o, d, t, launch=tp.packet_plain)
            ka = tp.traverse_any(w, o, d, t, launch=tp.packet_kernel)
            pa = tp.traverse_any(w, o, d, t, launch=tp.packet_plain)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(k, f), getattr(p, f))
                   for f in ("prim", "t", "u", "v"))
        winners = bool(torch.equal(k.prim[tie].cpu(),
                                   torch.from_numpy(want[want >= 0])))
        flags = bool(torch.equal(ka, pa))
        say(f"{kernel}-ties", t0,
            f"{kernel.upper()} vs its plain version on the wide tie "
            f"hierarchy ({', '.join(WIDE_TIES)}; {int(tie.sum())} of "
            f"{o.shape[0]} rays through the copies; t_max {t_max:g}): "
            f"closest prim, t, u, v bit-equal {same}, every tie ray hits "
            f"the expected copy {winners}; any-hit flags equal {flags} "
            f"({int(ka.sum())} blocked)")
        check(same and winners, f"{kernel.upper()} breaks a tie otherwise "
              "than its plain version")
        check(flags and bool(ka[tie].all()), f"{kernel.upper()} any-hit "
              "flags differ from the plain version on the tie hierarchy")


def design_steps(kernel: str, sess, phase: str) -> None:
    """The design probe's builds of `kernel` (and, with FLUCTUS_PARENT_TREE
    set to another checkout's root, that checkout's kernel) timed on the
    k1-time / k4-time tiles, one line each, every one bit-equal to the
    plain version."""
    from fluctus_tpu_torch.scripts import probe_walk_design as probe
    t0 = time.perf_counter()
    out = probe.design_steps(kernel, sess,
                             parent=os.environ.get("FLUCTUS_PARENT_TREE"),
                             say=lambda m: say(phase, t0, m))
    bad = [n for n, r in out.items() if not r["equal"]]
    check(not bad, f"{kernel.upper()} builds {bad} differ from the plain "
          "version")


def golden_sessions(dev, backend="auto"):
    """The 64x64 golden sessions: {name: (session, spp)}."""
    import torch
    from fluctus_tpu_torch.core.types import AreaLight
    from fluctus_tpu_torch.render import driver

    cornell = driver.create_session(
        CORNELL, cfg=kitchen_cfg(64, 64, max_bounces=4).replace(
            backend=backend), cache_dir=None, state_dir=None, device=dev)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    cornell.params = dataclasses.replace(cornell.params, area_light=AreaLight(
        pos=f([0.0, 3.95, 0.0]), right=f([1.0, 0.0, 0.0]),
        up=f([0.0, 0.0, -1.0]), normal=f([0.0, -1.0, 0.0]),
        emission=f([15.0, 15.0, 15.0]), size=f([1.0, 1.0])))
    kitchen = driver.create_session(
        KITCHEN, cfg=kitchen_cfg(64, 64).replace(backend=backend),
        cache_dir=None, state_dir=STATES, auto_frame=False, device=dev)
    return {"cornell_area": (cornell, 8), "kitchen_cfg3": (kitchen, 4)}


# ------------------------------------------------------------ env map

def env_cfg(width, height, area: bool = False):
    """BASELINE config 2's frame (4 bounces, MIS env map; the cornell
    variant adds its area light)."""
    from fluctus_tpu_torch.core.types import RenderConfig
    return RenderConfig(width=width, height=height, max_bounces=4,
                        use_area_light=area, use_env_map=True)


def env_sessions(path, dev, backend="auto", size=64):
    """The env-lit sessions: the luxball (thin-lens DoF, aperture 0.06,
    as tests/golden_common.py's luxball_cfg2) and the cornell with the env
    map and its area light. {name: session}."""
    import torch
    from fluctus_tpu_torch.core.types import AreaLight
    from fluctus_tpu_torch.render import driver

    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    lux = driver.create_session(
        LUXBALL, path, env_cfg(size, size).replace(backend=backend),
        cache_dir=None, state_dir=None, device=dev)
    lux.params = dataclasses.replace(lux.params, camera=dataclasses.replace(
        lux.params.camera, aperture_size=f(0.06)))
    cor = driver.create_session(
        CORNELL, path, env_cfg(size, size, area=True).replace(
            backend=backend), cache_dir=None, state_dir=None, device=dev)
    cor.params = dataclasses.replace(cor.params, area_light=AreaLight(
        pos=f([0.0, 3.95, 0.0]), right=f([1.0, 0.0, 0.0]),
        up=f([0.0, 0.0, -1.0]), normal=f([0.0, -1.0, 0.0]),
        emission=f([15.0, 15.0, 15.0]), size=f([1.0, 1.0])))
    return {"luxball_env": lux, "cornell_env": cor}


def phase_session_env(tmp_dir: str):
    """Write the seeded 1024x512 sky with the port's write_hdr and open the
    luxball with it through create_session (so the HDR reader and the
    alias-table build are on the path). Returns (session, env path)."""
    import numpy as np
    from fluctus_tpu_torch.fixtures import sky_env
    from fluctus_tpu_torch.io.hdr import write_hdr
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.scene import envmap as env_host

    t0 = time.perf_counter()
    img = sky_env(1024, 512, seed=ENV_SEED)
    path = os.path.join(tmp_dir, "sky.hdr")
    write_hdr(path, img)
    t_write = time.perf_counter() - t0
    secs = {}
    load = env_host.load

    def timed_load(p):
        t = time.perf_counter()
        out = load(p)
        secs["tables"] = time.perf_counter() - t
        return out
    t1 = time.perf_counter()
    env_host.load = timed_load
    try:
        sess = env_sessions(path, "cuda", size=512)["luxball_env"]
    finally:
        env_host.load = load
    t_sess = time.perf_counter() - t1
    e = sess.scene.envmap
    check(sess.cfg.use_env_map and tuple(e.image.shape) == (512, 1024, 3),
          "the luxball session has no 1024x512 env map")
    pdf = e.pdf_table.cpu().numpy()
    say("session-env", t0,
        f"sky 1024x512 (seed {ENV_SEED}, max radiance "
        f"{float(img.max()):.1f}) written in {t_write:.2f} s; luxball "
        f"{sess.host_scene.n_tris} tris + env map: read + alias tables "
        f"{secs['tables']:.2f} s, session {t_sess:.2f} s; pdf mean "
        f"{float(np.mean(pdf.astype(np.float64))):.6f}, max {pdf.max():.1f}"
        f", wide depth {sess.scene.wbvh.depth}")
    return sess, path


def phase_golden_env(path, card: str):
    """64x64 env-lit renders on the card (the luxball and the cornell with
    env and area light; 8 spp) held at GOLDEN_LIMITS against the same
    renders on this host's CPU through the plain versions: the lockstep
    through K1 (both forms) and through K4 (backend "pallas"; the CPU
    reference traces through plain K1, whose hits the plain K4 equals on
    these scenes, tests/test_torch_env_render.py), and the stream through
    K1's fused closest call. Returns {name: {route: launches}}."""
    import torch
    from fluctus_tpu_torch.render import driver

    spp = 8
    cpu = env_sessions(path, "cpu")
    out = {}
    for name, cs in cpu.items():
        t0 = time.perf_counter()
        ref_l = driver.render(cs, spp, integrator="lockstep").numpy()
        ref_s = driver.render(cs, spp, integrator="stream").numpy()
        say("golden-env", t0, f"{name}: lockstep and stream on this host's "
            f"CPU (plain versions), the references")
        out[name] = {}
        for backend, kernel in (("auto", "K1"), ("pallas", "K4")):
            gs = env_sessions(path, "cuda", backend)[name]
            t0 = time.perf_counter()
            reset_counts()
            img = driver.render(gs, spp, integrator="lockstep").cpu().numpy()
            torch.cuda.synchronize()
            mine = traced_only(kernel, f"golden-env {name}")
            golden_check(name, img, ref_l, t0,
                         f"the lockstep, {kernel} only ({mine}), against "
                         "the CPU lockstep")
            out[name][f"lockstep {kernel}"] = mine
            if backend == "auto":
                t0 = time.perf_counter()
                reset_counts()
                img = driver.render(gs, spp, integrator="stream")
                img = img.cpu().numpy()
                torch.cuda.synchronize()
                mine = traced_closest_only("K1", f"golden-env {name} stream")
                golden_check(name, img, ref_s, t0,
                             f"the stream, K1 closest only ({mine}), "
                             "against the CPU stream")
                out[name]["stream K1"] = mine
    return out


def phase_deep_stack():
    """K1, K4 and K5 on the chains of fluctus_tpu_torch/fixtures.py at
    wide depth DEEP_DEPTH (beyond the 128-entry walks: K1 and K5 need
    stack_entries(40) = 296 entries, K4 281; beyond the parent's 192-entry
    K4 stack too), closest and any-hit, each
    bit-equal to its plain version; the chain whose inner child is
    entered first fills the stacks to their worst case."""
    import torch
    from fluctus_tpu_torch.convert import forest_from_numpy, wide_from_numpy
    from fluctus_tpu_torch.fixtures import deep_chain_bvh, deep_chain_forest
    from fluctus_tpu_torch.ops import traverse_forest as tf
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts

    t0 = time.perf_counter()
    arrays, o, d, _ = deep_chain_bvh(DEEP_DEPTH, "near", n_rays=4096)
    w = wide_from_numpy(arrays, device="cuda")
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    t = torch.full((o.shape[0],), 3.4e38, device="cuda")
    t2 = torch.where(torch.arange(o.shape[0], device="cuda") % 2 == 0, t,
                     6.0)
    res = {}
    k = ts.traverse_kernel(w, o, d, t, any_hit=False)
    p, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
    res["K1 closest"] = all(torch.equal(getattr(k, f), getattr(p, f))
                            for f in ("prim", "t", "u", "v"))
    res["K1 any"] = torch.equal(ts.traverse_kernel(w, o, d, t2, any_hit=True),
                                ts.traverse_plain(w, o, d, t2, True)[1])
    hits = int((k.prim >= 0).sum())
    k = tp.traverse_closest(w, o, d, t, launch=tp.packet_kernel)
    p = tp.traverse_closest(w, o, d, t, launch=tp.packet_plain)
    res["K4 closest"] = all(torch.equal(getattr(k, f), getattr(p, f))
                            for f in ("prim", "t", "u", "v"))
    res["K4 any"] = torch.equal(
        tp.traverse_any(w, o, d, t2, launch=tp.packet_kernel),
        tp.traverse_any(w, o, d, t2, launch=tp.packet_plain))
    fa, fo, fd, _ = deep_chain_forest(DEEP_DEPTH, n_rays=4096)
    ft = forest_from_numpy(fa, device="cuda")
    fo, fd = torch.from_numpy(fo).cuda(), torch.from_numpy(fd).cuda()
    ob, db, tv, _ = tf._prep(fo, fd, torch.full((fo.shape[0],), 3.4e38,
                                                device="cuda"), tf.WQ_BLK)
    for any_hit in (False, True):
        kq = tf.queue_kernel(ft, ob, db, tv, any_hit)
        pq = tf.queue_plain(ft, ob, db, tv, any_hit)
        res[f"K5 {'any' if any_hit else 'closest'}"] = all(
            torch.equal(x, y) for x, y in zip(kq, pq))
    torch.cuda.synchronize()
    say("deep-stack", t0,
        f"chains of wide depth {DEEP_DEPTH} ({o.shape[0]} rays, {hits} "
        f"hits; K1/K5 stack {ts.stack_entries(DEEP_DEPTH)} entries a ray, "
        f"K4 {tp.stack_entries(DEEP_DEPTH)} of its {tp.MAX_STACK} a warp): "
        f"bit-equal to the "
        f"plain versions {res}")
    check(all(res.values()), "a kernel differs from its plain version on "
          "the deep chain")


# ------------------------------------------------------------ big scene

@contextlib.contextmanager
def env(**kw):
    """Set environment variables for the duration of a block."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


KERNEL_OF = {"vlist": "K2", "rounds": "K3"}


def brute_launchers(sched):
    """(kernel wrapper, plain version) of the scheduler `sched`."""
    from fluctus_tpu_torch.ops import traverse_brute as tb
    if sched == "vlist":
        return tb.vlaunch_kernel, tb.vlaunch_plain
    return tb.launch_kernel, tb.launch_plain


def brute_rays(sess, n: int, seed: int):
    """n closest-form rays (every 8th primary ray of the frame, then
    seeded bounce rays; t_max 3.4e38) and n shadow rays toward the area
    light with per-lane t_max (any-hit form), built by kernel_rays."""
    import torch
    o, d, t_c, o_s, d_s, t_s = kernel_rays(sess, n, seed)
    n_p = o.shape[0] - n
    half = n // 2
    pick = torch.cat([
        torch.arange(0, n_p, max(n_p // half, 1), device=o.device)[:half],
        torch.arange(n_p, n_p + n - half, device=o.device)])
    return (o[pick].contiguous(), d[pick].contiguous(),
            t_c[pick].contiguous(), o_s, d_s, t_s)


def compare_closest(kc, pc):
    """(prim mismatches outside equal-t ties, ties, max rel t error, max
    abs t error) of two closest-hit results."""
    diff = kc.prim != pc.prim
    ties = diff & (kc.t == pc.t)
    hit = (kc.prim >= 0) & (pc.prim >= 0)
    t_abs = (kc.t - pc.t).abs()
    t_rel = float((t_abs / pc.t.abs().clamp(min=1e-30))[hit].max()) \
        if bool(hit.any()) else 0.0
    t_max_abs = float(t_abs[hit].max()) if bool(hit.any()) else 0.0
    return int((diff & ~ties).sum()), int(ties.sum()), t_rel, t_max_abs


def phase_brute_check(bf, rays, sched):
    """K2 (sched "vlist") or K3 ("rounds") against its plain version
    through the same scheduler, both forms, on the same rays."""
    import torch
    from fluctus_tpu_torch.ops import traverse_brute as tb

    name = KERNEL_OF[sched]
    t0 = time.perf_counter()
    o, d, t_c, o_s, d_s, t_s = rays
    kern, plain = brute_launchers(sched)
    with env(FLUCTUS_BRUTE_SCHED=sched):
        kc, ex_kc = tb.traverse_closest(bf, o, d, t_c, with_flag=True,
                                        launch=kern)
        pc, ex_pc = tb.traverse_closest(bf, o, d, t_c, with_flag=True,
                                        launch=plain)
        ka, ex_ka = tb.traverse_any(bf, o_s, d_s, t_s, with_flag=True,
                                    launch=kern)
        pa, ex_pa = tb.traverse_any(bf, o_s, d_s, t_s, with_flag=True,
                                    launch=plain)
    torch.cuda.synchronize()
    n_mis, n_ties, t_rel, t_abs = compare_closest(kc, pc)
    uv_equal = bool(torch.equal(kc.u, pc.u) and torch.equal(kc.v, pc.v))
    flag_mis = int((ka != pa).sum())
    exhausted = [ex_kc, ex_pc, ex_ka, ex_pa]
    say(f"{name.lower()}-check", t0,
        f"{name} vs its plain version, both through the {sched} scheduler "
        f"on a subset of the frame's rays, the same for both: "
        f"{o.shape[0]} closest rays ({o.shape[0] // 2} primary, the rest "
        f"bounce) and {o_s.shape[0]} shadow rays: closest "
        f"{int((kc.prim >= 0).sum())}"
        f" hits, prim mismatches {n_mis} (+{n_ties} equal-t ties), max rel"
        f" t err {t_rel:.3e}, u/v bit-equal {uv_equal}; any-hit "
        f"{int(ka.sum())} blocked, flag mismatches {flag_mis}; exhausted "
        f"{exhausted}")
    check(n_mis == 0, f"{name} closest prim ids differ from the plain "
          "version")
    check(t_rel <= T_REL_TOL, f"{name} t error {t_rel} > {T_REL_TOL}")
    check(flag_mis == 0, f"{name} any-hit flags differ from the plain "
          "version")
    check(not any(exhausted), f"{name}: the round cap cut a walk")
    return t_abs, flag_mis


def phase_ties(sched):
    """K2 (sched "vlist") or K3 ("rounds") against its plain version
    through the same scheduler on the tie forests of
    fluctus_tpu_torch/fixtures.py: equal-t copies of one triangle in
    different team slices, pieces and pair slots of one 1,024-triangle
    group and in a later visit ("group"), and in different 128-triangle
    groups of one visit, over both CTAs and two pieces ("groups"). Both
    forms bit-equal, and every tie ray returns the lowest slot of the group
    listed first in the chunk visited first."""
    import torch
    from fluctus_tpu_torch.convert import brute_from_numpy
    from fluctus_tpu_torch.fixtures import LAYOUTS, tie_forest
    from fluctus_tpu_torch.ops import traverse_brute as tb

    name = KERNEL_OF[sched]
    kern, plain = brute_launchers(sched)
    for layout, (_, slots, _, _) in LAYOUTS.items():
        t0 = time.perf_counter()
        arrays, o, d, want = tie_forest(layout)
        bf = brute_from_numpy(arrays, device="cuda")
        o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
        tp = int(bf.tris.shape[2])
        groups = (f"group of {tb._resolve_gr(int(bf.tile), tp)} tiles"
                  if sched == "vlist"
                  else f"tile {tb._fit_tile(tb.TT, tp)}")
        with env(FLUCTUS_BRUTE_SCHED=sched):
            k = tb.traverse_closest(bf, o, d, 3.4e38, launch=kern)
            p = tb.traverse_closest(bf, o, d, 3.4e38, launch=plain)
            ka = tb.traverse_any(bf, o, d, 9.5, launch=kern)
            pa = tb.traverse_any(bf, o, d, 9.5, launch=plain)
        torch.cuda.synchronize()
        tie = torch.from_numpy(want >= 0).cuda()
        winners = bool(torch.equal(k.prim[tie].cpu(),
                                   torch.from_numpy(want[want >= 0])))
        same = all(torch.equal(getattr(k, f), getattr(p, f))
                   for f in ("prim", "t", "u", "v"))
        err = float((k.t - p.t).abs().max())
        say(f"{name.lower()}-ties", t0,
            f"{name} vs its plain version on the {layout!r} tie forest "
            f"({groups}; {len(slots)} triangles copied; "
            f"{int(tie.sum())} of {o.shape[0]} rays through the copies): "
            f"closest prim, t, u, v bit-equal {same} (max abs t err "
            f"{err:.3e}), every tie ray hits the expected copy {winners}; "
            f"any-hit flags equal {bool(torch.equal(ka, pa))}")
        check(same and winners, f"{name} breaks a tie otherwise than its "
              f"plain version ({layout!r} layout)")
        check(bool(torch.equal(ka, pa)), f"{name} any-hit flags differ from "
              f"the plain version on the {layout!r} tie forest")


class Recorder:
    """A launch function that keeps the arguments of every call."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)


def brute_bound(sched, calls, stats_list):
    """Least time for the launches of one traversal call: bytes (every
    launch's ray slots, seeds and outputs once, plus the table rows and
    boxes its visits need) over HBM bandwidth, or the tile or chunk slab
    tests and the Moller tests of live lanes against real triangles over
    the f32 instruction rate; the larger."""
    byts = ops = 0
    for args, st in zip(calls, stats_list):
        if sched == "vlist":
            _, _, tris, _, rays8, *_, blk, tt, v_per, gr = args
            cap, tp = rays8.shape[0], tris.shape[2]
            byts += cap * 64 + 8 * (cap // blk) * v_per
            byts += int(st["chunks_run"].sum()) * (tp // tt) * 6 * 4
            byts += int(st["groups_run"].sum()) * gr * tt * 10 * 4
        else:
            _, tris, boxes_t, rays8, *_, blk, tt, mm, c_real = args
            cap, tp = rays8.shape[0], tris.shape[2]
            byts += cap * (64 + 4 * mm) + 4 * (cap // blk)
            byts += boxes_t.shape[1] * 6 * 4
            byts += int(st["chunks_run"].sum()) * tp * 10 * 4
        ops += st["slab_tests"] * OPS_PER_CHILD + st["tri_tests"] * OPS_PER_TRI
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_INSTR_PER_S * 1e3
    return larger(t_bytes, t_ops)


def phase_brute_time(bf, rays, sched, wbvh_full):
    """Per 65,536-ray traversal call: the kernel's time summed over the
    call's launches (replayed on the recorded inputs), launches per call,
    the plain version's time on the same inputs, the bound, the whole
    call's wall time, and K1's time on the same rays over a full hierarchy
    of the scene."""
    import torch
    from fluctus_tpu_torch.ops import traverse_brute as tb
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch.timing import time_launches

    name = KERNEL_OF[sched]
    o, d, t_c, o_s, d_s, t_s = rays
    kern, plain = brute_launchers(sched)
    out = {}
    for form, (ro, rd, rt) in (("closest", (o, d, t_c)),
                               ("any", (o_s, d_s, t_s))):
        t0 = time.perf_counter()
        anyh = form == "any"
        trav = tb.traverse_any if anyh else tb.traverse_closest
        rec = Recorder(kern)
        with env(FLUCTUS_BRUTE_SCHED=sched):
            trav(bf, ro, rd, rt, launch=rec)
            torch.cuda.synchronize()
            call_ms = time_launches(
                lambda: trav(bf, ro, rd, rt, launch=kern), 3, 1)
        stats_list = []
        for args in rec.calls:
            st: dict = {}
            plain(*args, stats=st)
            stats_list.append(st)
        p1 = sum(time_launches(lambda: plain(*a), 1, 1) for a in rec.calls)
        k1 = sum(time_launches(lambda: kern(*a), 10, 1) for a in rec.calls)
        k2 = sum(time_launches(lambda: kern(*a), 10, 1) for a in rec.calls)
        p2 = sum(time_launches(lambda: plain(*a), 1, 1) for a in rec.calls)
        b_ms, b_by = brute_bound(sched, rec.calls, stats_list)
        k1_ms = time_launches(
            lambda: ts.traverse_kernel(wbvh_full, ro, rd, rt, anyh), 10, 1)
        n = ro.shape[0]
        slab = sum(s["slab_tests"] for s in stats_list)
        tri = sum(s["tri_tests"] for s in stats_list)
        out[form] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                         bound_ms=b_ms, bound_by=b_by,
                         launches_per_call=len(rec.calls), call_ms=call_ms,
                         k1_ms=k1_ms)
        r = out[form]
        unit = "passes" if sched == "vlist" else "launches (scout + rounds)"
        extra = ""
        if sched == "vlist":
            tp, tt = bf.tris.shape[2], int(bf.tile)
            gr = tb._resolve_gr(tt, tp)
            r["warps_per_sm"], placed = tb.k2_resident_warps(tp, tt, gr,
                                                             anyh)
            extra = (f"; {r['warps_per_sm']} resident warps per SM "
                     f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
                     f"{placed:.1f} per SM as K2's clusters fit the card "
                     f"(cudaOccupancyMaxActiveClusters); tile {tt}, group "
                     f"{gr} tiles")
        say(f"{name.lower()}-time", t0,
            f"{form}: {r['ms']:.3f} ms of {name} per {n}-ray call, "
            f"{len(rec.calls)} {unit} per call; whole call with its "
            f"scheduler {call_ms:.3f} ms; plain {r['plain_ms']:.1f} ms; "
            f"bound {b_ms:.4f} ms by {b_by} ({slab / n:.1f} slab and "
            f"{tri / n:.1f} Moller tests per ray); K1 on the same rays over"
            f" the full hierarchy {k1_ms:.4f} ms{extra}")
    if sched == "vlist":
        from fluctus_tpu_torch.scripts import measure_mfu
        t0 = time.perf_counter()
        visit_s, rate = measure_mfu.brute_visit_rate()
        out["all_live_gtests"] = rate / 1e9
        say("k2-time", t0,
            f"all-live slab (measure_mfu.brute_visit_rate: 8,192 "
            f"triangles, 16,384 rays, every tile live): {rate / 1e9:.2f} G "
            f"Moller tests/s, {visit_s * 1e6:.3f} us per 128-lane chunk "
            f"visit, {rate * OPS_PER_TRI / F32_INSTR_PER_S * 100:.1f}% of "
            f"the {F32_INSTR_PER_S / 1e12:.1f} T instr/s at {OPS_PER_TRI} "
            f"a test")
    return out


def conference_cfg(width, height):
    return kitchen_cfg(width, height, max_bounces=6)


def phase_golden_big():
    """conference.npz (64x64, 6 bounces, 4 spp) through K2 and, under
    FLUCTUS_BRUTE_SCHED=rounds, through K3. The rounds render is K3's path
    run: its counts are read around it. Returns (K3's launches, the
    session)."""
    from fluctus_tpu_torch.render import driver

    sess = driver.create_session(CONFERENCE, cfg=conference_cfg(64, 64),
                                 state_dir=STATES, auto_frame=False,
                                 cache_dir=None, device="cuda")
    check(sess.scene.bforest is not None and sess.scene.wbvh is None,
          "conference golden session is not a brute-forest session")
    phase_golden_only(sess, "conference", 4, "K2")
    with env(FLUCTUS_BRUTE_SCHED="rounds"):
        return phase_golden_only(sess, "conference", 4, "K3"), sess


def full_hierarchy(host):
    """The 8-wide hierarchy of a scene above the cutover, as
    FLUCTUS_FAST_BIG=0 uploads it (SAH build, no spatial splits)."""
    with env(FLUCTUS_FAST_BIG="0"):
        host.bvh = None
        return host.to_device("cuda").wbvh



# ------------------------------------------------------------ packets (K4)

def sorted_by_ray_sort(bvh, o, d, t):
    """Rays in the order the integrator hands them to K4: sorted by octant
    and Morton code over the hierarchy's bounds."""
    from fluctus_tpu_torch.ops import ray_sort
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    lo, hi = tp.wbvh_bounds(bvh)
    order, _ = ray_sort.sort_order(o, d, lo, hi)
    return o[order].contiguous(), d[order].contiguous(), t[order].contiguous()


def phase_packet_check(sess):
    """K4 against its plain version on the kitchen's kernel rays (seed 7,
    as K1's check), sorted as the integrator sorts them, both forms."""
    import torch
    from fluctus_tpu_torch.ops import traverse_pallas as tp

    t0 = time.perf_counter()
    bvh = sess.scene.wbvh
    o, d, t_c, o_s, d_s, t_s = kernel_rays(sess, 1 << 17, seed=7)
    o, d, t_c = sorted_by_ray_sort(bvh, o, d, t_c)
    o_s, d_s, t_s = sorted_by_ray_sort(bvh, o_s, d_s, t_s)
    kc = tp.traverse_closest(bvh, o, d, t_c, launch=tp.packet_kernel)
    pc = tp.traverse_closest(bvh, o, d, t_c, launch=tp.packet_plain)
    ka = tp.traverse_any(bvh, o_s, d_s, t_s, launch=tp.packet_kernel)
    pa = tp.traverse_any(bvh, o_s, d_s, t_s, launch=tp.packet_plain)
    torch.cuda.synchronize()
    n_mis, n_ties, t_rel, t_abs = compare_closest(kc, pc)
    uv_equal = bool(torch.equal(kc.u, pc.u) and torch.equal(kc.v, pc.v))
    t_equal = bool(torch.equal(kc.t, pc.t))
    flag_mis = int((ka != pa).sum())
    say("k4-check", t0,
        f"K4 vs its plain version on the same sorted packets: closest "
        f"{o.shape[0]} rays, {int((kc.prim >= 0).sum())} hits, prim "
        f"mismatches {n_mis} (+{n_ties} equal-t ties), t bit-equal "
        f"{t_equal}, u/v bit-equal {uv_equal}; any-hit {o_s.shape[0]} rays, "
        f"{int(ka.sum())} blocked, flag mismatches {flag_mis}")
    check(n_mis == 0 and n_ties == 0 and t_equal and uv_equal,
          "K4 closest results differ from the plain version")
    check(flag_mis == 0, "K4 any-hit flags differ from the plain version")
    return t_abs, flag_mis


def packet_bound(bvh, n_rays, stats):
    """K4's packet-lane bound: bytes as K1's bound, or the slab tests of
    the occupied child slots and the Moller tests of the real triangles
    of every visited row, times the packet's real lanes, over the f32
    instruction rate: (bytes ms, operations ms). It counts what the packet
    design makes every lane do; `bound_ms` on K1's per-ray counts is what
    the same closest hits need."""
    table = (bvh.nodes.numel() + bvh.leaves.numel()) * 4
    t_bytes = (table + n_rays * (28 + 16)) / HBM_BYTES_PER_S * 1e3
    ops = (stats["child_tests"] * OPS_PER_CHILD
           + stats["tri_tests"] * OPS_PER_TRI)
    return t_bytes, ops / F32_INSTR_PER_S * 1e3


def phase_packet_time(sess, tile=1 << 16):
    """Per 65,536-ray K4 call, on the tiles K1's timing uses, each sorted
    as the integrator sorts it: kernel ms, plain ms, the bound on K1's
    per-ray counts of the same rays (reported as the kernel's bound) and
    the packet-lane bound beside it, K1 on the same rays, and the packet
    visits."""
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch.scripts.probe_walk_design import spread
    from fluctus_tpu_torch.timing import time_launches

    bvh = sess.scene.wbvh
    o, d, t_c, o_s, d_s, t_s = kernel_rays(sess, 1 << 17, seed=7)
    n_p = o.shape[0] - (1 << 17)
    sets = {"closest": [(o[:tile], d[:tile], t_c[:tile]),
                        (o[n_p:n_p + tile], d[n_p:n_p + tile],
                         t_c[n_p:n_p + tile])],
            "any": [(o_s[:tile], d_s[:tile], t_s[:tile])]}
    out = {}
    for form, rays in sets.items():
        t1 = time.perf_counter()
        anyh = form == "any"
        stats: dict = {}
        ray_stats: dict = {}
        k_ms = p_ms = k1_ms = 0.0
        for ro, rd, rt in rays:
            ro, rd, rt = sorted_by_ray_sort(bvh, ro, rd, rt)
            a = tp._prep(ro, rd, rt)[:3]
            tp.packet_plain(*a, bvh, anyh, n_real=tile, stats=stats)
            ts.traverse_plain(bvh, ro, rd, rt, anyh, stats=ray_stats)
            run_k = lambda: tp.packet_kernel(*a, bvh, anyh)
            run_p = lambda: tp.packet_plain(*a, bvh, anyh)
            p1 = time_launches(run_p, 1, 1)
            k1 = time_launches(run_k, 10, 1)
            k2 = time_launches(run_k, 10, 1)
            p2 = time_launches(run_p, 1, 1)
            k_ms += (k1 + k2) / 2
            p_ms += (p1 + p2) / 2
            k1_ms += time_launches(
                lambda: ts.traverse_kernel(bvh, ro, rd, rt, anyh), 10, 1)
        n = len(rays)
        say("k4-time", t1,
            f"{form}: per packet (max / median / mean) "
            f"{spread(stats['packet_node_visits'])} node and "
            f"{spread(stats['packet_leaf_visits'])} leaf visits over "
            f"{stats['packet_node_visits'].numel()} packets (the plain "
            f"version's counts)")
        b_ms, b_by = bound_ms(bvh, tile * n, ray_stats, anyh)
        b_ms /= n
        pk_bytes, pk_ops = (x / n for x in packet_bound(bvh, tile * n, stats))
        pk_ms, pk_by = larger(pk_bytes, pk_ops)
        out[form] = dict(ms=k_ms / n, plain_ms=p_ms / n, bound_ms=b_ms,
                         bound_by=b_by, packet_bound_ms=pk_ms,
                         k1_ms=k1_ms / n)
        r = out[form]
        say("k4-time", t1,
            f"{form}: {r['ms']:.3f} ms per {tile}-ray launch (plain "
            f"{r['plain_ms']:.1f} ms), bound {b_ms:.4f} ms by {b_by} on "
            f"K1's per-ray counts ({ray_stats['child_tests'] / (n * tile):.1f}"
            f" child slab and {ray_stats['tri_tests'] / (n * tile):.1f} "
            f"triangle tests per ray); packet-lane bound {pk_ms:.4f} ms by "
            f"{pk_by} (bytes {pk_bytes:.4f} ms, operations {pk_ops:.4f} ms; "
            f"per packet {stats['node_visits'] / (n * tile / 512):.1f} node "
            f"and {stats['leaf_visits'] / (n * tile / 512):.1f} leaf "
            f"visits, per ray {stats['child_tests'] / (n * tile):.1f} child "
            f"slab and {stats['tri_tests'] / (n * tile):.1f} triangle "
            f"tests); K1 on the same rays {r['k1_ms']:.4f} ms")
    return out


# ------------------------------------------------------------ treelet (K5)

def forest_bound(ft, n_rays, any_hit, stats_list):
    """Least time for one K5 traversal call: bytes (the call's rays in and
    hits out once, the chunk boxes once, and the real rows of every chunk
    the call walks once, pad rows left out) over HBM bandwidth, or the
    slab tests of the occupied child slots and the Moller tests of the
    real triangles of the rows the walks visit over the f32 instruction
    rate: (bytes ms, operations ms). The scheduler's extra launches, pad
    slots and re-read tables are the port's cost, not the function's."""
    import torch
    walked = sorted(set().union(*(s.get("chunks_walked", set())
                                  for s in stats_list)))
    sel = torch.as_tensor(walked, dtype=torch.long, device=ft.nodes.device)
    node_rows = int(torch.isfinite(ft.nodes[sel][:, :, 0:48:6]).any(-1)
                    .sum())
    ids = ft.leaves[sel][..., 9].contiguous().view(torch.int32)
    leaf_rows = int((ids >= 0).any(-1).sum())
    byts = (node_rows * NODE_ROW_BYTES + leaf_rows * ft.leaf_width * 10 * 4
            + ft.boxes.numel() * 4 + n_rays * (28 + (1 if any_hit else 16)))
    ops = sum(s["child_tests"] * OPS_PER_CHILD + s["tri_tests"] * OPS_PER_TRI
              for s in stats_list)
    return byts / HBM_BYTES_PER_S * 1e3, ops / F32_INSTR_PER_S * 1e3


def queue_rays(ro, rd, rt):
    """Rays as the work queue's entry point hands them to queue_kernel and
    queue_plain: padded to the round loop's block, t_max a vector."""
    from fluctus_tpu_torch.ops import traverse_brute as tb
    from fluctus_tpu_torch.ops import traverse_forest as tf
    return tb._prep(ro, rd, rt, tf.WQ_BLK)[:3]


def queue_sorted(ft, ro, rd, rt, any_hit):
    """The work queue's kernel on the rays sorted by octant and Morton code
    over the forest bounds (ray_sort.sorted_apply, as the passes sort
    them), the results back in the rays' order."""
    from fluctus_tpu_torch.ops import ray_sort
    from fluctus_tpu_torch.ops import traverse_forest as tf
    from fluctus_tpu_torch.ops import traverse_stack as ts
    o, d, t = queue_rays(ro, rd, rt)
    return ray_sort.sorted_apply(
        o, d, ft.boxes[:, 0:3].amin(0), ft.boxes[:, 3:6].amax(0),
        lambda o_, d_, t_: ts.Traversal(*tf.queue_kernel(
            ft, o_.contiguous(), d_.contiguous(), t_.contiguous(), any_hit)),
        t)


def phase_forest_check(ft, wbvh, rays):
    """K5 against its plain version, both forms, on the conference's
    65,536-ray subsets: the work queue's kernel (queue_kernel, through
    the entry point, and on the rays sorted by octant and Morton code)
    against queue_plain, and the per-launch kernel (launch_kernel) against
    launch_plain through the same scheduler, the round loop and the
    passes; and K5 against K1 over the session's own full hierarchy."""
    import torch
    from fluctus_tpu_torch.ops import traverse_forest as tf
    from fluctus_tpu_torch.ops import traverse_stack as ts

    o, d, t_c, o_s, d_s, t_s = rays
    k1c = ts.traverse_kernel(wbvh, o, d, t_c, any_hit=False)
    k1a = ts.traverse_kernel(wbvh, o_s, d_s, t_s, any_hit=True)
    err = {}
    for mode in ("queue",) + tf.MODES:
        t0 = time.perf_counter()
        if mode == "queue":
            kc2 = queue_sorted(ft, o, d, t_c, False)
            ka2 = queue_sorted(ft, o_s, d_s, t_s, True).prim > 0
            kc = tf.traverse_closest(ft, o, d, t_c)
            ka = tf.traverse_any(ft, o_s, d_s, t_s)
            pc = ts.Traversal(*tf.queue_plain(ft, *queue_rays(o, d, t_c),
                                           False))
            pa = tf.queue_plain(ft, *queue_rays(o_s, d_s, t_s), True)[1] > 0
            other = bool(all(torch.equal(getattr(kc, f), getattr(kc2, f))
                             for f in ("prim", "t", "u", "v"))
                         and torch.equal(ka, ka2))
            what = ("the queue kernel (one launch a call) vs queue_plain "
                    "(the round loop over the plain version)")
        else:
            kc = tf.traverse_closest(ft, o, d, t_c, mode=mode,
                                     launch=tf.launch_kernel)
            pc = tf.traverse_closest(ft, o, d, t_c, mode=mode,
                                     launch=tf.launch_plain)
            ka = tf.traverse_any(ft, o_s, d_s, t_s, mode=mode,
                                 launch=tf.launch_kernel)
            pa = tf.traverse_any(ft, o_s, d_s, t_s, mode=mode,
                                 launch=tf.launch_plain)
            other = True
            what = (f"the per-launch kernel ({mode}) vs its plain version "
                    f"through the same scheduler")
        torch.cuda.synchronize()
        n_mis, n_ties, t_rel, t_abs = compare_closest(kc, pc)
        t_equal = bool(torch.equal(kc.t, pc.t))
        uv_equal = bool(torch.equal(kc.u, pc.u) and torch.equal(kc.v, pc.v))
        flag_mis = int((ka != pa).sum())
        k1_mis, k1_ties, k1_rel, _ = compare_closest(kc, k1c)
        k1_flag = int((ka != k1a).sum())
        order = (f"; with the rays sorted by octant and Morton code: "
                 f"bit-equal {other}" if mode == "queue" else "")
        say("k5-check", t0,
            f"K5, {what}, {o.shape[0]} closest rays ({o.shape[0] // 2} "
            f"primary, the rest bounce) and {o_s.shape[0]} shadow rays: "
            f"closest {int((kc.prim >= 0).sum())} hits, prim mismatches "
            f"{n_mis} (+{n_ties} equal-t ties), t bit-equal {t_equal}, u/v "
            f"bit-equal {uv_equal}; any-hit {int(ka.sum())} blocked, flag "
            f"mismatches {flag_mis}{order}. Against K1 over the session's "
            f"hierarchy: prim mismatches {k1_mis} (+{k1_ties} ties), max rel"
            f" t err {k1_rel:.3e}, flag mismatches {k1_flag}")
        check(n_mis == 0 and n_ties == 0 and t_equal and uv_equal,
              f"K5 ({mode}) closest results differ from the plain version")
        check(flag_mis == 0, f"K5 ({mode}) any-hit flags differ from the "
              "plain version")
        check(other, "K5's queue kernel gives other bits on sorted rays")
        check(k1_mis == 0 and k1_rel <= T_REL_TOL and k1_flag == 0,
              f"K5 ({mode}) and K1 disagree on the conference")
        err[mode] = (t_abs, flag_mis)
    return err


def phase_forest_time(ft, wbvh, rays):
    """Per 65,536-ray call, both forms: the work queue's kernel
    (queue_kernel: its one launch on the rays as given and sorted by
    octant and Morton code, the whole call through the entry point and
    with that sort, queue_plain's time), and the
    per-launch kernel under the round loop (the per-round design) and the
    passes (K5's time summed over the call's launches, replayed on the
    recorded inputs, launches per call, the whole call with the
    scheduler's PyTorch work, the plain version's time on the same
    inputs); the bound (the same walks, so one per form) and K1 on the
    same rays over the session's hierarchy. One call of each form runs
    under sync-debug mode "error": the queue's call reads nothing back."""
    import torch
    from fluctus_tpu_torch.ops import ray_sort
    from fluctus_tpu_torch.ops import traverse_forest as tf
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch.timing import time_launches

    o, d, t_c, o_s, d_s, t_s = rays
    out = {}
    for form, (ro, rd, rt) in (("closest", (o, d, t_c)),
                               ("any", (o_s, d_s, t_s))):
        anyh = form == "any"
        trav = tf.traverse_any if anyh else tf.traverse_closest
        n = ro.shape[0]
        k1_ms = time_launches(
            lambda: ts.traverse_kernel(wbvh, ro, rd, rt, anyh), 10, 1)
        for mode in tf.MODES:
            t0 = time.perf_counter()
            rec = Recorder(tf.launch_kernel)
            trav(ft, ro, rd, rt, mode=mode, launch=rec)
            call_ms = time_launches(
                lambda: trav(ft, ro, rd, rt, mode=mode,
                             launch=tf.launch_kernel), 3, 1)
            stats_list = []
            for args in rec.calls:
                st: dict = {}
                tf.launch_plain(*args, stats=st)
                stats_list.append(st)
            # the plain per-launch version once (it takes tens of seconds
            # a call; these designs' plain times are not in the kernels
            # line), the kernel twice
            p1 = sum(time_launches(lambda: tf.launch_plain(*a), 1, 1)
                     for a in rec.calls)
            k1 = sum(time_launches(lambda: tf.launch_kernel(*a), 10, 1)
                     for a in rec.calls)
            k2 = sum(time_launches(lambda: tf.launch_kernel(*a), 10, 1)
                     for a in rec.calls)
            t_bytes, t_ops = forest_bound(ft, n, anyh, stats_list)
            b_ms, b_by = larger(t_bytes, t_ops)
            child = sum(s["child_tests"] for s in stats_list)
            tri = sum(s["tri_tests"] for s in stats_list)
            out[(mode, form)] = dict(
                ms=(k1 + k2) / 2, plain_ms=p1, bound_ms=b_ms,
                bound_by=b_by, launches_per_call=len(rec.calls),
                call_ms=call_ms, k1_ms=k1_ms)
            r = out[(mode, form)]
            unit = ("rounds (the per-round design)" if mode == "workqueue"
                    else "passes")
            say("k5-time", t0,
                f"{mode} {form}, per-launch kernel: {r['ms']:.3f} ms of K5 "
                f"per {n}-ray call, {len(rec.calls)} {unit} per call; whole "
                f"call with its scheduler {call_ms:.3f} ms; plain "
                f"{r['plain_ms']:.1f} ms; bound {b_ms:.4f} ms by {b_by} "
                f"(bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms; "
                f"{child / n:.1f} child slab and {tri / n:.1f} Moller tests "
                f"per ray); K1 on the same rays over the session's "
                f"hierarchy {k1_ms:.4f} ms")

        # the work queue in one launch: the same walks as the round loop,
        # so the round loop's bound
        t0 = time.perf_counter()
        qo, qd, qt = queue_rays(ro, rd, rt)
        k1 = time_launches(lambda: tf.queue_kernel(ft, qo, qd, qt, anyh),
                           10, 1)
        k2 = time_launches(lambda: tf.queue_kernel(ft, qo, qd, qt, anyh),
                           10, 1)
        so, sd, st = (x[ray_sort.sort_order(
            qo, qd, ft.boxes[:, 0:3].amin(0), ft.boxes[:, 3:6].amax(0))[0]]
            .contiguous() for x in (qo, qd, qt))
        k_sorted = time_launches(
            lambda: tf.queue_kernel(ft, so, sd, st, anyh), 10, 1)
        calls = {}
        for srt in (False, True, True, False):
            fn = ((lambda: queue_sorted(ft, ro, rd, rt, anyh)) if srt
                  else (lambda: trav(ft, ro, rd, rt)))
            ms = time_launches(fn, 10, 1)
            calls[srt] = min(calls.get(srt, ms), ms)
        tf.reset_counts()
        torch.cuda.set_sync_debug_mode("error")   # raises on a host sync
        try:
            trav(ft, ro, rd, rt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = tf.LAUNCHES[form]
        p1 = time_launches(lambda: tf.queue_plain(ft, qo, qd, qt, anyh), 1, 1)
        wq = out[("workqueue", form)]
        out[("queue", form)] = dict(
            ms=(k1 + k2) / 2, plain_ms=p1, bound_ms=wq["bound_ms"],
            bound_by=wq["bound_by"], launches_per_call=launches,
            call_ms=calls[False], k1_ms=k1_ms)
        r = out[("queue", form)]
        say("k5-time", t0,
            f"queue {form}: {r['ms']:.3f} ms of K5 per {n}-ray call "
            f"(queue_kernel, the rays as given; {k_sorted:.3f} ms on the "
            f"rays sorted by octant and Morton code), {launches} launch and"
            f" no host sync per call; whole call through the entry point "
            f"{calls[False]:.3f} ms with the rays as given, "
            f"{calls[True]:.3f} ms with them sorted there; plain "
            f"(queue_plain) {p1:.1f} ms; bound {wq['bound_ms']:.4f} ms by "
            f"{wq['bound_by']}; beside the per-round design: "
            f"{wq['ms']:.3f} ms of K5 in {wq['launches_per_call']} rounds, "
            f"whole call {wq['call_ms']:.3f} ms")
        check(launches == 1, f"a K5 work-queue call made {launches} "
              "launches")
    return out


@contextlib.contextmanager
def counted_calls(module, names):
    """{name: calls} of the functions `names` of `module` inside the block
    (the module's attributes wrapped for its duration)."""
    counts = dict.fromkeys(names, 0)
    old = {n: getattr(module, n) for n in names}

    def counted(n):
        def fn(*args, **kw):
            counts[n] += 1
            return old[n](*args, **kw)
        return fn
    for n in names:
        setattr(module, n, counted(n))
    try:
        yield counts
    finally:
        for n, f in old.items():
            setattr(module, n, f)


def launch_counts(field: str = "LAUNCHES") -> dict:
    """{kernel: {"closest": n, "any": n}} from the wrappers' counters
    (`LAUNCHES`, or `PLAIN_CALLS` for the plain versions)."""
    from fluctus_tpu_torch.ops import (traverse_brute, traverse_forest,
                                       traverse_pallas, traverse_stack)
    brute = getattr(traverse_brute, field)
    return {"K1": dict(getattr(traverse_stack, field)),
            "K2": {f: brute[f"k2_{f}"] for f in ("closest", "any")},
            "K3": {f: brute[f"k3_{f}"] for f in ("closest", "any")},
            "K5": dict(getattr(traverse_forest, field)),
            "K4": dict(getattr(traverse_pallas, field))}


def reset_counts() -> None:
    from fluctus_tpu_torch.ops import (traverse_brute, traverse_forest,
                                       traverse_pallas, traverse_stack)
    for m in (traverse_stack, traverse_brute, traverse_forest,
              traverse_pallas):
        m.reset_counts()


def traced_only(kernel: str, what: str) -> dict:
    """Fail unless, since the last reset_counts, `kernel` launched in both
    forms, no other traversal kernel launched and no plain version ran.
    Returns the kernel's launches."""
    launches = launch_counts()
    mine = launches.pop(kernel)
    check(mine["closest"] > 0 and mine["any"] > 0,
          f"{what} did not launch {kernel} in both forms: {mine}")
    check(all(v == 0 for d in launches.values() for v in d.values()),
          f"{what} launched other kernels: {launches}")
    plain = launch_counts("PLAIN_CALLS")
    check(all(v == 0 for d in plain.values() for v in d.values()),
          f"plain traversal ran in {what}: {plain}")
    return mine


def phase_frame_only(sess, spp: int, card: str, phase: str, kernel: str,
                     what: str, keep: dict | None = None):
    """One lockstep frame through the entry points that must trace through
    `kernel` (a key of launch_counts) only, in both forms; counts read
    around exactly this call. With `keep`, the frame goes into
    keep["img"]."""
    import torch
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.render.benchmark import ray_counts_per_sample

    t0 = time.perf_counter()
    reset_counts()
    img = driver.render(sess, spp, integrator="lockstep")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cfg = sess.cfg
    n = cfg.width * cfg.height * spp
    prim, ext, shadow = ray_counts_per_sample(cfg, n)
    mine = traced_only(kernel, f"the {what} frame")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3), "image shape")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(bool((img >= 0).all()), "image has negative values")
    if keep is not None:
        keep["img"] = img
    say(phase, t0,
        f"{what} {cfg.width}x{cfg.height} {spp} spp, {cfg.max_bounces} "
        f"bounces: {secs:.3f} s, {(prim + ext + shadow) / secs / 1e6:.3f} "
        f"MRays/s analytic, {n / secs / 1e6:.4f} Msamples/s, {kernel} "
        f"launches {mine}, no other kernel or plain version, mean radiance"
        f" {float(img.mean()):.5f}, on {card}")
    return secs, mine


def golden_share(img, ref):
    """(share of pixels within RTOL/ATOL, mean relative error)."""
    import numpy as np
    within = np.isclose(img, ref, rtol=RTOL, atol=ATOL).all(-1)
    return float(within.mean()), float(np.abs(img - ref).mean()
                                       / np.abs(ref).mean())


def golden_check(name, img, gold, t0, what):
    """Hold one render against its golden at GOLDEN_LIMITS[name]."""
    import numpy as np
    share, mean_rel = golden_share(img, gold)
    need_share, need_rel = GOLDEN_LIMITS[name]
    say("golden", t0,
        f"{name} through {what}: {share * 100:.3f}% of pixels within rtol "
        f"{RTOL} / atol {ATOL} (need {need_share * 100:.1f}%), mean relative"
        f" error {mean_rel:.3e} (need <= {need_rel:.0e}), max abs diff "
        f"{float(np.abs(img - gold).max()):.3e}")
    check(share >= need_share and mean_rel <= need_rel,
          f"golden {name} not held through {what}")


def phase_golden_only(sess, name, spp, kernel):
    """Render `sess` and hold it against golden `name`, checking that only
    `kernel` (a key of launch_counts) traced, in both forms. Returns its
    launches."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.render import driver

    t0 = time.perf_counter()
    reset_counts()
    img = driver.render(sess, spp, integrator="lockstep").cpu().numpy()
    torch.cuda.synchronize()
    mine = traced_only(kernel, f"golden {name}")
    gold = np.load(os.path.join(GOLDENS, f"{name}.npz"))["img"]
    golden_check(name, img, gold, t0, f"{kernel} only ({mine})")
    return mine


# ------------------------------------------------------------ probes (P1, P2)

def phase_p1(sess):
    """P1 against its plain version (bit-equal), then the launch-floor
    probe (the path P1 serves): P1 at 1 and 64 blocks and K1 closest at
    1,024 and 65,536 rays, with P1's launches counted per shape."""
    import torch
    from fluctus_tpu_torch.ops import probes
    from fluctus_tpu_torch.scripts import probe_launch_floor as plf
    from fluctus_tpu_torch.timing import time_launches

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = {b: torch.rand((8 * b, 128), generator=g, device="cuda")
          for b in (1, 64)}
    err = {}
    for b, x in xs.items():
        k = probes.copy_plus_one_kernel(x)
        p = probes.copy_plus_one_plain(x)
        torch.cuda.synchronize()
        err[b] = float((k - p).abs().max())
        check(torch.equal(k, p), f"P1 ({b} blocks) differs from x + 1")
    say("p1-check", t0, "P1 bit-equal to its plain version x + 1.0 on "
        f"(8, 128) and (512, 128) random f32 tiles (max abs err "
        f"{err[1]:.3e} / {err[64]:.3e})")

    t1 = time.perf_counter()
    lo, hi = sess.host_scene.bounds()
    out = {}
    for key, fn in plf.probes(sess.scene.wbvh, lo, hi).items():
        probes.reset_counts()
        if key.startswith("p1"):
            # in turns with its plain version, PyTorch's own x + 1.0
            x = xs[1 if key == "p1_1_block" else 64]
            plain = lambda: probes.copy_plus_one_plain(x)
            p_a, k_a, k_b, p_b = (time_launches(f)
                                  for f in (plain, fn, fn, plain))
            out[key] = dict(ms=(k_a + k_b) / 2, plain_ms=(p_a + p_b) / 2,
                            launches=probes.LAUNCHES["p1"])
        else:
            out[key] = dict(ms=time_launches(fn),
                            launches=probes.LAUNCHES["p1"])
    for key, b in (("p1_1_block", 1), ("p1_64_blocks", 64)):
        x = xs[b]
        r = out[key]
        check(r["launches"] > 0, f"the launch-floor probe did not launch "
              f"P1 at {b} blocks")
        r["bound_ms"] = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        r["max_abs_err"] = err[b]
    say("p1-time", t1,
        "launch floor, per launch (16 back to back, best of 3): "
        + ", ".join(f"{k} {v['ms'] * 1e3:.2f} us" for k, v in out.items())
        + "; P1 beside x + 1.0 in turns: " + ", ".join(
            f"{k[3:]} {out[k]['ms'] * 1e3:.2f} / "
            f"{out[k]['plain_ms'] * 1e3:.2f} us = "
            f"{out[k]['ms'] / out[k]['plain_ms']:.3f} x"
            for k in ("p1_1_block", "p1_64_blocks"))
        + f"; P1 launches {out['p1_1_block']['launches']} / "
        f"{out['p1_64_blocks']['launches']}")
    t2 = time.perf_counter()
    st = plf.measure_steps()
    say("p1-steps", t2, "host steps of one P1 launch at 1 block (see "
        "probe_launch_floor.py), us per launch: " + ", ".join(
            f"{k} {v * 1e3:.2f}" for k, v in st.items()))
    return out


def phase_p2():
    """P2, both forms, against their plain versions (bit-equal) on a
    random (512, 1024) tile at 512 trips. Then the MFU probe: P2's rates,
    the bf16 matmul and the HBM bandwidth, against the data-sheet peaks
    the bounds use."""
    import torch
    from fluctus_tpu_torch.ops import probes
    from fluctus_tpu_torch.scripts import measure_mfu as mfu
    from fluctus_tpu_torch.timing import time_launches

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand(mfu.P2_SHAPE, generator=g, device="cuda") + 0.5
    err = {}
    for fused in (False, True):
        p = probes.fma_chain_plain(x, mfu.P2_ITERS, fused)
        k = probes.fma_chain_kernel(x, mfu.P2_ITERS, fused)
        torch.cuda.synchronize()
        err[fused] = (float((k - p).abs().max()), bool(torch.equal(k, p)))
    p_u = probes.fma_chain_plain(x, mfu.P2_ITERS, False)
    p_f = probes.fma_chain_plain(x, mfu.P2_ITERS, True)
    say("p2-check", t0,
        f"P2 vs its plain versions on a random {mfu.P2_SHAPE} tile, "
        f"{mfu.P2_ITERS} trips: unfused bit-equal {err[False][1]}, fused "
        f"bit-equal {err[True][1]} (max abs err {err[False][0]:.3e} / "
        f"{err[True][0]:.3e}); the two plain forms part by up to "
        f"{float(((p_u - p_f).abs() / p_f).max()):.3e} relative")
    check(err[False][1] and err[True][1], "P2 differs from its plain "
          "version")

    t1 = time.perf_counter()
    out = {}
    steps = 8 * mfu.P2_ITERS * x.numel()
    for fused in (True, False):
        plain_ms = time_launches(lambda: probes.fma_chain_plain(
            x, mfu.P2_ITERS, fused), reps=1, best_of=2)
        probes.reset_counts()
        flops, ms = mfu.p2_rate(fused)
        key = "p2_fused" if fused else "p2_unfused"
        launches = probes.LAUNCHES[key]
        check(launches > 0, f"the MFU probe did not launch {key}")
        instr = steps if fused else 2 * steps
        out[fused] = dict(
            ms=ms, plain_ms=plain_ms, launches=launches, flops=flops,
            instr_s=instr / (ms * 1e-3),
            bound_ms=instr / F32_INSTR_PER_S * 1e3,
            max_abs_err=err[fused][0])
    mm = mfu.matmul_bf16()
    bw = mfu.hbm_bw()
    f, u = out[True], out[False]
    say("p2-time", t1,
        f"P2 fused {f['flops'] / 1e12:.3f} TFLOP/s = "
        f"{f['instr_s'] / 1e12:.3f} T instr/s, "
        f"{f['flops'] / (2 * F32_INSTR_PER_S) * 100:.1f}% of the 67 "
        f"TFLOP/s data-sheet peak ({f['ms']:.4f} ms per launch); unfused "
        f"{u['flops'] / 1e12:.3f} TFLOP/s = {u['instr_s'] / 1e12:.3f} T "
        f"instr/s, {u['instr_s'] / F32_INSTR_PER_S * 100:.1f}% of the "
        f"{F32_INSTR_PER_S / 1e12:.1f} T instr/s the bounds use "
        f"({u['ms']:.4f} ms); plain {f['plain_ms']:.1f} / "
        f"{u['plain_ms']:.1f} ms; HBM stream "
        f"{bw / 1e9:.1f} GB/s ({bw / HBM_BYTES_PER_S * 100:.1f}% of "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); bf16 matmul 2048^2 "
        f"{mm / 1e12:.1f} TFLOP/s ({mm / 989e12 * 100:.1f}% of 989)")
    return out


# ------------------------------------------------------------ stream

@contextlib.contextmanager
def capture_returns(module, name: str):
    """Record the return value of every call of `module.name` while the
    block runs."""
    orig = getattr(module, name)
    got = []

    def wrapped(*a, **k):
        r = orig(*a, **k)
        got.append(r)
        return r
    setattr(module, name, wrapped)
    try:
        yield got
    finally:
        setattr(module, name, orig)


FUSED_SEGMENT = 8    # a segment past the first, whose pending rays are real


@contextlib.contextmanager
def capture_fused_call():
    """Keep copies of the ray arguments (orig, dir, sh_orig, sh_dir,
    sh_len) of call FUSED_SEGMENT of common.trace_scene_with_shadow, or of
    the last call if there are fewer, while the block runs."""
    from fluctus_tpu_torch.integrators import common
    orig = common.trace_scene_with_shadow
    got = {"calls": 0, "args": None}

    def wrapped(*a, **k):
        if got["calls"] <= FUSED_SEGMENT:
            got["args"] = tuple(x.clone() for x in a[3:8])
        got["calls"] += 1
        return orig(*a, **k)
    common.trace_scene_with_shadow = wrapped
    try:
        yield got
    finally:
        common.trace_scene_with_shadow = orig


def fused_check(sess, got, kernel: str, what: str) -> None:
    """One deferred segment's fused call, rebuilt from its captured rays
    ([ext ; shadow], t_max T_MAX and the shadow lengths), through
    `kernel`'s wrapper and its plain version on the same inputs: prim, t,
    u and v bit-equal. Run after the main path's counts are read."""
    import torch
    from fluctus_tpu_torch.integrators import common
    from fluctus_tpu_torch.ops import traverse_brute as tb
    from fluctus_tpu_torch.ops import traverse_stack as ts

    t0 = time.perf_counter()
    check(got["args"] is not None, f"{what}: no fused call was made")
    b = got["args"][0].shape[0]
    o, d, t = common.fused_rays(*got["args"])
    if kernel == "K1":
        w = sess.scene.wbvh
        k = ts.traverse_kernel(w, o, d, t, any_hit=False)
        p, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
    else:
        kern, plain = brute_launchers("vlist")
        k = tb.traverse_closest(sess.scene.bforest, o, d, t, launch=kern)
        p = tb.traverse_closest(sess.scene.bforest, o, d, t, launch=plain)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(k, f), getattr(p, f))
               for f in ("prim", "t", "u", "v"))
    say("fused-check", t0,
        f"{what}: fused call {min(FUSED_SEGMENT, got['calls'] - 1)} of "
        f"{got['calls']}, {b} extension rays ({int((k.prim[:b] >= 0).sum())}"
        f" hits) + {o.shape[0] - b} shadow rays with per-lane t_max "
        f"({int((k.prim[b:] >= 0).sum())} blocked), {kernel} against its "
        f"plain version: prim, t, u, v bit-equal {same}")
    check(same, f"{what}: {kernel} differs from its plain version on the "
          "fused call")


def traced_closest_only(kernel: str, what: str) -> dict:
    """Fail unless, since the last reset_counts, `kernel` launched in its
    closest form only (every shadow ray went through the fused call), no
    other traversal kernel launched and no plain version ran."""
    launches = launch_counts()
    mine = launches.pop(kernel)
    check(mine["closest"] > 0 and mine["any"] == 0,
          f"{what} did not launch {kernel} in the closest form only: {mine}")
    check(all(v == 0 for d in launches.values() for v in d.values()),
          f"{what} launched other kernels: {launches}")
    plain = launch_counts("PLAIN_CALLS")
    check(all(v == 0 for d in plain.values() for v in d.values()),
          f"plain traversal ran in {what}: {plain}")
    return mine


def no_nee(sess):
    return dataclasses.replace(sess, cfg=sess.cfg.replace(sample_expl=False))


def phase_stream_check(sess):
    """The kitchen at 64x64, 2 spp, through K1 only. Without next-event
    estimation the stream and the lockstep trace the same paths with the
    same random numbers, so their images agree to atol 1e-5; with it, the
    stream's light sampling is the reference wavefront's (the light
    distance shortened by 0.995, wf_logic.cl:272), so it is held deferred
    against immediate (rtol 1e-4, atol 1e-5) and against the lockstep
    only through the case above. Spawns equal n_pix * spp."""
    import torch
    from fluctus_tpu_torch.render import driver

    t0 = time.perf_counter()
    choice = driver.choose_integrator(sess)     # the openness probe
    small = dataclasses.replace(sess, cfg=sess.cfg.replace(width=64,
                                                          height=64))
    spp, n_pix = 2, 64 * 64
    reset_counts()
    plain = no_nee(small)
    img_l = driver.render(plain, spp, integrator="lockstep")
    img_s, cnt_s = driver.render_stream(plain, spp)
    img_d, cnt_d = driver.render_stream(small, spp, deferred=True)
    img_i, cnt_i = driver.render_stream(small, spp, deferred=False)
    torch.cuda.synchronize()
    traced_only("K1", "stream-check")
    d_ls = float((img_s - img_l).abs().max())
    di_ok = bool(torch.allclose(img_d, img_i, rtol=1e-4, atol=1e-5))
    di_err = float((img_d - img_i).abs().max())
    spawns = [int(c[0]) for c in (cnt_s, cnt_d, cnt_i)]
    say("stream-check", t0,
        f"kitchen 64x64 {spp} spp through K1: without NEE stream vs "
        f"lockstep max abs diff {d_ls:.3e} (limit 1e-5); with NEE "
        f"deferred vs immediate max abs diff {di_err:.3e} (rtol 1e-4, "
        f"atol 1e-5: {di_ok}); spawns {spawns} (need {n_pix * spp}); "
        f"counters deferred {cnt_d.tolist()} immediate {cnt_i.tolist()}; "
        f"integrator=\"auto\" picks {choice} for the 512x512 kitchen")
    check(d_ls <= 1e-5, "stream and lockstep differ without NEE")
    check(di_ok, "deferred and immediate streams differ")
    check(spawns == [n_pix * spp] * 3, "stream spawn count is not exact")
    check(torch.equal(cnt_d, cnt_i), "deferred and immediate counters "
          "differ")


def phase_frame_stream(sess, spp: int, card: str, phase="frame-stream",
                       what="kitchen"):
    """The `what` frame through driver.render(integrator="stream"): K1
    in closest form only (every shadow ray fused), no plain version;
    spawns n_pix * spp; analytic and actual-queue MRays/s, Msamples/s."""
    import torch
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.render.benchmark import ray_counts_per_sample

    t0 = time.perf_counter()
    reset_counts()
    with capture_returns(driver, "render_stream") as got, \
            capture_fused_call() as fused:
        img = driver.render(sess, spp, integrator="stream")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mine = traced_closest_only("K1", f"the {what} stream frame")
    fused_check(sess, fused, "K1", f"the {what} stream frame")
    cfg = sess.cfg
    n = cfg.width * cfg.height * spp
    counters = got[0][1].tolist()
    prim, ext, shadow = ray_counts_per_sample(cfg, n)
    check(tuple(img.shape) == (cfg.height, cfg.width, 3), "image shape")
    check(bool(torch.isfinite(img).all()) and bool((img >= 0).all()),
          "stream image has non-finite or negative values")
    check(counters[0] == n, f"spawns {counters[0]} != {n}")
    say(phase, t0,
        f"{what} stream {cfg.width}x{cfg.height} {spp} spp, "
        f"{cfg.max_bounces} bounces, pool {driver.stream_pool(cfg)}: "
        f"{secs:.3f} s, {(prim + ext + shadow) / secs / 1e6:.3f} MRays/s "
        f"analytic, {sum(counters) / secs / 1e6:.3f} MRays/s actual queue "
        f"(spawns, extension, shadow = {counters}), "
        f"{n / secs / 1e6:.4f} Msamples/s, K1 launches {mine}, no any-hit "
        f"launch, no other kernel or plain version, mean radiance "
        f"{float(img.mean()):.5f}, on {card}")
    return secs, mine


def phase_golden_stream(sess, name, spp, kernel, reference, ref_what):
    """Golden session `name` through the stream. Without NEE: the stream
    against the lockstep on the card (atol 1e-5: the same paths). With
    NEE, through `kernel` in closest form only: against `reference` (an
    image of the same stream from an independent route, `ref_what`) at
    GOLDEN_LIMITS[name]; and, for the record only, against the lockstep
    golden, from which the reference wavefront's light sampling moves it
    (the 0.995 shortening)."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.render import driver

    t0 = time.perf_counter()
    plain = no_nee(sess)
    img_l = driver.render(plain, spp, integrator="lockstep")
    img_s, _ = driver.render_stream(plain, spp)
    d_ls = float((img_s - img_l).abs().max())
    check(d_ls <= 1e-5, f"{name}: stream and lockstep differ without NEE "
          f"({d_ls})")
    reset_counts()
    with capture_fused_call() as fused:
        img = driver.render(sess, spp, integrator="stream").cpu().numpy()
    torch.cuda.synchronize()
    mine = traced_closest_only(kernel, f"golden {name} through the stream")
    fused_check(sess, fused, kernel, f"golden {name} through the stream")
    golden_check(name, img, reference, t0,
                 f"the stream, {kernel} closest only ({mine}), against "
                 f"{ref_what}; without NEE stream vs lockstep max abs diff "
                 f"{d_ls:.3e}")
    gold = np.load(os.path.join(GOLDENS, f"{name}.npz"))["img"]
    share, rel = golden_share(img, gold)
    say("golden", t0, f"{name}: the stream against the lockstep golden, "
        f"for the record: {share * 100:.3f}% of pixels within rtol {RTOL} /"
        f" atol {ATOL}, mean relative error {rel:.3e}")
    return mine


def phase_bench(sess):
    """benchmark.run_benchmark (lockstep, 4 spp per tile step) and
    run_benchmark_stream (1 spp per frame, so that a frame fits the 8 s)
    on the session for about 8 s each, with the reference CSV schema."""
    import math
    from fluctus_tpu_torch.render import benchmark as bm

    out_dir = os.path.join(REPO, "out")     # gitignored
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for label, run in (
            ("lockstep", bm.run_benchmark),
            ("stream", functools.partial(bm.run_benchmark_stream,
                                         spp_per_frame=1))):
        t0 = time.perf_counter()
        csv = os.path.join(out_dir, f"smoke_bench_{label}.csv")
        r = run(sess, duration_s=8.0, scene_name="kitchen", csv_path=csv)
        lines = open(csv).read().splitlines()
        check(lines[0] == bm.CSV_HEADER and len(lines) >= 2
              and all(len(ln.split(";")) == 7 for ln in lines[1:]),
              f"{label} benchmark CSV does not follow the schema")
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in (
            "primary_mrays_s", "extension_mrays_s", "total_mrays_s",
            "samples_mrays_s", "samples_per_pixel")),
            f"{label} benchmark result: {r}")
        say("bench", t0, f"{label}: {json.dumps(r)} | {bm.summary_line(r)}"
            f" | {len(lines) - 1} CSV rows")
        results[label] = r
    return results


# ------------------------------------------------------------ scene formats

PLY_GRID = 17          # BASELINE config 4's stand-in: 17^3 icospheres
PLY_SPP = 4


def timed_calls(module, names, secs: dict, sync: bool = False):
    """Wrap the functions `names` of `module` so their seconds add up in
    `secs` (a context manager; the originals come back after); with
    `sync`, each call's seconds end at a torch.cuda.synchronize()."""
    old = {n: getattr(module, n) for n in names}

    def timed(n):
        def fn(*args, **kw):
            t = time.perf_counter()
            try:
                return old[n](*args, **kw)
            finally:
                if sync:
                    import torch
                    torch.cuda.synchronize()
                secs[n] = secs.get(n, 0.0) + time.perf_counter() - t
        return fn

    @contextlib.contextmanager
    def block():
        for n in names:
            setattr(module, n, timed(n))
        try:
            yield secs
        finally:
            for n, f in old.items():
                setattr(module, n, f)
    return block()


def ply_cfg(width, height):
    """BASELINE config 1's setup (Lambert-only, env-lit, short paths) at
    config 4's size: lockstep, 2 bounces, the env map, no area light."""
    from fluctus_tpu_torch.core.types import RenderConfig
    return RenderConfig(width=width, height=height, max_bounces=2,
                        use_area_light=False, use_env_map=True)


def phase_session_ply(tmp_dir: str, sky: str):
    """Write the 6.3M-triangle sphere grid as binary PLY and open it with
    the sky through create_session: above the fast-big cutover, so the
    upload builds the brute forest (K2's tables) and no hierarchy."""
    from fluctus_tpu_torch.fixtures import sphere_grid_ply
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.scene import scene as scene_mod

    t0 = time.perf_counter()
    path = os.path.join(tmp_dir, f"grid{PLY_GRID}.ply")
    n_tris, n_verts = sphere_grid_ply(path, PLY_GRID, 3, seed=0)
    t_write = time.perf_counter() - t0
    t1 = time.perf_counter()
    secs: dict = {}
    with timed_calls(scene_mod, ("load_ply", "file_hash",
                                 "build_brute_forest"), secs):
        sess = driver.create_session(path, sky, ply_cfg(512, 512),
                                     cache_dir=None, state_dir=None,
                                     device="cuda")
    t_sess = time.perf_counter() - t1
    bf = sess.scene.bforest
    geom = sess.scene.geom
    geom_bytes = sum(getattr(geom, f.name).numel() * 4
                     for f in dataclasses.fields(geom))
    check(sess.host_scene.n_tris == n_tris == 6_288_640,
          f"the PLY session holds {sess.host_scene.n_tris} triangles")
    check(bf is not None and sess.scene.wbvh is None,
          "the PLY session is not a brute-forest session")
    say("session-ply", t0,
        f"sphere grid {PLY_GRID}^3 x 1280: {n_tris} tris, {n_verts} "
        f"vertices, {os.path.getsize(path) / 1e6:.1f} MB of binary PLY "
        f"written in {t_write:.2f} s; session {t_sess:.2f} s: PLY load "
        f"{secs['load_ply']:.2f} s, hash {secs['file_hash']:.2f} s, brute "
        f"forest build {secs['build_brute_forest']:.2f} s, the rest (env "
        f"map, upload) {t_sess - sum(secs.values()):.2f} s; forest "
        f"C={bf.tris.shape[0]}, Tp={bf.tris.shape[2]}, "
        f"{(bf.tris.numel() + bf.tboxes.numel()) * 4 / 1e9:.2f} GB; "
        f"geometry {geom_bytes / 1e9:.2f} GB")
    secs.update(write=t_write, session=t_sess)
    return sess, secs


def primary_rays(sess, n: int):
    """n of the frame's primary rays (every (pixels / n)-th pixel), t_max
    3.4e38."""
    import torch
    from fluctus_tpu_torch.core import rng
    from fluctus_tpu_torch.integrators import common
    from fluctus_tpu_torch.ops import camera

    cfg, p = sess.cfg, sess.params
    pix = torch.arange(0, cfg.width * cfg.height,
                       cfg.width * cfg.height // n, device=sess.device,
                       dtype=torch.int32)[:n]
    u = [rng.uniform(pix, 0, 0, k) for k in range(4)]
    o, d = camera.generate_rays(p.camera, pix, cfg.width, cfg.height, *u,
                                p.world_radius)
    t = torch.full((n,), common.T_MAX, dtype=torch.float32,
                   device=sess.device)
    return o.contiguous(), d.contiguous(), t


def phase_ply_k2_check(sess):
    """K2 against its plain version on 4,096 of the PLY frame's primary
    rays: closest (prim, t, u, v) and any-hit, bit for bit."""
    import torch
    from fluctus_tpu_torch.ops import traverse_brute as tb

    t0 = time.perf_counter()
    bf = sess.scene.bforest
    o, d, t = primary_rays(sess, 4096)
    kc = tb.traverse_closest(bf, o, d, t, launch=tb.vlaunch_kernel)
    pc = tb.traverse_closest(bf, o, d, t, launch=tb.vlaunch_plain)
    ka = tb.traverse_any(bf, o, d, t, launch=tb.vlaunch_kernel)
    pa = tb.traverse_any(bf, o, d, t, launch=tb.vlaunch_plain)
    torch.cuda.synchronize()
    equal = all(torch.equal(getattr(kc, f), getattr(pc, f))
                for f in ("prim", "t", "u", "v")) and torch.equal(ka, pa)
    say("k2-ply", t0, f"K2 vs its plain version on {o.shape[0]} primary "
        f"rays of the PLY frame: {int((kc.prim >= 0).sum())} hits, "
        f"{int(ka.sum())} blocked; closest prim/t/u/v and any-hit flags "
        f"bit-equal: {equal}")
    check(equal, "K2 differs from its plain version on the PLY scene")


def phase_k1_equal(sess, phase: str, what: str, n: int = 1 << 14):
    """K1 against its plain version on the session's rays (primary,
    seeded bounce rays, shadow rays toward its area light), bit for bit."""
    import torch
    from fluctus_tpu_torch.ops import traverse_stack as ts

    t0 = time.perf_counter()
    bvh = sess.scene.wbvh
    o, d, t_c, o_s, d_s, t_s = kernel_rays(sess, n, seed=5)
    kc = ts.traverse_kernel(bvh, o, d, t_c, any_hit=False)
    pc, _ = ts.traverse_plain(bvh, o, d, t_c, any_hit=False)
    ka = ts.traverse_kernel(bvh, o_s, d_s, t_s, any_hit=True)
    _, pa = ts.traverse_plain(bvh, o_s, d_s, t_s, any_hit=True)
    torch.cuda.synchronize()
    equal = all(torch.equal(getattr(kc, f), getattr(pc, f))
                for f in ("prim", "t", "u", "v")) and torch.equal(ka, pa)
    say(phase, t0, f"K1 vs its plain version on {what}: {o.shape[0]} "
        f"closest rays ({int((kc.prim >= 0).sum())} hits), {o_s.shape[0]} "
        f"shadow rays ({int(ka.sum())} blocked); bit-equal: {equal}")
    check(equal, f"K1 differs from its plain version on {what}")


def phase_golden_ply(tmp_dir: str, sky: str):
    """The grid-3 sphere grid (34,560 tris, under the cutover: K1 over its
    hierarchy) at 64x64 on the card against the same render on this
    host's CPU, at GOLDEN_LIMITS."""
    import torch
    from fluctus_tpu_torch.fixtures import sphere_grid_ply
    from fluctus_tpu_torch.render import driver

    t0 = time.perf_counter()
    path = os.path.join(tmp_dir, "grid3.ply")
    sphere_grid_ply(path, 3, 3, seed=0)
    ref = driver.render(driver.create_session(
        path, sky, ply_cfg(64, 64), cache_dir=None, state_dir=None,
        device="cpu"), PLY_SPP, integrator="lockstep").numpy()
    gs = driver.create_session(path, sky, ply_cfg(64, 64), cache_dir=None,
                               state_dir=None, device="cuda")
    reset_counts()
    img = driver.render(gs, PLY_SPP, integrator="lockstep").cpu().numpy()
    torch.cuda.synchronize()
    mine = traced_only("K1", "golden-ply")
    golden_check("ply_grid3", img, ref, t0,
                 f"K1 only ({mine}), against the CPU render")


def pbrt_cfg(width, height):
    """The PBRT kitchen's frame: lockstep, 8 bounces; the area light comes
    from the file."""
    from fluctus_tpu_torch.core.types import RenderConfig
    return RenderConfig(width=width, height=height, max_bounces=8,
                        use_area_light=False, use_env_map=False)


def state_camera(sess, state: dict):
    """`sess` with the camera of a saved state (PBRT's LookAt is ignored
    by the loaders)."""
    import torch
    from fluctus_tpu_torch.core.types import Camera
    dev = sess.device
    c = state["camera"]
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    cam = Camera(pos=f(c["pos"]), dir=f(c["dir"]), up=f(c["up"]),
                 right=f(c["right"]), fov=f(c["fov"]),
                 aperture_size=f(c["aperture_size"]),
                 focal_dist=f(c["focal_dist"]))
    return dataclasses.replace(sess, params=dataclasses.replace(
        sess.params, camera=cam))


def pbrt_session(path, state, width, height, device, backend="auto"):
    from fluctus_tpu_torch.render import driver
    s = driver.create_session(path, cfg=pbrt_cfg(width, height).replace(
        backend=backend), cache_dir=None, state_dir=None, device=device)
    return state_camera(s, state)


def phase_session_pbrt(tmp_dir: str):
    """The kitchen written as PBRT (fixtures.scene_pbrt) with the saved
    state's ceiling light as its AreaLightSource quad, opened through
    create_session (the working directory is `tmp_dir`, so the parse
    cache lands there). Returns (session, pbrt path, state)."""
    from fluctus_tpu_torch.fixtures import scene_pbrt

    t0 = time.perf_counter()
    with open(os.path.join(STATES, "state_c68e332cfae81cc6.json")) as f:
        state = json.load(f)
    path = scene_pbrt(KITCHEN, tmp_dir, state["area_light"])
    t_write = time.perf_counter() - t0
    t1 = time.perf_counter()
    sess = pbrt_session(path, state, 512, 512, "cuda")
    t_sess = time.perf_counter() - t1
    check(sess.cfg.use_area_light, "the PBRT session has no area light")
    al = sess.params.area_light
    check(bool(torch_close(al.pos, state["area_light"]["pos"])),
          "the PBRT area light is not the file's quad")
    check(sess.scene.wbvh is not None, "the PBRT kitchen has no hierarchy")
    t2 = time.perf_counter()
    pbrt_session(path, state, 64, 64, "cuda")
    t_warm = time.perf_counter() - t2
    say("session-pbrt", t0,
        f"kitchen as PBRT: {os.path.getsize(path) / 1e6:.1f} MB written in "
        f"{t_write:.2f} s; session (parse + parse cache + SBVH + upload) "
        f"{t_sess:.2f} s, again from the parse cache {t_warm:.2f} s; "
        f"{sess.host_scene.n_tris} tris, {len(sess.host_scene.materials)} "
        f"materials, {len(sess.host_scene.textures.textures)} textures, "
        f"area light from the file's quad at "
        f"{[round(float(x), 4) for x in al.pos.cpu()]}")
    return sess, path, state, {"parse_session": t_sess, "warm": t_warm}


def torch_close(t, ref):
    import numpy as np
    return np.allclose(t.cpu().numpy(), np.asarray(ref, np.float32))


def phase_pbf(path, state, pbrt_sess):
    """convert_pbrt_to_pbf, then the .pbf through create_session: its host
    arrays equal the PBRT route's. Then 64x64 renders of each route
    through K1 and K4 against the same route's render on this host's CPU,
    at GOLDEN_LIMITS (the PBF's area-light frame is rebuilt from its two
    triangles, with right and up in another order, and its materials pass
    through float32, so the two routes sample the light differently).
    These renders are the stream's (K1's or K4's fused closest call) with
    implicit light hits off: the file's emitter quad lies in the area
    light's own plane, so a camera or bounce ray that reaches the light,
    and a lockstep shadow ray (which ends on the plane), ties with the
    emitter's triangles and an ulp decides it; the stream's shadow rays
    stop short of the light (0.995), so no ray ties (ROADMAP Queue 3).
    Returns (the PBF session, the renders' launches)."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.scene.loaders.pbf import convert_pbrt_to_pbf

    t0 = time.perf_counter()
    pbf = os.path.splitext(path)[0] + ".pbf"
    convert_pbrt_to_pbf(path, pbf)
    t_conv = time.perf_counter() - t0
    t1 = time.perf_counter()
    fsess = pbrt_session(pbf, state, 512, 512, "cuda")
    t_sess = time.perf_counter() - t1
    a, b = pbrt_sess.host_scene, fsess.host_scene
    fields = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
              "mat_id")
    same = [f for f in fields if np.array_equal(getattr(a, f),
                                                getattr(b, f))]
    check(len(same) == len(fields), f"PBF arrays differ from PBRT's: only "
          f"{same} equal")
    check(fsess.cfg.use_area_light, "the PBF session has no area light")
    say("pbf", t0, f"kitchen .pbrt -> .pbf in {t_conv:.2f} s "
        f"({os.path.getsize(pbf) / 1e6:.1f} MB); PBF session {t_sess:.2f} "
        f"s; host arrays {', '.join(fields)} equal to the PBRT route's; "
        f"materials {len(b.materials)} (PBRT {len(a.materials)})")

    def golden(src, device, backend="auto"):
        s = pbrt_session(src, state, 64, 64, device, backend)
        return dataclasses.replace(s, cfg=s.cfg.replace(sample_impl=False))

    launches = {}
    for src in (path, pbf):
        name = os.path.basename(src)
        t0 = time.perf_counter()
        ref = driver.render(golden(src, "cpu"), 4,
                            integrator="stream").numpy()
        say("golden-pbrt", t0, f"{name} at 64x64, 8 bounces, 4 spp, the "
            "stream without implicit light hits on this host's CPU (plain "
            "versions), the reference")
        for backend, kernel in (("auto", "K1"), ("pallas", "K4")):
            gs = golden(src, "cuda", backend)
            t0 = time.perf_counter()
            reset_counts()
            img = driver.render(gs, 4, integrator="stream").cpu().numpy()
            torch.cuda.synchronize()
            mine = traced_closest_only(kernel, f"golden {name}")
            golden_check("kitchen_pbrt", img, ref, t0,
                         f"{name}, the stream, {kernel}'s fused closest call"
                         f" only ({mine}), against its CPU render")
            launches[(os.path.splitext(src)[1], kernel)] = mine
    return fsess, launches


def phase_save_image(img, exposure, tonemap_op, tmp_dir: str):
    """The PBRT frame written as PNG and HDR with io/image.py and read
    back by the port's own decoders."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.io.hdr import float_to_rgbe, read_hdr, \
        rgbe_to_float
    from fluctus_tpu_torch.io.image import save_image
    from fluctus_tpu_torch.ops import tonemap
    from fluctus_tpu_torch.scene.png import read_png

    t0 = time.perf_counter()
    lin = img.cpu().numpy()
    w = torch.ones(img.shape[:2], dtype=torch.float32, device=img.device)
    ldr = tonemap.postprocess(img, w, exposure, tonemap_op).cpu().numpy()
    png, hdr = (os.path.join(tmp_dir, f"kitchen.{e}") for e in ("png", "hdr"))
    save_image(png, ldr)
    save_image(hdr, lin)
    u8 = np.clip(ldr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    back = read_png(png)
    ok_png = np.array_equal(back[..., :3], u8) and (back[..., 3] == 255).all()
    ok_hdr = np.array_equal(read_hdr(hdr),
                            rgbe_to_float(float_to_rgbe(lin)))
    say("save-image", t0, f"{lin.shape[1]}x{lin.shape[0]} frame: PNG "
        f"{os.path.getsize(png)} bytes read back equal to its 8-bit pixels:"
        f" {ok_png}; HDR {os.path.getsize(hdr)} bytes read back equal to "
        f"its RGBE values: {ok_hdr}")
    check(ok_png and ok_hdr, "a written image does not read back")


def phase_session_cache(tmp_dir: str):
    """The conference under FLUCTUS_FAST_BIG=0 (SBVH hierarchy) with the
    hierarchy cache in `tmp_dir`: cold (build and write) then warm (read);
    the two hierarchies equal."""
    import numpy as np
    from fluctus_tpu_torch.render import driver

    cache = os.path.join(tmp_dir, "hierarchies")
    out = {}
    bvhs = []
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        with env(FLUCTUS_FAST_BIG="0"):
            s = driver.create_session(CONFERENCE, cfg=conference_cfg(64, 64),
                                      cache_dir=cache, state_dir=STATES,
                                      auto_frame=False, device="cuda")
        out[run] = time.perf_counter() - t0
        bvhs.append(s.host_scene.bvh)
        del s
    files = os.listdir(cache)
    a, b = bvhs
    same = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "node_lo", "node_hi", "node_right", "node_count", "node_parent",
        "prim_idx")) and a.depth == b.depth
    say("session-cache", t0,
        f"conference (FLUCTUS_FAST_BIG=0, SBVH): cold session (build + "
        f"cache write) {out['cold']:.2f} s, warm (cache read) "
        f"{out['warm']:.2f} s; {files}, {a.n_nodes} nodes; hierarchies "
        f"equal: {same}")
    check(len(files) == 1 and same, "the cached hierarchy differs")
    return out


def phase_native_off():
    """The kitchen's SAH hierarchy built by NumPy under FLUCTUS_NATIVE=0,
    traced by K1 bit-equal to the plain version."""
    from fluctus_tpu_torch.render import driver

    t0 = time.perf_counter()
    with env(FLUCTUS_NATIVE="0"):
        s = driver.create_session(KITCHEN, cfg=kitchen_cfg(512, 512),
                                  use_sbvh=False, cache_dir=None,
                                  state_dir=STATES, auto_frame=False,
                                  device="cuda")
    t_sess = time.perf_counter() - t0
    say("native-off", t0, f"kitchen, FLUCTUS_NATIVE=0: NumPy SAH session "
        f"{t_sess:.2f} s, {s.host_scene.bvh.n_nodes} binary nodes, wide "
        f"depth {s.scene.wbvh.depth}")
    phase_k1_equal(s, "native-off", "the NumPy-built kitchen hierarchy")
    return t_sess

@contextlib.contextmanager
def working_dir(path: str):
    """Run a block with `path` as the working directory."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def phase_formats(card: str) -> dict:
    """The scene formats, the hierarchy cache and the NumPy builders, run
    in a temporary working directory (so the PBRT parse cache lands
    there): the 6.3M-triangle PLY through K2 (session-ply, k2-ply,
    frame-ply), the grid-3 PLY golden through K1, the PBRT kitchen with
    its file's area light through K1 (session-pbrt, frame-pbrt, k1-pbrt),
    its PBF conversion and the 64x64 renders of both through K1 and K4
    (pbf), the frame written as PNG and HDR (save-image), the
    conference's cold and warm cached sessions (session-cache) and the
    NumPy-built kitchen through K1 (native-off)."""
    import torch
    from fluctus_tpu_torch.fixtures import sky_env
    from fluctus_tpu_torch.io.hdr import write_hdr
    from fluctus_tpu_torch.render import driver

    out = {}
    with tempfile.TemporaryDirectory() as tmp_dir, working_dir(tmp_dir):
        sky = os.path.join(tmp_dir, "sky.hdr")
        write_hdr(sky, sky_env(1024, 512, seed=ENV_SEED))
        psess, out["ply_secs"] = phase_session_ply(tmp_dir, sky)
        phase_ply_k2_check(psess)
        t0 = time.perf_counter()
        driver.render(dataclasses.replace(psess, cfg=psess.cfg.replace(
            width=64, height=64)), 1, integrator="lockstep")
        torch.cuda.synchronize()
        say("warm-up", t0, "sphere grid PLY 64x64 1 spp")
        out["frame_ply"] = phase_frame_only(
            psess, PLY_SPP, card, "frame-ply", "K2",
            "sphere grid PLY (6.3M tris), env-lit,")
        del psess
        torch.cuda.empty_cache()
        phase_golden_ply(tmp_dir, sky)

        ksess, kpath, state, out["pbrt_secs"] = phase_session_pbrt(tmp_dir)
        t0 = time.perf_counter()
        driver.render(dataclasses.replace(ksess, cfg=ksess.cfg.replace(
            width=64, height=64)), 1, integrator="lockstep")
        torch.cuda.synchronize()
        say("warm-up", t0, "PBRT kitchen 64x64 1 spp")
        kept = {}
        out["frame_pbrt"] = phase_frame_only(
            ksess, 4, card, "frame-pbrt", "K1", "kitchen from PBRT,", kept)
        phase_k1_equal(ksess, "k1-pbrt", "the PBRT kitchen's rays")
        _, out["golden_pbf"] = phase_pbf(kpath, state, ksess)
        phase_save_image(kept["img"], ksess.params.exposure,
                         ksess.cfg.tonemap_op, tmp_dir)
        del ksess, kept
        torch.cuda.empty_cache()
        out["cache_secs"] = phase_session_cache(tmp_dir)
        out["native_off_secs"] = phase_native_off()
    out["dds_secs"] = phase_dds()
    out["raster_secs"] = phase_raster_formats()
    return out


def phase_dds() -> float:
    """One 2048x2048 BC7 texture (fixtures.dds_bytes: 262,144 seeded
    blocks, the first nine in BC7 modes 0-7 and the reserved mode 8)
    through the texture dispatch and scene/native/bcn.cpp (built with g++
    first). Returns the decode seconds."""
    import numpy as np
    from fluctus_tpu_torch.fixtures import dds_bytes
    from fluctus_tpu_torch.scene import dds, imageformat

    t0 = time.perf_counter()
    dds.load_library()
    t_build = time.perf_counter() - t0
    data = dds_bytes("BC7", 2048, 2048, seed=7)
    t1 = time.perf_counter()
    kind = imageformat.sniff(data)
    rgba = imageformat.decode(data, kind)
    secs = time.perf_counter() - t1
    check(kind == "dds" and rgba.shape == (2048, 2048, 4),
          "the BC7 texture did not decode")
    check(bool((rgba[0:4, 32:36] == np.array([0, 0, 0, 255],
                                              np.uint8)).all()),
          "the reserved-mode block (the ninth) is not opaque black")
    say("dds", t0, f"BC7 2048x2048 ({len(data)} bytes): g++ build "
        f"{t_build:.2f} s, decode {secs:.3f} s")
    return secs


# ------------------------------------------------------------ gradients

GRAD_LEAVES = ("kd", "env_image", "env_strength", "ni", "cam_pos", "cam_fov")
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
GRAD_SIZE = 64
GRAD_POOL = 1024


def grad_sessions(env_path, dev, backend="auto"):
    """The grad-check sessions at 64x64: the plane of the CPU gradient
    tests env-lit (tests/test_integrator.py::plane_session) and area-lit
    by next-event estimation only under the tilted camera
    (tests/test_gradients.py::_camera_grad_session), both by
    fixtures.plane_session, and the env-lit luxball of env_sessions."""
    from fluctus_tpu_torch import fixtures

    out = {"plane_env": fixtures.plane_session(dev, size=GRAD_SIZE),
           "plane_area": fixtures.plane_session(
               dev, size=GRAD_SIZE, env_val=None, use_area_light=True,
               sample_impl=False, tilted=True),
           "luxball_env": env_sessions(env_path, dev, backend)[
               "luxball_env"]}
    for s_ in out.values():
        s_.cfg = s_.cfg.replace(backend=backend)
    return out


def grads_of(sess, form: str, n_seg: int = 0):
    """Loss and gradients of GRAD_LEAVES through parallel/mesh.py: loss_fn
    (form "lockstep") or the deferred loss_fn_stream ("stream", n_seg
    segments of GRAD_POOL lanes), every pixel at sample 0 against a
    constant 0.1. Returns (loss, {leaf: grad}, forward launches, backward
    launches, plain calls)."""
    import torch
    from fluctus_tpu_torch.parallel import mesh
    from fluctus_tpu_torch.render.optimize import _DIFF_GETTERS

    s_, p_, c_ = sess.scene, sess.params, sess.cfg
    n = c_.width * c_.height
    pix = torch.arange(n, device=s_.device)
    tgt = torch.full((n, 3), 0.1, device=s_.device)
    leaves = {k: _DIFF_GETTERS[k](s_, p_).detach().clone()
              .requires_grad_(True) for k in GRAD_LEAVES}
    reset_counts()
    with torch.enable_grad():
        if form == "stream":
            loss, nd = mesh.loss_fn_stream(leaves, s_, p_, c_, pix, 0, tgt,
                                           GRAD_POOL, n_seg, deferred=True)
            check(int(nd) == n, f"the {form} loss left {n - int(nd)} rays "
                  "undrained")
        else:
            loss = mesh.loss_fn(leaves, s_, p_, c_, pix, 0, tgt)
        fwd = launch_counts()
        plain = launch_counts("PLAIN_CALLS")
        reset_counts()
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    bwd = launch_counts()
    plain_b = launch_counts("PLAIN_CALLS")
    grads = {k: (torch.zeros_like(leaves[k]) if x is None else x).cpu()
             for k, x in zip(leaves, g)}
    check(all(bool(torch.isfinite(x).all()) for x in grads.values()),
          f"non-finite {form} gradients")
    return float(loss.detach()), grads, fwd, bwd, (plain, plain_b)


def worst_leaf(grads, ref):
    """(leaf, max |a - b|, the largest |a - b| / (atol + rtol |b|)) over
    the leaves, the leaf with the largest ratio."""
    rows = []
    for k, a in grads.items():
        b = ref[k]
        d = (a - b).abs()
        rows.append((k, float(d.max()), float((d / (GRAD_ATOL + GRAD_RTOL
                                                    * b.abs())).max())))
    return max(rows, key=lambda r: r[2])


def phase_grad_check(env_path: str, card: str) -> dict:
    """Gradients of loss_fn and the deferred loss_fn_stream for kd,
    env_image, env_strength, ni, cam_pos and cam_fov on the grad_sessions,
    on the card through K1 and, under backend "pallas", through K4,
    against the same port code on this host's CPU (plain versions), at
    rtol 1e-3 / atol 1e-6; the traversal kernels' launches in the forward
    and in the backward, which must launch none. Returns {session:
    {route: forward launches}}."""
    import torch
    from fluctus_tpu_torch.integrators import wavefront

    cpu = grad_sessions(env_path, "cpu")
    out = {}
    for name, cs in cpu.items():
        c_ = cs.cfg
        n = c_.width * c_.height
        pix = torch.arange(n)
        t0 = time.perf_counter()
        k, _ = wavefront.plan_stream_segments(cs.scene, cs.params, c_, pix,
                                              0, GRAD_POOL, deferred=True)
        n_seg = k + 2
        ref = {form: grads_of(cs, form, n_seg)
               for form in ("lockstep", "stream")}
        say("grad-check", t0, f"{name}: loss_fn and loss_fn_stream "
            f"(deferred, pool {GRAD_POOL}, {n_seg} segments) on this "
            f"host's CPU, the reference: losses "
            f"{ref['lockstep'][0]:.6f} / {ref['stream'][0]:.6f}")
        out[name] = {}
        for backend, kernel in (("auto", "K1"), ("pallas", "K4")):
            gs = grad_sessions(env_path, "cuda", backend)[name]
            for form in ("lockstep", "stream"):
                t0 = time.perf_counter()
                loss, grads, fwd, bwd, plain = grads_of(gs, form, n_seg)
                torch.cuda.synchronize()
                mine = fwd.pop(kernel)
                want_any = form == "lockstep" and (
                    gs.cfg.sample_expl and (gs.cfg.use_env_map
                                            or gs.cfg.use_area_light))
                check(mine["closest"] > 0 and (mine["any"] > 0) == want_any,
                      f"{name} {form} forward did not go through {kernel} "
                      f"as expected: {mine}")
                check(all(v == 0 for d in fwd.values() for v in d.values()),
                      f"{name} {form} forward launched other kernels: {fwd}")
                check(all(v == 0 for d in bwd.values() for v in d.values()),
                      f"{name} {form} backward launched traversal kernels: "
                      f"{bwd}")
                check(all(v == 0 for p_ in plain for d in p_.values()
                          for v in d.values()),
                      f"plain traversal ran in {name} {form}: {plain}")
                leaf, err, ratio = worst_leaf(grads, ref[form][1])
                check(abs(loss - ref[form][0])
                      <= GRAD_ATOL + GRAD_RTOL * abs(ref[form][0]),
                      f"{name} {form} loss {loss} against the CPU's "
                      f"{ref[form][0]}")
                check(ratio <= 1.0, f"{name} {form} through {kernel}: "
                      f"gradient of {leaf} off the CPU's by {err:.3e} "
                      f"({ratio:.2f} x the tolerance)")
                say("grad-check", t0,
                    f"{name} {form} through {kernel}: forward launches "
                    f"{mine}, backward launches 0 (no traversal kernel, no "
                    f"plain version); every leaf within rtol {GRAD_RTOL} / "
                    f"atol {GRAD_ATOL} of the CPU, worst {leaf} max abs "
                    f"err {err:.3e} ({ratio:.3f} x the tolerance), on "
                    f"{card}")
                out[name][f"{form} {kernel}"] = mine
            del gs
    return out


class LapClock:
    """on_lap for render/optimize.py: the seconds of each part (the device
    synchronized at its end) and the traversal launches in it."""

    def __init__(self):
        import torch
        self.sync = torch.cuda.synchronize
        self.secs, self.launches = {}, {}
        self.sync()
        reset_counts()
        self.t = time.perf_counter()

    def __call__(self, part: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.secs[part] = now - self.t
        self.launches[part] = launch_counts()
        reset_counts()
        self.t = now


def phase_grad_step(esess, card: str) -> dict:
    """scripts/bench_grad.py's north-star shape on the in-repo stand-in:
    the env-lit luxball at 512x512, 4 bounces, env_image (1024x512) and
    kd differentiable. One stream optimizer step at 4 spp over the full
    frame (2,097,152 rays in the two sample sets), checkpointed and under
    FLUCTUS_STREAM_SAVE=all: the seconds of the planning, the radiance
    pass, the loss forward and the backward, fwd+bwd MRays/s (the rays the
    loss forward traced, counted on the device, over the step), K1's
    launches and the peak of torch.cuda.max_memory_allocated; then one
    lockstep step at minibatch 4096, 4 spp. No backward launches a
    traversal kernel. Returns the K1 launches of the path."""
    import torch
    from fluctus_tpu_torch.integrators import wavefront
    from fluctus_tpu_torch.render import optimize

    s_, p_, c_ = esess.scene, esess.params, esess.cfg
    dev = s_.device
    n_pix = c_.width * c_.height
    spp = 4
    target = torch.full((n_pix, 3), 0.1, device=dev)
    diff = {k: optimize._DIFF_GETTERS[k](s_, p_) for k in ("env_image",
                                                            "kd")}
    t0 = time.perf_counter()
    reset_counts()
    n_seg, pool = optimize.plan_stream(s_, p_, c_, n_pix, spp)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    plan_launches = launch_counts()["K1"]
    say("grad-step", t0, f"luxball 512x512, 4 bounces, 4 spp, two sample "
        f"sets: plan {t_plan:.3f} s, {n_seg} segments of a {pool}-lane "
        f"pool (K1 {plan_launches})")
    pix = optimize.stratified_pixels(n_pix, n_pix, 0, dev)
    k1 = {"closest": plan_launches["closest"], "any": plan_launches["any"]}
    for save in ("named", "all"):
        with env(FLUCTUS_STREAM_SAVE=save):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            clock = LapClock()
            with wavefront.count_loss_rays() as box:
                loss, grads, nd, n_total = optimize.stream_grad(
                    diff, s_, p_, c_, pix, target, 0, spp, n_seg, pool,
                    on_lap=clock)
            rays = int(box[0])
            peak = torch.cuda.max_memory_allocated()
        check(nd == n_total, f"the grad step left {n_total - nd} rays "
              "undrained")
        check(all(bool(torch.isfinite(g).all()) for g in grads.values())
              and float(grads["kd"].abs().sum()) > 0.0,
              "grad-step gradients not finite or kd's zero")
        bwd = clock.launches["backward"]
        check(all(v == 0 for d in bwd.values() for v in d.values()),
              f"the grad step's backward launched traversal kernels: {bwd}")
        secs = clock.secs
        step = sum(secs.values())
        for part in ("radiance", "loss_forward"):
            for f in ("closest", "any"):
                k1[f] += clock.launches[part]["K1"][f]
        say("grad-step", t0,
            f"stream step, FLUCTUS_STREAM_SAVE={save}: radiance "
            f"{secs['radiance']:.3f} s (K1 {clock.launches['radiance']['K1']}"
            f"), loss forward {secs['loss_forward']:.3f} s (K1 "
            f"{clock.launches['loss_forward']['K1']}), backward "
            f"{secs['backward']:.3f} s (no traversal launch); step "
            f"{step:.3f} s; loss forward traced {rays} rays: "
            f"{rays / step / 1e6:.3f} fwd+bwd MRays/s over the step "
            f"({rays / (secs['loss_forward'] + secs['backward']) / 1e6:.3f}"
            f" over loss forward + backward); peak memory "
            f"{peak / 2**30:.2f} GiB; loss {float(loss):.6f}, |d kd| "
            f"{float(grads['kd'].abs().sum()):.4e}, on {card}")
    t0 = time.perf_counter()
    mpix = optimize.stratified_pixels(n_pix, 4096, 0, dev)
    torch.cuda.reset_peak_memory_stats()
    clock = LapClock()
    loss, grads = optimize.lockstep_grad(diff, s_, p_, c_, mpix, target, 0,
                                         spp, on_lap=clock)
    peak = torch.cuda.max_memory_allocated()
    bwd = clock.launches["backward"]
    check(all(v == 0 for d in bwd.values() for v in d.values()),
          f"the lockstep step's backward launched traversal kernels: {bwd}")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "lockstep step gradients not finite")
    fwd = clock.launches["forward"]["K1"]
    for f in ("closest", "any"):
        k1[f] += fwd[f]
    say("grad-step", t0,
        f"lockstep step, minibatch 4096, 4 spp, two sample sets: forward "
        f"{clock.secs['forward']:.3f} s (K1 {fwd}), backward "
        f"{clock.secs['backward']:.3f} s (no traversal launch); peak "
        f"memory {peak / 2**30:.2f} GiB; loss {float(loss):.6f}, on {card}")
    return k1


def phase_optimize(esess, tmp_dir: str, card: str) -> None:
    """run_optimization on the env-lit luxball (512x512) for 3 steps, kd
    differentiable, against a target the port renders with kd x 0.5 and
    writes with io.hdr.write_hdr; method "auto", which must resolve to the
    stream on the card (three stream_grad steps, no lockstep_grad);
    minibatches of 16,384 pixels at 1 spp. Every loss finite, the final kd nearer the target's, and a second
    call with steps=4 resumes from the checkpoint with a history of 4."""
    import torch
    from fluctus_tpu_torch.io.hdr import write_hdr
    from fluctus_tpu_torch.render import driver, optimize

    t0 = time.perf_counter()
    m = esess.scene.materials
    kd0 = m.kd.clone()
    kd_t = kd0 * 0.5
    tsess = dataclasses.replace(esess, scene=dataclasses.replace(
        esess.scene, materials=dataclasses.replace(m, kd=kd_t)))
    img = driver.render(tsess, 4, integrator="lockstep")
    path = os.path.join(tmp_dir, "target.hdr")
    write_hdr(path, img.cpu().numpy())
    say("optimize", t0, "target: the luxball with kd x 0.5, lockstep 4 spp,"
        " written as .hdr")
    check(optimize.resolve_method("auto", esess.device) == "stream",
          "method auto did not resolve to the stream on the card")
    out = os.path.join(tmp_dir, "opt")
    kw = dict(lr=0.05, spp=1, minibatch=16384, out_dir=out,
              diff_keys=("kd",), checkpoint_every=1, log_every=100,
              method="auto")
    t0 = time.perf_counter()
    reset_counts()
    with counted_calls(optimize, ("stream_grad", "lockstep_grad")) as calls:
        diff, hist = optimize.run_optimization(esess, path, steps=3, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1 = launch_counts()["K1"]
    check(calls == {"stream_grad": 3, "lockstep_grad": 0},
          f"the optimization did not take the stream: {calls}")
    check(k1["closest"] > 0, f"the optimization launched no K1: {k1}")
    check(len(hist) == 3 and all(h == h and abs(h) < float("inf")
                                 for h in hist), f"losses {hist}")
    d0 = float((kd0 - kd_t).abs().sum())
    d1 = float((diff["kd"] - kd_t).abs().sum())
    check(d1 < d0, f"kd did not move toward the target: {d0} -> {d1}")
    t1 = time.perf_counter()
    diff2, hist2 = optimize.run_optimization(esess, path, steps=4, **kw)
    check(len(hist2) == 4 and hist2[:3] == hist,
          f"resume gave the history {hist2} after {hist}")
    say("optimize", t0,
        f"run_optimization, method auto -> stream, 3 steps {secs:.3f} s "
        f"(K1 {k1}), losses {[round(h, 6) for h in hist]}; sum |kd - "
        f"target| {d0:.4f} -> {d1:.4f}; resumed to 4 steps in "
        f"{time.perf_counter() - t1:.3f} s, history of 4, on {card}")


# ------------------------------------------------------------ surfaces

def hold_aux(got, want, what: str, ties_allowed: bool) -> int:
    """Hold render_aux buffers against the plain walk's: depth at rtol
    1e-6 everywhere, albedo and normal bit-equal except (with
    `ties_allowed`) at pixels where the two stopped on different
    triangles at equal t, under 1 % of them. Returns those pixels."""
    import torch
    a, n, d = got
    wa, wn, wd = want
    check(bool(torch.isfinite(d).all()) and bool(torch.isfinite(a).all()),
          f"{what}: non-finite aux buffers")
    rel = float(((d - wd).abs() / wd.abs().clamp(min=1e-30)).max())
    check(rel <= 1e-6, f"{what}: depth off by {rel:.3e} relative")
    tie = ((a != wa) | (n != wn)).any(-1)
    n_tie = int(tie.sum())
    check(n_tie == 0 or (ties_allowed and n_tie < 0.01 * tie.numel()),
          f"{what}: albedo or normal differ on {n_tie} pixels")
    return n_tie


def phase_aux(sess, card: str) -> dict:
    """render_aux on the kitchen session (512x512): K1's closest form, one
    launch a tile and nothing else, against the same buffers through
    K1's plain version on the card (backend "wide"); then at 64x64 under
    backend "pallas" through K4 against the plain walk. Returns the
    seconds and K1's launches."""
    import torch
    from fluctus_tpu_torch.render import driver

    cfg = sess.cfg
    t0 = time.perf_counter()
    reset_counts()
    got = driver.render_aux(sess)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    k1 = launches.pop("K1")
    tiles = -(-cfg.width * cfg.height // cfg.tile_size)
    check(k1 == {"closest": tiles, "any": 0},
          f"render_aux launched K1 {k1}, not one closest launch a tile")
    check(all(v == 0 for d in launches.values() for v in d.values()),
          f"render_aux launched other kernels: {launches}")
    plain = launch_counts("PLAIN_CALLS")
    check(all(v == 0 for d in plain.values() for v in d.values()),
          f"render_aux ran a plain traversal: {plain}")
    want = driver.render_aux(dataclasses.replace(
        sess, cfg=cfg.replace(backend="wide")))
    hold_aux(got, want, "K1 aux buffers", ties_allowed=False)
    a, n, d = got
    t1 = time.perf_counter()
    timing = time_aux_tiles(sess)
    say("aux-time", t1, f"K1 closest on the aux path's {timing['tiles']} "
        f"tiles of centre rays: {timing['ms']:.4f} ms a launch (plain "
        f"{timing['plain_ms']:.1f} ms), bound {timing['bound_ms']:.5f} ms "
        f"by {timing['bound_by']}, max abs t err "
        f"{timing['max_abs_err']:.3e}, on {card}")
    small = dataclasses.replace(sess, cfg=cfg.replace(width=64, height=64,
                                                      backend="pallas"))
    reset_counts()
    got4 = driver.render_aux(small)
    torch.cuda.synchronize()
    k4 = launch_counts()["K4"]
    check(k4["closest"] >= 1 and launch_counts()["K1"]["closest"] == 0,
          f"the pallas aux buffers did not go through K4 alone: {k4}")
    ties4 = hold_aux(got4, driver.render_aux(dataclasses.replace(
        small, cfg=small.cfg.replace(backend="wide"))), "K4 aux buffers",
        ties_allowed=True)
    miss = int((d == 2.0).sum())
    say("aux", t0, f"kitchen {cfg.width}x{cfg.height} render_aux: "
        f"{secs:.3f} s, K1 launches {k1}; albedo, normal and depth "
        f"bit-equal to the plain walk on the card; {miss} misses, mean "
        f"depth {float(d[d < 2.0].mean()):.4f} world radii; 64x64 through "
        f"K4 ({k4['closest']} closest launches): depth within 1e-6, "
        f"{ties4} equal-t tie pixels, on {card}")
    return {"secs": secs, "k1": k1["closest"], "timing": timing}


def time_aux_tiles(sess) -> dict:
    """K1's closest form against its plain version on render_aux's own
    launches: each tile of cfg.tile_size centre rays (u = v = 0.5, no
    lens, t_max T_MAX), kernel and plain in turns on the same rays, bit
    for bit. Returns ms and plain_ms per launch, the bound per launch from
    these rays' visits (bound_ms), bound_by, max_abs_err and the tiles."""
    import torch
    from fluctus_tpu_torch.integrators import common
    from fluctus_tpu_torch.ops import camera
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch.timing import time_launches

    cfg, p, bvh = sess.cfg, sess.params, sess.scene.wbvh
    n_pix = cfg.width * cfg.height
    tile = min(cfg.tile_size, n_pix)
    stats: dict = {}
    k_ms = p_ms = err = 0.0
    starts = range(0, n_pix, tile)
    for start in starts:
        pix = torch.arange(start, min(start + tile, n_pix),
                           dtype=torch.int32, device=sess.device)
        half = torch.full(pix.shape, 0.5, device=sess.device)
        zero = torch.zeros(pix.shape, device=sess.device)
        o, d = camera.generate_rays(p.camera, pix, cfg.width, cfg.height,
                                    half, half, zero, zero, p.world_radius)
        kc = ts.traverse_kernel(bvh, o, d, common.T_MAX, any_hit=False)
        pc, _ = ts.traverse_plain(bvh, o, d, common.T_MAX, any_hit=False,
                                  stats=stats)
        check(torch.equal(kc.prim, pc.prim) and torch.equal(kc.t, pc.t),
              f"K1 differs from its plain version on aux tile {start}")
        err = max(err, float((kc.t - pc.t).abs().max()))
        run_p = lambda: ts.traverse_plain(bvh, o, d, common.T_MAX, False)
        run_k = lambda: ts.traverse_kernel(bvh, o, d, common.T_MAX, False)
        p1 = time_launches(run_p, 2, 1)
        k1 = time_launches(run_k, 20, 1)
        k2 = time_launches(run_k, 20, 1)
        p2 = time_launches(run_p, 2, 1)
        k_ms += (k1 + k2) / 2
        p_ms += (p1 + p2) / 2
    n = len(starts)
    b_ms, b_by = bound_ms(bvh, n_pix, stats, any_hit=False)
    return dict(ms=k_ms / n, plain_ms=p_ms / n, bound_ms=b_ms / n,
                bound_by=b_by, max_abs_err=err, tiles=n)


def phase_denoise(sess, card: str) -> dict:
    """render_denoised on the kitchen (512x512, its 8 bounces, 4 spp,
    lockstep) with the seconds of its render, aux buffers and filter;
    then test_render_denoised_end_to_end's check on an in-repo scene: the
    env-lit luxball at 128x128 (4 bounces, a pinhole camera, as the
    teapot's) under the seeded sky without its sun disc (the teapot's
    night.hdr has none), where the denoised 2 spp frame's MSE against a
    64 spp frame must be below 0.6 x the raw frame's. The feature buffers
    come from centre rays without the lens, so a thin-lens frame would
    hold its defocus blur against sharp edges: with the luxball's 0.06
    aperture the denoised frame is farther from the 64 spp one than the
    raw frame (MSE 2.664e-3 against 2.395e-3 on the card)."""
    import torch
    from fluctus_tpu_torch.fixtures import sky_env
    from fluctus_tpu_torch.io.hdr import write_hdr
    from fluctus_tpu_torch.render import driver

    secs = {}
    t0 = time.perf_counter()
    with timed_calls(driver, ("render", "render_aux"), secs, sync=True):
        den = driver.render_denoised(sess, 4, integrator="lockstep")
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    cfg = sess.cfg
    check(tuple(den.shape) == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(den).all()), "the denoised frame")
    parts = {"render": secs["render"], "aux": secs["render_aux"],
             "denoise": total - secs["render"] - secs["render_aux"]}
    with tempfile.TemporaryDirectory() as tmp_dir:
        path = os.path.join(tmp_dir, "sky_nosun.hdr")
        write_hdr(path, sky_env(1024, 512, seed=ENV_SEED,
                                sun_radiance=0.0))
        lux = driver.create_session(LUXBALL, path, env_cfg(128, 128),
                                    cache_dir=None, state_dir=None,
                                    device="cuda")
    t1 = time.perf_counter()
    raw = driver.render(lux, 2, integrator="lockstep")
    dl = driver.render_denoised(lux, 2, integrator="lockstep")
    ref = driver.render(lux, 64, integrator="lockstep")
    mse_raw = float(((raw - ref) ** 2).mean())
    mse_den = float(((dl - ref) ** 2).mean())
    check(mse_den < 0.6 * mse_raw, f"the denoised luxball is not nearer "
          f"the 64 spp frame: MSE {mse_den:.3e} against {mse_raw:.3e}")
    say("denoise", t0, f"kitchen {cfg.width}x{cfg.height} 4 spp "
        f"render_denoised: render {parts['render']:.3f} s, aux "
        f"{parts['aux']:.3f} s, denoise {parts['denoise']:.3f} s; luxball "
        f"128x128 under the sunless sky: MSE against 64 spp {mse_den:.4e} "
        f"denoised, {mse_raw:.4e} raw (ratio {mse_den / mse_raw:.3f}, "
        f"limit 0.6) in {time.perf_counter() - t1:.2f} s, on {card}")
    return parts


def phase_progressive(esess, tmp_dir: str, card: str) -> float:
    """The env-lit luxball (512x512): two ProgressiveRender increments of
    4 spp (samples_per_launch 4) bit-equal to lockstep.render(8,
    samples_per_launch=4); a parameter change resets the accumulator;
    render_progressive(export_every=1) writes a PNG; render_preview runs
    at 2 bounces, bit-equal to the lockstep at 2 bounces. Returns the
    seconds."""
    import torch
    from fluctus_tpu_torch.integrators import lockstep
    from fluctus_tpu_torch.render import driver

    t0 = time.perf_counter()
    prog = driver.ProgressiveRender(esess, samples_per_launch=4)
    prog.add(4)
    check(prog.add(4) == 8, "the progressive count")
    img = prog.image()
    t_prog = time.perf_counter() - t0
    one = lockstep.render(esess.scene, esess.params, esess.cfg, 8,
                          samples_per_launch=4)
    check(torch.equal(img, one), "two progressive increments differ from "
          "the one-shot frame")
    prog.session = dataclasses.replace(esess, params=dataclasses.replace(
        esess.params, env_strength=esess.params.env_strength * 2.0))
    check(prog.add(4) == 4, "a parameter change did not reset the "
          "accumulator")
    out = os.path.join(tmp_dir, "progressive.png")
    driver.render_progressive(esess, iterations=2, spp_increment=1,
                              export_every=1, export_path=out)
    check(os.path.getsize(out) > 0, "render_progressive wrote no PNG")
    prev = driver.render_preview(esess, 1)
    check(esess.cfg.max_bounces > 2 and torch.equal(prev, lockstep.render(
        esess.scene, esess.params, esess.cfg.replace(max_bounces=2), 1)),
        "render_preview is not the 2-bounce lockstep frame")
    secs = time.perf_counter() - t0
    say("progressive", t0, f"luxball {esess.cfg.width}x{esess.cfg.height}: "
        f"2 x 4 spp progressive {t_prog:.3f} s, bit-equal to the 8 spp "
        f"one-shot; reset on a parameter change; PNG export "
        f"{os.path.getsize(out)} bytes; 2-bounce preview; {secs:.2f} s in "
        f"all, on {card}")
    return secs


def phase_pick(sess, card: str) -> float:
    """The centre pick on the kitchen: one K1 launch of one ray whose t
    and prim equal the plain walk's on the card; pick_dof_depth sets the
    focal distance; save_state then load_state round-trip the camera in a
    temporary directory. Returns the seconds."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.core.types import default_params
    from fluctus_tpu_torch.render import state as st

    t0 = time.perf_counter()
    reset_counts()
    t, prim = st.pick(sess.scene, sess.params, sess.cfg, 0.5, 0.5)
    k1 = launch_counts()["K1"]
    check(k1 == {"closest": 1, "any": 0}, f"pick launched K1 {k1}")
    t_p, prim_p = st.pick(sess.scene, sess.params,
                          sess.cfg.replace(backend="wide"), 0.5, 0.5)
    check(prim >= 0 and (t, prim) == (t_p, prim_p),
          f"the pick ({t}, {prim}) is not the plain walk's "
          f"({t_p}, {prim_p})")
    p2 = st.pick_dof_depth(sess.scene, sess.params, sess.cfg)
    check(float(p2.camera.focal_dist) == np.float32(t),
          "pick_dof_depth did not set the focal distance")
    with tempfile.TemporaryDirectory() as d:
        st.save_state(p2, sess.host_scene.hash, state_dir=d)
        back = st.load_state(default_params(device="cuda"),
                             sess.host_scene.hash, state_dir=d)
    for f in dataclasses.fields(back.camera):
        check(torch.equal(getattr(back.camera, f.name),
                          getattr(p2.camera, f.name)),
              f"the saved camera's {f.name} did not come back")
    secs = time.perf_counter() - t0
    say("pick", t0, f"kitchen centre pick: t {t:.6f}, prim {prim} through "
        f"one K1 launch of one ray, equal to the plain walk; focal "
        f"distance set; state saved and read back; {secs:.3f} s, on "
        f"{card}")
    return secs


def phase_cli(card: str, device: str = "cuda", size: int = 512,
              spp: int = 4, small_size: int = 64) -> dict:
    """python3 -m fluctus_tpu_torch.cli as a user runs it, from the
    repository root (so the kitchen's saved state is found), every output
    and the hierarchy cache in a temporary directory; the commands run
    at once, each in its own process. The kitchen at 512x512, 4 spp:
    render (plain, --hdr, --denoise 0.5, --progressive 2 --export-every
    1), benchmark --duration 5 with --csv and --txt, optimize --steps 2
    --minibatch 4096 against a constant 0.05 target the phase writes, and
    convert of the PBRT kitchen of fixtures.scene_pbrt; and at 64x64,
    1 spp, --backend jnp, packed and wide, each held against the auto
    frame of the same command at the goldens' tolerance on >= 99.5 % of
    pixels. Returns {command: seconds} and the phase's seconds."""
    import subprocess
    import numpy as np
    from fluctus_tpu_torch.fixtures import scene_pbrt
    from fluctus_tpu_torch.io.hdr import read_hdr, write_hdr

    t0 = time.perf_counter()
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return os.path.join(tmp, name)

        with open(os.path.join(STATES, "state_c68e332cfae81cc6.json")) as f:
            state = json.load(f)
        pbrt = scene_pbrt(KITCHEN, tmp, state["area_light"])
        base = ["--area-light", "--cache-dir", out("hierarchies"),
                "--device", device]
        big = [KITCHEN, "-x", str(size), "-y", str(size), *base]
        small = [KITCHEN, "-x", str(small_size), "-y", str(small_size),
                 "-s", "1", "--hdr", "--integrator", "lockstep", *base]
        cmds = {
            "render": (["render", *big, "-s", str(spp), "-o", out("r.png")],
                       out("r.png")),
            "render --hdr": (["render", *big, "-s", str(spp), "--hdr", "-o",
                              out("r.hdr")], out("r.hdr")),
            "render --denoise 0.5": (["render", *big, "-s", str(spp),
                                      "--denoise", "0.5", "-o",
                                      out("d.png")], out("d.png")),
            "render --progressive 2": (["render", *big, "-s", str(spp),
                                        "--progressive", "2",
                                        "--export-every", "1", "-o",
                                        out("p.png")], out("p.png")),
            "benchmark": (["benchmark", *big, "--duration", "5", "--csv",
                           out("b.csv"), "--txt", out("b.txt")],
                          out("b.csv")),
            "convert": (["convert", pbrt, out("k.pbf")], out("k.pbf")),
        }
        for be in ("auto", "jnp", "packed", "wide"):
            cmds[f"render --backend {be}"] = (
                ["render", *small, "--backend", be, "-o",
                 out(f"{be}.hdr")], out(f"{be}.hdr"))

        def run(name):
            args, made = cmds[name]
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "fluctus_tpu_torch.cli", *args],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            secs[name] = time.perf_counter() - t
            check(proc.returncode == 0, f"cli {name}: rc "
                  f"{proc.returncode}\n{proc.stdout[-2000:]}"
                  f"{proc.stderr[-4000:]}")
            check(os.path.exists(made) and os.path.getsize(made) > 0,
                  f"cli {name} wrote no {made}")
            return proc.stdout

        write_hdr(out("target.hdr"), np.full((size, size, 3), 0.05,
                                             np.float32))
        cmds["optimize"] = (["optimize", *big, "--target",
                             out("target.hdr"), "--steps", "2",
                             "--minibatch", "4096", "--spp", "1",
                             "--out-dir", out("opt")],
                            out("opt/loss_history.npy"))
        with ThreadPoolExecutor(len(cmds)) as pool:
            outs = dict(zip(cmds, pool.map(run, list(cmds))))
        hist = np.load(out("opt/loss_history.npy"))
        check(hist.shape == (2,) and bool(np.isfinite(hist).all()),
              f"cli optimize: loss history {hist}")
        bench = json.loads(outs["benchmark"].strip().splitlines()[-1])
        auto = read_hdr(out("auto.hdr"))
        shares = {}
        for be in ("jnp", "packed", "wide"):
            share, mean_rel = golden_share(read_hdr(out(f"{be}.hdr")), auto)
            shares[be] = share
            check(share >= 0.995, f"cli --backend {be}: {share:.4f} of "
                  f"pixels within the golden tolerance of the auto frame")
    total = time.perf_counter() - t0
    say("cli", t0, "python3 -m fluctus_tpu_torch.cli, rc 0 and an output "
        "each: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + f"; benchmark {bench['total_mrays_s']:.3f} MRays/s "
        f"({bench['integrator']}); optimize loss {hist[0]:.6f} -> "
        f"{hist[1]:.5f}; 64x64 frames within the golden tolerance of auto:"
        f" " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
        + f"; {total:.2f} s in all, on {card}")
    return {"secs": total, "commands": secs}


def phase_raster_formats() -> dict:
    """One 512x512 file of each of the raster formats PCX, DCX, QOI, SGI,
    MSP, XBM, DIB, PSD (RGB, RGBA, CMYK, Lab), Sun raster and the TIFF
    layouts planar, BigTIFF CMYK and float (fixtures.raster_bytes,
    psd_bytes, sun_raster_bytes, tiff_bytes; the card's machine has no
    PIL, so equality with PIL is the CPU tests' part) through the texture
    dispatch. Returns {format: decode seconds}."""
    from fluctus_tpu_torch import fixtures
    from fluctus_tpu_torch.scene import imageformat

    t0 = time.perf_counter()
    files = {f: fixtures.raster_bytes(f, 512, 512, seed=3)
             for f in fixtures.RASTER_FORMATS}
    files["psd"] = fixtures.psd_bytes("RGB", 512, 512, False, seed=3)
    files["psd-rle"] = fixtures.psd_bytes("RGBA", 512, 512, True, seed=3)
    files["psd-cmyk"] = fixtures.psd_bytes("CMYK", 512, 512, True, seed=3)
    files["psd-lab"] = fixtures.psd_bytes("LAB", 512, 512, False, seed=3)
    import numpy as np
    import zlib
    g = np.random.default_rng(3)
    px = g.integers(0, 256, (512, 512, 4)).astype(np.uint8)
    files["tiff-planar"] = fixtures.tiff_bytes(
        512, 512, 8, 3, 2, [zlib.compress(px[:, :, k].tobytes())
                            for k in range(3)], comp=8, planar=2)
    files["bigtiff-cmyk"] = fixtures.tiff_bytes(
        512, 512, 8, 4, 5, [px.tobytes()], bigtiff=True)
    files["tiff-float"] = fixtures.tiff_bytes(
        512, 512, 32, 1, 1, [(px[..., 0].astype(np.float32) * 1.5 - 20)
                             .tobytes()], fmt=[3])
    files["sun"] = fixtures.sun_raster_bytes(24, 512, 512, False, seed=3)
    files["sun-rle"] = fixtures.sun_raster_bytes(8, 512, 512, True, seed=3,
                                                 colors=256)
    secs = {}
    for name, data in files.items():
        t = time.perf_counter()
        rgba = imageformat.decode(data, imageformat.sniff(data))
        secs[name] = time.perf_counter() - t
        check(rgba.shape == (512, 512, 4) and rgba.std() > 0,
              f"the {name} texture did not decode")
    say("formats", t0, "512x512 decodes: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in secs.items()))
    return secs


# ------------------------------------------------------------ packet forest

PF_RAYS = 1 << 16      # rays of each forest call held against plain


def pforest_bound(chunks, n_rays, any_hit, stats):
    """Least time for one forest call (one launch a chunk): bytes (every
    chunk's real rows once, and each launch's rays in and hits out) over
    HBM bandwidth, or the slab and Moller tests that the rays' visits in
    all chunks need over the f32 instruction rate: (ms, what binds)."""
    import torch
    rows = 0
    for c in chunks:
        rows += int(torch.isfinite(c.nodes[:, 0:48:6]).any(-1).sum()) \
            * NODE_ROW_BYTES
        ids = c.leaves[..., 9].contiguous().view(torch.int32)
        rows += int((ids >= 0).any(-1).sum()) * c.leaf_width * 10 * 4
    io = len(chunks) * n_rays * (28 + (1 if any_hit else 16))
    ops = (stats["child_tests"] * OPS_PER_CHILD
           + stats["tri_tests"] * OPS_PER_TRI)
    return larger((rows + io) / HBM_BYTES_PER_S * 1e3,
                  ops / F32_INSTR_PER_S * 1e3)


def forest_stats(chunks, maps, rays, any_hit):
    """The plain walk's visit counts over the forest, with the t_max each
    chunk gets in the forest walk (bound_ms's stats)."""
    from fluctus_tpu_torch.ops import traverse_stack as ts
    st: dict = {}
    if any_hit:
        ts._forest_any(lambda wb, o, d, t: ts.traverse_plain(
            wb, o, d, t, True, stats=st)[1], chunks, *rays)
    else:
        ts._forest_closest(lambda wb, o, d, t: ts.traverse_plain(
            wb, o, d, t, False, stats=st)[0], chunks, maps, *rays)
    return st


def phase_pforest_check(sess, rays) -> dict:
    """K1's and K4's forest walks (one launch a chunk) against the same
    loops over their plain versions, both forms, on the conference's
    rays (K4's sorted as the integrator sorts them, by the whole scene's
    bounds); then the K1 forest's hits against K1 over the full
    hierarchy, which differ only where two triangles are hit at equal t
    (to T_REL_TOL). Returns ({kernel: (max abs t error, flag
    mismatches)}, {(kernel, form): plain ms of this one call}); K4's plain
    walk takes half a minute a call, so it runs once."""
    import torch
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts

    ch, maps, w = sess.scene.wforest, sess.scene.wforest_maps, sess.scene.wbvh
    o, d, t_c, o_s, d_s, t_s = rays
    walks = {
        "K1": (lambda *r: ts.traverse_closest_forest(ch, maps, *r),
               lambda *r: ts.closest_forest_plain(ch, maps, *r),
               lambda *r: ts.traverse_any_forest(ch, *r),
               lambda *r: ts.any_forest_plain(ch, *r), lambda *r: r),
        "K4": (lambda *r: tp.traverse_closest_forest(ch, maps, *r),
               lambda *r: tp.traverse_closest_forest(
                   ch, maps, *r, launch=tp.packet_plain),
               lambda *r: tp.traverse_any_forest(ch, *r),
               lambda *r: tp.traverse_any_forest(
                   ch, *r, launch=tp.packet_plain),
               lambda *r: sorted_by_ray_sort(w, *r))}
    out, plain_ms = {}, {}

    def timed(fn, *r):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(*r)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    for name, (kc_f, pc_f, ka_f, pa_f, order) in walks.items():
        t0 = time.perf_counter()
        rc, ra = order(o, d, t_c), order(o_s, d_s, t_s)
        kc, ka = kc_f(*rc), ka_f(*ra)
        pc, plain_ms[(name, "closest")] = timed(pc_f, *rc)
        pa, plain_ms[(name, "any")] = timed(pa_f, *ra)
        equal = all(bool(torch.equal(a, b)) for a, b in zip(kc, pc))
        flag_mis = int((ka != pa).sum())
        t_abs = float((kc.t - pc.t).abs().max())
        say("pforest-check", t0,
            f"{name} forest ({len(ch)} launches a call) vs the same loop "
            f"over its plain version: closest {rc[0].shape[0]} rays, "
            f"{int((kc.prim >= 0).sum())} hits, t/prim/u/v bit-equal "
            f"{equal}; any-hit {ra[0].shape[0]} rays, {int(ka.sum())} "
            f"blocked, flag mismatches {flag_mis}")
        check(equal, f"the {name} forest's closest hits differ from plain")
        check(flag_mis == 0, f"the {name} forest's flags differ from plain")
        out[name] = (t_abs, flag_mis)
    t0 = time.perf_counter()
    kc = ts.traverse_closest_forest(ch, maps, o, d, t_c)
    full = ts.traverse_kernel(w, o, d, t_c, any_hit=False)
    diff = kc.prim != full.prim
    ties = diff & (kc.t == full.t)
    near = diff & ~ties & ((kc.t - full.t).abs()
                           <= T_REL_TOL * full.t.abs())
    other = int((diff & ~ties & ~near).sum())
    same_hit = bool(torch.equal(kc.prim >= 0, full.prim >= 0))
    say("pforest-check", t0,
        f"K1 forest vs K1 over the full hierarchy, same {o.shape[0]} rays: "
        f"prim mismatches {other} outside ties, {int(ties.sum())} tie rays "
        f"at equal t, {int(near.sum())} at t within {T_REL_TOL} relative "
        f"(triangles sharing an edge, found through other boxes); the same "
        f"rays hit {same_hit}")
    check(other == 0 and same_hit,
          "the packet forest and the full hierarchy disagree")
    return out, plain_ms


def phase_pforest_time(sess, rays, plain_ms: dict) -> dict:
    """Per forest call on PF_RAYS rays: kernel ms (one launch a chunk),
    plain ms (pforest-check's call), and the bound (pforest_bound on the
    plain walk's counts of the same rays), closest and any-hit, for K1
    and for K4 (rays sorted). {(kernel, form): dict}."""
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch.timing import time_launches

    ch, maps, w = sess.scene.wforest, sess.scene.wforest_maps, sess.scene.wbvh
    o, d, t_c, o_s, d_s, t_s = rays
    out = {}
    for form, r in (("closest", (o, d, t_c)), ("any", (o_s, d_s, t_s))):
        anyh = form == "any"
        t0 = time.perf_counter()
        b_ms, b_by = pforest_bound(ch, r[0].shape[0], anyh,
                                   forest_stats(ch, maps, r, anyh))
        rs = sorted_by_ray_sort(w, *r)
        if anyh:
            runs = {"K1": lambda: ts.traverse_any_forest(ch, *r),
                    "K4": lambda: tp.traverse_any_forest(ch, *rs)}
        else:
            runs = {"K1": lambda: ts.traverse_closest_forest(ch, maps, *r),
                    "K4": lambda: tp.traverse_closest_forest(ch, maps, *rs)}
        for k, run_k in runs.items():
            ms = (time_launches(run_k, 5, 1) + time_launches(run_k, 5, 1)) / 2
            p_ms = plain_ms[(k, form)]
            out[(k, form)] = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by)
            say("pforest-time", t0,
                f"{k} forest {form}: {ms:.3f} ms per {r[0].shape[0]}-ray "
                f"call of {len(ch)} launches (plain {p_ms:.1f} ms), bound "
                f"{b_ms:.4f} ms by {b_by} on the plain walk's counts")
    return out


def phase_packet_forest(card: str) -> dict:
    """The conference under FLUCTUS_PACKET_FOREST=1: the session (SBVH
    hierarchy, 8-wide collapse and the packet forest of 4 MB chunks
    beside it, since its wide tables pass FOREST_TABLE_BYTES) with its
    set-up seconds by step; both forest walks held against their plain
    versions and the full hierarchy (pforest-check) and timed
    (pforest-time); the conference golden at 64x64 and the 512x512
    6-bounce 4 spp lockstep frame through the K1 forest ("auto") and the
    K4 forest ("pallas"), each through that kernel only, one launch a
    chunk. Returns the launches, the errors and the times."""
    import torch
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.scene import scene as scene_mod

    t0 = time.perf_counter()
    secs: dict = {}
    with env(FLUCTUS_PACKET_FOREST="1"), \
            timed_calls(driver, ("load_scene",), secs), \
            timed_calls(scene_mod.HostScene, ("build_bvh",), secs), \
            timed_calls(scene_mod, ("build_wide", "build_wide_forest",
                                    "pad_forest"), secs, sync=True):
        sess = driver.create_session(CONFERENCE, cfg=conference_cfg(512, 512),
                                     cache_dir=None, state_dir=STATES,
                                     auto_frame=False, device="cuda")
    t_sess = time.perf_counter() - t0
    s_ = sess.scene
    ch = s_.wforest
    check(len(ch) > 1 and s_.wbvh is not None and s_.bforest is None
          and s_.ftables is None, "the session holds no packet forest")
    check(all(c.root_ref == 0 for c in ch), "a forest chunk root is a leaf")
    mb = sum((c.nodes.numel() + c.leaves.numel()) * 4 for c in ch) / 1e6
    say("session-pforest", t0,
        f"conference {sess.host_scene.n_tris} tris under "
        f"FLUCTUS_PACKET_FOREST=1: session {t_sess:.2f} s (load "
        f"{secs['load_scene']:.2f}, SBVH build {secs['build_bvh']:.2f}, "
        f"8-wide collapse {secs['build_wide']:.2f}, forest build "
        f"{secs['build_wide_forest']:.2f}, forest pad + upload "
        f"{secs['pad_forest']:.2f}, the rest "
        f"{t_sess - sum(secs.values()):.2f} s); {len(ch)} chunks at "
        f"{scene_mod.FOREST_CHUNK_BYTES >> 20} MB, each padded to nodes "
        f"{tuple(ch[0].nodes.shape)}, leaves {tuple(ch[0].leaves.shape)} "
        f"({mb:.1f} MB), depths {[c.depth for c in ch]}; hierarchy nodes "
        f"{tuple(s_.wbvh.nodes.shape)}, depth {s_.wbvh.depth}")
    rays = brute_rays(sess, PF_RAYS, seed=11)
    err, plain_ms = phase_pforest_check(sess, rays)
    times = phase_pforest_time(sess, rays, plain_ms)
    del rays
    launches = {}
    for backend, kernel, mod in (("auto", "K1", ts), ("pallas", "K4", tp)):
        bs = dataclasses.replace(sess, cfg=sess.cfg.replace(backend=backend))
        phase_golden_only(dataclasses.replace(bs, cfg=bs.cfg.replace(
            width=64, height=64)), "conference", 4, kernel)
        t0 = time.perf_counter()
        with counted_calls(mod, ("traverse_closest_forest",
                                 "traverse_any_forest")) as calls:
            secs_f, mine = phase_frame_only(
                bs, 4, card, f"frame-pforest-{kernel.lower()}", kernel,
                f"conference, FLUCTUS_PACKET_FOREST=1, backend {backend},")
        per = {"closest": calls["traverse_closest_forest"] * len(ch),
               "any": calls["traverse_any_forest"] * len(ch)}
        say(f"frame-pforest-{kernel.lower()}", t0,
            f"{kernel} forest calls: {calls['traverse_closest_forest']} "
            f"closest, {calls['traverse_any_forest']} any-hit; launches "
            f"{mine} = one a chunk ({len(ch)} chunks)")
        check(mine == per, f"the {kernel} forest frame made other than one "
              "launch a chunk")
        launches[kernel] = mine
        launches[kernel + "_secs"] = secs_f
    torch.cuda.empty_cache()
    return {"launches": launches, "err": err, "times": times,
            "chunks": len(ch), "session": t_sess}


# ------------------------------------------------------------ parallel

PAR_SHARDS = 4
PAR_SPP = 8
PAR_SCALING_SPP = 2
PAR_GRAD_RAYS = 4096    # the grad-step cell's minibatch
PAR_POOL = 1024


def phase_parallel(esess, card: str, device: str = "cuda") -> dict:
    """parallel/ on a PAR_SHARDS-shard mesh over one device (the shards
    share it and run one after another): render_sharded and
    render_stream_sharded against the single-device lockstep.render and
    render_stream (rtol 1e-5 / atol 1e-6; the lockstep stripes should be
    bit-equal), the per-shard spawn counters, grad_step with the mesh
    against without and grad_step_stream against grad_step on kd and
    env_strength at the grad-step cell's minibatch, and scaling_benchmark
    at 1, 2 and 4 shards in both integrators. Returns K1's launches over
    the phase's sharded renders and steps, and the scaling records."""
    import numpy as np
    import torch
    from fluctus_tpu_torch.integrators import lockstep, wavefront
    from fluctus_tpu_torch.parallel import distributed, mesh as pmesh
    from fluctus_tpu_torch.render import optimize

    s_, p_, c_ = esess.scene, esess.params, esess.cfg
    dev = torch.device(device)
    m = pmesh.make_mesh([dev] * PAR_SHARDS)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    what = (f"{c_.width}x{c_.height}, {c_.max_bounces} bounces, {PAR_SPP} "
            f"spp, {PAR_SHARDS} shards sharing {device}")
    t0 = time.perf_counter()
    single = lockstep.render(s_, p_, c_, PAR_SPP)
    sync()
    t_single = time.perf_counter() - t0
    t1 = time.perf_counter()
    reset_counts()
    img = pmesh.render_sharded(s_, p_, c_, PAR_SPP, m)
    sync()
    k1 = launch_counts()["K1"]
    t_sh = time.perf_counter() - t1
    bit = bool(torch.equal(img, single))
    diff = float((img - single).abs().max())
    say("parallel", t0,
        f"luxball env-lit {what}: render_sharded {t_sh:.3f} s against "
        f"lockstep.render {t_single:.3f} s; bit-equal {bit}, max abs diff "
        f"{diff:.3e}, K1 {k1}")
    check(np.allclose(img.cpu().numpy(), single.cpu().numpy(), rtol=1e-5,
                      atol=1e-6), "render_sharded differs from render")
    t0 = time.perf_counter()
    ref, _ = wavefront.render_stream(s_, p_, c_, PAR_SPP)
    sync()
    t_single = time.perf_counter() - t0
    t1 = time.perf_counter()
    reset_counts()
    img, counters = pmesh.render_stream_sharded(s_, p_, c_, PAR_SPP, m)
    sync()
    k1s = launch_counts()["K1"]
    t_sh = time.perf_counter() - t1
    n_loc = -(-c_.width * c_.height // m.size)
    spawns = [int(x) for x in counters[:, 0]]
    diff = float((img - ref).abs().max())
    say("parallel", t0,
        f"render_stream_sharded {t_sh:.3f} s against render_stream "
        f"{t_single:.3f} s: max abs diff {diff:.3e}; per-shard [spawns, "
        f"extension, shadow] {counters.tolist()}, spawns sum {sum(spawns)} "
        f"(n_loc {n_loc} x {m.size} x {PAR_SPP} = "
        f"{n_loc * m.size * PAR_SPP}); K1 {k1s}")
    check(np.allclose(img.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5,
                      atol=1e-6), "render_stream_sharded differs")
    check(sum(spawns) == n_loc * m.size * PAR_SPP, "spawn counters")
    for f in k1:
        k1[f] += k1s[f]

    t0 = time.perf_counter()
    n_pix = c_.width * c_.height
    pix = optimize.stratified_pixels(n_pix, PAR_GRAD_RAYS, 0, dev)
    tgt = torch.full((pix.shape[0], 3), 0.1, device=dev)
    diff_p = {k: optimize._DIFF_GETTERS[k](s_, p_)
              for k in ("kd", "env_strength")}
    l1, n1 = pmesh.grad_step(diff_p, s_, p_, c_, pix, 0, tgt)
    reset_counts()
    l4, n4 = pmesh.grad_step(diff_p, s_, p_, c_, pix, 0, tgt, mesh=m)
    n_seg = wavefront.plan_stream_segments(
        s_, p_, c_, pix[:PAR_GRAD_RAYS // m.size], 0, PAR_POOL,
        deferred=True)[0] + 4
    ls, ns, nd = pmesh.grad_step_stream(diff_p, s_, p_, c_, pix, 0, tgt,
                                        PAR_POOL, n_seg, m)
    sync()
    kg = launch_counts()["K1"]
    for f in k1:
        k1[f] += kg[f]

    def worst(a, b):
        return max(float(((a[k] - b[k]).abs() / (1e-7 + b[k].abs())).max())
                   for k in a)
    say("parallel", t0,
        f"grad_step on {PAR_GRAD_RAYS} stratified rays (kd, env_strength): "
        f"loss {float(l1):.8f} without a mesh, {float(l4):.8f} with "
        f"({m.size} shards), leaves' max rel diff {worst(n4, n1):.3e}; "
        f"grad_step_stream ({n_seg} segments of a {PAR_POOL}-lane pool a "
        f"shard) loss {float(ls):.8f}, n_done {int(nd)}, leaves' max rel "
        f"diff against grad_step {worst(ns, n1):.3e}; K1 {kg}")
    check(abs(float(l4) - float(l1)) <= 1e-5 * abs(float(l1))
          and all(np.allclose(n4[k].cpu().numpy(), n1[k].cpu().numpy(),
                              rtol=1e-5, atol=1e-7) for k in n1),
          "grad_step with the mesh differs from without")
    check(int(nd) == PAR_GRAD_RAYS, "grad_step_stream left rays undrained")
    check(abs(float(ls) - float(l1)) <= 1e-5 * abs(float(l1))
          and all(np.allclose(ns[k].cpu().numpy(), n1[k].cpu().numpy(),
                              rtol=1e-4, atol=1e-7) for k in n1),
          "grad_step_stream differs from grad_step")

    scaling = {}
    for integ in ("lockstep", "stream"):
        t0 = time.perf_counter()
        rows = distributed.scaling_benchmark(
            s_, p_, c_, spp=PAR_SCALING_SPP, device_counts=[1, 2, 4],
            integrator=integ, devices=[dev] * 4)
        scaling[integ] = rows
        say("parallel-scaling", t0,
            f"{integ}, {PAR_SCALING_SPP} spp, shards sharing one {device} "
            f"(efficiency is no scaling figure): {json.dumps(rows)}")
        check([r["devices"] for r in rows] == [1, 2, 4]
              and all(r["mrays_s"] > 0 for r in rows), "scaling records")
    return {"k1": k1, "scaling": scaling}


PAR_RANKS = 2


def phase_parallel_ranks(env_path: str, card: str, device: str = "cuda:0",
                         size: int = 512, spp: int = 4) -> dict:
    """Two processes started by torch.multiprocessing, joined in a gloo
    group (NCCL refuses two ranks on one GPU), each holding one shard on
    `device`: the all-gathered render_sharded image and the all-reduced
    grad_step_stream (fixtures.rank_worker; gloo's collectives go through
    a host copy of just those tensors) against the same spec on a
    single-process 2-shard mesh: image bit-equal, loss and leaves within
    rtol 1e-6."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from fluctus_tpu_torch import fixtures
    from fluctus_tpu_torch.parallel import mesh as pmesh

    spec = {"device": device, "scene": LUXBALL, "env": env_path,
            "size": size, "max_bounces": 4, "aperture": 0.06, "spp": spp,
            "grad_rays": PAR_GRAD_RAYS, "leaves": ["kd", "env_strength"],
            "pool": PAR_POOL}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.spawn(fixtures.rank_worker, nprocs=PAR_RANKS, args=(
            PAR_RANKS, "file://" + os.path.join(tmp, "rendezvous"), out,
            spec))
        got = torch.load(out)
    t_ranks = time.perf_counter() - t0
    t1 = time.perf_counter()
    reset_counts()
    want = fixtures.sharded_run(fixtures.rank_session(spec), spec,
                                pmesh.make_mesh([device] * PAR_RANKS))
    k1 = launch_counts()["K1"]
    bit = bool(torch.equal(got["img"], want["img"]))
    rel = max(float(((got[k] - want[k]).abs()
                     / (1e-12 + want[k].abs())).max())
              for k in ("loss", "kd", "env_strength"))
    say("parallel-ranks", t0,
        f"{PAR_RANKS} ranks in a gloo group (NCCL refuses two ranks on one "
        f"GPU; each collective tensor staged through the host), one shard "
        f"each on {device}, luxball {size}x{size} {spp} spp: {t_ranks:.2f} "
        f"s with process start; the in-process {PAR_RANKS}-shard mesh "
        f"{time.perf_counter() - t1:.2f} s (K1 {k1}); image bit-equal "
        f"{bit}; loss {float(got['loss']):.8f} / {float(want['loss']):.8f}, "
        f"n_done {int(got['n_done'])}; max rel diff of loss and leaves "
        f"{rel:.3e}, on {card}")
    check(got["mesh_size"] == PAR_RANKS and bit, "the ranks' image differs "
          "from the in-process mesh's")
    check(all(np.allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6,
                          atol=0) for k in ("loss", "kd", "env_strength")),
          "the ranks' step differs from the in-process mesh's")
    return {"k1": k1, "secs": t_ranks}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import fluctus_tpu_torch   # noqa: F401  (fails outside the repository)
    from fluctus_tpu_torch.ops import probes
    from fluctus_tpu_torch.ops import traverse_brute as tb
    from fluctus_tpu_torch.ops import traverse_forest as tf
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts
    from fluctus_tpu_torch import launch
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.timing import card_line

    t0 = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say("device", t0, f"{card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    mods = (ts, tb, tf, tp, probes)
    with ThreadPoolExecutor(len(mods)) as pool:   # one nvcc per source
        for f in [pool.submit(m.load_kernel) for m in mods]:
            f.result()
    for name, info in (("K1", ts.BUILD_INFO), ("K2+K3", tb.BUILD_INFO),
                       ("K5", tf.BUILD_INFO), ("K4", tp.BUILD_INFO),
                       ("P1+P2", probes.BUILD_INFO)):
        regs = [ln.split(":", 1)[-1].strip()
                for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln]
        say("build", t0, f"{name} nvcc {' '.join(launch.NVCC_FLAGS)}: "
            f"{info['seconds']:.1f} s; " + " | ".join(regs))

    t0 = time.perf_counter()
    sess = driver.create_session(KITCHEN, cfg=kitchen_cfg(512, 512),
                                 state_dir=STATES, auto_frame=False,
                                 cache_dir=None, device="cuda")
    w = sess.scene.wbvh
    say("session", t0, f"kitchen: {sess.host_scene.n_tris} tris, wide "
        f"nodes {tuple(w.nodes.shape)}, leaves {tuple(w.leaves.shape)}, "
        f"depth {w.depth}, state {sess.host_scene.hash}")

    ktimes = phase_kernel(sess)
    phase_wide_ties("k1")
    design_steps("k1", sess, "k1-time")
    p1 = phase_p1(sess)
    p2 = phase_p2()

    t0 = time.perf_counter()
    small = dataclasses.replace(sess, cfg=sess.cfg.replace(width=64,
                                                          height=64))
    driver.render(small, 1, integrator="lockstep")
    torch.cuda.synchronize()
    say("warm-up", t0, "64x64 1 spp")

    secs, launches = phase_frame_only(sess, 16, card, "frame", "K1",
                                      "kitchen")
    gold = golden_sessions("cuda")
    for name, (gs, spp) in gold.items():
        phase_golden_only(gs, name, spp, "K1")

    # the streaming wavefront through K1 (fused extension + shadow calls)
    phase_stream_check(sess)
    secs_s, launches_s = phase_frame_stream(sess, 4, card)
    cpu_golden = golden_sessions("cpu")
    for name, (gs, spp) in gold.items():
        t0 = time.perf_counter()
        ref = driver.render(cpu_golden[name][0], spp,
                            integrator="stream").numpy()
        say("golden", t0, f"{name}: the stream on this host's CPU (plain "
            f"versions), the reference for the card's stream")
        phase_golden_stream(gs, name, spp, "K1", ref,
                            "the same stream on this host's CPU")
    del cpu_golden, gold
    bench = phase_bench(sess)

    # the packet path (K4): backend="pallas" on the same kitchen session
    k4_err = phase_packet_check(sess)
    phase_wide_ties("k4")
    ptimes = phase_packet_time(sess)
    design_steps("k4", sess, "k4-time")
    psess = dataclasses.replace(sess, cfg=sess.cfg.replace(backend="pallas"))
    t0 = time.perf_counter()
    driver.render(dataclasses.replace(psess, cfg=psess.cfg.replace(
        width=64, height=64)), 1, integrator="lockstep")
    torch.cuda.synchronize()
    say("warm-up", t0, "kitchen 64x64 1 spp, backend pallas")
    secs_p, launches_p = phase_frame_only(psess, 4, card, "frame-packet",
                                          "K4", "kitchen, backend pallas,")
    for name, (gs, spp) in golden_sessions("cuda", "pallas").items():
        phase_golden_only(gs, name, spp, "K4")
    # the auxiliary surfaces on the kitchen session: the denoiser's
    # buffers (K1, and K4 at 64x64), the denoised frame, picking
    aux = phase_aux(sess, card)
    den = phase_denoise(sess, card)
    secs_pick = phase_pick(sess, card)
    del sess, small, psess
    torch.cuda.empty_cache()

    # env-map lighting: the luxball (BASELINE config 2) under a seeded sky
    with tempfile.TemporaryDirectory() as tmp_dir:
        esess, env_path = phase_session_env(tmp_dir)
        t0 = time.perf_counter()
        driver.render(dataclasses.replace(esess, cfg=esess.cfg.replace(
            width=64, height=64)), 1, integrator="lockstep")
        torch.cuda.synchronize()
        say("warm-up", t0, "luxball 64x64 1 spp, env map")
        secs_e, _ = phase_frame_only(
            esess, 8, card, "frame-env", "K1", "luxball, env-lit,")
        secs_es, _ = phase_frame_stream(
            esess, 8, card, "frame-env-stream", "luxball, env-lit,")
        phase_golden_env(env_path, card)
        # gradients and the inverse-rendering loop (K1; K4 in grad-check)
        t_grad = time.perf_counter()
        grad_launches = phase_grad_check(env_path, card)
        k1_grad = phase_grad_step(esess, card)
        phase_optimize(esess, tmp_dir, card)
        secs_grad = time.perf_counter() - t_grad
        secs_prog = phase_progressive(esess, tmp_dir, card)
        # parallel/: a 4-shard mesh on the card, then two gloo ranks
        par = phase_parallel(esess, card)
        ranks = phase_parallel_ranks(env_path, card)
        del esess
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    big = driver.create_session(CONFERENCE, cfg=conference_cfg(512, 512),
                                cache_dir=None, state_dir=STATES,
                                auto_frame=False,
                                device="cuda")
    bf = big.scene.bforest
    check(bf is not None and big.scene.wbvh is None,
          "the conference session is not a brute-forest session")
    say("session-big", t0,
        f"conference: {big.host_scene.n_tris} tris, no hierarchy; brute "
        f"forest C={bf.tris.shape[0]} chunks, Tp={bf.tris.shape[2]}, "
        f"NTp={bf.tboxes.shape[2]}, tile {bf.tile}, Cp={bf.boxes_t.shape[1]}"
        f", {(bf.tris.numel() + bf.tboxes.numel()) * 4 / 1e6:.1f} MB; "
        f"session (load + forest + upload) {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    wbvh_full = full_hierarchy(big.host_scene)
    say("session-big", t0, f"full hierarchy for K1 (FLUCTUS_FAST_BIG=0, "
        f"SAH): nodes {tuple(wbvh_full.nodes.shape)}, leaves "
        f"{tuple(wbvh_full.leaves.shape)}, depth {wbvh_full.depth}")
    rays = brute_rays(big, 1 << 16, seed=11)
    err = {s_: phase_brute_check(bf, rays, s_) for s_ in ("vlist", "rounds")}
    phase_ties("vlist")
    phase_ties("rounds")
    btimes = {s_: phase_brute_time(bf, rays, s_, wbvh_full)
              for s_ in ("vlist", "rounds")}
    t0 = time.perf_counter()
    o, d, t_c = rays[:3]
    k1c = ts.traverse_kernel(wbvh_full, o, d, t_c, any_hit=False)
    k2c = tb.traverse_closest(bf, o, d, t_c)
    n_mis, n_ties, t_rel, _ = compare_closest(k2c, k1c)
    say("k1-vs-k2", t0, f"K2 vs K1 over the full hierarchy, same "
        f"{o.shape[0]} closest rays: prim mismatches {n_mis} (+{n_ties} "
        f"equal-t ties), max rel t err {t_rel:.3e}")
    check(n_mis == 0, "K2 and K1 disagree on the conference")

    t0 = time.perf_counter()
    driver.render(dataclasses.replace(big, cfg=big.cfg.replace(
        width=64, height=64)), 1, integrator="lockstep")
    torch.cuda.synchronize()
    say("warm-up", t0, "conference 64x64 1 spp")
    t0 = time.perf_counter()
    with counted_calls(tb, ("traverse_closest", "traverse_any")) as calls:
        secs_big, launches_big = phase_frame_only(big, 4, card, "frame-big",
                                                  "K2", "conference")
    k3 = btimes["rounds"]
    say("frame-big", t0,
        f"brute traversal calls: {calls['traverse_closest']} closest, "
        f"{calls['traverse_any']} any-hit; K3 (the round loop) at its "
        f"launches per k3-time call would make "
        f"{calls['traverse_closest'] * k3['closest']['launches_per_call']}"
        f" closest and "
        f"{calls['traverse_any'] * k3['any']['launches_per_call']} any-hit "
        f"launches here")
    launches_k3, gbig = phase_golden_big()
    t0 = time.perf_counter()
    k1_scene = dataclasses.replace(gbig.scene, wbvh=wbvh_full, bforest=None)
    ref = driver.render_stream(dataclasses.replace(gbig, scene=k1_scene),
                               4)[0]
    say("golden", t0, "conference: the stream through the fused K1 call "
        "over the full hierarchy, the reference for the fused K2 call")
    phase_golden_stream(gbig, "conference", 4, "K2", ref.cpu().numpy(),
                        "the same stream through K1 over the full "
                        "hierarchy")
    del wbvh_full, gbig, k1_scene
    torch.cuda.empty_cache()
    del big, bf
    torch.cuda.empty_cache()

    # the treelet path (K5): FLUCTUS_FOREST=treelet leaves the fast-big
    # path, so the session builds the SBVH hierarchy and the forest
    t0 = time.perf_counter()
    with env(FLUCTUS_FOREST="treelet"):
        tsess = driver.create_session(CONFERENCE,
                                      cfg=conference_cfg(512, 512),
                                      cache_dir=None, state_dir=STATES,
                                auto_frame=False,
                                      device="cuda")
    ft, tw = tsess.scene.ftables, tsess.scene.wbvh
    check(ft is not None and tw is not None and tsess.scene.bforest is None,
          "the treelet session holds no treelet forest")
    say("session-treelet", t0,
        f"conference under FLUCTUS_FOREST=treelet: session (load + SBVH "
        f"hierarchy + 8-wide collapse + treelet forest + upload) "
        f"{time.perf_counter() - t0:.2f} s; hierarchy nodes "
        f"{tuple(tw.nodes.shape)}, leaves {tuple(tw.leaves.shape)}, depth "
        f"{tw.depth}, {(tw.nodes.numel() + tw.leaves.numel()) * 4 / 1e6:.1f}"
        f" MB; forest C={ft.nodes.shape[0]} chunks, nodes "
        f"{tuple(ft.nodes.shape)}, leaves {tuple(ft.leaves.shape)}, lvl "
        f"{ft.lvl}, {(ft.nodes.numel() + ft.leaves.numel()) * 4 / 1e6:.1f} "
        f"MB")
    trays = brute_rays(tsess, 1 << 16, seed=11)
    k5_err = phase_forest_check(ft, tw, trays)
    ftimes = phase_forest_time(ft, tw, trays)
    t0 = time.perf_counter()
    driver.render(dataclasses.replace(tsess, cfg=tsess.cfg.replace(
        width=64, height=64)), 1, integrator="lockstep")
    torch.cuda.synchronize()
    say("warm-up", t0, "conference 64x64 1 spp, treelet forest")
    t0 = time.perf_counter()
    with counted_calls(tf, ("traverse_closest", "traverse_any")) as calls:
        secs_t, launches_t = phase_frame_only(
            tsess, 4, card, "frame-treelet", "K5",
            "conference, FLUCTUS_FOREST=treelet,")
    per_call = {"closest": calls["traverse_closest"],
                "any": calls["traverse_any"]}
    say("frame-treelet", t0, f"K5 traversal calls {per_call}, launches "
        f"{launches_t}: one launch per call")
    check(launches_t == per_call, "the treelet frame made other than one K5 "
          "launch per traversal call")
    phase_golden_only(dataclasses.replace(tsess, cfg=tsess.cfg.replace(
        width=64, height=64)), "conference", 4, "K5")
    del tsess, ft, tw
    torch.cuda.empty_cache()
    # the packet forest: K1 (auto) and K4 (pallas) one launch a chunk
    pf = phase_packet_forest(card)
    phase_deep_stack()
    cli = phase_cli(card)
    fmt = phase_formats(card)

    kernels = []
    for form, name in (("closest", "K1 traverse_stack closest"),
                       ("any", "K1 traverse_stack any-hit")):
        r = ktimes[form]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fluctus_tpu_torch/csrc/traverse_stack.cu",
            "replaces": "fluctus_tpu/ops/traverse_mxu.py:97",
            "launches": launches[form],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    for form, name in (("closest", "K1 traverse_stack closest, grad path"),
                       ("any", "K1 traverse_stack any-hit, grad path")):
        r = ktimes[form]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fluctus_tpu_torch/csrc/traverse_stack.cu",
            "replaces": "fluctus_tpu/ops/traverse_mxu.py:97",
            "launches": k1_grad[form],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    r = aux["timing"]
    kernels.append({
        "name": "K1 traverse_stack closest, aux path", "route": "cuda",
        "source": "fluctus_tpu_torch/csrc/traverse_stack.cu",
        "replaces": "fluctus_tpu/ops/traverse_mxu.py:97",
        "launches": aux["k1"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None})
    for sched, replaces, counts in (
            ("vlist", "fluctus_tpu/ops/traverse_brute.py:578", launches_big),
            ("rounds", "fluctus_tpu/ops/traverse_brute.py:70", launches_k3)):
        k = KERNEL_OF[sched]
        for form, label in (("closest", "closest"), ("any", "any-hit")):
            r = btimes[sched][form]
            t_abs, flag_mis = err[sched]
            kernels.append({
                "name": f"{k} traverse_brute {label}", "route": "cuda",
                "source": "fluctus_tpu_torch/csrc/traverse_brute.cu",
                "replaces": replaces,
                "launches": counts[form],
                "max_abs_err": t_abs if form == "closest"
                else float(flag_mis > 0),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None})
    for form, label in (("closest", "closest"), ("any", "any-hit")):
        r = ftimes[("queue", form)]
        t_abs, flag_mis = k5_err["queue"]
        kernels.append({
            "name": f"K5 traverse_forest {label}", "route": "cuda",
            "source": "fluctus_tpu_torch/csrc/traverse_forest.cu",
            "replaces": "fluctus_tpu/ops/traverse_forest.py:151",
            "launches": launches_t[form],
            "max_abs_err": t_abs if form == "closest"
            else float(flag_mis > 0),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    for form, label in (("closest", "closest"), ("any", "any-hit")):
        r = ptimes[form]
        t_abs, flag_mis = k4_err
        kernels.append({
            "name": f"K4 traverse_packet {label}", "route": "cuda",
            "source": "fluctus_tpu_torch/csrc/traverse_packet.cu",
            "replaces": "fluctus_tpu/ops/traverse_pallas.py:60",
            "launches": launches_p[form],
            "max_abs_err": t_abs if form == "closest"
            else float(flag_mis > 0),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    for kernel, source, replaces in (
            ("K1", "traverse_stack.cu", "fluctus_tpu/ops/traverse_mxu.py:97"),
            ("K4", "traverse_packet.cu",
             "fluctus_tpu/ops/traverse_pallas.py:60")):
        t_abs, flag_mis = pf["err"][kernel]
        for form, label in (("closest", "closest"), ("any", "any-hit")):
            r = pf["times"][(kernel, form)]
            kernels.append({
                "name": f"{kernel} {source[:-3]} {label}, packet forest "
                        f"(ms per call of {pf['chunks']} launches)",
                "route": "cuda", "source": f"fluctus_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": pf["launches"][kernel][form],
                "max_abs_err": t_abs if form == "closest"
                else float(flag_mis > 0),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None})
    for form, name in (("closest", "K1 traverse_stack closest, parallel path"),
                       ("any", "K1 traverse_stack any-hit, parallel path")):
        r = ktimes[form]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fluctus_tpu_torch/csrc/traverse_stack.cu",
            "replaces": "fluctus_tpu/ops/traverse_mxu.py:97",
            "launches": par["k1"][form] + ranks["k1"][form],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    for key, replaces in (("p1_1_block", "scripts/probe_pallas_floor.py:55"),
                          ("p1_64_blocks",
                           "scripts/probe_pallas_floor.py:65")):
        r = p1[key]
        kernels.append({
            "name": f"P1 probes copy_plus_one, {key[3:].replace('_', ' ')}",
            "route": "cuda", "source": "fluctus_tpu_torch/csrc/probes.cu",
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            # the plain version is one PyTorch call, x + 1.0
            "library_ms": r["plain_ms"]})
    for fused in (True, False):
        r = p2[fused]
        kernels.append({
            "name": f"P2 probes fma_chain {'fused' if fused else 'unfused'}",
            "route": "cuda", "source": "fluctus_tpu_torch/csrc/probes.cu",
            "replaces": "scripts/measure_mfu.py:37",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "operations",
            "library_ms": None})
    print(f"[total] {time.perf_counter() - _T0:8.2f}s  kitchen frame "
          f"{secs:.3f} s, kitchen stream frame {secs_s:.3f} s (bench: "
          f"lockstep {bench['lockstep']['total_mrays_s']:.3f}, stream "
          f"{bench['stream']['total_mrays_s']:.3f} MRays/s), kitchen "
          f"packet frame {secs_p:.3f} s, conference "
          f"frame {secs_big:.3f} s (brute), {secs_t:.3f} s (treelet), "
          f"luxball env-lit frame {secs_e:.3f} s lockstep, {secs_es:.3f} s "
          f"stream; gradients (grad-check, grad-step, optimize) "
          f"{secs_grad:.2f} s (grad-check forward launches "
          f"{grad_launches['luxball_env']}); PLY session {fmt['ply_secs']['session']:.2f} s (load "
          f"{fmt['ply_secs']['load_ply']:.2f}, hash "
          f"{fmt['ply_secs']['file_hash']:.2f}, brute forest "
          f"{fmt['ply_secs']['build_brute_forest']:.2f}), PLY frame "
          f"{fmt['frame_ply'][0]:.3f} s (K2 {fmt['frame_ply'][1]}), PBRT "
          f"session {fmt['pbrt_secs']['parse_session']:.2f} s, PBRT frame "
          f"{fmt['frame_pbrt'][0]:.3f} s (K1 {fmt['frame_pbrt'][1]}), "
          f"conference cold / warm {fmt['cache_secs']['cold']:.2f} / "
          f"{fmt['cache_secs']['warm']:.2f} s, NumPy SAH kitchen session "
          f"{fmt['native_off_secs']:.2f} s, BC7 2048x2048 decode "
          f"{fmt['dds_secs']:.3f} s, 512x512 raster decodes "
          f"{sum(fmt['raster_secs'].values()):.3f} s; kitchen render_aux "
          f"{aux['secs']:.3f} s (K1 {aux['k1']}), denoised frame render "
          f"{den['render']:.3f} + aux {den['aux']:.3f} + denoise "
          f"{den['denoise']:.3f} s, progressive {secs_prog:.2f} s, pick "
          f"{secs_pick:.3f} s, cli {cli['secs']:.2f} s; packet forest "
          f"session {pf['session']:.2f} s, frames "
          f"{pf['launches']['K1_secs']:.3f} s (K1) / "
          f"{pf['launches']['K4_secs']:.3f} s (K4) over "
          f"{pf['chunks']} chunks; parallel ranks {ranks['secs']:.2f} s on "
          f"{card}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
