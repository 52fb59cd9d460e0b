"""Where a frame's time goes on the card.

    python3 -m fluctus_tpu_torch.render.profile [--scene PATH]
        [--bounces N] [--spp N] [--frames N] [--backend auto|pallas]
        [--integrator lockstep|stream] [--env-sky SEED]

Traces, with torch.profiler, one piece of a 512x512 frame (area light, the
scene's saved state; the kitchen at 8 bounces by default; with --env-sky,
the env-lit luxball frame of chip_smoke.py instead: the seeded 1024x512
sky of fluctus_tpu_torch/fixtures.py, no area light, the framing of
create_session, thin-lens aperture 0.06): under the
lockstep integrator one 65,536-ray tile at 1 spp, under the stream one
deferred segment of the driver's pool (2^14 lanes) after 8 warm segments,
with a spawn budget of 64 spp so the pool stays full. It prints the
device time by kernel, the device-busy share of the traced wall time, and
the traversal kernels' share (K1; K2/K3 on a scene above the fast-big
cutover; K5 under FLUCTUS_FOREST=treelet; K4 under --backend pallas); then
times N whole frames at --spp through the same integrator to show the
spread. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


TRAVERSAL_KERNELS = ("traverse_kernel", "k2_kernel", "k3_kernel",
                     "forest_kernel", "queue_kernel", "packet_kernel")


def _session(scene: str, bounces: int, backend: str, env_sky=None):
    import dataclasses
    import tempfile

    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver
    if env_sky is None:
        cfg = RenderConfig(width=512, height=512, max_bounces=bounces,
                           use_area_light=True, use_env_map=False,
                           backend=backend)
        return driver.create_session(
            scene, cfg=cfg, state_dir=os.path.join(REPO, "data", "states"),
            auto_frame=False, device="cuda")
    from fluctus_tpu_torch.fixtures import sky_env
    from fluctus_tpu_torch.io.hdr import write_hdr
    cfg = RenderConfig(width=512, height=512, max_bounces=bounces,
                       use_area_light=False, backend=backend)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sky.hdr")
        write_hdr(path, sky_env(1024, 512, seed=env_sky))
        sess = driver.create_session(scene, path, cfg, state_dir=None,
                                     device="cuda")
    cam = dataclasses.replace(sess.params.camera, aperture_size=torch.tensor(
        0.06, device="cuda"))
    return dataclasses.replace(sess, params=dataclasses.replace(
        sess.params, camera=cam))


def _modules():
    from fluctus_tpu_torch.ops import (traverse_brute, traverse_forest,
                                       traverse_pallas, traverse_stack)
    return {"k1": traverse_stack, "": traverse_brute,
            "k5": traverse_forest, "k4": traverse_pallas}


def _launch_counts() -> dict:
    counts = {}
    for prefix, m in _modules().items():
        counts.update({f"{prefix}_{k}" if prefix else k: v
                       for k, v in m.LAUNCHES.items()})
    return {k: v for k, v in counts.items() if v}


def _tile_step(sess):
    """A warm-up and a traced call: one lockstep tile-sample."""
    from fluctus_tpu_torch.integrators import lockstep

    idx = torch.arange(1 << 16, dtype=torch.int32, device="cuda")
    lockstep.sample_radiance(sess.scene, sess.params, sess.cfg, idx, 0)
    title = (f"tile 65536 rays, 1 spp, {sess.cfg.max_bounces} bounces")
    return title, lambda: lockstep.sample_radiance(
        sess.scene, sess.params, sess.cfg, idx, 1)


def _segment_step(sess, spp: int = 64, warm: int = 8):
    """A warm-up and a traced call: one deferred stream segment of the
    driver's pool, after `warm` segments."""
    from fluctus_tpu_torch.integrators import wavefront as wf
    from fluctus_tpu_torch.render.driver import stream_pool

    cfg = sess.cfg.replace(pool_size=stream_pool(sess.cfg))
    pool = cfg.pool_size
    state, counters = wf.init_stream_state(sess.params, cfg, pool)
    carry = [state, counters, wf._pend_init(pool, "cuda"),
             torch.full((pool,), -1, dtype=torch.int64, device="cuda"),
             torch.zeros((pool, 3), device="cuda")]

    def step():
        carry[:] = wf._stream_segment_d(sess.scene, sess.params, cfg,
                                        *carry[:2], spp, *carry[2:])[:5]
    for _ in range(warm):
        step()
    title = (f"stream segment, pool {pool}, {sess.cfg.max_bounces} bounces, "
             f"after {warm} segments")
    return title, step


def profile_step(sess, integrator: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    title, step = (_segment_step(sess) if integrator == "stream"
                   else _tile_step(sess))
    torch.cuda.synchronize()
    for m in _modules().values():
        m.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    by_name: dict = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    trav_us = sum(us for name, (us, _) in by_name.items()
                  if any(k in name for k in TRAVERSAL_KERNELS))
    print(f"{title}: wall {wall * 1e3:.1f} ms (profiled), traversal "
          f"launches "
          f"{_launch_counts()}")
    print(f"device kernels: {len(kernels)} launches, busy "
          f"{busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall * 100:.1f}% of "
          f"wall; traversal kernels {trav_us / 1e3:.2f} ms = "
          f"{trav_us / max(busy_us, 1) * 100:.1f}% of device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"  {us / 1e3:9.2f} ms  {n:6d}x  {name[:100]}")


def time_frames(sess, n: int, spp: int, integrator: str) -> None:
    from fluctus_tpu_torch.render import driver
    for i in range(n):
        t0 = time.perf_counter()
        driver.render(sess, spp, integrator=integrator)
        torch.cuda.synchronize()
        print(f"frame {i}: 512x512 {spp} spp, {integrator}: "
              f"{time.perf_counter() - t0:.3f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=os.path.join(
        REPO, "assets", "kitchen_proxy.obj"))
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--backend", default="auto", choices=("auto", "pallas"))
    ap.add_argument("--integrator", default="lockstep",
                    choices=("lockstep", "stream"))
    ap.add_argument("--env-sky", type=int, default=None, metavar="SEED",
                    help="env-lit luxball frame under the seeded sky "
                    "(the scene defaults to assets/luxball_proxy.obj)")
    args = ap.parse_args()
    if args.env_sky is not None and args.scene == ap.get_default("scene"):
        args.scene = os.path.join(REPO, "assets", "luxball_proxy.obj")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from fluctus_tpu_torch.timing import card_line
    print(f"card: {card_line()} | torch {torch.__version__}")
    sess = _session(args.scene, args.bounces, args.backend, args.env_sky)
    sc = sess.scene
    tables = ("brute forest" if sc.bforest is not None else
              "BVH8 + treelet forest" if sc.ftables is not None else "BVH8")
    print(f"scene {os.path.basename(args.scene)}: "
          f"{sess.host_scene.n_tris} tris, {tables}, backend "
          f"{sess.cfg.backend}, env map {sess.cfg.use_env_map}")
    profile_step(sess, args.integrator)
    time_frames(sess, args.frames, args.spp, args.integrator)


if __name__ == "__main__":
    main()
