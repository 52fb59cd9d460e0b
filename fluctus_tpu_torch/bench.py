"""The port's benchmark: one JSON line with the headline metric.

    python3 -m fluctus_tpu_torch.bench

The protocol of the repository's `bench.py`: the full 512x512 frame, 4
bounces, next-event estimation with MIS, exactly 16 spp through the
streaming wavefront (`render_stream(deferred=True, segments_per_launch=32)`,
pool min(pool_size, 2^14)); one warm-up frame whose sum must be positive,
then the fastest of 6 timed frames, each ending in a host read of the
image sum. It reports total MRays/s with the reference protocol's analytic
ray accounting (src/clcontext.cpp:648-656), the rays the stream's queues
really traced (src/tracer.cpp:333-345) over the same time, and Msamples/s.

`bench.py` renders teapot.ply under the night.hdr env map; neither file
is in the repository, so this renders the in-repository kitchen
(`assets/kitchen_proxy.obj`, 25,672 triangles) with its saved camera and
ceiling area light. The port renders env maps too; the kitchen stays the
scene so that the metric keeps its meaning from one measurement to the
next. Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITCHEN = os.path.join(REPO, "assets", "kitchen_proxy.obj")
STATES = os.path.join(REPO, "data", "states")
SPP = 16
FRAMES = 6


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fluctus_tpu_torch.bench needs a CUDA card")
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.integrators import wavefront
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.render.benchmark import ray_counts_per_sample

    cfg = RenderConfig(width=512, height=512, max_bounces=4,
                       use_area_light=True, use_env_map=False,
                       tile_size=1 << 16)
    sess = driver.create_session(KITCHEN, cfg=cfg, state_dir=STATES,
                                 auto_frame=False, device="cuda")
    scfg = sess.cfg.replace(pool_size=min(sess.cfg.pool_size, 1 << 14))

    def frame():
        img, counters = wavefront.render_stream(sess.scene, sess.params,
                                                scfg, SPP,
                                                segments_per_launch=32,
                                                deferred=True)
        return float(img.sum()), counters

    warm, counters = frame()
    if not warm > 0.0:
        raise RuntimeError(f"warm-up frame summed to {warm}")
    # the queues' populations are the same every frame (fixed RNG keys)
    actual_rays = float(counters.double().sum())
    dt = min(_timed(frame) for _ in range(FRAMES))

    n_samples = cfg.width * cfg.height * SPP
    primary, ext, shadow = ray_counts_per_sample(sess.cfg, n_samples)
    print(json.dumps({
        "metric": "kitchen_512x512_16spp_b4_total_mrays_per_s",
        "value": round((primary + ext + shadow) / dt / 1e6, 3),
        "unit": "MRays/s",
        "vs_baseline": 1.0,
        "accounting": "analytic lockstep-equivalent (reference protocol "
                      "formula, src/clcontext.cpp:648-656)",
        "actual_queue_mrays_per_s": round(actual_rays / dt / 1e6, 3),
        "actual_queue_accounting": "rays actually traced by the stream "
                                   "renderer's queues (src/tracer.cpp:"
                                   "333-345 equivalent)",
        "samples_per_s_m": round(n_samples / dt / 1e6, 3),
        "frame_s": dt,
        "device": torch.cuda.get_device_name(0),
    }), flush=True)


if __name__ == "__main__":
    main()
