"""Process-group set-up and the scaling benchmark (counterpart of
`fluctus_tpu/parallel/distributed.py`).

One process per card under NCCL (or per CPU under gloo), joined by
`torch.distributed`; `parallel/mesh.py` then spans the ranks, with the
pixels split into one stripe per shard and the only traffic between
ranks being the image gather and the gradient all-reduce. With one
process everything here runs on that process's shards alone.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from fluctus_tpu_torch.parallel import mesh as pmesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               backend: str | None = None) -> None:
    """Join the process group of `num_processes` ranks as `process_id`
    (torch.distributed.init_process_group); a no-op for one process.
    `coordinator_address` is "host:port" (TCP) or an init URL such as
    "file:///path". The backend follows `device`: NCCL for "cuda" (one
    rank per card: the rank's card becomes the current device), gloo for
    "cpu"; `backend` overrides it (gloo for several ranks on one card,
    which NCCL refuses)."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need a coordinator address and "
                         "a process id")
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _sync(mesh) -> None:
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def scaling_benchmark(scene, params, cfg, spp: int = 1, device_counts=None,
                      integrator: str = "lockstep",
                      devices=None) -> list[dict]:
    """Rays per second on meshes of growing shard count, one record per
    count: devices (shards), wall_s, mrays_s, efficiency (the rate over
    the 1-count rate times the count) and shard_ray_balance (the least
    over the most rays of a shard). The meshes take the first n of
    `devices` (default: make_mesh()'s; a device may repeat, so shards can
    share one card, and then efficiency measures no scaling).
    integrator "lockstep" (render_sharded, rays counted analytically) or
    "stream" (render_stream_sharded, the actual per-shard queue
    counters). Before timing, asserts that the ray axis is partitioned:
    every shard's stripe has the padded frame over the shard count."""
    devices = list(devices if devices is not None
                   else pmesh.make_mesh().devices)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= len(devices)]
    n_pix = cfg.width * cfg.height
    bounces = cfg.max_bounces + 1
    n_lights = int(cfg.use_env_map) + int(cfg.use_area_light)
    rays_per_sample = n_pix * bounces * (1 + (n_lights if cfg.sample_expl
                                              else 0))
    results = []
    base_rate = None
    for n in device_counts:
        m = pmesh.make_mesh(devices[:n])
        # a silently replicated layout would still report efficiency ~1,
        # since the lockstep's ray count is analytic
        pad = (-n_pix) % m.size
        spans = [pmesh.stripe(n_pix, m, d) for d in range(m.size)]
        sizes = {b - a for a, b in spans}
        assert sizes == {(n_pix + pad) // m.size} and all(
            spans[d][0] == spans[d - 1][1] for d in range(1, m.size)), (
            f"ray axis not partitioned over {m.size} shards: stripes "
            f"{spans}")
        if integrator == "stream":
            pmesh.render_stream_sharded(scene, params, cfg, spp, m)  # warm
            _sync(m)
            t0 = time.perf_counter()
            _, c = pmesh.render_stream_sharded(scene, params, cfg, spp, m)
            _sync(m)
            dt = time.perf_counter() - t0
            c = c.cpu().numpy().astype(np.float64)
            n_rays = float(c.sum())
            per_shard = c.sum(axis=1)
            balance = (float(per_shard.min() / per_shard.max())
                       if per_shard.max() > 0 else 1.0)
        else:
            pmesh.render_sharded(scene, params, cfg, 1, m)          # warm
            _sync(m)
            t0 = time.perf_counter()
            pmesh.render_sharded(scene, params, cfg, spp, m)
            _sync(m)
            dt = time.perf_counter() - t0
            n_rays = rays_per_sample * spp
            balance = 1.0
        rate = n_rays / dt
        if base_rate is None:
            base_rate = rate
        results.append({"devices": m.size, "wall_s": dt,
                        "mrays_s": rate / 1e6,
                        "efficiency": rate / (base_rate * n),
                        "shard_ray_balance": balance})
    return results
