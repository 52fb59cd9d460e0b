"""Benchmark harness of the reference's measurement protocol (counterpart
of `fluctus_tpu/render/benchmark.py`; reference: Tracer::runBenchmark,
src/tracer.cpp:362-528): timed rendering with a stat row per step, the CSV
schema `scene;time;primary;extension;shadow;total;samples` and an averaged
summary. Rays are counted as the reference's queues count them: primary =
camera rays, extension = every bounce ray including the primary ones,
shadow = next-event rays.

Every timed step ends in a host read of its result, which waits for the
device (the JAX package fetches a value for the same reason).
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from fluctus_tpu_torch.integrators import lockstep

CSV_HEADER = "scene;time;primary;extension;shadow;total;samples"


def ray_counts_per_sample(cfg, n_pix):
    """Analytic rays per sample of the lockstep integrator: every lane runs
    every bounce; extension rays include the primary ones, as the
    reference's queue counts do. Returns (primary, extension, shadow)."""
    bounces = cfg.max_bounces + 1
    n_lights = (1 if cfg.use_env_map else 0) + (1 if cfg.use_area_light
                                               else 0)
    shadow = n_pix * bounces * (n_lights if cfg.sample_expl else 0)
    return n_pix, n_pix * bounces, shadow


def run_benchmark(session, duration_s: float = 30.0, scene_name: str = "",
                  csv_path: str | None = None, spp_per_iter: int = 4):
    """Lockstep: render tiles of `spp_per_iter` samples for `duration_s`,
    one stat row per tile, with the analytic ray counts. Returns the
    result dict; with `csv_path`, writes the reference-schema CSV."""
    cfg = session.cfg
    scene, params = session.scene, session.params
    dev = session.device
    n_pix = cfg.width * cfg.height
    tile = min(cfg.tile_size, n_pix)
    primary_c, ext_c, shadow_c = ray_counts_per_sample(cfg, tile)
    if spp_per_iter < 4:
        warnings.warn(
            f"run_benchmark: spp_per_iter={spp_per_iter} raised to 4; "
            "smaller steps measure per-call overhead", stacklevel=2)
        spp_per_iter = 4

    def step(idx, s):
        out = lockstep._render_tile_spp(scene, params, cfg, idx, s,
                                        spp_per_iter)
        float(out[0, 0])       # host read: waits for the device

    tiles = [torch.arange(st, min(st + tile, n_pix), dtype=torch.int32,
                          device=dev) for st in range(0, n_pix, tile)]
    step(tiles[0], 0)          # warm-up
    rows = []
    samples_done = 0.0
    t0 = time.perf_counter()
    t_last = t0
    s = 0
    while time.perf_counter() - t0 < duration_s:
        for idx in tiles:
            step(idx, s)
            now = time.perf_counter()
            dt = now - t_last
            t_last = now
            k = spp_per_iter * idx.shape[0] / tile   # last tile may be short
            rows.append((scene_name, now - t0, k * primary_c / dt / 1e6,
                         k * ext_c / dt / 1e6, k * shadow_c / dt / 1e6,
                         k * (primary_c + ext_c + shadow_c) / dt / 1e6,
                         spp_per_iter * idx.shape[0] / dt / 1e6))
            samples_done += k * idx.shape[0]
        s += spp_per_iter

    wall = time.perf_counter() - t0
    primary, ext, shadow = ray_counts_per_sample(cfg, samples_done)
    result = {
        "scene": scene_name,
        "wall_s": wall,
        "samples_per_pixel": samples_done / n_pix,
        "primary_mrays_s": primary / wall / 1e6,
        "extension_mrays_s": ext / wall / 1e6,
        "shadow_mrays_s": shadow / wall / 1e6,
        "total_mrays_s": (primary + ext + shadow) / wall / 1e6,
        "samples_mrays_s": samples_done / wall / 1e6,
    }
    if csv_path:
        _write_csv(csv_path, rows)
    return result


def _write_csv(csv_path, rows):
    with open(csv_path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for r in rows:
            f.write(f"{r[0]};{r[1]:.2f};{r[2]:.2f};{r[3]:.2f};"
                    f"{r[4]:.2f};{r[5]:.2f};{r[6]:.2f}\n")


def summary_line(result: dict) -> str:
    """The reference's averaged one-line report (src/tracer.cpp:503)."""
    return (f"{result['scene']}: "
            f"{result['primary_mrays_s']:.1f}M primary, "
            f"{result['extension_mrays_s']:.2f}M extension, "
            f"{result['shadow_mrays_s']:.2f}M shadow, "
            f"{result['samples_mrays_s']:.2f}M samples, "
            f"total: {result['total_mrays_s']:.2f}M rays/s")


def write_txt_report(txt_path: str, results: list[dict]):
    """Averaged txt report, one summary line per run (reference:
    simpleReport, src/tracer.cpp:500-527)."""
    with open(txt_path, "w") as f:
        for r in results:
            f.write(summary_line(r) + "\n")


def run_benchmark_stream(session, duration_s: float = 30.0,
                         scene_name: str = "", csv_path: str | None = None,
                         spp_per_frame: int = 4):
    """Streaming wavefront: render whole frames of `spp_per_frame` for
    `duration_s`, one stat row per frame, counting the rays the stream's
    queues really traced (primary = spawns, extension and shadow = live
    lanes per segment; reference: src/tracer.cpp:333-345). The stream ends
    paths early, so it traces far fewer rays than the lockstep count."""
    from fluctus_tpu_torch.render.driver import render_stream

    n_pix = session.cfg.width * session.cfg.height

    def frame():
        _, counters = render_stream(session, spp_per_frame)
        return counters.cpu().numpy().astype(np.float64)

    frame()   # warm-up
    rows = []
    tot = np.zeros(3)
    samples_done = 0
    t0 = time.perf_counter()
    t_last = t0
    while time.perf_counter() - t0 < duration_s:
        c = frame()
        now = time.perf_counter()
        dt = now - t_last
        t_last = now
        spawns, ext, shadow = c
        tot += c
        samples_done += n_pix * spp_per_frame
        rows.append((scene_name, now - t0, spawns / dt / 1e6,
                     ext / dt / 1e6, shadow / dt / 1e6,
                     (spawns + ext + shadow) / dt / 1e6,
                     n_pix * spp_per_frame / dt / 1e6))
    wall = time.perf_counter() - t0
    result = {
        "scene": scene_name,
        "wall_s": wall,
        "samples_per_pixel": samples_done / n_pix,
        "primary_mrays_s": tot[0] / wall / 1e6,
        "extension_mrays_s": tot[1] / wall / 1e6,
        "shadow_mrays_s": tot[2] / wall / 1e6,
        "total_mrays_s": tot.sum() / wall / 1e6,
        "samples_mrays_s": samples_done / wall / 1e6,
    }
    if csv_path:
        _write_csv(csv_path, rows)
    return result
