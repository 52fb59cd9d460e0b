"""Reference-protocol benchmark sweep (counterpart of
scripts/run_protocol.py): for each scene of `SCENES`, both integrators
for --duration seconds at SIZE x SIZE (reference: 30 s at 1024x1024,
src/tracer.cpp:362-528), reference-schema CSVs, and whether the
openness probe's pick (`driver.choose_integrator`) ties or beats the
better integrator by samples/s. The cross-integrator metric is samples/s:
the lockstep's MRays/s counts the analytic bound, the stream's its queues.

    python3 -m fluctus_tpu_torch.scripts.run_protocol [--duration 12] \
        [--device cuda|cpu]

Run it from the repository root: it writes
out/protocol_<scene>_<integrator>.csv, out/protocol_summary.json (the JAX
script's keys) and out/protocol_summary.txt (the reference's averaged
report), reads the saved cameras and lights from data/states and caches
hierarchies in data/hierarchies. The reference project's assets are
looked for inside the checkout, in reference/assets (ignored by git);
scenes whose files are absent are printed as skipped, so a bare checkout
runs the kitchen (K1) and the conference (above the fast-big cutover on
a card: K2) wherever it sits.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ASSETS = os.path.join(REPO, "reference", "assets")
SIZE = 1024
TIE = 0.05
# (name, path, env_map, use_area_light, max_bounces), the JAX script's list
SCENES = [
    ("egyptcat", f"{ASSETS}/egyptcat/egyptcat.obj",
     f"{ASSETS}/env_maps/night.hdr", False, 4),
    ("psor-cube", f"{ASSETS}/psor/psor-cube.obj", None, False, 4),
    ("gold_rings", f"{ASSETS}/gold_rings/gold_rings_bark.obj", None,
     False, 4),
    ("teapot", f"{ASSETS}/teapot.ply", f"{ASSETS}/env_maps/night.hdr",
     False, 4),
    # config-3 stand-in: a closed textured interior, camera and ceiling
    # light from data/states (src/tracer.cpp:384-389)
    ("kitchen", f"{REPO}/assets/kitchen_proxy.obj", None, True, 8),
    # conference-class stand-in, camera and light from data/states
    ("conference", f"{REPO}/assets/conference_proxy.obj", None, True, 6),
]


def verdict(rows: dict, auto_pick: str) -> tuple[str, bool, bool]:
    """(winner by samples/s, tie, auto correct): within 5 % the two
    integrators are equal to measurement noise, and either pick is
    right."""
    winner = max(rows, key=lambda k: rows[k]["samples_mrays_s"])
    vals = [rows[k]["samples_mrays_s"] for k in rows]
    tie = (max(vals) - min(vals)) <= TIE * max(vals)
    return winner, tie, tie or auto_pick == winner


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.render.benchmark import (run_benchmark,
                                                    run_benchmark_stream,
                                                    write_txt_report)
    os.makedirs("out", exist_ok=True)
    summary, txt_results = [], []
    for name, path, env, area, mb in SCENES:
        if not os.path.exists(path):
            print(f"skip {name}: {path} missing")
            continue
        cfg = RenderConfig(width=SIZE, height=SIZE, max_bounces=mb,
                           use_env_map=env is not None, use_area_light=area)
        sess = driver.create_session(
            path, env, cfg=cfg, use_sbvh=True, cache_dir="data/hierarchies",
            auto_frame=not area, state_dir="data/states" if area else None,
            device=args.device)
        auto_pick = driver.choose_integrator(sess)
        rows = {}
        for integ, fn in (("lockstep", run_benchmark),
                          ("stream", run_benchmark_stream)):
            r = fn(sess, duration_s=args.duration, scene_name=name,
                   csv_path=f"out/protocol_{name}_{integ}.csv")
            rows[integ] = r
            txt_results.append({**r, "scene": f"{name} [{integ}]"})
            print(f"{name:10s} {integ:8s}: "
                  f"{r['total_mrays_s']:7.2f} MRays/s, "
                  f"{r['samples_mrays_s']:6.2f} Msamples/s, "
                  f"{r['samples_per_pixel']:.1f} spp", flush=True)
        winner, tie, ok = verdict(rows, auto_pick)
        print(f"{name:10s} auto picked {auto_pick}; winner by samples/s: "
              f"{winner}{' (tie)' if tie else ''} -> "
              f"{'OK' if ok else 'MISS'}", flush=True)
        summary.append({
            "scene": name, "auto": auto_pick, "winner": winner,
            "auto_correct": ok,
            "lockstep_mrays_s": round(rows["lockstep"]["total_mrays_s"], 2),
            "stream_mrays_s": round(rows["stream"]["total_mrays_s"], 2),
            "lockstep_msamples_s":
                round(rows["lockstep"]["samples_mrays_s"], 3),
            "stream_msamples_s": round(rows["stream"]["samples_mrays_s"], 3),
        })
    with open("out/protocol_summary.json", "w") as f:
        json.dump(summary, f, indent=1)
    write_txt_report("out/protocol_summary.txt", txt_results)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
