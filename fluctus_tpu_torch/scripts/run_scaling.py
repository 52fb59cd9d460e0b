"""Scaling protocol: parallel/distributed.py::scaling_benchmark over
meshes of 1, 2, 4, ... shards for both integrators, written as one JSON
file (counterpart of scripts/run_scaling.py).

    python3 -m fluctus_tpu_torch.scripts.run_scaling --shards 4 \
        --out out/scaling.json [--device cuda|cpu] [--size 128] [--spp 2]

Shards go on distinct cards while there are enough of them, else they
repeat the one device (`--device cpu` repeats the CPU): such shards share
one device and run one after another, so the records check the stripes,
the per-shard pools and the balance, and their efficiency is no scaling
figure (the JSON says so). The scene defaults to the luxball proxy under
a seeded 1024x512 sky (fixtures.sky_env, seed 11).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def shard_devices(device: str, shards: int) -> list:
    """`shards` devices: distinct cards where `device` is CUDA and enough
    exist, else `device` repeated."""
    import torch
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= shards):
        return [torch.device("cuda", i) for i in range(shards)]
    return [torch.device(device)] * shards


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="out/scaling.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4,
                    help="the largest mesh; meshes of 1, 2, 4, ... up to it")
    ap.add_argument("--size", type=int, default=128, help="frame edge")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--scene",
                    default=os.path.join(REPO, "assets", "luxball_proxy.obj"))
    ap.add_argument("--env-map", default=None,
                    help="a Radiance .hdr (default: the seeded sky)")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.fixtures import sky_env
    from fluctus_tpu_torch.io.hdr import write_hdr
    from fluctus_tpu_torch.parallel.distributed import scaling_benchmark
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.timing import card_line

    devices = shard_devices(args.device, args.shards)
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= args.shards]
    cfg = RenderConfig(width=args.size, height=args.size,
                       max_bounces=args.bounces, use_env_map=True)
    with tempfile.TemporaryDirectory() as tmp:
        env = args.env_map
        if env is None:
            env = os.path.join(tmp, "sky.hdr")
            write_hdr(env, sky_env(1024, 512, seed=11))
        sess = driver.create_session(args.scene, env, cfg, cache_dir=None,
                                     state_dir=None, device=devices[0])
    shared = len(set(devices)) < len(devices)
    out = {"device": (card_line() if devices[0].type == "cuda"
                      else "cpu"),
           "shards": [str(d) for d in devices],
           "frame": f"{args.size}x{args.size}x{args.spp}spp, "
                    f"{args.bounces} bounces",
           "scene": os.path.basename(args.scene)}
    if shared:
        out["note"] = ("shards share one device and run one after "
                       "another: efficiency is no scaling figure; the "
                       "records check the stripes, pools and balance")
    for integ in ("lockstep", "stream"):
        rows = scaling_benchmark(sess.scene, sess.params, sess.cfg,
                                 spp=args.spp, device_counts=counts,
                                 integrator=integ, devices=devices)
        out[integ] = rows
        for r in rows:
            print(f"{integ:9s} {r['devices']} shards: {r['mrays_s']:.4f} "
                  f"MRays/s, efficiency {r['efficiency']:.3f}"
                  f"{' (shared device)' if shared else ''}, balance "
                  f"{r['shard_ray_balance']:.3f}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
