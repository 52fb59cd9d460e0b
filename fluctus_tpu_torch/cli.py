"""Command line (counterpart of `fluctus_tpu/cli.py`; reference:
src/main.cpp's TCLAP arguments and batch mode).

    python -m fluctus_tpu_torch.cli render SCENE [-x W -y H -s SPP ...]
    python -m fluctus_tpu_torch.cli benchmark SCENE [--csv F --txt F ...]
    python -m fluctus_tpu_torch.cli optimize SCENE --target T.hdr [...]
    python -m fluctus_tpu_torch.cli convert SRC.pbrt DST.pbf

The subcommands, arguments, defaults and choices are the JAX package's,
plus `--device` on the scene commands (default "cuda": the card; "cpu"
runs on the CPU); `convert` is host code and takes none.
"""
from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(prog="fluctus-tpu")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("scene", help="scene file (.obj/.ply)")
        sp.add_argument("-x", "--width", type=int, default=1024)
        sp.add_argument("-y", "--height", type=int, default=1024)
        sp.add_argument("--env-map", default=None)
        sp.add_argument("--max-bounces", type=int, default=4)
        sp.add_argument("--no-env-light", action="store_true")
        sp.add_argument("--area-light", action="store_true")
        sp.add_argument("--no-sbvh", action="store_true")
        sp.add_argument("--cache-dir", default="data/hierarchies")
        sp.add_argument("--backend", default="auto",
                        choices=["auto", "jnp", "packed", "wide", "pallas",
                                 "mxu"],
                        help="traversal backend (auto and mxu: the per-lane "
                             "kernels; pallas: the packet kernel; jnp, "
                             "packed, wide: the plain walks)")
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the card) or cpu")

    r = sub.add_parser("render")
    common(r)
    r.add_argument("-s", "--spp", type=int, default=16)
    r.add_argument("-o", "--output", default="output.png")
    r.add_argument("--integrator", default="auto",
                   choices=["auto", "lockstep", "stream"],
                   help="auto: an openness probe picks on the card, "
                        "lockstep on the CPU")
    r.add_argument("--denoise", type=float, default=0.0, metavar="BLEND",
                   help="edge-avoiding A-trous denoise blend in [0,1] "
                        "(reference: OptiX denoiser blend slider)")
    r.add_argument("--hdr", action="store_true",
                   help="write linear .hdr instead of tonemapped png")
    r.add_argument("--progressive", type=int, default=0, metavar="ITERS",
                   help="progressive refinement: ITERS increments of "
                        "--spp samples each into one accumulator "
                        "(reference: Tracer::update refinement loop, "
                        "src/tracer.cpp:189-358)")
    r.add_argument("--export-every", type=int, default=0, metavar="N",
                   help="with --progressive: auto-export the current "
                        "estimate every N iterations (reference exports "
                        "every 1000, src/tracer.cpp:356-357)")

    b = sub.add_parser("benchmark")
    common(b)
    b.add_argument("--duration", type=float, default=30.0,
                   help="seconds per scene (reference: 30 s)")
    b.add_argument("--csv", default=None, help="CSV output path")
    b.add_argument("--txt", default=None,
                   help="averaged one-line txt report path (reference "
                        "simpleReport format, src/tracer.cpp:503)")
    b.add_argument("--integrator", default="lockstep",
                   choices=["auto", "lockstep", "stream"],
                   help="lockstep: analytic ray accounting (every lane "
                        "every bounce); stream: streaming wavefront with "
                        "the rays its queues traced (reference wavefront "
                        "accounting, src/tracer.cpp:333-345); auto: an "
                        "openness probe picks per scene")

    o = sub.add_parser("optimize")
    common(o)
    o.add_argument("--target", required=True, help="target image (.hdr)")
    o.add_argument("--steps", type=int, default=100)
    o.add_argument("--lr", type=float, default=1e-2)
    o.add_argument("--spp", type=int, default=4)
    o.add_argument("--out-dir", default="out/optimize")
    o.add_argument("--minibatch", type=int, default=0,
                   help="pixels per step (0 = full frame)")
    o.add_argument("--diff-keys", default="kd",
                   help="comma list: kd,ks,ns,ni,env_image,env_strength,"
                        "cam_pos,cam_dir,cam_fov,cam_aperture_size,"
                        "cam_focal_dist")
    o.add_argument("--method", default="auto",
                   choices=["auto", "lockstep", "stream"],
                   help="gradient path: stream = streaming-wavefront "
                        "fwd+bwd; lockstep = the checkpointed lockstep; "
                        "auto = stream off the CPU")

    c = sub.add_parser("convert",
                       help=".pbrt text -> .pbf binary container "
                            "(reference: Scene::convertPBRTModel)")
    c.add_argument("src", help="input .pbrt file")
    c.add_argument("dst", help="output .pbf file")
    return p


def make_session(args):
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver

    cfg = RenderConfig(
        width=args.width, height=args.height, max_bounces=args.max_bounces,
        use_env_map=not args.no_env_light and args.env_map is not None,
        use_area_light=args.area_light, backend=args.backend)
    return driver.create_session(
        args.scene, env_map=args.env_map, cfg=cfg,
        use_sbvh=not args.no_sbvh, cache_dir=args.cache_dir,
        device=args.device)


def cmd_render(args):
    from fluctus_tpu_torch.io.image import save_image
    from fluctus_tpu_torch.render import driver

    sess = make_session(args)
    if args.progressive:
        driver.render_progressive(
            sess, iterations=args.progressive, spp_increment=args.spp,
            export_every=args.export_every, export_path=args.output,
            hdr=args.hdr,
            callback=lambda it, p: print(
                f"iteration {it}/{args.progressive}: {p.spp_done} spp"))
        print(f"wrote {args.output}")
        return
    if args.denoise > 0.0:
        img = driver.render_denoised(sess, args.spp, blend=args.denoise,
                                     integrator=args.integrator)
        if not args.hdr:
            img = driver.display_frame(sess, img)
    elif args.hdr:
        img = driver.render(sess, args.spp, integrator=args.integrator)
    else:
        img = driver.render_ldr(sess, args.spp, integrator=args.integrator)
    save_image(args.output, img.cpu().numpy())
    print(f"wrote {args.output}")


def cmd_benchmark(args):
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.render.benchmark import (
        run_benchmark, run_benchmark_stream, write_txt_report)

    sess = make_session(args)
    integrator = args.integrator
    if integrator == "auto":
        integrator = driver.choose_integrator(sess)
    fn = (run_benchmark_stream if integrator == "stream"
          else run_benchmark)
    result = fn(sess, duration_s=args.duration,
                scene_name=args.scene, csv_path=args.csv)
    result["integrator"] = integrator
    if args.txt:
        write_txt_report(args.txt, [result])
    print(json.dumps(result))


def cmd_optimize(args):
    from fluctus_tpu_torch.render.optimize import run_optimization

    run_optimization(make_session(args), target_path=args.target,
                     steps=args.steps, lr=args.lr, spp=args.spp,
                     out_dir=args.out_dir, minibatch=args.minibatch,
                     diff_keys=tuple(args.diff_keys.split(",")),
                     method=args.method)


def cmd_convert(args):
    from fluctus_tpu_torch.scene.loaders.pbf import convert_pbrt_to_pbf

    convert_pbrt_to_pbf(args.src, args.dst)
    print(f"wrote {args.dst}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"render": cmd_render, "benchmark": cmd_benchmark,
     "optimize": cmd_optimize, "convert": cmd_convert}[args.command](args)


if __name__ == "__main__":
    main()
