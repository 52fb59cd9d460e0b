"""K2's and K3's design steps on the card: builds of
`csrc/traverse_brute.cu` with other values of the constants the two
kernels share, timed on the same recorded conference launches.

    python3 -m fluctus_tpu_torch.scripts.probe_k2_design [--kernel k3]
    PYTHONPATH=<other checkout> python3 <this file> --variants default \
        [--kernel k3]

Loads the conference session (its brute forest, as the frame traces it),
takes chip_smoke.py's k2-time rays (65,536 closest rays: every 8th primary
ray of the 512x512 frame, then seeded bounce rays; 65,536 shadow rays
with per-lane t_max), records the launches of one traversal call in each
form through the default build (K2: the visit-list scheduler; K3: the
round loop, FLUCTUS_BRUTE_SCHED=rounds), and replays them through every
variant of VARIANTS (a copy of the source with other `constexpr int`
values, built into the build directory): ms per call (the sum of the
call's launches, each 10 back to back, the variants in turns, best of two
rounds), whether the variant is bit-equal to the default build, K2's
resident warps per SM, the kernel's registers (read from a fresh build's
log), and K2's all-live slab rate in G Moller tests/s
(measure_mfu.brute_visit_rate). For the default build it also prints
each launch alone (its time and its Moller tests; for K2 the largest ray
block's tests at one SM's share of the all-live rate) and, for K2, each
launch again with the ray blocks reordered, heaviest first or most valid
visit slots first (blocks are independent, so the results stay the
same). The second form times another checkout's kernel (its default
build only) on the same rays. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import fluctus_tpu_torch
from fluctus_tpu_torch.timing import card_line, time_launches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    fluctus_tpu_torch.__file__)))
CONFERENCE = os.path.join(ROOT, "assets", "conference_proxy.obj")
STATES = os.path.join(ROOT, "data", "states")

# name: the constants (K2's and K3's) that differ from the source's own
VARIANTS = {
    "default": {},
    "1 CTA, 1 team": {"kCluster": 1, "kTeams": 1, "kMinBlocks": 8,
                      "kK3MinBlocks": 8},
    "1 CTA, 4 teams": {"kCluster": 1},
    "4 CTAs": {"kCluster": 4},
    "8 CTAs, 2 teams": {"kCluster": 8, "kTeams": 2},
    "1 CTA an SM": {"kMinBlocks": 1, "kK3MinBlocks": 1},
    "2 CTAs an SM": {"kMinBlocks": 2, "kK3MinBlocks": 2},
    "pieces of 128": {"kPiece": 128},
    "pieces of 1024": {"kPiece": 1024},
}


def registers(log: str, kernel: str = "k2") -> str:
    """'closest/any-hit' registers and spill stores of `kernel`'s entry
    (k2_kernel or k3_kernel) from a ptxas -v log."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            cur = (("any" if "ILb1" in name else "closest")
                   if f"{kernel}_kernel" in name else None)
        elif cur and "spill stores" in ln:
            out[cur + "_spill"] = ln.split(",")[1].split()[0]
        elif cur and "Used" in ln and "registers" in ln:
            out[cur] = re.search(r"Used (\d+) registers", ln).group(1)
            cur = None
    return (f"{out.get('closest', '?')}/{out.get('any', '?')} registers, "
            f"{out.get('closest_spill', '?')}/{out.get('any_spill', '?')} "
            f"bytes of spill stores")


def variant_source(name: str) -> str:
    """The path of K2's source with VARIANTS[name]'s constants, written
    into the build directory."""
    from fluctus_tpu_torch.build import build_dir
    from fluctus_tpu_torch.ops import traverse_brute as tb
    with open(tb._SRC) as f:
        src = f.read()
    for const, value in VARIANTS[name].items():
        src, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{tb._SRC} has no one {const}")
    path = os.path.join(build_dir(),
                        "k2_variant_" + re.sub(r"\W+", "_", name) + ".cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def build_variants(names, kernel: str = "k2"):
    """{name: (library, `kernel`'s registers)}; the default is the
    package's own build."""
    from fluctus_tpu_torch.ops import traverse_brute as tb

    def one(name):
        if name == "default":
            return tb.load_kernel(), registers(tb.BUILD_INFO["log"], kernel)
        from fluctus_tpu_torch import launch
        info: dict = {}
        src = variant_source(name)
        lib = launch.load_library(
            src, os.path.splitext(os.path.basename(src))[0], tb.ENTRIES,
            info=info)
        return lib, registers(info["log"], kernel)
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


@contextlib.contextmanager
def using(lib):
    """traverse_brute's wrappers launch through `lib` inside the block."""
    from fluctus_tpu_torch.ops import traverse_brute as tb
    old, tb._lib = tb._lib, lib
    try:
        yield
    finally:
        tb._lib = old


def wrapper(kernel: str):
    """The launch wrapper of `kernel` ("k2" or "k3")."""
    from fluctus_tpu_torch.ops import traverse_brute as tb
    return tb.vlaunch_kernel if kernel == "k2" else tb.launch_kernel


def recorded_calls(bf, rays, kernel: str = "k2"):
    """{form: the launches of `kernel` in one traversal call through the
    default build}, rays as chip_smoke.brute_rays makes them."""
    from fluctus_tpu_torch.ops import traverse_brute as tb
    o, d, t_c, o_s, d_s, t_s = rays
    kern = wrapper(kernel)
    out = {}
    old = os.environ.get("FLUCTUS_BRUTE_SCHED")
    os.environ["FLUCTUS_BRUTE_SCHED"] = "vlist" if kernel == "k2" \
        else "rounds"
    try:
        for form, trav, (ro, rd, rt) in (
                ("closest", tb.traverse_closest, (o, d, t_c)),
                ("any", tb.traverse_any, (o_s, d_s, t_s))):
            calls = []

            def rec(*args):
                calls.append(args)
                return kern(*args)
            trav(bf, ro, rd, rt, launch=rec)
            out[form] = calls
    finally:
        if old is None:
            os.environ.pop("FLUCTUS_BRUTE_SCHED")
        else:
            os.environ["FLUCTUS_BRUTE_SCHED"] = old
    torch.cuda.synchronize()
    return out


def permute_blocks(args, perm):
    """K2 launch arguments with ray block perm[j] moved to block j."""
    sel, val, tris, tboxes, rays8, it, ip, iu, iv, *rest = args
    blk, v_per = rest[1], rest[3]
    lanes = (perm[:, None] * blk
             + torch.arange(blk, device=perm.device)).reshape(-1)
    slots = (perm[:, None] * v_per
             + torch.arange(v_per, device=perm.device)).reshape(-1)
    return ((sel[slots].contiguous(), val[slots].contiguous(), tris, tboxes)
            + tuple(x[lanes].contiguous() for x in (rays8, it, ip, iu, iv))
            + tuple(rest))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="all",
                    help="'all' (every VARIANTS entry) or 'default'")
    ap.add_argument("--kernel", default="k2", choices=("k2", "k3"),
                    help="the kernel whose launches are timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_k2_design needs a CUDA card")
    sys.path.append(ROOT)
    import chip_smoke
    from fluctus_tpu_torch.ops import traverse_brute as tb
    from fluctus_tpu_torch.render import driver
    from fluctus_tpu_torch.scripts import measure_mfu

    kernel = args.kernel
    big_k = kernel.upper()
    kern = wrapper(kernel)
    plain = tb.vlaunch_plain if kernel == "k2" else tb.launch_plain
    print(f"card: {card_line()} | {torch.cuda.get_device_name(0)} | "
          f"package {os.path.dirname(fluctus_tpu_torch.__file__)} | "
          f"kernel {big_k}", flush=True)
    names = list(VARIANTS) if args.variants == "all" else ["default"]
    t0 = time.perf_counter()
    libs = build_variants(names, kernel)
    print(f"built {len(names)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sess = driver.create_session(CONFERENCE,
                                 cfg=chip_smoke.conference_cfg(512, 512),
                                 state_dir=STATES, auto_frame=False,
                                 device="cuda")
    bf = sess.scene.bforest
    rays = chip_smoke.brute_rays(sess, 1 << 16, seed=11)
    calls = recorded_calls(bf, rays, kernel)
    # another checkout's K2 (an earlier design) has no occupancy query and
    # no per-block counts
    own = hasattr(tb, "k2_resident_warps")

    ms = {(n, f): [] for n in names for f in calls}
    for _ in range(2):                       # rounds, the variants in turns
        for n in names:
            with using(libs[n][0]):
                for f in calls:
                    ms[(n, f)].append(sum(time_launches(
                        lambda a=a: kern(*a), 10, 1) for a in calls[f]))

    # the default build's launches one by one: time, Moller tests, and
    # (K2) the largest block's tests over one SM's share of the all-live
    # rate
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, rate = measure_mfu.brute_visit_rate()
    for f in calls:
        for k, a in enumerate(calls[f]):
            st: dict = {}
            plain(*a, stats=st)
            ms_k = time_launches(lambda: kern(*a), 10, 1)
            blk = st.get("block_tri_tests")
            big = (f"; largest block {int(blk.max()) / 1e6:.2f} M tests, "
                   f"{int(blk.max()) / (rate / sms) * 1e3:.3f} ms alone on "
                   f"one SM" if blk is not None else "")
            tests = max(st["tri_tests"], 1)
            print(f"{big_k} default {f} launch {k}: {ms_k:.3f} ms, "
                  f"{tests / 1e6:.1f} M Moller tests, "
                  f"{ms_k * 1e-3 * rate / tests:.2f} x their time at K2's "
                  f"all-live rate{big}", flush=True)

    # the same launches with the ray blocks in another order (blocks are
    # independent): the heaviest first, from the plain version's per-block
    # counts, or those with the most valid visit slots first
    if own and kernel == "k2":
        for f in calls:
            for k, a in enumerate(calls[f]):
                st: dict = {}
                tb.vlaunch_plain(*a, stats=st)
                w = st["block_tri_tests"]
                visits = a[1].reshape(w.numel(), -1).sum(1)
                res = []
                for name, perm in (
                        ("as is", torch.arange(w.numel(), device=w.device)),
                        ("heaviest first", torch.argsort(-w, stable=True)),
                        ("most visits first",
                         torch.argsort(-visits, stable=True))):
                    b = permute_blocks(a, perm)
                    t_ms = time_launches(lambda: tb.vlaunch_kernel(*b), 10,
                                         1)
                    res.append(f"{name} {t_ms:.3f} ms")
                print(f"K2 default {f} launch {k}, blocks reordered: "
                      + ", ".join(res), flush=True)

    def run(name, form):
        with using(libs[name][0]):
            return [kern(*a) for a in calls[form]]

    for n in names:
        same = all(torch.equal(x, y) for f in calls
                   for k, p in zip(run(n, f), run("default", f))
                   for x, y in zip(k, p))
        with using(libs[n][0]):
            warps = "?"
            if own and kernel == "k2":
                tp, tt = bf.tris.shape[2], int(bf.tile)
                gr = tb._resolve_gr(tt, tp)
                per_sm, placed = tb.k2_resident_warps(tp, tt, gr, False)
                warps = f"{per_sm} ({placed:.1f} as clusters fit)"
            visit_s, rate = measure_mfu.brute_visit_rate()
        print(f"{big_k} {n:28s}: closest {min(ms[(n, 'closest')]):.3f} ms "
              f"({len(calls['closest'])} launches), any-hit "
              f"{min(ms[(n, 'any')]):.3f} ms ({len(calls['any'])}); "
              f"bit-equal to the default {same}; {warps} resident K2 warps "
              f"per SM; {libs[n][1]}; K2 all-live {rate / 1e9:.2f} G "
              f"tests/s ({visit_s * 1e6:.3f} us per 128-lane chunk visit)",
              flush=True)


if __name__ == "__main__":
    main()
