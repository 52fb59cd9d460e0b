"""K1's and K4's design steps on the card: builds of
`csrc/traverse_stack.cu` (K1) and `csrc/traverse_packet.cu` (K4) with other
values of their constants, and another checkout's sources (the parent's
design), timed on the same rays.

    python3 -m fluctus_tpu_torch.scripts.probe_walk_design --kernel k4 \
        [--parent out/parent] [--variants all|default]

Loads the kitchen session (512x512, as chip_smoke.py), takes the k1-time
/ k4-time rays (two 65,536-ray closest tiles: primary rays, then seeded
bounce rays; one 65,536-ray any-hit tile of shadow rays with per-lane
t_max; for K4 each tile sorted by octant and Morton code as the
integrator sorts it) and times every build of VARIANTS[kernel] (a copy of
the source with other `constexpr` values, written into the build
directory) and, with --parent, the other checkout's kernel: ms per
65,536-ray launch (closest the mean over its two tiles), the builds in
turns, the best of two rounds. Each build is held against the plain
version on every tile (t, prim, u, v and flags bit-equal) and its
registers and spill are read from its ptxas log.

For K4 it also builds each design (the parent's too) with clock64()
counters and prints, per packet, the cycles from the first pop to the
empty stack and the node and leaf visits: max, median and mean, and the
cycles per visit; beside them the plain version's per-packet visits on
the same rays. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import fluctus_tpu_torch
from fluctus_tpu_torch.scripts.probe_k2_design import registers
from fluctus_tpu_torch.timing import card_line, time_launches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    fluctus_tpu_torch.__file__)))
KITCHEN = os.path.join(ROOT, "assets", "kitchen_proxy.obj")
STATES = os.path.join(ROOT, "data", "states")

# name: the constants that differ from the source's own (K4's variants
# name all five). K1's steps: one lane a ray with vector row loads and the
# rank selection (its stack in local memory as before), then teams of 4
# and 8 lanes with either stack placement, the leaf's slots one at a time
# or two side by side, and the register cut. K4's: one CTA of one thread
# a lane per packet (the per-warp walk alone, then with the row
# prefetch), clusters of 4 and 8 CTAs, 1, 2 and 4 threads a lane, the
# leaf's slots side by side, the row prefetch left out.


def _k4(cluster, split, unroll, min_blocks, prefetch=True):
    return {"kCluster": cluster, "kSplit": split, "kUnroll": unroll,
            "kMinBlocks": min_blocks, "kPrefetch": prefetch}


VARIANTS = {
    "k1": {
        "default": {},
        "1 lane, local stack": {"kTeam": 1, "kSharedStack": False,
                                "kMinBlocks": 4, "kUnroll": 1},
        "1 lane, local, unroll 2": {"kTeam": 1, "kSharedStack": False,
                                    "kMinBlocks": 4},
        "4 lanes, local stack": {"kTeam": 4, "kSharedStack": False},
        "4 lanes": {"kTeam": 4},
        "8 lanes, local stack": {"kSharedStack": False},
        "8 lanes, unroll 1": {"kUnroll": 1},
        "8 lanes, 4 CTAs an SM": {"kMinBlocks": 4},
        "8 lanes, 256 threads": {"kThreads": 256, "kMinBlocks": 4},
    },
    "k4": {
        "default": {},
        "1 CTA, 1 thread, bare": _k4(1, 1, 1, 1, prefetch=False),
        "1 CTA, 1 thread, prefetch": _k4(1, 1, 1, 1),
        "4 CTAs, 1 thread": _k4(4, 1, 1, 4),
        "8 CTAs, 1 thread": _k4(8, 1, 1, 8),
        "4 CTAs, 2 threads": _k4(4, 2, 2, 4),
        "8 CTAs, 2 threads": _k4(8, 2, 2, 8),
        "4 CTAs, 4 threads": _k4(4, 4, 2, 2),
        "8 CTAs, 4 threads, unroll 4": _k4(8, 4, 4, 4),
        "no row prefetch": _k4(8, 4, 2, 4, prefetch=False),
    },
}
SOURCE = {"k1": "traverse_stack.cu", "k4": "traverse_packet.cu"}
ENTRY = {"k1": "k1_traverse", "k4": "k4_packet"}
KERNEL_FN = {"k1": "traverse", "k4": "packet"}   # the <name>_kernel entries
PROF_MAX = 1 << 16          # CTAs the instrumented K4 records

# the clock64() counters of an instrumented K4 build: (pattern, text put
# after it, whether the pattern must match); the others match once in
# the parent's source too. Per CTA (its thread 0): the walk's cycles, its
# node and leaf visits, and, where the source has the optional anchors,
# the cycles of its visits in parts: an inner visit's row wait, its tests
# and exchange up to the barrier, the barrier, and the rest (rank, push,
# next fetch); a leaf's row wait, its tests (with the next row's fetch
# issued) and the rest (the lane's merge).
PROF_FIELDS = 10
PARTS = ("inner wait", "inner tests", "inner barrier", "inner push",
         "leaf wait", "leaf tests", "leaf merge")
INSTRUMENT = [
    (r"\nnamespace \{\n",
     "__device__ unsigned long long k4_prof[%d * %d];\n"
     % (PROF_FIELDS, PROF_MAX), True),
    (r"\n(?=  while \(sp > 0\) \{\n)",
     "  const long long prof_t0 = clock64();\n"
     "  unsigned prof_nodes = 0, prof_leaves = 0;\n"
     "  unsigned long long prof_part[7] = {0, 0, 0, 0, 0, 0, 0};\n", True),
    (r"\n    const int enc = [^\n]*;\n",
     "    if (enc >= 0) ++prof_nodes; else ++prof_leaves;\n"
     "    const long long prof_v0 = clock64();\n"
     "    long long prof_w = prof_v0, prof_b0 = prof_v0, prof_b1 = prof_v0;\n",
     True),
    (r"\n    fetch_wait\(\);\n", "    prof_w = clock64();\n", False),
    (r"\n(?=      if \(kCluster > 1\)\n        cl\.sync\(\);\n)",
     "      prof_b0 = clock64();\n", False),
    (r"\n        __syncthreads\(\);\n", "      prof_b1 = clock64();\n",
     False),
    (r"\n(?=      if \(ANY_HIT\) \{\n        bool hit = lj != INT_MAX;)",
     "      prof_b0 = clock64();\n", False),
    (r"\n(?=    cur \^= 1;\n)",
     "    {\n"
     "      const long long now = clock64();\n"
     "      if (enc >= 0) {\n"
     "        prof_part[0] += prof_w - prof_v0;\n"
     "        prof_part[1] += prof_b0 - prof_w;\n"
     "        prof_part[2] += prof_b1 - prof_b0;\n"
     "        prof_part[3] += now - prof_b1;\n"
     "      } else {\n"
     "        prof_part[4] += prof_w - prof_v0;\n"
     "        prof_part[5] += prof_b0 - prof_w;\n"
     "        prof_part[6] += now - prof_b0;\n"
     "      }\n"
     "    }\n", False),
    (r"\n(?=  out_t\[i\] = best_t;\n)",
     "  if (threadIdx.x == 0 && blockIdx.x < %d) {\n"
     "    unsigned long long* p = k4_prof + %d * blockIdx.x;\n"
     "    p[0] = clock64() - prof_t0;\n"
     "    p[1] = prof_nodes;\n"
     "    p[2] = prof_leaves;\n"
     "    for (int q = 0; q < 7; ++q) p[3 + q] = prof_part[q];\n"
     "  }\n" % (PROF_MAX, PROF_FIELDS), True),
]
PROF_COPY = """
// a: destination (device), bytes, stream
extern "C" int k4_prof_copy(const long long* a, int n) {
  if (n != 3) return -1;
  return (int)cudaMemcpyFromSymbolAsync(
      (void*)a[0], k4_prof, (size_t)a[1], 0, cudaMemcpyDeviceToDevice,
      (cudaStream_t)a[2]);
}
"""


def source_text(kernel: str, tree: str | None, consts: dict,
                instrument: bool) -> str:
    """`kernel`'s source from checkout `tree` (None: this package) with
    `consts` substituted, its header included by absolute path, and with
    `instrument` the clock64() counters (K4 only)."""
    csrc = os.path.join(tree, "fluctus_tpu_torch", "csrc") if tree else \
        os.path.join(os.path.dirname(fluctus_tpu_torch.__file__), "csrc")
    with open(os.path.join(csrc, SOURCE[kernel])) as f:
        src = f.read()
    for const, value in consts.items():
        v = str(value).lower() if isinstance(value, bool) else str(value)
        src, n = re.subn(rf"constexpr (int|bool) {const} = \w+;",
                         rf"constexpr \g<1> {const} = {v};", src)
        if n != 1:
            raise RuntimeError(f"{SOURCE[kernel]} has no one {const}")
    src = src.replace('#include "wide_walk.cuh"',
                      f'#include "{os.path.join(csrc, "wide_walk.cuh")}"')
    if instrument:
        for pat, text, needed in INSTRUMENT:
            m = list(re.finditer(pat, src))
            if not m and not needed:
                continue
            if len(m) != 1:
                raise RuntimeError(f"{SOURCE[kernel]}: {pat!r} matches "
                                   f"{len(m)} times")
            src = src[:m[0].end()] + text + src[m[0].end():]
        src += PROF_COPY
    return src


_BUILT: dict = {}   # build's libraries of this process, by job


def build(kernel: str, jobs: dict):
    """{name: (library, registers)} for jobs {name: (tree, consts,
    instrument)}, built in parallel into the build directory (a job
    built before in this process is not built again)."""
    from fluctus_tpu_torch import launch
    from fluctus_tpu_torch.build import build_dir

    def one(item):
        name, (tree, consts, instrument) = item
        key = (kernel, name, tree, tuple(sorted(consts.items())), instrument)
        if key not in _BUILT:
            _BUILT[key] = compile_one(name, tree, consts, instrument)
        return name, _BUILT[key]

    def compile_one(name, tree, consts, instrument):
        stem = (f"{kernel}_variant_" + re.sub(r"\W+", "_", name)
                + ("_clock" if instrument else ""))
        path = os.path.join(build_dir(), stem + ".cu")
        with open(path, "w") as f:
            f.write(source_text(kernel, tree, consts, instrument))
        entries = {ENTRY[kernel]: kernel.upper()}
        if instrument:
            entries["k4_prof_copy"] = "K4 counters"
        info: dict = {}
        lib = launch.load_library(path, stem, entries, info=info)
        return lib, registers(info["log"], KERNEL_FN[kernel])
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        return dict(pool.map(one, jobs.items()))


@contextlib.contextmanager
def using(module, lib):
    """`module`'s wrapper launches through `lib` inside the block."""
    old, module._lib = module._lib, lib
    try:
        yield
    finally:
        module._lib = old


def runner(kernel: str, lib, bvh, rays, any_hit: bool):
    """A no-argument call of `lib`'s kernel on one tile."""
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts
    if kernel == "k4":
        def run():
            with using(tp, lib):
                return tp.packet_kernel(*rays, bvh, any_hit)
    else:
        def run():
            with using(ts, lib):
                return ts.traverse_kernel(bvh, *rays, any_hit)
    return run


def outputs(kernel: str, res, any_hit: bool):
    """The result tensors to compare: (t, prim, u, v) or the flags."""
    if kernel == "k4":
        return (res[1],) if any_hit else tuple(res)
    return (res,) if any_hit else tuple(res)


def tiles(sess, kernel: str):
    """{form: [tile rays]}: chip_smoke.py's k1-time / k4-time tiles (K4's
    sorted and padded as its wrapper pads them)."""
    sys.path.append(ROOT)
    import chip_smoke
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    tile = 1 << 16
    o, d, t_c, o_s, d_s, t_s = chip_smoke.kernel_rays(sess, 1 << 17, seed=7)
    n_p = o.shape[0] - (1 << 17)
    sets = {"closest": [(o[:tile], d[:tile], t_c[:tile]),
                        (o[n_p:n_p + tile], d[n_p:n_p + tile],
                         t_c[n_p:n_p + tile])],
            "any": [(o_s[:tile], d_s[:tile], t_s[:tile])]}
    bvh = sess.scene.wbvh
    for form, rays in sets.items():
        out = []
        for ro, rd, rt in rays:
            ro, rd, rt = (x.contiguous() for x in (ro, rd, rt))
            if kernel == "k4":
                ro, rd, rt = chip_smoke.sorted_by_ray_sort(bvh, ro, rd, rt)
                ro, rd, rt = tp._prep(ro, rd, rt)[:3]
            out.append((ro, rd, rt))
        sets[form] = out
    return sets


def plain(kernel: str, bvh, rays, any_hit: bool, stats=None):
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.ops import traverse_stack as ts
    if kernel == "k4":
        return outputs(kernel, tp.packet_plain(*rays, bvh, any_hit,
                                               stats=stats), any_hit)
    p, blocked = ts.traverse_plain(bvh, *rays, any_hit, stats=stats)
    return (blocked,) if any_hit else tuple(p)


def design_steps(kernel: str, sess, sets=None, parent: str | None = None,
                 names=None, say=print, rounds: int = 2) -> dict:
    """Build and time `kernel`'s VARIANTS `names` (all by default) and,
    with `parent` (another checkout's root), its kernel, on `sets` (the
    `tiles`, made if None). Prints one line a build; returns {name: {form:
    ms, "equal": bool, "registers": str}}."""
    bvh = sess.scene.wbvh
    sets = sets or tiles(sess, kernel)
    names = list(VARIANTS[kernel]) if names is None else names
    parent = os.path.abspath(parent) if parent else None
    jobs = {n: (None, VARIANTS[kernel][n], False) for n in names}
    if parent:
        jobs["parent"] = (parent, {}, False)
    t0 = time.perf_counter()
    libs = build(kernel, jobs)
    say(f"{kernel.upper()} built {len(jobs)} designs in "
        f"{time.perf_counter() - t0:.1f} s")
    want = {form: [plain(kernel, bvh, r, form == "any") for r in rays]
            for form, rays in sets.items()}
    out = {}
    for n, (lib, regs) in libs.items():
        same = True
        for form, rays in sets.items():
            for r, w in zip(rays, want[form]):
                got = outputs(kernel, runner(kernel, lib, bvh, r,
                                             form == "any")(),
                              form == "any")
                same &= all(torch.equal(a, b) for a, b in zip(got, w))
        out[n] = {"equal": same, "registers": regs}
    reps = 10 if kernel == "k4" else 20
    ms = {(n, f): [] for n in libs for f in sets}
    for _ in range(rounds):                 # the builds in turns
        for n, (lib, _) in libs.items():
            for form, rays in sets.items():
                ms[(n, form)].append(sum(time_launches(
                    runner(kernel, lib, bvh, r, form == "any"), reps, 1)
                    for r in rays)
                    / len(rays))
    for n in libs:
        r = out[n]
        r.update({f: min(ms[(n, f)]) for f in sets})
        say(f"{kernel.upper()} {n:24s}: closest {r['closest']:.4f} ms, "
            f"any-hit {r['any']:.4f} ms per 65536-ray launch; bit-equal to "
            f"the plain version {r['equal']}; {r['registers']}")
    return out


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now (MHz)."""
    s = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True).stdout
    return float(s.split()[0])


def spread(x) -> str:
    """'max / median / mean' of a 1-D tensor."""
    x = x.double()
    return (f"{float(x.max()):.0f} / {float(x.median()):.0f} / "
            f"{float(x.mean()):.1f}")


def cluster_size(tree: str | None) -> int:
    """CTAs per packet of the K4 source in checkout `tree` (1 where the
    source has no kCluster)."""
    m = re.search(r"constexpr int kCluster = (\d+);",
                  source_text("k4", tree, {}, False))
    return int(m.group(1)) if m else 1


def packet_profile(sess, sets=None, parent: str | None = None,
                   say=print, names=("default",)) -> dict:
    """K4's per-packet cycles and visits (the VARIANTS `names` and, with
    `parent`, the other checkout's design) and the plain version's
    per-packet visits, on the k4-time tiles. Prints one line per design
    and form."""
    from fluctus_tpu_torch.launch import launch
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    bvh = sess.scene.wbvh
    sets = sets or tiles(sess, "k4")
    parent = os.path.abspath(parent) if parent else None
    jobs = {n: (None, VARIANTS["k4"][n], True) for n in names}
    if parent:
        jobs["parent"] = (parent, {}, True)
    libs = build("k4", jobs)
    prof = torch.zeros(PROF_FIELDS * PROF_MAX, dtype=torch.int64,
                       device="cuda")
    res = {}
    for form, rays in sets.items():
        anyh = form == "any"
        st: dict = {}
        for r in rays:
            tp.packet_plain(*r, bvh, anyh, stats=st)
        pn, pl = st["packet_node_visits"], st["packet_leaf_visits"]
        say(f"K4 plain version, {form}: per packet (max / median / mean) "
            f"{spread(pn)} node and {spread(pl)} leaf visits over "
            f"{pn.numel()} packets")
        for name, (lib, _) in libs.items():
            cyc, nv, lv, parts, ms = [], [], [], [], 0.0
            for r in rays:
                run = runner("k4", lib, bvh, r, anyh)
                ms += time_launches(run, 5, 1) / len(rays)
                run()
                n_cta = r[0].shape[0] // tp.BLK
                launch(lib.k4_prof_copy, 0, prof.data_ptr(), prof.numel() * 8)
                torch.cuda.synchronize()
                # one row per CTA; a packet's CTAs are consecutive
                per = VARIANTS["k4"].get(name, {}).get(
                    "kCluster", cluster_size(jobs[name][0]))
                p = prof[:PROF_FIELDS * n_cta * per].view(
                    n_cta, per, PROF_FIELDS).clone()
                prof.zero_()
                cyc.append(p[:, :, 0].amax(1))
                nv.append(p[:, 0, 1])
                lv.append(p[:, 0, 2])
                parts.append(p[:, 0, 3:])
            cyc, nv, lv, parts = (torch.cat(x) for x in (cyc, nv, lv,
                                                         parts))
            mhz = sm_clock_mhz()
            per_visit = cyc.double() / (nv + lv).clamp(min=1).double()
            heavy = int(cyc.argmax())
            split = ""
            if int(parts.sum()) > 0:
                def per(row, n_in, n_lf):
                    return ", ".join(
                        f"{part} {int(row[q]) / max(n_in if q < 4 else n_lf, 1):.0f}"
                        for q, part in enumerate(PARTS))
                split = (f"; CTA 0's cycles a visit, all packets: "
                         f"{per(parts.sum(0), int(nv.sum()), int(lv.sum()))}"
                         f"; the heaviest packet: "
                         f"{per(parts[heavy], int(nv[heavy]), int(lv[heavy]))}")
            say(f"K4 {name} (clock64 build), {form}: {ms:.4f} ms a launch "
                f"(mean of its tiles); per packet (max / median / mean) "
                f"{spread(cyc)} cycles, {spread(nv)} node and {spread(lv)} "
                f"leaf visits, {spread(per_visit)} cycles a visit; the "
                f"heaviest packet {int(cyc[heavy])} cycles in "
                f"{int(nv[heavy] + lv[heavy])} visits = "
                f"{int(cyc[heavy]) / mhz / 1e3:.4f} ms at the SM clock read "
                f"after ({mhz:.0f} MHz){split}")
            res[(name, form)] = dict(cycles=cyc.cpu(), nodes=nv.cpu(),
                                     leaves=lv.cpu(), ms=ms)
        res[("plain", form)] = dict(nodes=pn.cpu(), leaves=pl.cpu())
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="k4", choices=("k1", "k4"))
    ap.add_argument("--variants", default="all",
                    help="'all' (every VARIANTS entry) or 'default'")
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose kernel is timed "
                         "beside (its source only; this package's "
                         "wrappers launch it)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--profile", default="default",
                    help="K4 VARIANTS to build with clock64 counters, "
                         "separated by ';'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_walk_design needs a CUDA card")
    sys.path.append(ROOT)
    import chip_smoke
    from fluctus_tpu_torch.render import driver

    print(f"card: {card_line()} | {torch.cuda.get_device_name(0)} | "
          f"kernel {args.kernel.upper()}", flush=True)
    sess = driver.create_session(KITCHEN, cfg=chip_smoke.kitchen_cfg(512, 512),
                                 state_dir=STATES, auto_frame=False,
                                 device="cuda")
    say = lambda s: print(s, flush=True)
    sets = tiles(sess, args.kernel)
    names = None if args.variants == "all" else ["default"]
    parent = os.path.abspath(args.parent) if args.parent else None
    if args.kernel == "k4":
        packet_profile(sess, sets, parent, say,
                       [n.strip() for n in args.profile.split(";")])
    design_steps(args.kernel, sess, sets, parent, names, say, args.rounds)


if __name__ == "__main__":
    main()
