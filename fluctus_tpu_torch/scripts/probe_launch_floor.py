"""The launch floor on the card (counterpart of
`scripts/probe_pallas_floor.py`).

    python3 -m fluctus_tpu_torch.scripts.probe_launch_floor

Times, per launch, 16 launches back to back between two CUDA events, best
of 3:
  1. P1 `copy_plus_one` on one (8, 128) tile, one block: a launch's cost;
  2. P1 on 64 tiles, 64 blocks: the cost of more blocks;
  3. K1 closest on 1,024 rays: a traversal launch of one wave;
  4. K1 closest on 65,536 rays: the integrator's tile.
The rays are seeded random rays inside the kitchen (the TPU probe used
the teapot, which is not in the repository). If (3) is near (1), a
traversal call's floor is the launch; if (3) is far above it, it lives in
the traversal itself.

Then the host steps of one P1 launch at one block (`steps`), each a
complete path to the same launcher, cheapest last, beside PyTorch's own
`x + 1.0`:
  a. ctypes: a check of five tensor attributes, `torch.empty_like`,
     `with torch.cuda.device`, a `torch.cuda.Stream` object for its
     handle, and a ctypes call of the launcher;
  b. as a, with the raw stream handle (`_cuda_getCurrentRawStream`);
  c. as b, entering `torch.cuda.device` only for another device;
  d. as c, through the fastcall extension instead of ctypes;
  e. the wrapper as shipped (`copy_plus_one_kernel`: d with its checks);
  f. as d with the output allocated once outside: what `empty_like` costs.
Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from fluctus_tpu_torch.timing import BEST_OF, REPS, card_line, time_launches

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KITCHEN = os.path.join(REPO, "assets", "kitchen_proxy.obj")


def random_rays(lo, hi, n: int, seed: int, device="cuda"):
    """n rays with origins uniform in the box [lo, hi] and uniform
    directions, from a seed."""
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def kitchen_bvh():
    """The kitchen's 8-wide hierarchy on the card and its bounds."""
    from fluctus_tpu_torch.scene.scene import load_scene
    host = load_scene(KITCHEN)
    host.build_bvh(use_sbvh=True)
    return host.to_device("cuda").wbvh, host.bounds()


def probes(wbvh, lo, hi) -> dict:
    """{probe: call} for the four probes of the module docstring."""
    from fluctus_tpu_torch.ops import probes as pr
    from fluctus_tpu_torch.ops import traverse_stack as ts

    x1 = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
    x64 = torch.zeros((64 * 8, 128), dtype=torch.float32, device="cuda")
    o, d = random_rays(lo, hi, 1 << 16, seed=0)
    o1, d1 = o[:1024].contiguous(), d[:1024].contiguous()
    return {
        "p1_1_block": lambda: pr.copy_plus_one_kernel(x1),
        "p1_64_blocks": lambda: pr.copy_plus_one_kernel(x64),
        "k1_closest_1k": lambda: ts.traverse_kernel(wbvh, o1, d1, 3.4e38,
                                                    False),
        "k1_closest_64k": lambda: ts.traverse_kernel(wbvh, o, d, 3.4e38,
                                                     False),
    }


def steps(rows: int = 8) -> dict:
    """{step: call} for the host steps a-f of the module docstring, and
    "x + 1.0", on a (rows, 128) f32 tensor. Each call makes one P1 launch
    (PyTorch's one add) and returns its output."""
    from fluctus_tpu_torch import launch
    from fluctus_tpu_torch.ops import probes as pr

    lib = pr.load_kernel()
    entry = lib.p1_copy_plus_one
    cdll = ctypes.CDLL(pr.BUILD_INFO["path"])
    fn = cdll.p1_copy_plus_one
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    fn.restype = ctypes.c_int
    args4 = ctypes.c_longlong * 4
    fc = launch.fastcall()
    get_device = torch._C._cuda_getDevice
    raw_stream = torch._C._cuda_getCurrentRawStream
    x = torch.rand((rows, 128), device="cuda")
    o_once = torch.empty_like(x)
    f32 = torch.float32

    def checked(t):
        if (not t.is_cuda or t.dtype != f32 or not t.is_contiguous()
                or t.dim() != 2 or t.shape[1] != 128 or t.shape[0] % 8):
            raise ValueError("P1: bad input")

    def done(rc):
        if rc:
            raise RuntimeError(f"P1 launch failed: {rc}")
        pr.LAUNCHES["p1"] += 1

    def a():
        checked(x)
        o = torch.empty_like(x)
        with torch.cuda.device(x.device):
            s = torch.cuda.current_stream(x.device).cuda_stream
            done(fn(args4(x.data_ptr(), o.data_ptr(), x.shape[0] // 8, s),
                    4))
        return o

    def b():
        checked(x)
        o = torch.empty_like(x)
        with torch.cuda.device(x.device):
            s = raw_stream(x.get_device())
            done(fn(args4(x.data_ptr(), o.data_ptr(), x.shape[0] // 8, s),
                    4))
        return o

    def c():
        checked(x)
        o = torch.empty_like(x)
        d = x.get_device()
        assert d == get_device()
        done(fn(args4(x.data_ptr(), o.data_ptr(), x.shape[0] // 8,
                      raw_stream(d)), 4))
        return o

    def d_():
        checked(x)
        o = torch.empty_like(x)
        d = x.get_device()
        assert d == get_device()
        done(fc(entry.addr, x.data_ptr(), o.data_ptr(), x.shape[0] // 8,
                raw_stream(d)))
        return o

    def f():
        checked(x)
        d = x.get_device()
        assert d == get_device()
        done(fc(entry.addr, x.data_ptr(), o_once.data_ptr(),
                x.shape[0] // 8, raw_stream(d)))
        return o_once

    return {"x + 1.0": lambda: x + 1.0, "a ctypes": a,
            "b raw stream": b, "c no device guard": c,
            "d fastcall": d_,
            "e wrapper": lambda: pr.copy_plus_one_kernel(x),
            "f no allocation": f}, x


def measure_steps(rows: int = 8) -> dict:
    """{step: ms per launch}, each step timed in turn with x + 1.0 (x + 1.0
    first and last), after checking that every step computes x + 1."""
    calls, x = steps(rows)
    want = x + 1.0
    for name, fn in calls.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"launch step {name} differs from x + 1")
    out = {"x + 1.0": [time_launches(calls["x + 1.0"])]}
    for name, fn in calls.items():
        if name != "x + 1.0":
            out[name] = [time_launches(fn)]
            out["x + 1.0"].append(time_launches(calls["x + 1.0"]))
    return {k: min(v) for k, v in out.items()}


def measure(wbvh, lo, hi) -> dict:
    """{probe: ms per launch}."""
    return {k: time_launches(f) for k, f in probes(wbvh, lo, hi).items()}


LABELS = {"p1_1_block": "P1 copy, 1 block      ",
          "p1_64_blocks": "P1 copy, 64 blocks    ",
          "k1_closest_1k": "K1 closest, 1k rays   ",
          "k1_closest_64k": "K1 closest, 64k rays  "}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_launch_floor needs a CUDA card")
    print(f"card: {card_line()} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    wbvh, (lo, hi) = kitchen_bvh()
    for k, ms in measure(wbvh, lo, hi).items():
        print(f"{LABELS[k]}: {ms * 1e3:9.2f} us per launch ({REPS} back to "
              f"back, best of {BEST_OF})", flush=True)
    st = measure_steps()
    for k, ms in st.items():
        print(f"P1 host step {k:20s}: {ms * 1e3:9.2f} us per launch "
              f"({ms / st['x + 1.0']:.2f} x of x + 1.0)", flush=True)


if __name__ == "__main__":
    main()
