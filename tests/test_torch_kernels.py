"""Kernels K1 (fluctus_tpu_torch/csrc/traverse_stack.cu), K2 and K3
(csrc/traverse_brute.cu), K5 (csrc/traverse_forest.cu: the work queue in
one launch and the per-launch kernel), K4
(csrc/traverse_packet.cu) and the probes P1 and P2 (csrc/probes.cu) against
their plain versions, the launch helper (launch.py), the streaming
wavefront against the lockstep integrator through K1, the octant ray sort
around K1, env-lit frames, and PLY, PBRT, cached and NumPy-built scenes
through K1 and K2, on the card. These
need an NVIDIA card with nvcc, so they carry the `cuda` marker and skip
elsewhere; the file imports no JAX, so it runs on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""
import os

import numpy as np
import pytest
import torch

from fluctus_tpu_torch.ops import traverse_stack as ts
from fluctus_tpu_torch.scene.scene import load_scene

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    ts.load_kernel()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def kitchen(card):
    host = load_scene("assets/kitchen_proxy.obj")
    host.build_bvh(use_sbvh=True)
    return host, host.to_device(card).wbvh


def _rays(host, n, seed, device):
    g = np.random.default_rng(seed)
    lo, hi = host.bounds()
    o = (lo + (hi - lo) * g.random((n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.where(g.random(n) < 0.5, np.float32(3.4e38),
                 g.uniform(0.05, 3.0, n)).astype(np.float32)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
            torch.from_numpy(t).to(device))


def test_k1_closest_equals_plain(card, kitchen):
    host, w = kitchen
    o, d, t = _rays(host, 8192, 1, card)
    k = ts.traverse_kernel(w, o, d, t, any_hit=False)
    p, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
    torch.cuda.synchronize()
    # same visit order and -fmad=false arithmetic: bit-equal
    assert torch.equal(k.prim, p.prim)
    assert torch.equal(k.t, p.t)
    assert torch.equal(k.u, p.u) and torch.equal(k.v, p.v)


def test_k1_any_equals_plain(card, kitchen):
    host, w = kitchen
    o, d, t = _rays(host, 8192, 2, card)
    k = ts.traverse_kernel(w, o, d, t, any_hit=True)
    _, p = ts.traverse_plain(w, o, d, t, any_hit=True)
    assert torch.equal(k, p)


def test_k1_octant_sorted_equals_unsorted(card, kitchen, monkeypatch):
    """FLUCTUS_TRAV_SORT=octant around K1: 65,536 kitchen rays under a
    per-lane t_max, sorted by direction octant, walked and unsorted, give
    every field of the unsorted walk bit for bit, through one launch."""
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.integrators import common
    host, w = kitchen
    o, d, t = _rays(host, 1 << 16, 7, card)
    scene = host.to_device(card)
    monkeypatch.delenv("FLUCTUS_TRAV_SORT", raising=False)
    want = common._closest_tr(scene, RenderConfig(), o, d, t)
    monkeypatch.setenv("FLUCTUS_TRAV_SORT", "octant")
    ts.reset_counts()
    got = common._closest_tr(scene, RenderConfig(), o, d, t)
    assert ts.LAUNCHES["closest"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_k1_all_miss_at_f32_max(card, kitchen):
    _, w = kitchen
    o = torch.full((512, 3), 3.0e37, device=card)
    d = torch.tensor([0.0, 0.0, 1.0], device=card).expand(512, 3)
    r = ts.traverse_kernel(w, o, d.contiguous(), 3.4e38, any_hit=False)
    assert bool((r.prim == -1).all())


def test_k1_wrapper_refuses_bad_input(card, kitchen):
    _, w = kitchen
    o = torch.zeros((16, 3), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="K1"):
        ts.traverse_kernel(w, o, o, 1.0, any_hit=False)


def test_k1_counts_launches(card, kitchen):
    host, w = kitchen
    o, d, t = _rays(host, 256, 3, card)
    ts.reset_counts()
    ts.traverse_closest(w, o, d, t)
    ts.traverse_any(w, o, d, t)
    assert ts.LAUNCHES == {"closest": 1, "any": 1}
    assert ts.PLAIN_CALLS == {"closest": 0, "any": 0}


# ---------------------------------------------------------------- K2, K3
# Kernels K2 and K3 (fluctus_tpu_torch/csrc/traverse_brute.cu) against
# their plain versions through the same scheduler: the same visit slots
# reach both, so the results are bit-equal.

@pytest.fixture(scope="module")
def brute(card):
    from fluctus_tpu_torch.accel.forest import build_brute_forest
    from fluctus_tpu_torch.convert import brute_from_numpy
    from fluctus_tpu_torch.ops import traverse_brute as tb
    tb.load_kernel()
    host = load_scene("assets/kitchen_proxy.obj")
    hb = build_brute_forest(host.v0, host.v1, host.v2, target_tris=2048)
    bf = brute_from_numpy({f: getattr(hb, f) for f in
                           ("tris", "boxes", "boxes_t", "tboxes", "tile")},
                          device=card)
    return host, bf


def _brute_launchers(sched):
    from fluctus_tpu_torch.ops import traverse_brute as tb
    if sched == "vlist":
        return tb.vlaunch_kernel, tb.vlaunch_plain
    return tb.launch_kernel, tb.launch_plain


@pytest.mark.parametrize("sched", ["vlist", "rounds"])
def test_k2_k3_closest_equal_plain(card, brute, sched, monkeypatch):
    from fluctus_tpu_torch.ops import traverse_brute as tb
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", sched)
    host, bf = brute
    o, d, t = _rays(host, 4096, 4, card)
    kern, plain = _brute_launchers(sched)
    k, kx = tb.traverse_closest(bf, o, d, t, with_flag=True, launch=kern)
    p, px = tb.traverse_closest(bf, o, d, t, with_flag=True, launch=plain)
    torch.cuda.synchronize()
    assert not kx and not px
    assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t)
    assert torch.equal(k.u, p.u) and torch.equal(k.v, p.v)
    assert int((k.prim >= 0).sum()) > 100


@pytest.mark.parametrize("sched", ["vlist", "rounds"])
def test_k2_k3_any_equal_plain(card, brute, sched, monkeypatch):
    from fluctus_tpu_torch.ops import traverse_brute as tb
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", sched)
    host, bf = brute
    o, d, t = _rays(host, 4096, 5, card)
    kern, plain = _brute_launchers(sched)
    k = tb.traverse_any(bf, o, d, t, launch=kern)
    p = tb.traverse_any(bf, o, d, t, launch=plain)
    assert torch.equal(k, p) and 0 < int(k.sum()) < 4096


def test_k2_k3_count_launches_and_refuse_bad_input(card, brute, monkeypatch):
    from fluctus_tpu_torch.ops import traverse_brute as tb
    host, bf = brute
    o, d, t = _rays(host, 300, 6, card)      # pads to a block multiple
    tb.reset_counts()
    tb.traverse_closest(bf, o, d, t)
    tb.traverse_any(bf, o, d, t)
    assert tb.LAUNCHES["k2_closest"] > 0 and tb.LAUNCHES["k2_any"] > 0
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", "rounds")
    tb.traverse_closest(bf, o, d, t)
    assert tb.LAUNCHES["k3_closest"] > 0
    assert sum(tb.PLAIN_CALLS.values()) == 0
    with pytest.raises(ValueError, match="K2"):
        tb.vlaunch_kernel(torch.zeros(8, dtype=torch.int64, device=card),
                          torch.zeros(8, dtype=torch.int32, device=card),
                          bf.tris, bf.tboxes,
                          torch.zeros((128, 8), device=card),
                          *[torch.zeros((128, 1), dtype=dt, device=card)
                            for dt in (torch.float32, torch.int32,
                                       torch.float32, torch.float32)],
                          False, 128, bf.tile, 8, 1)


def test_k2_tie_layout_equals_plain(card):
    """Equal-t copies of one triangle across the team slices, pieces and
    pair slots of one 1,024-triangle group and in a later visit, and across
    the groups, CTAs and pieces of one visit (fixtures.LAYOUTS): K2 returns
    the lowest slot of the group listed first in the chunk visited first,
    bit-equal to its plain version, in both forms."""
    from fluctus_tpu_torch.convert import brute_from_numpy
    from fluctus_tpu_torch.fixtures import LAYOUTS, tie_forest
    from fluctus_tpu_torch.ops import traverse_brute as tb
    for layout in LAYOUTS:
        arrays, o, d, want = tie_forest(layout)
        bf = brute_from_numpy(arrays, device=card)
        o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
        k = tb.traverse_closest(bf, o, d, 3.4e38, launch=tb.vlaunch_kernel)
        p = tb.traverse_closest(bf, o, d, 3.4e38, launch=tb.vlaunch_plain)
        torch.cuda.synchronize()
        tie = torch.from_numpy(want >= 0).to(card)
        assert torch.equal(k.prim[tie].cpu(),
                           torch.from_numpy(want[want >= 0])), layout
        assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t), layout
        assert torch.equal(k.u, p.u) and torch.equal(k.v, p.v), layout
        ka = tb.traverse_any(bf, o, d, 9.5, launch=tb.vlaunch_kernel)
        pa = tb.traverse_any(bf, o, d, 9.5, launch=tb.vlaunch_plain)
        assert torch.equal(ka, pa) and bool(ka[tie].all()), layout


@pytest.mark.parametrize("form", ["closest", "any"])
def test_k3_tie_layouts_and_random_forest_equal_plain(card, form,
                                                      monkeypatch):
    """K3 against its plain version through the round loop, on both tie
    layouts of fixtures.LAYOUTS (every tie ray hits the expected copy) and
    on a forest of seeded random triangles whose chunk width is no
    multiple of the 512-triangle tile: bit-equal."""
    from fluctus_tpu_torch.accel.forest import build_brute_forest
    from fluctus_tpu_torch.convert import brute_from_numpy
    from fluctus_tpu_torch.fixtures import LAYOUTS, tie_forest
    from fluctus_tpu_torch.ops import traverse_brute as tb
    monkeypatch.setenv("FLUCTUS_BRUTE_SCHED", "rounds")
    any_hit = form == "any"
    g = np.random.default_rng(31)
    v0 = g.uniform(-2, 2, (3000, 3)).astype(np.float32)
    v1 = v0 + g.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32)
    v2 = v0 + g.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32)
    hb = build_brute_forest(v0, v1, v2, target_tris=320, tile=128)
    rnd = brute_from_numpy({f: getattr(hb, f) for f in
                            ("tris", "boxes", "boxes_t", "tboxes", "tile")},
                           device=card)
    assert rnd.tris.shape[2] % 512 and rnd.tris.shape[0] >= 4
    o = g.uniform(-3, 3, (4096, 3)).astype(np.float32)
    d = g.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.where(g.random(4096) < 0.5, np.float32(3.4e38),
                 g.uniform(0.5, 4.0, 4096)).astype(np.float32)
    cases = [(brute_from_numpy(a, device=card), o_, d_, t_, w)
             for layout in LAYOUTS
             for a, o_, d_, w in [tie_forest(layout)]
             for t_ in [np.full(len(o_), 9.5 if any_hit else 3.4e38,
                                np.float32)]]
    cases.append((rnd, o, d, t, None))
    trav = tb.traverse_any if any_hit else tb.traverse_closest
    for bf, o_, d_, t_, want in cases:
        o_, d_, t_ = (torch.from_numpy(x).to(card) for x in (o_, d_, t_))
        k = trav(bf, o_, d_, t_, launch=tb.launch_kernel)
        p = trav(bf, o_, d_, t_, launch=tb.launch_plain)
        torch.cuda.synchronize()
        if any_hit:
            assert torch.equal(k, p) and bool(k.any())
            if want is not None:
                assert bool(k[torch.from_numpy(want >= 0).to(card)].all())
            continue
        assert all(torch.equal(getattr(k, f), getattr(p, f))
                   for f in ("prim", "t", "u", "v"))
        assert int((k.prim >= 0).sum()) > 100
        if want is not None:
            tie = torch.from_numpy(want >= 0).to(card)
            assert torch.equal(k.prim[tie].cpu(),
                               torch.from_numpy(want[want >= 0]))


# ---------------------------------------------------------------- K5, K4
# Kernel K5 (csrc/traverse_forest.cu) against its plain version through
# the same scheduler, and K4 (csrc/traverse_packet.cu) against its plain
# version on the same packets: bit-equal.

@pytest.fixture(scope="module")
def treelet(card):
    from fluctus_tpu_torch.accel.forest import build_host_forest
    from fluctus_tpu_torch.core.types import ForestTables
    from fluctus_tpu_torch.ops import traverse_forest as tf
    tf.load_kernel()
    host = load_scene("assets/kitchen_proxy.obj")
    hf = build_host_forest(host.v0, host.v1, host.v2, target_tris=2048)
    ft = ForestTables(*(torch.from_numpy(x).to(card)
                        for x in (hf.nodes, hf.leaves, hf.boxes)),
                      lvl=hf.lvl, leaf_width=hf.leaf_width)
    return host, ft


@pytest.mark.parametrize("mode", ["workqueue", "blocksched"])
def test_k5_closest_equals_plain(card, treelet, mode):
    from fluctus_tpu_torch.ops import traverse_forest as tf
    host, ft = treelet
    o, d, t = _rays(host, 4096, 7, card)
    k = tf.traverse_closest(ft, o, d, t, mode=mode, launch=tf.launch_kernel)
    p = tf.traverse_closest(ft, o, d, t, mode=mode, launch=tf.launch_plain)
    torch.cuda.synchronize()
    assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t)
    assert torch.equal(k.u, p.u) and torch.equal(k.v, p.v)
    assert int((k.prim >= 0).sum()) > 100


@pytest.mark.parametrize("mode", ["workqueue", "blocksched"])
def test_k5_any_equals_plain(card, treelet, mode):
    from fluctus_tpu_torch.ops import traverse_forest as tf
    host, ft = treelet
    o, d, t = _rays(host, 4096, 8, card)
    k = tf.traverse_any(ft, o, d, t, mode=mode, launch=tf.launch_kernel)
    p = tf.traverse_any(ft, o, d, t, mode=mode, launch=tf.launch_plain)
    assert torch.equal(k, p) and 0 < int(k.sum()) < 4096


@pytest.mark.parametrize("form", ["closest", "any"])
def test_k5_queue_equals_plain(card, treelet, form):
    """K5's work queue in one launch (queue_kernel) against its plain
    version, the round loop over launch_plain: t, prim, u and v
    bit-equal."""
    from fluctus_tpu_torch.ops import traverse_forest as tf
    host, ft = treelet
    o, d, t = _rays(host, 4096, 13, card)
    any_hit = form == "any"
    k = tf.queue_kernel(ft, o, d, t, any_hit)
    p = tf.queue_plain(ft, o, d, t, any_hit)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert int((k[1] > 0).sum() if any_hit else (k[1] >= 0).sum()) > 100


def test_k5_queue_call_makes_one_launch_and_no_sync(card, treelet):
    """A work-queue traversal call launches K5 once and reads nothing back
    from the card: it runs under sync-debug mode "error", with a scalar
    and with a per-lane t_max."""
    from fluctus_tpu_torch.ops import traverse_forest as tf
    host, ft = treelet
    o, d, t = _rays(host, 4096, 14, card)
    want = tf.traverse_closest(ft, o, d, t)
    tf.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tf.traverse_closest(ft, o, d, t)
        blocked = tf.traverse_any(ft, o, d, t)
        tf.traverse_closest(ft, o, d, 3.4e38)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tf.LAUNCHES == {"closest": 2, "any": 1}
    assert sum(tf.PLAIN_CALLS.values()) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert 0 < int(blocked.sum()) < 4096


def test_k4_closest_equals_plain(card, kitchen):
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    host, w = kitchen
    o, d, t = _rays(host, 3000, 9, card)     # pads to 6 packets
    k = tp.traverse_closest(w, o, d, t, launch=tp.packet_kernel)
    p = tp.traverse_closest(w, o, d, t, launch=tp.packet_plain)
    torch.cuda.synchronize()
    assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t)
    assert torch.equal(k.u, p.u) and torch.equal(k.v, p.v)
    assert int((k.prim >= 0).sum()) > 100


def test_k4_any_equals_plain(card, kitchen):
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    host, w = kitchen
    o, d, t = _rays(host, 3000, 10, card)
    k = tp.traverse_any(w, o, d, t, launch=tp.packet_kernel)
    p = tp.traverse_any(w, o, d, t, launch=tp.packet_plain)
    assert torch.equal(k, p) and 0 < int(k.sum()) < 3000


@pytest.mark.parametrize("t_max", [3.4e38, 9.5])
def test_k1_k4_wide_tie_bvh_equal_plain(card, t_max):
    """The tie hierarchy of fluctus_tpu_torch/fixtures.py (equal-t copies
    in slots a K1 team deals to different lanes, in two leaves entered in a
    known order, in two leaves with equal entry distances; tie rays in
    every warp and every CTA of a K4 packet): K1 and K4 bit-equal to their
    plain versions, and every tie ray hits the copy each kernel's
    sequential rule picks."""
    from fluctus_tpu_torch.convert import wide_from_numpy
    from fluctus_tpu_torch.fixtures import wide_tie_bvh
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    arrays, o, d, want = wide_tie_bvh()
    w = wide_from_numpy(arrays, device=card)
    o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    t = torch.full((o.shape[0],), t_max, device=card)
    k1 = ts.traverse_kernel(w, o, d, t, any_hit=False)
    p1, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
    k4 = tp.traverse_closest(w, o, d, t, launch=tp.packet_kernel)
    p4 = tp.traverse_closest(w, o, d, t, launch=tp.packet_plain)
    torch.cuda.synchronize()
    for k, p, kern in ((k1, p1, "k1"), (k4, p4, "k4")):
        assert all(torch.equal(getattr(k, f), getattr(p, f))
                   for f in ("prim", "t", "u", "v")), kern
        tie = torch.from_numpy(want[kern] >= 0).to(card)
        assert torch.equal(k.prim[tie].cpu(),
                           torch.from_numpy(want[kern][want[kern] >= 0]))
    a1 = ts.traverse_kernel(w, o, d, t, any_hit=True)
    _, b1 = ts.traverse_plain(w, o, d, t, any_hit=True)
    a4 = tp.traverse_any(w, o, d, t, launch=tp.packet_kernel)
    b4 = tp.traverse_any(w, o, d, t, launch=tp.packet_plain)
    assert torch.equal(a1, b1) and torch.equal(a4, b4)
    assert torch.equal(a1, a4) and bool(a1.any())


def test_k4_k5_count_launches_and_refuse_bad_input(card, kitchen, treelet):
    from fluctus_tpu_torch.ops import traverse_forest as tf
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    host, w = kitchen
    _, ft = treelet
    o, d, t = _rays(host, 300, 11, card)
    tf.reset_counts()
    tp.reset_counts()
    tf.traverse_closest(ft, o, d, t)
    tf.traverse_any(ft, o, d, t, mode="blocksched")
    tp.traverse_closest(w, o, d, t)
    tp.traverse_any(w, o, d, t)
    assert tf.LAUNCHES["closest"] > 0 and tf.LAUNCHES["any"] > 0
    assert tp.LAUNCHES == {"closest": 1, "any": 1}
    assert sum(tf.PLAIN_CALLS.values()) + sum(tp.PLAIN_CALLS.values()) == 0
    z = torch.zeros((128, 3), device=card)
    zi = torch.zeros(128, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="K5"):        # chunk id out of range
        tf.launch_kernel(torch.full((1, 1), 99, dtype=torch.int32,
                                    device=card),
                         torch.zeros((1, 1), device=card), ft.nodes,
                         ft.leaves, z, z, z[:, 0], zi, z[:, 0], z[:, 0],
                         False, 128, ft.lvl, ft.leaf_width)
    with pytest.raises(ValueError, match="K4"):        # not a packet multiple
        tp.packet_kernel(z, z, z[:, 0], w, False)


# ---------------------------------------------------------------- P1, P2
# The probes (fluctus_tpu_torch/csrc/probes.cu) round as their plain
# versions do (the fused P2's plain version rounds once per step), so
# they are bit-equal.

def test_p1_equals_plain(card):
    from fluctus_tpu_torch.ops import probes
    g = torch.Generator(device=card).manual_seed(0)
    for rows in (8, 512):
        x = torch.rand((rows, 128), generator=g, device=card)
        assert torch.equal(probes.copy_plus_one_kernel(x), x + 1.0)


@pytest.mark.parametrize("fused", [False, True])
def test_p2_matches_plain(card, fused):
    from fluctus_tpu_torch.ops import probes
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.rand((512, 1024), generator=g, device=card) + 0.5
    k = probes.fma_chain_kernel(x, 64, fused)
    assert torch.equal(k, probes.fma_chain_plain(x, 64, fused))


def test_probes_count_launches_and_refuse_bad_input(card):
    from fluctus_tpu_torch.ops import probes
    probes.reset_counts()
    probes.copy_plus_one(torch.zeros((8, 128), device=card))
    probes.fma_chain(torch.zeros((8, 128), device=card), 2, fused=True)
    probes.fma_chain(torch.zeros((8, 128), device=card), 2, fused=False)
    assert probes.LAUNCHES == {"p1": 1, "p2_fused": 1, "p2_unfused": 1}
    assert sum(probes.PLAIN_CALLS.values()) == 0
    with pytest.raises(ValueError, match="P1"):
        probes.copy_plus_one_kernel(torch.zeros((7, 128), device=card))
    with pytest.raises(ValueError, match="P2"):
        probes.fma_chain_kernel(torch.zeros((3, 100), device=card), 2, True)


def test_launch_helper_p1_and_k1(card, kitchen):
    """P1 and K1 through the launch helper: right on the current and on a
    side stream; a CPU or a non-contiguous tensor raises before the launch,
    a launcher's non-zero result raises after it."""
    from fluctus_tpu_torch import launch
    from fluctus_tpu_torch.ops import probes
    x = torch.rand((64, 128), device=card)
    assert torch.equal(probes.copy_plus_one(x), x + 1.0)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = probes.copy_plus_one(x)
    side.synchronize()
    assert torch.equal(y, x + 1.0)
    with pytest.raises(ValueError, match="P1"):
        probes.copy_plus_one_kernel(x.cpu())
    with pytest.raises(ValueError, match="not contiguous"):
        probes.copy_plus_one_kernel(torch.rand((128, 64), device=card).t())
    host, w = kitchen
    o, d, t = _rays(host, 1024, 12, card)
    k = ts.traverse_kernel(w, o, d, t, any_hit=False)
    p, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
    assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t)
    with pytest.raises(ValueError, match="K1"):
        ts.traverse_kernel(w, o.cpu(), d.cpu(), t.cpu(), any_hit=False)
    with pytest.raises(ValueError, match="not contiguous"):
        ts.traverse_kernel(w, o.t().contiguous().t(), d, t, any_hit=False)
    with pytest.raises(RuntimeError, match="P1 launch failed"):
        launch.launch(probes.load_kernel().p1_copy_plus_one,
                      torch.cuda.current_device(), 0, 0)   # one arg short


# ---------------------------------------------------------------- stream
# Without next-event estimation the stream traces the lockstep's paths
# with the same random numbers: images agree to atol 1e-5 and the spawn
# count is exact. With it, deferred and immediate agree.

def test_stream_matches_lockstep_through_k1(card):
    import dataclasses
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.integrators import wavefront
    from fluctus_tpu_torch.render import driver
    cfg = RenderConfig(width=64, height=64, max_bounces=8,
                       use_area_light=True, use_env_map=False,
                       pool_size=1 << 12)
    s = driver.create_session("assets/kitchen_proxy.obj", cfg=cfg,
                              state_dir="data/states", auto_frame=False,
                              device=card)
    plain = dataclasses.replace(s, cfg=s.cfg.replace(sample_expl=False))
    ts.reset_counts()
    img_s, cnt = wavefront.render_stream(plain.scene, plain.params,
                                         plain.cfg, 2)
    img_l = driver.render(plain, 2, integrator="lockstep")
    assert float((img_s - img_l).abs().max()) <= 1e-5
    assert int(cnt[0]) == 64 * 64 * 2
    img_d, cnt_d = wavefront.render_stream(s.scene, s.params, s.cfg, 2,
                                           deferred=True)
    img_i, cnt_i = wavefront.render_stream(s.scene, s.params, s.cfg, 2)
    assert torch.allclose(img_d, img_i, rtol=1e-4, atol=1e-5)
    assert torch.equal(cnt_d, cnt_i)
    assert ts.LAUNCHES["closest"] > 0 and ts.LAUNCHES["any"] > 0
    assert sum(ts.PLAIN_CALLS.values()) == 0


# ---------------------------------------------------------------- deep
# Hierarchies deeper than the 128-entry walks hold: the chains of
# fluctus_tpu_torch/fixtures.py at wide depth 40 (K1 and K5 need
# 7 * 41 + 9 = 296 stack entries, K4 7 * 40 + 1 = 281 of its 449).

@pytest.mark.parametrize("order", ["near", "far"])
def test_k1_k4_deep_chain_equal_plain(card, order):
    from fluctus_tpu_torch.convert import wide_from_numpy
    from fluctus_tpu_torch.fixtures import deep_chain_bvh
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    arrays, o, d, _ = deep_chain_bvh(40, order)
    w = wide_from_numpy(arrays, device=card)
    o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    t = torch.full((o.shape[0],), 3.4e38, device=card)
    t2 = torch.where(torch.arange(o.shape[0], device=card) % 2 == 0, t, 6.0)
    k1 = ts.traverse_kernel(w, o, d, t, any_hit=False)
    p1, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
    k4 = tp.traverse_closest(w, o, d, t, launch=tp.packet_kernel)
    p4 = tp.traverse_closest(w, o, d, t, launch=tp.packet_plain)
    torch.cuda.synchronize()
    for k, p in ((k1, p1), (k4, p4)):
        assert all(torch.equal(getattr(k, f), getattr(p, f))
                   for f in ("prim", "t", "u", "v"))
    assert int((k1.prim >= 0).sum()) > o.shape[0] // 2
    assert torch.equal(ts.traverse_kernel(w, o, d, t2, any_hit=True),
                       ts.traverse_plain(w, o, d, t2, any_hit=True)[1])
    assert torch.equal(tp.traverse_any(w, o, d, t2, launch=tp.packet_kernel),
                       tp.traverse_any(w, o, d, t2, launch=tp.packet_plain))


@pytest.mark.parametrize("form", ["closest", "any"])
def test_k5_deep_chain_forest_equals_plain(card, form):
    """Chunks of wide depth 40 take the 464-entry walk, in the work queue
    and in the passes."""
    from fluctus_tpu_torch.convert import forest_from_numpy
    from fluctus_tpu_torch.fixtures import deep_chain_forest
    from fluctus_tpu_torch.ops import traverse_forest as tf
    tf.load_kernel()
    arrays, o, d, _ = deep_chain_forest(40)
    ft = forest_from_numpy(arrays, device=card)
    o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    t = torch.full((o.shape[0],), 3.4e38, device=card)
    ob, db, tv, b = tf._prep(o, d, t, tf.WQ_BLK)
    any_hit = form == "any"
    k = tf.queue_kernel(ft, ob, db, tv, any_hit)
    p = tf.queue_plain(ft, ob, db, tv, any_hit)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(k, p))
    fn = tf.traverse_any if any_hit else tf.traverse_closest
    kb = fn(ft, o, d, t, mode="blocksched")
    pb = fn(ft, o, d, t, mode="blocksched", launch=tf.launch_plain)
    if any_hit:
        assert torch.equal(kb, pb) and bool(kb.any())
    else:
        assert torch.equal(kb.prim, pb.prim) and torch.equal(kb.t, pb.t)


# ---------------------------------------------------------------- env map
# Env-map lighting on the card: its ops are PyTorch's (no kernel of its
# own); the frames trace through K1 and K4.

def _sky_session(tmp_path, device, backend="auto"):
    import dataclasses
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.fixtures import sky_env
    from fluctus_tpu_torch.io.hdr import write_hdr
    from fluctus_tpu_torch.render import driver
    path = str(tmp_path / "sky.hdr")
    if not (tmp_path / "sky.hdr").exists():
        write_hdr(path, sky_env(64, 32, seed=3, sun_texels=1.5))
    cfg = RenderConfig(width=32, height=32, max_bounces=4, backend=backend)
    s = driver.create_session("assets/luxball_proxy.obj", path, cfg,
                              state_dir=None, device=device)
    cam = dataclasses.replace(s.params.camera, aperture_size=torch.tensor(
        0.06, device=s.device))
    return dataclasses.replace(s, params=dataclasses.replace(s.params,
                                                             camera=cam))


def test_env_ops_on_the_card_equal_cpu(card, tmp_path):
    """Alias draws pick the same texels on the card as on the CPU, and
    directions, radiance and pdfs agree within the tolerances the CPU
    tests hold against the JAX package (CUDA's atan2, acos, sin and cos
    are not the CPU's)."""
    from fluctus_tpu_torch.ops import envmap as env_ops
    s = _sky_session(tmp_path, card)
    env_g = s.scene.envmap
    env_c = _sky_session(tmp_path, "cpu").scene.envmap
    for f in ("image", "pdf_table", "prob_table", "alias_table"):
        assert torch.equal(getattr(env_g, f).cpu(), getattr(env_c, f))
    g = np.random.default_rng(5)
    u = torch.from_numpy(g.uniform(size=1 << 16).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(1 << 16, 3)).astype(np.float32))
    ig, Lg, pg = env_ops._alias_draw(env_g, u.to(card))
    ic, Lc, pc = env_ops._alias_draw(env_c, u)
    assert torch.equal(ig.cpu(), ic)
    torch.testing.assert_close(Lg.cpu(), Lc, rtol=0, atol=2e-6)
    torch.testing.assert_close(pg.cpu(), pc, rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(env_ops.direction_to_uv(d.to(card)).cpu(),
                               env_ops.direction_to_uv(d), rtol=0, atol=2e-6)
    torch.testing.assert_close(env_ops.eval_dir(env_g, d.to(card)).cpu(),
                               env_ops.eval_dir(env_c, d), rtol=1e-3,
                               atol=1e-6)
    torch.testing.assert_close(env_ops.pdf_dir(env_g, d.to(card)).cpu(),
                               env_ops.pdf_dir(env_c, d), rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_env_lit_frame_on_the_card_equals_cpu(card, tmp_path, backend):
    """A 32x32 env-lit luxball frame (4 bounces, 2 spp, the lockstep)
    through K1 (backend auto) or K4 (pallas) equals the same frame on the
    CPU through the plain versions at the goldens' RTOL 1e-3 / ATOL 1e-4
    on 99.5 % of its pixels, mean relative error 1e-4."""
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.render import driver
    s_g = _sky_session(tmp_path, card, backend)
    s_c = _sky_session(tmp_path, "cpu", backend)
    ts.reset_counts()
    tp.reset_counts()
    img_g = driver.render(s_g, 2, integrator="lockstep").cpu().numpy()
    kern = tp if backend == "pallas" else ts
    assert kern.LAUNCHES["closest"] > 0 and kern.LAUNCHES["any"] > 0
    img_c = driver.render(s_c, 2, integrator="lockstep").numpy()
    within = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1)
    mean_rel = np.abs(img_g - img_c).mean() / np.abs(img_c).mean()
    assert within.mean() >= 0.995 and mean_rel <= 1e-4, (within.mean(),
                                                          mean_rel)


# ------------------------------------------------------------ scene formats
# PLY, PBRT and PBF scenes, the hierarchy cache and the NumPy builders on the
# card: host code, traced by K1 and K2.

def _held(img_g, img_c):
    within = np.isclose(img_g, img_c, rtol=1e-3, atol=1e-4).all(-1)
    mean_rel = np.abs(img_g - img_c).mean() / np.abs(img_c).mean()
    assert within.mean() >= 0.995 and mean_rel <= 1e-4, (within.mean(),
                                                          mean_rel)
    assert float(img_c.mean()) > 1e-3


def _grid_session(tmp_path, device, grid=3):
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.fixtures import sky_env, sphere_grid_ply
    from fluctus_tpu_torch.io.hdr import write_hdr
    from fluctus_tpu_torch.render import driver
    ply, sky = tmp_path / f"grid{grid}.ply", tmp_path / "sky.hdr"
    if not ply.exists():
        sphere_grid_ply(str(ply), grid, 3, seed=0)
        write_hdr(str(sky), sky_env(64, 32, seed=3, sun_texels=1.5))
    cfg = RenderConfig(width=32, height=32, max_bounces=2,
                       use_area_light=False)
    return driver.create_session(str(ply), str(sky), cfg, cache_dir=None,
                                 state_dir=None, device=device)


def test_ply_frame_on_the_card_equals_cpu(card, tmp_path):
    """A 32x32 env-lit frame of the grid-3 sphere PLY (34,560 tris, under
    the cutover: K1 over its hierarchy) equals the CPU's at the goldens'
    limits."""
    from fluctus_tpu_torch.render import driver
    s_g = _grid_session(tmp_path, card)
    assert s_g.host_scene.n_tris == 34560 and s_g.scene.wbvh is not None
    ts.reset_counts()
    img_g = driver.render(s_g, 2, integrator="lockstep").cpu().numpy()
    assert ts.LAUNCHES["closest"] > 0 and ts.LAUNCHES["any"] > 0
    img_c = driver.render(_grid_session(tmp_path, "cpu"), 2,
                          integrator="lockstep").numpy()
    _held(img_g, img_c)


def test_pbrt_cornell_frame_on_the_card_equals_cpu(card, tmp_path,
                                                   monkeypatch):
    """The cornell written as PBRT with its quad emitter: the session takes
    the file's area light, and a 32x32 stream frame without implicit light
    hits (the emitter's triangles lie in the light's plane, see
    chip_smoke.py's pbf phase) through K1's fused call equals the CPU's."""
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.fixtures import scene_pbrt
    from fluctus_tpu_torch.render import driver
    monkeypatch.chdir(tmp_path)
    path = scene_pbrt(f"{REPO}/assets/cornell_proxy.obj", str(tmp_path), {
        "pos": [0.0, 3.95, 0.0], "right": [1.0, 0.0, 0.0],
        "up": [0.0, 0.0, -1.0], "normal": [0.0, -1.0, 0.0],
        "size": [1.0, 1.0], "emission": [15.0, 15.0, 15.0]})
    cfg = RenderConfig(width=32, height=32, max_bounces=4,
                       use_env_map=False, sample_impl=False)
    imgs = []
    for dev in (card, "cpu"):
        s = driver.create_session(path, cfg=cfg, cache_dir=None,
                                  state_dir=None, device=dev)
        assert s.cfg.use_area_light
        imgs.append(driver.render(s, 2, integrator="stream").cpu().numpy())
    _held(*imgs)


def test_k2_on_a_ply_scene_equals_plain(card, tmp_path, monkeypatch):
    """The grid-3 PLY above a lowered cutover uploads as a brute forest:
    K2 equals its plain version on the frame's primary rays."""
    from fluctus_tpu_torch.integrators import common
    from fluctus_tpu_torch.ops import camera
    from fluctus_tpu_torch.ops import traverse_brute as tb
    monkeypatch.setenv("FLUCTUS_FAST_BIG_MIN_TRIS", "10000")
    tb.load_kernel()
    s = _grid_session(tmp_path, card)
    bf = s.scene.bforest
    assert bf is not None and s.scene.wbvh is None
    pix = torch.arange(0, 1024, device=card, dtype=torch.int32)
    half = torch.full(pix.shape, 0.5, device=card)
    zero = torch.zeros(pix.shape, device=card)
    o, d = camera.generate_rays(s.params.camera, pix, 32, 32, half, half,
                                zero, zero, s.params.world_radius)
    t = torch.full((1024,), common.T_MAX, device=card)
    k = tb.traverse_closest(bf, o, d, t, launch=tb.vlaunch_kernel)
    p = tb.traverse_closest(bf, o, d, t, launch=tb.vlaunch_plain)
    torch.cuda.synchronize()
    assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t)
    assert torch.equal(k.u, p.u) and torch.equal(k.v, p.v)
    assert int((k.prim >= 0).sum()) > 100


@pytest.mark.parametrize("route", ["cached", "numpy"])
def test_cached_and_numpy_hierarchies_through_k1(card, tmp_path,
                                                 monkeypatch, route):
    """The cornell's hierarchy read back from the npz cache, or built by
    the NumPy SAH builder under FLUCTUS_NATIVE=0, traced by K1 bit-equal
    to the plain version."""
    from fluctus_tpu_torch.render import driver
    if route == "numpy":
        monkeypatch.setenv("FLUCTUS_NATIVE", "0")
    kw = dict(use_sbvh=route == "cached", cache_dir=str(tmp_path)
              if route == "cached" else None, state_dir=None, device=card)
    s = driver.create_session("assets/cornell_proxy.obj", **kw)
    if route == "cached":
        s = driver.create_session("assets/cornell_proxy.obj", **kw)
        assert len(list(tmp_path.iterdir())) == 1
    o, d, t = _rays(s.host_scene, 8192, 6, card)
    w = s.scene.wbvh
    k = ts.traverse_kernel(w, o, d, t, any_hit=False)
    p, _ = ts.traverse_plain(w, o, d, t, any_hit=False)
    ka = ts.traverse_kernel(w, o, d, t, any_hit=True)
    _, pa = ts.traverse_plain(w, o, d, t, any_hit=True)
    torch.cuda.synchronize()
    assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t)
    assert torch.equal(k.u, p.u) and torch.equal(k.v, p.v)
    assert torch.equal(ka, pa)


def _kitchen_session(device, size=32, backend="auto"):
    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver
    cfg = RenderConfig(width=size, height=size, max_bounces=2,
                       use_env_map=False, use_area_light=True,
                       backend=backend)
    return driver.create_session("assets/kitchen_proxy.obj", cfg=cfg,
                                 state_dir="data/states", auto_frame=False,
                                 cache_dir=None, device=device)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_aux_buffers_on_the_card_equal_plain(card, backend):
    """render_aux through K1 (one closest launch a tile) or K4 against the
    same buffers from the plain walk (backend "wide") on the card: depth
    at rtol 1e-6, albedo and normal bit-equal except where the two
    stopped on different triangles at equal t (K4's tie rule is not
    K1's)."""
    import dataclasses
    from fluctus_tpu_torch.integrators import common
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    from fluctus_tpu_torch.render import driver
    s = _kitchen_session(card, backend=backend)
    mod = tp if backend == "pallas" else ts
    mod.reset_counts()
    got = driver.render_aux(s)
    torch.cuda.synchronize()
    assert mod.LAUNCHES["closest"] >= 1 and mod.LAUNCHES["any"] == 0
    plain = dataclasses.replace(s, cfg=s.cfg.replace(backend="wide"))
    want = driver.render_aux(plain)
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0.0)
    tie = ((got[0] != want[0]) | (got[1] != want[1])).any(-1)
    assert float(tie.float().mean()) < 0.01
    assert torch.equal(got[0][~tie], want[0][~tie])
    assert torch.equal(got[1][~tie], want[1][~tie])
    if backend == "auto":
        assert not bool(tie.any())
    assert common.resolve_backend(backend) == s.cfg.backend


def test_pick_one_ray_through_k1(card):
    """pick is a batch of one ray: K1 takes B = 1 and agrees with the
    plain walk; pick_dof_depth sets the focal distance."""
    from fluctus_tpu_torch.render import state
    s = _kitchen_session(card)
    ts.reset_counts()
    t, prim = state.pick(s.scene, s.params, s.cfg, 0.5, 0.5)
    assert ts.LAUNCHES["closest"] == 1 and prim >= 0
    cpu = _kitchen_session("cpu")
    t_cpu, prim_cpu = state.pick(cpu.scene, cpu.params, cpu.cfg, 0.5, 0.5)
    assert prim == prim_cpu and t == pytest.approx(t_cpu, rel=1e-6)
    for b in (1, 3, 13):
        o = s.params.camera.pos.expand(b, 3).contiguous()
        d = torch.nn.functional.normalize(torch.randn(
            b, 3, generator=torch.Generator().manual_seed(b)), dim=1).to(card)
        k = ts.traverse_kernel(s.scene.wbvh, o, d, 3.4e38, any_hit=False)
        p, _ = ts.traverse_plain(s.scene.wbvh, o, d, 3.4e38, any_hit=False)
        assert torch.equal(k.prim, p.prim) and torch.equal(k.t, p.t)
    p2 = state.pick_dof_depth(s.scene, s.params, s.cfg)
    assert float(p2.camera.focal_dist) == np.float32(t)


@pytest.fixture(scope="module")
def packet_forest(card, kitchen):
    """The kitchen's packet forest at a 256 KB chunk budget (the scene's
    own tables stay under the 8 MB forest threshold)."""
    from fluctus_tpu_torch.accel.forest import build_binary
    from fluctus_tpu_torch.accel.wide import build_wide_forest
    from fluctus_tpu_torch.scene.scene import pad_forest
    host, _ = kitchen
    hosts, maps = build_wide_forest(host.v0, host.v1, host.v2, build_binary,
                                    budget_bytes=256 << 10)
    to = lambda a: torch.as_tensor(a, device=card)
    return host, pad_forest(hosts, to), tuple(to(m) for m in maps)


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_forest_walks_equal_plain(card, packet_forest, kernel):
    """Each forest walk on the card, one launch a chunk in each form,
    against the same loop over the plain version."""
    from fluctus_tpu_torch.ops import traverse_pallas as tp
    host, chunks, maps = packet_forest
    o, d, t = _rays(host, 4096, 21, card)
    if kernel == "k1":
        ts.reset_counts()
        k = ts.traverse_closest_forest(chunks, maps, o, d, t)
        kb = ts.traverse_any_forest(chunks, o, d, t)
        counts = dict(ts.LAUNCHES)
        p = ts.closest_forest_plain(chunks, maps, o, d, t)
        pb = ts.any_forest_plain(chunks, o, d, t)
    else:
        tp.reset_counts()
        k = tp.traverse_closest_forest(chunks, maps, o, d, t)
        kb = tp.traverse_any_forest(chunks, o, d, t)
        counts = dict(tp.LAUNCHES)
        p = tp.traverse_closest_forest(chunks, maps, o, d, t,
                                       launch=tp.packet_plain)
        pb = tp.traverse_any_forest(chunks, o, d, t, launch=tp.packet_plain)
    torch.cuda.synchronize()
    assert counts == {"closest": len(chunks), "any": len(chunks)}
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert torch.equal(kb, pb) and 0 < int(kb.sum()) < 4096
    assert int((k.prim >= 0).sum()) > 1000


def test_sharded_renders_on_the_card(card):
    """Four shards on the one card: the lockstep stripes bit-equal to the
    whole frame, the sharded stream within rtol 1e-5 / atol 1e-6 of the
    single-device stream, its spawns covering the padded frame."""
    from fluctus_tpu_torch.fixtures import plane_session
    from fluctus_tpu_torch.integrators import lockstep, wavefront
    from fluctus_tpu_torch.parallel import mesh as pmesh
    s = plane_session("cuda", size=23, max_bounces=2)
    m = pmesh.make_mesh([card] * 4)
    img = pmesh.render_sharded(s.scene, s.params, s.cfg, 2, m)
    assert torch.equal(img, lockstep.render(s.scene, s.params, s.cfg, 2))
    got, counters = pmesh.render_stream_sharded(s.scene, s.params, s.cfg, 2,
                                                m)
    want, _ = wavefront.render_stream(s.scene, s.params, s.cfg, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert int(counters[:, 0].sum()) == -(-23 * 23 // 4) * 4 * 2
