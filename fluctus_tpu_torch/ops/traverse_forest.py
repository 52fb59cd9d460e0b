"""Treelet-forest traversal of big scenes: kernel K5, its plain version and
the two schedulers that feed it (counterpart of
`fluctus_tpu/ops/traverse_forest.py`).

The scene is a `ForestTables` (accel/forest.py `build_host_forest`): one
8-wide BVH per spatial chunk, all rooted at node 0, with global triangle
ids. Inside a chunk visit a lane walks the chunk with K1's near-first
stack walk under its best t as t_max, and keeps the carried (t, prim, u,
v) unless the chunk holds a nearer hit. Two schedulers decide which chunks
a ray visits:

- the work queue (mode "workqueue", the default and the integrator's
  path): every ray walks its chunks in (entry, id) order from the cursor
  (-1, -1), the next being the nearest after its cursor whose entry beats
  its best t (any-hit: none once blocked). On the card `queue_kernel` runs
  the whole queue in one launch, one thread per ray, with no host read
  and the rays as given. Its plain version `queue_plain` is the round
  loop (`_run_workqueue`) over `launch_plain`: in each round every live
  ray visits its next chunk; rays sort by (chunk, octant), each chunk's
  segment pads to a block of WQ_BLK rays, so a block holds one chunk, and
  one launch runs the round; the loop ends when no ray has a next chunk (a
  host read per round). A ray's result depends only on its own visits, so
  the two agree bit for bit (csrc/traverse_forest.cu says why).
- the passes (`_run_passes`, mode "blocksched"): rays sort by octant and
  Morton code; every block of BLK rays gets the chunks its lanes hit,
  ordered by the block's least entry, and each pass visits the next
  K_CHUNKS of them in one launch of K5's `forest_kernel`
  (`launch_kernel`), a schedule `sel`/`ent` of shape (nb, K): ray block b
  visits chunks sel[b, 0..K-1] in order, and a lane skips a visit whose
  entry distance ent[b, k] does not beat its best t (or, in any-hit form,
  once it is blocked); until no block has a chunk nearer than its worst
  live lane.

`launch_plain` and `launch_kernel` share one signature, and so do
`queue_plain` and `queue_kernel`; the entry points take the plain
versions for CPU tensors and the kernels for CUDA tensors, with no
fallback between the two. A `launch` passed to the entry points runs the
work queue as the round loop over that per-launch wrapper (the
per-round design on the card). K5 reuses K1's walk (csrc/wide_walk.cuh)
and the plain version K1's plain walk over a per-chunk view, both built
alike, so the two agree bit for bit.

Deliberate difference from the JAX package: `_next_chunk` considers real
chunks only. The JAX scheduler pads the chunk list with degenerate boxes
at (3e37, 3e37, 3e37) that a ray with an exactly diagonal direction
"hits"; it then visits a chunk id >= C and merges a dead slot's output
(t 0, prim 0) into the ray, a phantom hit at the origin (ROADMAP Queue 3).
"""
from __future__ import annotations

import os

import torch

from fluctus_tpu_torch.core.types import ForestTables, WideBVH
from fluctus_tpu_torch.launch import CSRC, check, launch, load_library
from fluctus_tpu_torch.ops import ray_sort
from fluctus_tpu_torch.ops.traverse_brute import _octant, _prep, _slab
from fluctus_tpu_torch.ops.traverse_stack import (
    MAX_STACK, WALK_HEADER, Traversal, _inv_dir as _safe_inv, stack_entries,
    traverse_plain)

BLK = 1024        # rays per block of the passes' schedule
K_CHUNKS = 8      # chunk visits per pass
WQ_BLK = 128      # rays per block of the round loop
THREADS = 128     # threads per CUDA block (kThreads of the CUDA source)
INF = float("inf")
INT_MAX = 0x7FFFFFFF
MODES = ("workqueue", "blocksched")

# kernel launches and plain-version calls per form; chip_smoke.py zeroes
# these before a frame and reads them after it
LAUNCHES = {"closest": 0, "any": 0}
PLAIN_CALLS = {"closest": 0, "any": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _form(any_hit: bool) -> str:
    return "any" if any_hit else "closest"


# ---------------------------------------------------------------- schedule

def _chunk_slabs(boxes, orig, inv, t_lane):
    """(B, C) clamped entry distance of every ray into every chunk box and
    whether the box is hit with its raw entry below the lane's t."""
    tmn, tmx = _slab([boxes[:, k] for k in range(3)],
                     [boxes[:, 3 + k] for k in range(3)],
                     [orig[:, k:k + 1] for k in range(3)],
                     [inv[:, k:k + 1] for k in range(3)])
    hit = (tmx >= 0.0) & (tmn <= tmx) & (tmn < t_lane[:, None])
    return torch.clamp(tmn, min=0.0), hit


def _block_entries(boxes, orig, dir, t_vec, blk: int):
    """(nb, C) least entry distance into each chunk over a block's lanes,
    +inf where no lane hits the chunk."""
    e, hit = _chunk_slabs(boxes, orig, _safe_inv(dir), t_vec)
    e = torch.where(hit, e, INF)
    return e.reshape(-1, blk, e.shape[1]).amin(1)


def _schedule(ft: ForestTables, orig, dir, t_vec, blk: int, kk: int):
    """Per block, the chunks sorted by entry (stable): (order (nb, Cp)
    int32, entries (nb, Cp) f32, C), padded to a multiple of kk with the
    last chunk at entry +inf."""
    entries = _block_entries(ft.boxes, orig, dir, t_vec, blk)
    c = entries.shape[1]
    order = torch.argsort(entries, dim=1, stable=True)
    ent = torch.gather(entries, 1, order)
    cpad = (-c) % kk
    if cpad:
        order = torch.cat([order, order[:, -1:].expand(-1, cpad)], 1)
        ent = torch.cat([ent, torch.full((ent.shape[0], cpad), INF,
                                         device=ent.device)], 1)
    return order.to(torch.int32), ent, c


def _next_chunk(boxes, orig, inv, best_t, cur_e, cur_c):
    """Per ray, the (entry, chunk) that follows the cursor (cur_e, cur_c)
    in (entry, id) order among the real chunks whose entry is below
    best_t: (entry f32, +inf for none; chunk int64, -1 for none)."""
    c = boxes.shape[0]
    tl = torch.full_like(best_t, INF)
    e, hit = _chunk_slabs(boxes, orig, inv, tl)
    cid = torch.arange(c, device=orig.device)
    cand = hit & (e < best_t[:, None]) & (
        (e > cur_e[:, None])
        | ((e == cur_e[:, None]) & (cid > cur_c[:, None])))
    e_m = torch.where(cand, e, INF)
    e_best = e_m.amin(1)
    c_best = torch.where(cand & (e_m == e_best[:, None]), cid,
                         INT_MAX).amin(1)
    return e_best, torch.where(torch.isfinite(e_best), c_best, -1)


def _run_workqueue(ft: ForestTables, orig, dir, t_vec, any_hit: bool,
                   blk: int, launch, rounds: list | None = None):
    """Round loop (see module docstring). Returns (t, prim or blocked, u,
    v) per ray; appends the round count to `rounds` if given."""
    dev = orig.device
    c = ft.boxes.shape[0]
    bb = orig.shape[0]
    inv = _safe_inv(dir)
    cap = bb + c * blk            # padded-segment slot bound
    nb = cap // blk
    sel_ent = torch.zeros((nb, 1), dtype=torch.float32, device=dev)
    bt = t_vec.clone()
    bp = torch.zeros(bb, dtype=torch.int32, device=dev) if any_hit \
        else torch.full((bb,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(bb, device=dev)
    bv = torch.zeros(bb, device=dev)
    cur_e = torch.full((bb,), -1.0, device=dev)
    cur_c = torch.full((bb,), -1, dtype=torch.int64, device=dev)
    ne, nc = _next_chunk(ft.boxes, orig, inv, bt, cur_e, cur_c)
    octant = _octant(dir)
    chunks = torch.arange(c + 1, device=dev)
    n_rounds = 0
    while bool((nc >= 0).any()):
        live = nc >= 0
        key = torch.where(live, nc * 8 + octant, c * 8)
        order = torch.argsort(key, stable=True)
        rank = torch.argsort(order, stable=True)
        ch_sorted = (key[order] // 8).contiguous()
        starts = torch.searchsorted(ch_sorted, chunks)
        count = starts[1:] - starts[:-1]              # live rays per chunk
        ps = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        torch.cumsum(-(-count // blk) * blk, 0)])
        # block -> chunk: padding makes every block a single-chunk block
        bpos = torch.arange(nb, device=dev) * blk
        cb = (torch.searchsorted(ps, bpos, right=True) - 1).clamp(0, c - 1)
        # slot -> ray; dead pad slots enter with t 0 and take no step
        c_slot = cb.repeat_interleave(blk)
        j = torch.arange(cap, device=dev) - ps[c_slot]
        dead = (j < 0) | (j >= count[c_slot])
        ray = torch.where(dead, 0,
                          order[(starts[c_slot] + j).clamp(0, bb - 1)])
        ot, op, ou, ov = launch(
            cb[:, None].to(torch.int32).contiguous(), sel_ent, ft.nodes,
            ft.leaves, orig[ray].contiguous(), dir[ray].contiguous(),
            torch.where(dead, 0.0, bt[ray]).contiguous(),
            torch.where(dead, 0, bp[ray]).contiguous(),
            bu[ray].contiguous(), bv[ray].contiguous(), any_hit, blk,
            ft.lvl, ft.leaf_width)
        # merge: live ray r sits at slot ps[nc] + (rank - starts[nc])
        nc_cl = nc.clamp(0, c - 1)
        slot = (ps[nc_cl] + (rank - starts[nc_cl])).clamp(0, cap - 1)
        bt = torch.where(live, ot[slot], bt)
        bp = torch.where(live, op[slot], bp)
        bu = torch.where(live, ou[slot], bu)
        bv = torch.where(live, ov[slot], bv)
        cur_e = torch.where(live, ne, cur_e)
        cur_c = torch.where(live, nc, cur_c)
        eff_t = torch.where(bp > 0, 0.0, bt) if any_hit else bt
        ne, nc = _next_chunk(ft.boxes, orig, inv, eff_t, cur_e, cur_c)
        n_rounds += 1
    if rounds is not None:
        rounds.append(n_rounds)
    return bt, bp, bu, bv


def _run_passes(ft: ForestTables, orig, dir, t_vec, any_hit: bool,
                blk: int, kk: int, launch, rounds: list | None = None):
    """Block-scheduled passes (see module docstring). Returns (t, prim or
    blocked, u, v) per ray; appends the pass count to `rounds` if given."""
    dev = orig.device
    bb = orig.shape[0]
    nb = bb // blk
    order, ent, c = _schedule(ft, orig, dir, t_vec, blk, kk)
    t = t_vec.clone()
    p = torch.zeros(bb, dtype=torch.int32, device=dev) if any_hit \
        else torch.full((bb,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(bb, device=dev)
    v = torch.zeros(bb, device=dev)
    off = 0
    while off < c:
        cur = torch.where(p > 0, 0.0, t) if any_hit else t
        if not bool((ent[:, off] < cur.reshape(nb, blk).amax(1)).any()):
            break
        t, p, u, v = launch(order[:, off:off + kk].contiguous(),
                            ent[:, off:off + kk].contiguous(), ft.nodes,
                            ft.leaves, orig, dir, t, p, u, v, any_hit, blk,
                            ft.lvl, ft.leaf_width)
        off += kk
    if rounds is not None:
        rounds.append(off // kk)
    return t, p, u, v


# ---------------------------------------------------------------- plain

def chunk_view(ft_nodes, ft_leaves, c: int, lvl: int,
               leaf_width: int) -> WideBVH:
    """Chunk c of the stacked tables as a WideBVH rooted at node 0."""
    return WideBVH(nodes=ft_nodes[c], leaves=ft_leaves[c], root_ref=0,
                   depth=lvl - 1, leaf_width=leaf_width)


def launch_plain(sel, ent, nodes, leaves, orig, dir, it, ip, iu, iv,
                 any_hit: bool, blk: int, lvl: int, leaf_width: int,
                 stats: dict | None = None):
    """K5's plain version: for each schedule column k and each chunk in it,
    K1's plain walk of the chunk for the live lanes under their best t,
    merged with the carried hit. Returns new (t, prim or blocked, u, v).
    With `stats`, K1's visit counts (traverse_plain) summed over visits,
    and the set of chunk ids walked ("chunks_walked")."""
    PLAIN_CALLS[_form(any_hit)] += 1
    dev = orig.device
    bt, bp, bu, bv = it.clone(), ip.clone(), iu.clone(), iv.clone()
    if any_hit:
        bp = (bp > 0).to(torch.int32)
    b_of = torch.arange(orig.shape[0], device=dev) // blk
    for k in range(sel.shape[1]):
        s_k = sel[b_of, k].long()
        live = ent[b_of, k] < bt
        if any_hit:
            live &= bp <= 0
        for c in torch.unique(s_k[live]).tolist():
            lanes = (live & (s_k == c)).nonzero()[:, 0]
            if stats is not None:
                stats.setdefault("chunks_walked", set()).add(c)
            view = chunk_view(nodes, leaves, c, lvl, leaf_width)
            tr, blocked = traverse_plain(view, orig[lanes], dir[lanes],
                                         bt[lanes], any_hit, stats=stats)
            if any_hit:
                bp[lanes] = torch.where(blocked, 1, bp[lanes])
            else:
                keep = tr.prim >= 0
                got = lanes[keep]
                bt[got] = tr.t[keep]
                bp[got] = tr.prim[keep]
                bu[got] = tr.u[keep]
                bv[got] = tr.v[keep]
    return bt, bp, bu, bv


# ---------------------------------------------------------------- kernel

_SRC = os.path.join(CSRC, "traverse_forest.cu")
_lib = None
BUILD_INFO: dict = {}


def load_kernel():
    """Build (at first use) and load the K5 library."""
    global _lib
    if _lib is None:
        _lib = load_library(_SRC, "k5_forest",
                            {"k5_forest": "K5", "k5_queue": "K5"},
                            deps=[WALK_HEADER], info=BUILD_INFO)
    return _lib


def _check_forest(kern, nodes, leaves, lvl, leaf_width):
    """Checks the chunk tables; returns (c, tp, lp, cap), cap the stack
    entries a chunk walk needs (the launcher runs the 128-entry walk up to
    wide depth 16, the 464-entry one above)."""
    c, tp = nodes.shape[0], nodes.shape[1]
    lp = leaves.shape[1]
    check(kern, "nodes", nodes, torch.float32, (c, tp, 56))
    check(kern, "leaves", leaves, torch.float32, (c, lp, leaf_width, 10))
    cap = stack_entries(lvl - 1)
    if cap > MAX_STACK:
        raise ValueError(f"{kern}: chunk depth {lvl - 1} needs {cap} stack "
                         f"entries, more than {MAX_STACK}")
    return c, tp, lp, cap


def _check_rays(kern, bb, orig, dir, *per_ray):
    check(kern, "orig", orig, torch.float32, (bb, 3))
    check(kern, "dir", dir, torch.float32, (bb, 3))
    for name, x, dt in per_ray:
        check(kern, name, x, dt, (bb,))


def _new_outputs(bb, dev):
    return (torch.empty(bb, dtype=torch.float32, device=dev),
            torch.empty(bb, dtype=torch.int32, device=dev),
            torch.empty(bb, dtype=torch.float32, device=dev),
            torch.empty(bb, dtype=torch.float32, device=dev))


def launch_kernel(sel, ent, nodes, leaves, orig, dir, it, ip, iu, iv,
                  any_hit: bool, blk: int, lvl: int, leaf_width: int):
    """Launch K5 on the current stream (signature of launch_plain)."""
    bb = orig.shape[0]
    if blk <= 0 or blk % THREADS or bb % blk:
        raise ValueError(f"K5: blk {blk} must be a multiple of {THREADS} "
                         f"that divides the {bb} ray slots")
    nb, kk = bb // blk, sel.shape[-1]
    check("K5", "sel", sel, torch.int32, (nb, kk))
    check("K5", "ent", ent, torch.float32, (nb, kk))
    c, tp, lp, cap = _check_forest("K5", nodes, leaves, lvl, leaf_width)
    _check_rays("K5", bb, orig, dir, ("it", it, torch.float32),
                ("ip", ip, torch.int32), ("iu", iu, torch.float32),
                ("iv", iv, torch.float32))
    if bool(((sel < 0) | (sel >= c)).any()):
        raise ValueError(f"K5: sel holds chunk ids outside 0..{c - 1}")
    lib = _lib or load_kernel()
    outs = _new_outputs(bb, orig.device)
    launch(lib.k5_forest, orig.get_device(), *(x.data_ptr() for x in (
        sel, ent, nodes, leaves, orig, dir, it, ip, iu, iv)),
        bb, blk, kk, tp, lp, leaf_width, int(any_hit),
        *(x.data_ptr() for x in outs), cap)
    LAUNCHES[_form(any_hit)] += 1
    return outs


def queue_plain(ft: ForestTables, orig, dir, t_vec, any_hit: bool,
                rounds: list | None = None):
    """The work queue's plain version: the round loop over launch_plain.
    Returns (t, prim or blocked, u, v) per ray; the rays are a multiple of
    WQ_BLK. `rounds`, a list, receives the round count."""
    return _run_workqueue(ft, orig, dir, t_vec, any_hit, WQ_BLK,
                          launch_plain, rounds)


def queue_kernel(ft: ForestTables, orig, dir, t_vec, any_hit: bool):
    """Launch K5's work queue on the current stream (signature of
    queue_plain, without `rounds`): one launch, no host read."""
    bb = orig.shape[0]
    c, tp, lp, cap = _check_forest("K5", ft.nodes, ft.leaves, ft.lvl,
                                   ft.leaf_width)
    check("K5", "boxes", ft.boxes, torch.float32, (c, 8))
    _check_rays("K5", bb, orig, dir, ("t_vec", t_vec, torch.float32))
    lib = _lib or load_kernel()
    outs = _new_outputs(bb, orig.device)
    launch(lib.k5_queue, orig.get_device(), *(x.data_ptr() for x in (
        ft.boxes, ft.nodes, ft.leaves, orig, dir, t_vec)),
        bb, c, tp, lp, ft.leaf_width, int(any_hit),
        *(x.data_ptr() for x in outs), cap)
    LAUNCHES[_form(any_hit)] += 1
    return outs


def _launcher(dev: torch.device):
    """The per-launch wrapper for `dev`: K5 for CUDA, the plain version
    for the CPU."""
    return launch_kernel if dev.type == "cuda" else launch_plain


# ---------------------------------------------------------------- entry

def _traverse(ft, orig, dir, t_max, any_hit, mode, launch, rounds, blk,
              kk) -> Traversal:
    """Either scheduler; in the any-hit form `prim` holds the blocked
    flag."""
    if mode not in MODES:
        raise ValueError(f"forest traversal mode {mode!r}: use one of "
                         f"{MODES}")
    if mode == "workqueue":
        o, d, tv, b = _prep(orig, dir, t_max, WQ_BLK)
        if launch is not None:
            res = _run_workqueue(ft, o, d, tv, any_hit, WQ_BLK, launch,
                                 rounds)
        elif o.device.type == "cuda":
            if rounds is not None:
                raise ValueError("the queue kernel makes one launch and "
                                 "counts no rounds")
            # the rays as given: sorting them by octant and Morton code
            # costs more host time than the coherence saves (PERF.md)
            res = queue_kernel(ft, o, d, tv, any_hit)
        else:
            res = queue_plain(ft, o, d, tv, any_hit, rounds)
        return Traversal(*(x[:b] for x in res))
    launch = launch or _launcher(orig.device)

    def passes(o, d, t):
        o, d, t, b = _prep(o, d, t, blk)
        res = _run_passes(ft, o, d, t, any_hit, blk, kk, launch, rounds)
        return Traversal(*(x[:b] for x in res))

    # passes: coherence-sort by octant + Morton over the forest bounds
    t_vec = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=orig.device), orig.shape[:1])
    return ray_sort.sorted_apply(orig, dir, ft.boxes[:, 0:3].amin(0),
                                 ft.boxes[:, 3:6].amax(0), passes, t_vec)


def traverse_closest(ft: ForestTables, orig, dir, t_max,
                     mode: str = "workqueue", launch=None,
                     rounds: list | None = None, blk: int = BLK,
                     kk: int = K_CHUNKS) -> Traversal:
    """Closest hit under a scalar or per-lane t_max. `mode` picks the
    scheduler ("workqueue" or "blocksched", whose block and visits per
    pass are `blk` and `kk`); `launch`, a per-launch wrapper
    (launch_plain or launch_kernel), overrides the one chosen by device
    and runs the work queue as the round loop; `rounds`, a list, receives
    the call's round or pass count (a round loop's or the passes'; the
    queue kernel has none)."""
    return _traverse(ft, orig, dir, t_max, False, mode, launch, rounds, blk,
                     kk)


def traverse_any(ft: ForestTables, orig, dir, t_max,
                 mode: str = "workqueue", launch=None,
                 rounds: list | None = None, blk: int = BLK,
                 kk: int = K_CHUNKS) -> torch.Tensor:
    """True where some triangle is hit before the per-lane t_max."""
    return _traverse(ft, orig, dir, t_max, True, mode, launch, rounds, blk,
                     kk).prim > 0
