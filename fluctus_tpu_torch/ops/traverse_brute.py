"""Brute-chunk traversal of big scenes: kernels K2 and K3, their plain
versions, and the two schedulers that feed them (counterpart of
`fluctus_tpu/ops/traverse_brute.py`).

The scene is a `BruteForest` (accel/forest.py): spatial chunks of
triangles with no hierarchy inside a chunk. A chunk visit Moller-tests the
chunk's triangles against a block of `blk` rays. Two schedulers decide
which block visits which chunk:

- the visit-list scheduler (`_run_vlist`, the default): rays sort once by
  their nearest chunks; every block gets its chunks ordered front to back
  by the block's least entry distance, and each pass visits the next
  `v_per` of them in one launch of K2 (`vlaunch_*`), which also skips the
  chunk's tiles that no lane of the block can hit (`tboxes`). Passes run
  until no block has a chunk closer than its worst live lane.
- the round-loop scheduler (`_run_workqueue`, under
  FLUCTUS_BRUTE_SCHED=rounds or without `tboxes`): rays visit their next
  chunks in rounds; K3 (`launch_*`) tests whole chunks and computes each
  lane's next `mm` chunks after its (entry, id) cursor from the chunk
  AABBs, all in one float semantics so the walk is self-consistent. A
  scout launch (sel = -1) yields the first lists.

Each kernel has a plain PyTorch version with the same signature
(`vlaunch_plain` / `launch_plain`); one scheduler feeds either. The
wrappers take the plain version for CPU tensors and launch the kernel for
CUDA tensors; there is no fallback between the two. Kernel and plain
version evaluate the same expressions in the same order and the library
is built with -fmad=false, so they agree bit for bit on the card.

Semantics kept from the JAX kernels so the outputs match theirs: ties in
t go to the lowest triangle slot of a tile group and to the earlier
visit; a tile group (K2: `gr` tiles; K3: one tile of `tt` triangles) that
runs leaves a closest-form lane's best t at no more than 3e38 (the
kernels' "no hit" sentinel), so a miss under t_max 3.4e38 returns 3e38.
"""
from __future__ import annotations

import math
import os

import torch

from fluctus_tpu_torch.core.types import BruteForest
from fluctus_tpu_torch.launch import CSRC, call, check, launch, load_library
from fluctus_tpu_torch.ops.traverse_stack import (
    TRI_EPS, Traversal, _inv_dir as _safe_inv)

BLK = 128          # rays per block (threads per CUDA block)
PLAN = (1, 2, 4)   # visits per ray in the first rounds; the last repeats
MM = 4             # next-chunk lookahead of K3
TT = 512           # K3's Moller tile, fit to a divisor of the chunk width
V_PER = 8          # visit slots per block and K2 launch
MIN_PHASE_W = 1024  # smallest width of the round loop's shrinking drain
GR_TRIS = 1024     # triangles per guarded Moller group of K2 (auto gr)
MAX_MM = 8         # kMaxMM of the CUDA source
BIG = 3.0e38
INF = float("inf")
INT_MAX = 0x7FFFFFFF

# kernel launches and plain-version calls per kernel and form;
# chip_smoke.py zeroes these before a frame and reads them after it
LAUNCHES = {"k2_closest": 0, "k2_any": 0, "k3_closest": 0, "k3_any": 0}
PLAIN_CALLS = {"k2_closest": 0, "k2_any": 0, "k3_closest": 0, "k3_any": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _form(any_hit: bool) -> str:
    return "any" if any_hit else "closest"


# ---------------------------------------------------------------- plain

def _slab(lo, hi, o, inv):
    """Slab test; lo, hi, o, inv are 3-lists of broadcastable tensors."""
    t0 = [(lo[k] - o[k]) * inv[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * inv[k] for k in range(3)]
    tmn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                      torch.minimum(t0[1], t1[1])),
                        torch.minimum(t0[2], t1[2]))
    tmx = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                      torch.maximum(t0[1], t1[1])),
                        torch.maximum(t0[2], t1[2]))
    return tmn, tmx


def _moller(tr, o, d):
    """tr (N, 10, T) triangle rows [a e1 e2 tid+1]; o, d (N, blk, 3).
    Returns t, u, v, ok of shape (N, blk, T) and the ids (N, 1, T); `ok`
    holds the determinant, barycentric and t >= 0 tests."""
    r = [tr[:, k, None, :] for k in range(10)]
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z, tid = r
    ox, oy, oz = (o[..., k:k + 1] for k in range(3))
    dx, dy, dz = (d[..., k:k + 1] for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) >= TRI_EPS
    idet = 1.0 / torch.where(ok, det, 1.0)
    tvx = ox - ax
    tvy = oy - ay
    tvz = oz - az
    u = (tvx * px + tvy * py + tvz * pz) * idet
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * idet
    t = (e2x * qx + e2y * qy + e2z * qz) * idet
    ok = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= 0.0)
    return t, u, v, ok, tid


def _merge_group(t, u, v, tid, ok, bt, bp, bu, bv):
    """Closest-form result of one tile group (the JAX `_moller_tile`):
    the least t among the valid slots and 3e38, the first slot on ties;
    it replaces the carried best where it is smaller."""
    t_c = torch.where(ok, t, BIG)
    t_min = t_c.amin(-1)
    win = ok & (t_c == t_min[..., None])
    has = win.any(-1)
    j = win.to(torch.int32).argmax(-1, keepdim=True)
    pick = lambda x: torch.gather(x, -1, j)[..., 0]
    pid = torch.where(
        has, pick(tid.expand_as(t)).to(torch.int32) - 1, -1)
    pu = torch.where(has, pick(u), 0.0)
    pv = torch.where(has, pick(v), 0.0)
    better = t_min < bt
    return (torch.where(better, t_min, bt), torch.where(better, pid, bp),
            torch.where(better, pu, bu), torch.where(better, pv, bv))


def _seeds(it, ip, iu, iv):
    return (it[:, 0].clone(), ip[:, 0].clone(), iu[:, 0].clone(),
            iv[:, 0].clone())


def _outputs(bt, bp, bu, bv):
    return (bt.reshape(-1, 1), bp.reshape(-1, 1), bu.reshape(-1, 1),
            bv.reshape(-1, 1))


def vlaunch_plain(sel, val, tris, tboxes, rays8, it, ip, iu, iv,
                  any_hit: bool, blk: int, tt: int, v_per: int, gr: int,
                  stats: dict | None = None):
    """Plain version of K2. Block b walks visit slots b*v_per + v in
    order; a slot with val > 0 visits chunk sel: the slab test of the
    chunk's tile AABBs for the block's live lanes, then, for every group
    of `gr` tiles that some live lane's slab admits, Moller tests of the
    group's gr*tt triangles for all live lanes, merged into the carried
    (t, prim, u, v) or, in the any-hit form, into the blocked flag.
    With `stats`, adds the tile slab tests of live lanes against real
    tiles ("slab_tests"), the Moller tests of live lanes against real
    triangles ("tri_tests", and per block "block_tri_tests", int64 (nb,))
    and marks the chunks visited ("chunks_run", bool (C,)) and the
    (chunk, group) pairs run ("groups_run", bool (C, ng)): what K2 needs
    to do for these inputs."""
    PLAIN_CALLS[f"k2_{_form(any_hit)}"] += 1
    cap = rays8.shape[0]
    nb = cap // blk
    tp = tris.shape[2]
    nt = tp // tt
    ng = nt // gr
    gw = gr * tt
    o = rays8[:, 0:3].reshape(nb, blk, 3)
    d = rays8[:, 3:6].reshape(nb, blk, 3)
    inv = _safe_inv(d)
    bt, bp, bu, bv = (x.reshape(nb, blk) for x in _seeds(it, ip, iu, iv))
    selv = sel.reshape(nb, v_per).long()
    valv = val.reshape(nb, v_per)
    if stats is not None:
        real = tris[:, 9, :] > 0.0                       # (C, Tp)
        real_tiles = real.reshape(-1, nt, tt).any(-1).sum(-1)
        real_groups = real.reshape(-1, ng, gw).sum(-1)   # (C, ng)
        for k in ("slab_tests", "tri_tests"):
            stats.setdefault(k, 0)
        stats.setdefault("chunks_run", torch.zeros(
            tris.shape[0], dtype=torch.bool, device=tris.device))
        stats.setdefault("groups_run", torch.zeros(
            (tris.shape[0], ng), dtype=torch.bool, device=tris.device))
        stats.setdefault("block_tri_tests", torch.zeros(
            nb, dtype=torch.long, device=tris.device))
    for v in range(v_per):
        alive = bp <= 0 if any_hit else torch.ones_like(bp, dtype=torch.bool)
        lane = (bt > 0.0) & alive
        run = (valv[:, v] > 0) & lane.any(1)
        blocks = run.nonzero()[:, 0]
        if blocks.numel() == 0:
            continue
        ch = selv[blocks, v]
        tb = tboxes[ch, :, :nt]                          # (nr, 8, nt)
        ob, ib = o[blocks], inv[blocks]
        tmn, tmx = _slab([tb[:, k, None, :] for k in range(3)],
                         [tb[:, k, None, :] for k in range(3, 6)],
                         [ob[..., k:k + 1] for k in range(3)],
                         [ib[..., k:k + 1] for k in range(3)])
        lb = lane[blocks]
        cand = (tmx >= 0.0) & (tmn <= tmx) \
            & (torch.clamp(tmn, min=0.0) < bt[blocks][..., None]) \
            & lb[..., None]
        glive = cand.any(1).reshape(-1, ng, gr).any(-1)  # (nr, ng)
        if stats is not None:
            stats["slab_tests"] += int((lb.sum(1) * real_tiles[ch]).sum())
            stats["chunks_run"][ch] = True
        for g in range(ng):
            rows = glive[:, g].nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            bi = blocks[rows]
            tr = tris[ch[rows], 0:10, g * gw:(g + 1) * gw]
            cbt, cbp = bt[bi], bp[bi]
            live = cbt > 0.0
            if any_hit:
                live = live & (cbp <= 0)
            t, u, vv, ok, tid = _moller(tr, o[bi], d[bi])
            ok = ok & (t < cbt[..., None]) & (tid > 0.0) & live[..., None]
            if stats is not None:
                per_block = live.sum(1) * real_groups[ch[rows], g]
                stats["tri_tests"] += int(per_block.sum())
                stats["block_tri_tests"].index_add_(0, bi, per_block)
                stats["groups_run"][ch[rows], g] = True
            if any_hit:
                bp[bi] = torch.maximum(cbp, ok.any(-1).to(torch.int32))
            else:
                bt[bi], bp[bi], bu[bi], bv[bi] = _merge_group(
                    t, u, vv, tid, ok, cbt, cbp, bu[bi], bv[bi])
    return _outputs(bt, bp, bu, bv)


def launch_plain(sel, tris, boxes_t, rays8, it, ip, iu, iv, any_hit: bool,
                 blk: int, tt: int, mm: int, c_real: int,
                 stats: dict | None = None):
    """Plain version of K3. Block b visits chunk sel[b] (-1: scout, no
    visit): lanes whose entry into the chunk is below their best t
    Moller-test the whole chunk in tiles of tt triangles; then every lane
    gets the next `mm` chunks (ordered by entry, then id, pad chunks
    masked) after the cursor (entry, id) of the chunk just visited, or
    after (-inf, -1) for a scout or a lane that missed the chunk. A block
    with no live lane keeps its seeds and gets no next chunks.
    With `stats`, adds the chunk slab tests ("slab_tests": c_real per
    lane of a live block) and the Moller tests of live lanes against real
    triangles ("tri_tests"), and marks the chunks visited
    ("chunks_run", bool (C,))."""
    PLAIN_CALLS[f"k3_{_form(any_hit)}"] += 1
    cap = rays8.shape[0]
    nb = cap // blk
    tp = tris.shape[2]
    cp = boxes_t.shape[1]
    nt = tp // tt
    dev = rays8.device
    o = rays8[:, 0:3]
    d = rays8[:, 3:6]
    inv = _safe_inv(d)
    bt, bp, bu, bv = _seeds(it, ip, iu, iv)
    alive_in = bp <= 0 if any_hit else torch.ones_like(bp, dtype=torch.bool)
    blk_live = ((bt > 0.0) & alive_in).reshape(nb, blk).any(1)
    c_id = sel.long().repeat_interleave(blk)
    scout = c_id < 0

    tmn, tmx = _slab([boxes_t[k] for k in range(3)],
                     [boxes_t[k] for k in range(3, 6)],
                     [o[:, k:k + 1] for k in range(3)],
                     [inv[:, k:k + 1] for k in range(3)])   # (cap, Cp)
    cid = torch.arange(cp, device=dev)
    hitc = (tmx >= 0.0) & (tmn <= tmx) & (cid < c_real)
    e_all = torch.where(hitc, torch.clamp(tmn, min=0.0), INF)
    my_e = torch.where(
        scout, INF, torch.gather(e_all, 1, c_id.clamp(min=0)[:, None])[:, 0])
    live = ~scout & (my_e < bt) & (bt > 0.0)
    if any_hit:
        live = live & (bp <= 0)
    blocks = live.reshape(nb, blk).any(1).nonzero()[:, 0]
    if stats is not None:
        for k in ("slab_tests", "tri_tests"):
            stats.setdefault(k, 0)
        stats.setdefault("chunks_run", torch.zeros(
            tris.shape[0], dtype=torch.bool, device=dev))
        stats["slab_tests"] += int(blk_live.sum()) * blk * c_real
    if blocks.numel():
        ch = sel.long()[blocks]
        ob = o.reshape(nb, blk, 3)[blocks]
        db = d.reshape(nb, blk, 3)[blocks]
        lb = live.reshape(nb, blk)[blocks]
        b4 = [x.reshape(nb, blk)[blocks] for x in (bt, bp, bu, bv)]
        if stats is not None:
            n_real = (tris[ch, 9, :] > 0.0).sum(-1)
            stats["tri_tests"] += int((lb.sum(1) * n_real).sum())
            stats["chunks_run"][ch] = True
        for i in range(nt):
            tr = tris[ch, 0:10, i * tt:(i + 1) * tt]
            t, u, vv, ok, tid = _moller(tr, ob, db)
            ok = ok & (t < b4[0][..., None]) & (tid > 0.0) & lb[..., None]
            if any_hit:
                b4[1] = torch.maximum(b4[1], ok.any(-1).to(torch.int32))
            else:
                b4 = list(_merge_group(t, u, vv, tid, ok, *b4))
        for x, new in zip((bt, bp, bu, bv), b4):
            x.reshape(nb, blk)[blocks] = new

    # next chunks after the cursor of this visit
    eff_t = torch.where(bp > 0, 0.0, it[:, 0]) if any_hit else bt
    cur_e = torch.where(scout | (my_e == INF), -INF, my_e)
    cur_c = torch.where(scout, -1, c_id)
    cand = hitc & (e_all < eff_t[:, None]) & (
        (e_all > cur_e[:, None])
        | ((e_all == cur_e[:, None]) & (cid > cur_c[:, None])))
    onc = torch.full((cap, mm), -1, dtype=torch.int32, device=dev)
    for j in range(mm):
        e_j = torch.where(cand, e_all, INF).amin(1)
        c_j = torch.where(cand & (e_all == e_j[:, None]), cid,
                          INT_MAX).amin(1)
        got = e_j < INF
        onc[:, j] = torch.where(got, c_j, -1).to(torch.int32)
        cand = cand & ~((e_all == e_j[:, None]) & (cid == c_j[:, None])
                        & got[:, None])
    onc[~blk_live.repeat_interleave(blk)] = -1
    return _outputs(bt, bp, bu, bv) + (onc,)


# ---------------------------------------------------------------- kernels

_SRC = os.path.join(CSRC, "traverse_brute.cu")
_lib = None
BUILD_INFO: dict = {}
ENTRIES = {"k2_vlaunch": "K2", "k2_occupancy": "K2", "k3_launch": "K3"}


def load_kernel():
    """Build (at first use) and load the K2/K3 library."""
    global _lib
    if _lib is None:
        _lib = load_library(_SRC, "k23_brute", ENTRIES, info=BUILD_INFO)
    return _lib


def _check_rays(kern, blk, rays8, it, ip, iu, iv):
    cap = rays8.shape[0]
    if blk % 32 or not 0 < blk <= 1024 or cap % blk:
        raise ValueError(f"{kern}: blk {blk} must be a multiple of 32 up "
                         f"to 1024 that divides the {cap} ray slots")
    check(kern, "rays8", rays8, torch.float32, (cap, 8))
    for name, x, dt in (("it", it, torch.float32), ("ip", ip, torch.int32),
                        ("iu", iu, torch.float32), ("iv", iv, torch.float32)):
        check(kern, name, x, dt, (cap, 1))
    return cap


def _new_outputs(cap, dev):
    return (torch.empty((cap, 1), dtype=torch.float32, device=dev),
            torch.empty((cap, 1), dtype=torch.int32, device=dev),
            torch.empty((cap, 1), dtype=torch.float32, device=dev),
            torch.empty((cap, 1), dtype=torch.float32, device=dev))


def vlaunch_kernel(sel, val, tris, tboxes, rays8, it, ip, iu, iv,
                   any_hit: bool, blk: int, tt: int, v_per: int, gr: int):
    """Launch K2 on the current stream (signature of vlaunch_plain)."""
    if blk != BLK:
        raise ValueError(f"K2: blk {blk} must be {BLK}, the kernel's ray "
                         f"block")
    cap = _check_rays("K2", blk, rays8, it, ip, iu, iv)
    c, _, tp = tris.shape
    ntp = tboxes.shape[2]
    nt = tp // tt
    nb = cap // blk
    check("K2", "tris", tris, torch.float32, (c, 16, tp))
    check("K2", "tboxes", tboxes, torch.float32, (c, 8, ntp))
    check("K2", "sel", sel, torch.int32, (nb * v_per,))
    check("K2", "val", val, torch.int32, (nb * v_per,))
    if tp % tt or nt % gr or nt > ntp:
        raise ValueError(f"K2: tile {tt} x group {gr} does not fit Tp {tp}"
                         f" / NTp {ntp}")
    outs = _new_outputs(cap, rays8.device)
    launch((_lib or load_kernel()).k2_vlaunch, rays8.get_device(),
           sel.data_ptr(), val.data_ptr(), tris.data_ptr(),
           tboxes.data_ptr(), rays8.data_ptr(), it.data_ptr(), ip.data_ptr(),
           iu.data_ptr(), iv.data_ptr(), *(x.data_ptr() for x in outs),
           cap, blk, tp, ntp, tt, v_per, gr, int(any_hit))
    LAUNCHES[f"k2_{_form(any_hit)}"] += 1
    return outs


def k2_resident_warps(tp: int, tt: int, gr: int,
                      any_hit: bool) -> tuple[int, float]:
    """K2's resident warps at this chunk shape, as its launcher computes
    them: per SM from cudaOccupancyMaxActiveBlocksPerMultiprocessor, and
    per SM on average over the card from cudaOccupancyMaxActiveClusters,
    which also counts where K2's clusters fit."""
    lib = _lib or load_kernel()
    dev = torch.cuda.current_device()
    w = [call(lib.k2_occupancy, dev, tp, tt, gr, int(any_hit), c)
         for c in (0, 1)]
    if min(w) < 0:
        raise RuntimeError(f"K2: no occupancy for Tp {tp}, tile {tt}, "
                           f"group {gr}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return w[0], w[1] / sms


def launch_kernel(sel, tris, boxes_t, rays8, it, ip, iu, iv, any_hit: bool,
                  blk: int, tt: int, mm: int, c_real: int):
    """Launch K3 on the current stream (signature of launch_plain)."""
    if blk != BLK:
        raise ValueError(f"K3: blk {blk} must be {BLK}, the kernel's ray "
                         f"block")
    cap = _check_rays("K3", blk, rays8, it, ip, iu, iv)
    c, _, tp = tris.shape
    cp = boxes_t.shape[1]
    check("K3", "tris", tris, torch.float32, (c, 16, tp))
    check("K3", "boxes_t", boxes_t, torch.float32, (8, cp))
    check("K3", "sel", sel, torch.int32, (cap // blk,))
    if tp % tt or not 0 < mm <= MAX_MM or c_real > cp:
        raise ValueError(f"K3: tile {tt} must divide Tp {tp}, mm {mm} be "
                         f"in 1..{MAX_MM}, c_real {c_real} <= Cp {cp}")
    dev = rays8.device
    outs = _new_outputs(cap, dev)
    onc = torch.empty((cap, mm), dtype=torch.int32, device=dev)
    launch((_lib or load_kernel()).k3_launch, rays8.get_device(),
           *(x.data_ptr() for x in (sel, tris, boxes_t, rays8, it, ip, iu,
                                    iv, *outs, onc)),
           cap, blk, tp, cp, tt, mm, c_real, int(any_hit))
    LAUNCHES[f"k3_{_form(any_hit)}"] += 1
    return outs + (onc,)


def _launcher(kernel: str, dev: torch.device):
    """The wrapper for `dev`: the kernel for CUDA, the plain version for
    the CPU."""
    cuda = dev.type == "cuda"
    if kernel == "k2":
        return vlaunch_kernel if cuda else vlaunch_plain
    return launch_kernel if cuda else launch_plain


# ---------------------------------------------------------------- rounds

def _octant(dir):
    return ((dir[:, 0] < 0).long() | ((dir[:, 1] < 0).long() << 1)
            | ((dir[:, 2] < 0).long() << 2))


def _searchsorted(seq, vals, right=False):
    return torch.searchsorted(seq.contiguous(), vals.contiguous(),
                              right=right)


def _round(bf: BruteForest, rays8, octant, state, m_r: int, any_hit: bool,
           blk: int, tt: int, mm: int, launch):
    """One multi-visit round: every live ray visits its next m_r chunks.
    Slots (m-major: slot = m*bb + r) sort by (chunk, octant), each chunk's
    segment pads to a block multiple so every block holds one chunk, and
    per-slot results min-merge. The distinct chunks scheduled per round are
    capped at nz and renumbered densely; the carried next-chunk list
    advances only along a prefix of scheduled slots."""
    bt, bp, bu, bv, ncm = state
    dev = rays8.device
    bb = rays8.shape[0]
    c = bf.boxes.shape[0]
    s = m_r * bb
    nz = min(c, max(128, (2 * s) // blk))
    cap = s + nz * blk
    nb = cap // blk

    nc_used = ncm[:, :m_r].long()                        # (bb, m_r)
    key = torch.where(nc_used >= 0, nc_used, c)
    if m_r > 1 and nz < c:
        # the dense window holds the first nz distinct first-slot chunks,
        # so every round advances some cursor
        k0 = torch.sort(key[:, 0]).values
        first0 = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            k0[1:] != k0[:-1]]) & (k0 < c)
        dense0 = torch.cumsum(first0.long(), 0) - 1
        d0_key = torch.where(k0 < c, dense0, INT_MAX)
        w_start = _searchsorted(d0_key, torch.arange(nz, device=dev))
        wc = torch.where(w_start < bb, k0[w_start.clamp(0, bb - 1)], c)
        pos_w = _searchsorted(wc, key).clamp(0, nz - 1)
        member = wc[pos_w] == key
        key = torch.where(member, key, c)
    keys = (key * 8 + octant[:, None]).T.reshape(-1)     # (S,) m-major
    order = torch.argsort(keys, stable=True)
    rank = torch.argsort(order, stable=True)
    ch_sorted = keys[order] // 8
    live_s = ch_sorted < c                               # dead keys last
    first = live_s & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                ch_sorted[1:] != ch_sorted[:-1]])
    dense = torch.cumsum(first.long(), 0) - 1

    dj = torch.arange(nz, device=dev)
    dense_key = torch.where(live_s, dense, INT_MAX)
    starts_d = _searchsorted(dense_key, dj)
    ends_d = _searchsorted(dense_key, dj, right=True)
    count_d = ends_d - starts_d
    chunk_of = ch_sorted[starts_d.clamp(0, s - 1)]
    pc = -(-count_d // blk) * blk
    ps = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                    torch.cumsum(pc, 0)])

    bpos = torch.arange(nb, device=dev) * blk
    cbd = (_searchsorted(ps, bpos, right=True) - 1).clamp(0, nz - 1)
    sel = torch.where(count_d[cbd] > 0, chunk_of[cbd].clamp(0, c - 1), 0)
    s_idx = torch.arange(cap, device=dev)
    d_slot = cbd.repeat_interleave(blk)
    j = s_idx - ps[d_slot]
    dead = (j < 0) | (j >= count_d[d_slot])
    src = torch.where(dead, 0,
                      order[(starts_d[d_slot] + j).clamp(0, s - 1)])
    ray = src % bb
    it = torch.where(dead, 0.0, bt[ray])[:, None]
    ip = torch.where(dead, 1 if any_hit else 0, bp[ray])[:, None]
    iu = bu[ray][:, None]
    iv = bv[ray][:, None]

    ot, op, ou, ov, onc = launch(
        sel.to(torch.int32).contiguous(), bf.tris, bf.boxes_t,
        rays8[ray].contiguous(), it.contiguous(),
        ip.to(torch.int32).contiguous(), iu.contiguous(), iv.contiguous(),
        any_hit, blk, tt, mm, c)

    prefix = torch.ones(bb, dtype=torch.bool, device=dev)
    ar = torch.arange(bb, device=dev)
    for m in range(m_r):
        valid = nc_used[:, m] >= 0
        srnk = rank[m * bb + ar]
        did = dense[srnk]
        sched = valid & live_s[srnk] & (did < nz)
        did_c = did.clamp(0, nz - 1)
        pos = (ps[did_c] + (srnk - starts_d[did_c])).clamp(0, cap - 1)
        if any_hit:
            bp = torch.where(sched, torch.maximum(bp, op[pos, 0]), bp)
        else:
            better = sched & (ot[pos, 0] < bt)
            bt = torch.where(better, ot[pos, 0], bt)
            bp = torch.where(better, op[pos, 0], bp)
            bu = torch.where(better, ou[pos, 0], bu)
            bv = torch.where(better, ov[pos, 0], bv)
        use = sched & prefix
        ncm = torch.where(use[:, None], onc[pos], ncm)
        prefix = use
    return bt, bp, bu, bv, ncm


def _run_workqueue(bf: BruteForest, orig, dir, t_vec, any_hit: bool,
                   blk: int, plan, mm: int, tt: int, launch):
    """Round-loop walk: a scout launch, the rounds of `plan`, then rounds
    of plan[-1] visits until no ray holds a next chunk, at shrinking widths
    (live rays compact into the next width once they fit it). Returns the
    best (t, prim, u, v) and whether the round cap cut the walk."""
    dev = orig.device
    bb = orig.shape[0]
    c = bf.boxes.shape[0]
    rays8 = torch.cat([orig, dir, torch.zeros((bb, 2), device=dev)], 1)
    octant = _octant(dir)

    nb0 = bb // blk
    ip0 = torch.zeros((bb, 1), dtype=torch.int32, device=dev) if any_hit \
        else torch.full((bb, 1), -1, dtype=torch.int32, device=dev)
    z = torch.zeros((bb, 1), device=dev)
    ot, op, ou, ov, onc = launch(
        torch.full((nb0,), -1, dtype=torch.int32, device=dev), bf.tris,
        bf.boxes_t, rays8, t_vec[:, None].contiguous(), ip0, z, z.clone(),
        any_hit, blk, tt, mm, c)
    state = (ot[:, 0], op[:, 0], ou[:, 0], ov[:, 0], onc)

    for m_r in plan[:-1]:
        state = _round(bf, rays8, octant, state, m_r, any_hit, blk, tt, mm,
                       launch)
    m_t = plan[-1]

    widths = []
    w = bb
    while w // 4 >= max(blk, MIN_PHASE_W):
        w = max(blk, w // 4)
        widths.append(w)
    widths = widths[:2]
    # each round advances every scheduled cursor, so C rounds per ray
    # suffice; the cap stops a scheduling fault from spinning forever
    round_cap = int(os.environ.get("FLUCTUS_BRUTE_ROUND_CAP", 2 * c + 16))

    def n_live(st):
        return int((st[4][:, 0] >= 0).sum())

    def drain(st, rays8_w, octant_w, w_next):
        r = 0
        while n_live(st) > w_next and r < round_cap:
            st = _round(bf, rays8_w, octant_w, st, m_t, any_hit, blk, tt,
                        mm, launch)
            r += 1
        return st, n_live(st) > w_next

    exhausted = False
    stack = []
    cur_rays, cur_oct = rays8, octant
    for w in widths:
        state, trunc = drain(state, cur_rays, cur_oct, w)
        exhausted |= trunc
        live = state[4][:, 0] >= 0
        order = torch.argsort(torch.where(live, 0, 1), stable=True)
        rank = torch.argsort(order, stable=True)
        take = order[:w]
        stack.append((state, rank))
        state = tuple(a[take] for a in state)
        cur_rays = cur_rays[take]
        cur_oct = cur_oct[take]
    state, trunc = drain(state, cur_rays, cur_oct, 0)
    exhausted |= trunc

    for full_state, rank in reversed(stack):
        w = state[0].shape[0]
        inside = rank < w
        r_c = rank.clamp(max=w - 1)
        state = tuple(
            torch.where(inside if a_full.ndim == 1 else inside[:, None],
                        a_sub[r_c], a_full)
            for a_full, a_sub in zip(full_state, state))
    return state[:4] + (exhausted,)


# ---------------------------------------------------------------- vlist

def _resolve_gr(tt: int, tp: int) -> int:
    """Tiles per guarded group: about GR_TRIS triangles, a divisor of the
    chunk's tile count."""
    gr = max(1, GR_TRIS // tt)
    nt = tp // tt
    return next(g for g in (gr, 32, 16, 8, 4, 2, 1)
                if g <= gr and nt % g == 0)


def _chunk_slab(boxes_t, orig, dir, t_per_lane):
    """(B, Cp) entry distance of every ray into every chunk box, INF where
    the box is missed or entered beyond the lane's t."""
    inv = _safe_inv(dir)
    tmn, tmx = _slab([boxes_t[k] for k in range(3)],
                     [boxes_t[k] for k in range(3, 6)],
                     [orig[:, k:k + 1] for k in range(3)],
                     [inv[:, k:k + 1] for k in range(3)])
    e = torch.clamp(tmn, min=0.0)
    hit = (tmx >= 0.0) & (tmn <= tmx) & (e < t_per_lane[:, None])
    return torch.where(hit, e, INF), hit


def _chunk_entries_blockmin(boxes_t, orig, dir, t_per_lane, alive, blk):
    """(nb, Cp) least entry distance over each block's live lanes."""
    e, _ = _chunk_slab(boxes_t, orig, dir, t_per_lane)
    e = torch.where(alive[:, None], e, INF)
    return e.reshape(-1, blk, e.shape[1]).amin(1)


def _first_chunk_key(boxes_t, orig, dir, t_per_lane):
    """Per-ray sort key: the nearest and second-nearest intersected chunk
    ids packed as first*(Cp+1)+second (Cp = none). Pad chunk columns are
    not masked here, as in the JAX package."""
    cp = boxes_t.shape[1]
    e, hit = _chunk_slab(boxes_t, orig, dir, t_per_lane)
    first = torch.argmin(e, 1) + torch.where((~hit).all(1), cp, 0)
    cid = torch.arange(cp, device=orig.device)
    e2 = torch.where(cid == first[:, None], INF, e)
    second = torch.argmin(e2, 1) + torch.where((e2 == INF).all(1), cp, 0)
    return first * (cp + 1) + second


def _run_vlist(bf: BruteForest, orig, dir, t_vec, any_hit: bool,
               blk: int, v_per: int, tt: int, launch):
    """Visit-list walk (see module docstring): one launch per pass, one
    host read per pass for the loop test. Returns (t, prim, u, v)."""
    dev = orig.device
    bb = orig.shape[0]
    nb = bb // blk
    c = bf.boxes.shape[0]
    cp = bf.boxes_t.shape[1]
    gr = _resolve_gr(tt, bf.tris.shape[2])

    key = _first_chunk_key(bf.boxes_t, orig, dir, t_vec) * 8 + _octant(dir)
    order = torch.argsort(key, stable=True)
    rank = torch.argsort(order, stable=True)
    o_s, d_s, t_s = orig[order], dir[order], t_vec[order]
    rays8 = torch.cat([o_s, d_s, torch.zeros((bb, 2), device=dev)],
                      1).contiguous()

    bt = t_s.clone()
    bp = torch.zeros(bb, dtype=torch.int32, device=dev) if any_hit \
        else torch.full((bb,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(bb, device=dev)
    bv = torch.zeros(bb, device=dev)
    alive = bp <= 0 if any_hit else torch.ones(bb, dtype=torch.bool,
                                                device=dev)
    e_b = _chunk_entries_blockmin(bf.boxes_t, o_s, d_s, bt, alive, blk)
    cid = torch.arange(cp, device=dev)
    e_b = torch.where(cid < c, e_b, INF)
    sidx = torch.argsort(e_b, dim=1, stable=True)
    e_srt = torch.gather(e_b, 1, sidx)
    sidx = torch.cat([sidx, torch.zeros((nb, v_per), dtype=sidx.dtype,
                                        device=dev)], 1)
    e_srt = torch.cat([e_srt, torch.full((nb, v_per), INF, device=dev)], 1)

    def block_limit():
        """Per-block pruning bound: the worst live lane's best t."""
        lim = torch.where(bp <= 0, bt, 0.0) if any_hit else bt
        return lim.reshape(nb, blk).amax(1)

    k = 0
    while k * v_per < cp:
        lim = block_limit()
        if not bool((e_srt[:, k * v_per] < lim).any()):
            break
        sel_w = sidx[:, k * v_per:(k + 1) * v_per]
        valid = e_srt[:, k * v_per:(k + 1) * v_per] < lim[:, None]
        # dead slots repeat the window's first chunk
        sel_w = torch.where(valid, sel_w, sel_w[:, 0:1])
        ot, op, ou, ov = launch(
            sel_w.reshape(-1).to(torch.int32).contiguous(),
            valid.reshape(-1).to(torch.int32).contiguous(),
            bf.tris, bf.tboxes, rays8, bt[:, None].contiguous(),
            bp[:, None].contiguous(), bu[:, None].contiguous(),
            bv[:, None].contiguous(), any_hit, blk, tt, v_per, gr)
        bt, bp, bu, bv = ot[:, 0], op[:, 0], ou[:, 0], ov[:, 0]
        k += 1
    return bt[rank], bp[rank], bu[rank], bv[rank]


# ---------------------------------------------------------------- entry

def _fit_tile(tt: int, tp: int) -> int:
    """Largest divisor of the padded chunk width tp that is <= tt."""
    tt = min(tt, tp)
    if tp % tt:
        tt = math.gcd(tt, tp)
    assert tt > 0 and tp % tt == 0
    return tt


def _use_vlist(bf: BruteForest) -> bool:
    return (bf.tboxes is not None
            and os.environ.get("FLUCTUS_BRUTE_SCHED", "vlist") == "vlist")


def _vlist_tile(bf: BruteForest) -> int:
    """K2's Moller tile is the builder tile the tile AABBs were made for."""
    assert bf.tris.shape[2] % bf.tile == 0
    return int(bf.tile)


def _prep(orig, dir, t_max, blk):
    """Pad the rays to a block multiple with rays that miss everything
    (origin 3e37, t_max 0). A number t_max and the pad rays are filled on
    the device: no copy from the host, so no host sync."""
    b = orig.shape[0]
    dev = orig.device
    pad = (-b) % blk
    if torch.is_tensor(t_max) or hasattr(t_max, "__len__"):
        t_vec = torch.broadcast_to(torch.as_tensor(
            t_max, dtype=torch.float32, device=dev), (b,))
    else:
        t_vec = torch.full((b,), float(t_max), dtype=torch.float32,
                           device=dev)
    if pad:
        d_pad = torch.zeros((pad, 3), device=dev)
        d_pad[:, 2] = 1.0
        orig = torch.cat([orig, torch.full((pad, 3), 3.0e37, device=dev)])
        dir = torch.cat([dir, d_pad])
        t_vec = torch.cat([t_vec, torch.zeros(pad, device=dev)])
    return (orig.contiguous(), dir.contiguous(), t_vec.contiguous(), b)


def _traverse(bf, orig, dir, t_max, any_hit, launch):
    o, d, tv, b = _prep(orig, dir, t_max, BLK)
    if _use_vlist(bf):
        res = _run_vlist(bf, o, d, tv, any_hit, BLK, V_PER, _vlist_tile(bf),
                         launch or _launcher("k2", o.device))
        exhausted = False      # the pass loop is exhaustive
    else:
        res = _run_workqueue(bf, o, d, tv, any_hit, BLK, PLAN, MM,
                             _fit_tile(TT, bf.tris.shape[2]),
                             launch or _launcher("k3", o.device))
        res, exhausted = res[:4], res[4]
    return tuple(x[:b] for x in res), exhausted


def _flagged(res, exhausted, with_flag):
    if with_flag:
        return res, exhausted
    if exhausted:
        raise RuntimeError(
            "brute traversal: the round cap cut the walk before every ray "
            "had visited its chunks (FLUCTUS_BRUTE_ROUND_CAP)")
    return res


def traverse_closest(bf: BruteForest, orig, dir, t_max,
                     with_flag: bool = False, launch=None):
    """Closest hit under a scalar or per-lane t_max. With `with_flag`,
    returns (Traversal, exhausted); without it, a walk cut by the round cap
    raises. `launch` overrides the kernel wrapper chosen by device (a
    function with the signature of vlaunch_plain or launch_plain, for the
    scheduler in use)."""
    (bt, bp, bu, bv), exhausted = _traverse(bf, orig, dir, t_max, False,
                                            launch)
    return _flagged(Traversal(bt, bp, bu, bv), exhausted, with_flag)


def traverse_any(bf: BruteForest, orig, dir, t_max,
                 with_flag: bool = False, launch=None):
    """True where some triangle is hit before the per-lane t_max."""
    (_, bp, _, _), exhausted = _traverse(bf, orig, dir, t_max, True, launch)
    return _flagged(bp > 0, exhausted, with_flag)
