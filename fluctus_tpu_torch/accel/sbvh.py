"""NumPy SBVH builder (counterpart of `fluctus_tpu/accel/sbvh.py`, the
same arithmetic in the same order): spatial splits with reference
duplication (Stich et al. 2009), NumPy-vectorized.

Capability parity with the reference SBVH (src/sbvh.{hpp,cpp}): per node the
builder arbitrates between the best full-sweep object SAH split
(src/sbvh.cpp:159-223) and a chopped-binning spatial split
(src/sbvh.cpp:243-324, 128 bins), gated by the α overlap threshold
(src/sbvh.hpp:70-71); straddling references are split at the plane with
unsplit-left/unsplit-right/duplicate SAH arbitration (src/sbvh.cpp:360-449)
and duplicated boxes come from exact triangle-plane clipping. Differences
by design: BIN accumulation chops reference AABBs (conservative superset of
exact clipping — bounds stay valid; the native builder.cpp clips exactly in
bins too), and the tree flattens directly to the same BuiltBVH SoA arrays
as the plain builder, with prim_idx carrying duplicated references.
"""
from __future__ import annotations

import numpy as np

from fluctus_tpu_torch.accel.bvh import (MAX_DEPTH, MAX_LEAF, BuiltBVH,
                                   _surface_area)

ALPHA = 1e-5          # overlap threshold (reference: src/sbvh.hpp:70-71)
SPATIAL_BINS = 128    # reference: src/sbvh.cpp chopped binning bin count


def _object_split(lo, hi, centroid):
    """Full-sweep object SAH over 3 axes on reference boxes.

    Returns (cost, axis, order, split_pos, left_box, right_box)."""
    n = len(lo)
    best = (np.inf, None, None, None, None, None)
    for axis in range(3):
        order = np.argsort(centroid[:, axis], kind="stable")
        slo, shi = lo[order], hi[order]
        left_lo = np.minimum.accumulate(slo, axis=0)
        left_hi = np.maximum.accumulate(shi, axis=0)
        right_lo = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
        right_hi = np.maximum.accumulate(shi[::-1], axis=0)[::-1]
        sa_l = _surface_area(left_lo[:-1], left_hi[:-1])
        sa_r = _surface_area(right_lo[1:], right_hi[1:])
        counts = np.arange(1, n, dtype=np.float64)
        cost = sa_l * counts + sa_r * (n - counts)
        i = int(np.argmin(cost))
        if cost[i] < best[0]:
            best = (cost[i], axis, order, i + 1,
                    (left_lo[i], left_hi[i]), (right_lo[i + 1], right_hi[i + 1]))
    return best


def _spatial_split(lo, hi, node_lo, node_hi):
    """Chopped-binning spatial split: bin reference boxes into SPATIAL_BINS
    slabs per axis, clip boxes to slabs, evaluate SAH at bin boundaries.

    Returns (cost, axis, plane, (l_lo, l_hi), (r_lo, r_hi), n_l, n_r) —
    the bin-accumulated child boxes and duplicate-counting populations at
    the chosen plane feed the per-reference unsplit arbitration — or
    (inf, None, None, None, None, 0, 0)."""
    best = (np.inf, None, None, None, None, 0, 0)
    n = len(lo)
    for axis in range(3):
        extent = node_hi[axis] - node_lo[axis]
        if extent <= 0:
            continue
        width = extent / SPATIAL_BINS
        # bin range spanned by each reference
        b0 = np.clip(((lo[:, axis] - node_lo[axis]) / width).astype(np.int64),
                     0, SPATIAL_BINS - 1)
        b1 = np.clip(((hi[:, axis] - node_lo[axis]) / width).astype(np.int64),
                     0, SPATIAL_BINS - 1)
        # per-bin clipped boxes: accumulate min/max of the chopped AABBs.
        bin_lo = np.full((SPATIAL_BINS, 3), np.inf)
        bin_hi = np.full((SPATIAL_BINS, 3), -np.inf)
        entry = np.zeros(SPATIAL_BINS, np.int64)
        exit_ = np.zeros(SPATIAL_BINS, np.int64)
        np.add.at(entry, b0, 1)
        np.add.at(exit_, b1, 1)
        for b in range(SPATIAL_BINS):
            sel = (b0 <= b) & (b1 >= b)
            if not sel.any():
                continue
            plane_lo = node_lo[axis] + b * width
            plane_hi = plane_lo + width
            clo = lo[sel].copy()
            chi = hi[sel].copy()
            clo[:, axis] = np.maximum(clo[:, axis], plane_lo)
            chi[:, axis] = np.minimum(chi[:, axis], plane_hi)
            bin_lo[b] = np.minimum(bin_lo[b], clo.min(axis=0))
            bin_hi[b] = np.maximum(bin_hi[b], chi.max(axis=0))
        # prefix boxes + counts; split after bin i
        lt_lo = np.minimum.accumulate(bin_lo, axis=0)
        lt_hi = np.maximum.accumulate(bin_hi, axis=0)
        rt_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
        rt_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
        n_left = np.cumsum(entry)            # refs entering <= bin i
        n_right = n - np.concatenate([[0], np.cumsum(exit_)])[:-1]  # exit >= i
        sa_l = _surface_area(lt_lo[:-1], lt_hi[:-1])
        sa_r = _surface_area(rt_lo[1:], rt_hi[1:])
        valid = (n_left[:-1] > 0) & (n_right[1:] > 0) \
            & np.isfinite(sa_l) & np.isfinite(sa_r)
        cost = np.where(valid,
                        sa_l * n_left[:-1] + sa_r * n_right[1:], np.inf)
        i = int(np.argmin(cost))
        if cost[i] < best[0]:
            best = (cost[i], axis, node_lo[axis] + (i + 1) * width,
                    (lt_lo[i], lt_hi[i]), (rt_lo[i + 1], rt_hi[i + 1]),
                    int(n_left[i]), int(n_right[i + 1]))
    return best


def _clip_side_boxes(V, axis, plane, slo, shi):
    """Exact per-triangle clipped AABBs on both sides of an axis plane,
    intersected with each reference's current box.

    V: (s, 3, 3) triangle vertices. Returns (llo, lhi, lval, rlo, rhi,
    rval); a side is invalid when the triangle has no geometry there (its
    reference box straddles only because of ancestor box-splits)."""
    d = V[:, :, axis] - plane                       # (s, 3) signed dists
    i0 = np.array([0, 1, 2])
    i1 = np.array([1, 2, 0])
    da, db = d[:, i0], d[:, i1]
    cross = (da * db) < 0                           # edge crosses the plane
    t = da / np.where(cross, da - db, 1.0)
    P = V[:, i0] + t[..., None] * (V[:, i1] - V[:, i0])  # (s, 3, 3)

    def side(keep):
        vlo = np.where(keep[..., None], V, np.inf).min(axis=1)
        vhi = np.where(keep[..., None], V, -np.inf).max(axis=1)
        plo = np.where(cross[..., None], P, np.inf).min(axis=1)
        phi = np.where(cross[..., None], P, -np.inf).max(axis=1)
        blo = np.maximum(np.minimum(vlo, plo), slo)
        bhi = np.minimum(np.maximum(vhi, phi), shi)
        return blo, bhi, np.all(blo <= bhi, axis=1)

    llo, lhi, lval = side(d <= 0)
    rlo, rhi, rval = side(d >= 0)
    return llo, lhi, lval, rlo, rhi, rval


def build_sbvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
               max_leaf: int = MAX_LEAF, max_depth: int = MAX_DEPTH,
               alpha: float = ALPHA) -> BuiltBVH:
    m = len(v0)
    tri_lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    tri_hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)

    # reference lists (SoA, duplicated by spatial splits)
    ref_prim = np.arange(m, dtype=np.int64)
    ref_lo = tri_lo.copy()
    ref_hi = tri_hi.copy()

    root_sa = _surface_area(tri_lo.min(0), tri_hi.max(0))

    node_lo, node_hi = [], []
    node_right, node_count, node_parent = [], [], []
    out_prims: list[int] = []
    max_seen_depth = 0

    def emit(prim, lo, hi, parent, is_right, depth):
        nonlocal max_seen_depth
        idx = len(node_count)
        if is_right and parent >= 0:
            node_right[parent] = idx
        nlo = lo.min(axis=0)
        nhi = hi.max(axis=0)
        node_lo.append(nlo.astype(np.float32))
        node_hi.append(nhi.astype(np.float32))
        node_parent.append(parent)
        max_seen_depth = max(max_seen_depth, depth)
        n = len(prim)

        if n <= max_leaf:
            node_right.append(len(out_prims))
            node_count.append(n)
            out_prims.extend(prim.tolist())
            return

        centroid = (lo + hi) * 0.5
        if depth >= max_depth:
            # soft depth bound: median-split (no spatial) until leaf-sized —
            # oversized leaves would overflow fixed-width device leaf tests
            order = np.argsort(centroid[:, int(np.argmax(nhi - nlo))],
                               kind="stable")
            split = n // 2
            node_right.append(-1)
            node_count.append(0)
            emit(prim[order[:split]], lo[order[:split]], hi[order[:split]],
                 idx, False, depth + 1)
            emit(prim[order[split:]], lo[order[split:]], hi[order[split:]],
                 idx, True, depth + 1)
            return
        o_cost, axis, order, split, lbox, rbox = _object_split(lo, hi,
                                                               centroid)
        use_spatial = False
        s_axis = s_plane = None
        if lbox is not None:
            # overlap test (reference: sbvh.cpp chooses spatial when the
            # object split children overlap significantly)
            ov_lo = np.maximum(lbox[0], rbox[0])
            ov_hi = np.minimum(lbox[1], rbox[1])
            if np.all(ov_hi > ov_lo):
                overlap_sa = _surface_area(ov_lo, ov_hi)
                if overlap_sa > alpha * root_sa:
                    s_cost, s_axis, s_plane, s_lb, s_rb, s_nl, s_nr = \
                        _spatial_split(lo, hi, lo.min(0), hi.max(0))
                    use_spatial = s_axis is not None and s_cost < o_cost

        if use_spatial:
            fully_left = hi[:, s_axis] <= s_plane
            fully_right = lo[:, s_axis] >= s_plane
            straddle = ~fully_left & ~fully_right

            lp = [prim[fully_left]]
            ll = [lo[fully_left]]
            lh = [hi[fully_left]]
            rp = [prim[fully_right]]
            rl = [lo[fully_right]]
            rh = [hi[fully_right]]
            if straddle.any():
                sp_ = prim[straddle]
                slo = lo[straddle]
                shi = hi[straddle]
                # per-reference unsplit arbitration: duplicate only when
                # the SAH of splitting beats absorbing the whole reference
                # into one child. The bin boxes already contain every
                # straddler's clipped contribution.
                a_l = _surface_area(s_lb[0], s_lb[1])
                a_r = _surface_area(s_rb[0], s_rb[1])
                c_split = a_l * s_nl + a_r * s_nr
                gl = _surface_area(np.minimum(s_lb[0], slo),
                                   np.maximum(s_lb[1], shi))
                gr = _surface_area(np.minimum(s_rb[0], slo),
                                   np.maximum(s_rb[1], shi))
                c_ul = gl * s_nl + a_r * (s_nr - 1)
                c_ur = a_l * (s_nl - 1) + gr * s_nr
                V = np.stack([v0[sp_], v1[sp_], v2[sp_]],
                             axis=1).astype(np.float64)
                cllo, clhi, lval, crlo, crhi, rval = _clip_side_boxes(
                    V, s_axis, s_plane, slo, shi)
                go_l = ~rval | ((c_ul < c_split) & (c_ul <= c_ur))
                go_r = ~go_l & (~lval | (c_ur < c_split))
                dup = ~go_l & ~go_r
                lp += [sp_[go_l], sp_[dup]]
                ll += [slo[go_l], cllo[dup]]
                lh += [shi[go_l], clhi[dup]]
                rp += [sp_[go_r], sp_[dup]]
                rl += [slo[go_r], crlo[dup]]
                rh += [shi[go_r], crhi[dup]]
            lprim = np.concatenate(lp)
            llo = np.concatenate(ll)
            lhi = np.concatenate(lh)
            rprim = np.concatenate(rp)
            rlo = np.concatenate(rl)
            rhi = np.concatenate(rh)
            if len(lprim) == 0 or len(rprim) == 0 or \
                    max(len(lprim), len(rprim)) >= n:
                use_spatial = False  # degenerate; fall back to object split

        if not use_spatial:
            if order is None:
                split = n // 2
                order = np.argsort(centroid[:, int(np.argmax(
                    hi.max(0) - lo.min(0)))], kind="stable")
            o = order
            lprim, llo, lhi = prim[o[:split]], lo[o[:split]], hi[o[:split]]
            rprim, rlo, rhi = prim[o[split:]], lo[o[split:]], hi[o[split:]]

        node_right.append(-1)
        node_count.append(0)
        idx2 = idx
        emit(lprim, llo, lhi, idx2, False, depth + 1)
        emit(rprim, rlo, rhi, idx2, True, depth + 1)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(ref_prim, ref_lo, ref_hi, -1, False, 0)
    finally:
        sys.setrecursionlimit(old)

    return BuiltBVH(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_right=np.asarray(node_right, np.int32),
        node_count=np.asarray(node_count, np.int32),
        node_parent=np.asarray(node_parent, np.int32),
        prim_idx=np.asarray(out_prims, np.int32),
        depth=max_seen_depth,
    )
