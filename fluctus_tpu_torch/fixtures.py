"""Synthetic inputs: scenes written to disk in the formats the loaders
read (`sphere_grid_ply`, `scene_pbrt`), an HDR sky (`sky_env`), DDS
textures over seeded blocks (`dds_bytes`), PSD, Sun raster, SGI, MSP
and the other simple raster formats (`psd_bytes`, `sun_raster_bytes`,
`sgi_bytes`, `msp_bytes`, `raster_bytes`), the gradient tests' plane
(`plane_session`), a binary hierarchy deeper than the JAX walks' stacks
(`binary_chain_bvh`), and inputs that pin the traversal kernels' tie
rules.

K2 and K3: brute forests holding copies of one triangle at several
(chunk, slot) places, and the place whose id the visit-list walk must
return for a ray through them: the lowest slot of the group listed first
in the chunk visited first (`tie_forest`). K1 and K4: an 8-wide hierarchy
with copies in slots that K1's teams deal to different lanes, in two
leaves entered in a known order, and in two leaves with equal entry
distances (`wide_tie_bvh`), where K1 and K4 pick different copies.

The tests (tests/test_torch_{brute,traverse,packet,kernels}.py) and
chip_smoke.py's k1-, k2-, k3- and k4-ties phases read them.

The brute forests: tile 128 throughout; K2 (at csrc/traverse_brute.cu)
deals a group's slots over four teams and a visit's live groups over a
cluster's two CTAs, entry e to CTA e % 2.

- "group": Tp 1,024, one 1,024-slot group per chunk (gr = 8). A and B
  span three team slices each (256 slots a team), C's lower copy is
  staged in a later piece than its higher one (slot 130 against 555), E's
  two copies share one trip's pair, and D's copy in chunk 1, whose box is
  entered first, wins over its copy in chunk 0: the earlier visit keeps a
  tie.
- "groups": Tp 1,408 (11 tiles, no divisor from 2 to 8, so gr = 1 as on
  the conference): every tile is a group, all 11 live for the first ray
  block, so a group's entry in the visit's list is its tile. Four groups
  share a CTA's piece. F has copies at entries 0, 1, 2 and 5 (both CTAs,
  one piece); G's winner lies in CTA 1 in a higher team than the losers
  in CTA 0; H's in a higher team than a later entry of the same CTA; I
  puts copies in a team's first and second piece of both CTAs; J keeps
  the lower of two entries of one team in a later piece.
"""
from __future__ import annotations

import struct

import numpy as np

TILE = 128
# name: (Tp, {tie: [(chunk, slot), ...]}, {tie: (chunk, slot) of the winner},
# whether chunk 1 has a filler at z = 5 whose box is entered first)
LAYOUTS = {
    "group": (1024,
              {"A": [(0, 0), (0, 300), (0, 700)],
               "B": [(0, 701), (0, 301), (0, 1000)],
               "C": [(0, 555), (0, 130)],
               "D": [(0, 800), (1, 5)],
               "E": [(0, 259), (0, 258)]},
              {"A": (0, 0), "B": (0, 301), "C": (0, 130), "D": (1, 5),
               "E": (0, 258)},
              True),
    "groups": (11 * TILE,
               {"F": [(0, 5 * 128 + 0), (0, 2 * 128 + 10),
                      (0, 1 * 128 + 40), (0, 0 * 128 + 127)],
                "G": [(0, 2 * 128 + 0), (0, 3 * 128 + 0),
                      (0, 1 * 128 + 100)],
                "H": [(0, 6 * 128 + 1), (0, 4 * 128 + 96)],
                "I": [(0, 9 * 128 + 65), (0, 8 * 128 + 64),
                      (0, 7 * 128 + 70)],
                "J": [(0, 10 * 128 + 31), (0, 9 * 128 + 2),
                      (0, 8 * 128 + 5)]},
               {"F": (0, 127), "G": (0, 228), "H": (0, 608), "I": (0, 966),
                "J": (0, 1029)},
               False),
}


def tie_forest(layout: str = "group", seed: int = 0, n_rays: int = 256):
    """A two-chunk brute forest in the given LAYOUTS layout, with the tie
    copies at height z = 1 and seeded filler triangles below them in every
    other slot. Triangle ids are chunk * Tp + slot. Returns (arrays for
    convert.brute_from_numpy, orig, dir, want): rays from z = 10 straight
    down within 0.005, the first 5 x 16 through the tie triangles, the
    rest at seeded points; want holds the id each tie ray must hit, -2
    elsewhere."""
    tp, slots, winners, near_chunk1 = LAYOUTS[layout]
    g = np.random.default_rng(seed)
    c = 2
    v = np.zeros((c, tp, 3, 3), np.float32)         # (chunk, slot, vert, xyz)
    # fillers: small triangles at z in [0, 0.5] over [0, 4]^2
    base = np.concatenate([g.uniform(0, 4, (c, tp, 2)),
                           g.uniform(0, 0.5, (c, tp, 1))], -1)
    v[:, :, 0] = base
    v[:, :, 1] = base + g.uniform(0.05, 0.4, (c, tp, 3)) * [1, 1, 0.1]
    v[:, :, 2] = base + g.uniform(0.05, 0.4, (c, tp, 3)) * [-1, 1, 0.1]
    if near_chunk1:
        v[1, 6] = [[3.9, 3.9, 5.0], [3.95, 3.9, 5.0], [3.9, 3.95, 5.0]]
    else:
        v[1, :, :, 0] += 10.0                       # no ray enters chunk 1
    centres = {}
    for k, name in enumerate(slots):
        cx, cy = 0.5 + 0.75 * k, 2.0
        tri = np.float32([[cx - 0.15, cy - 0.15, 1.0], [cx + 0.2, cy - 0.1, 1.0],
                          [cx - 0.05, cy + 0.2, 1.0]])
        centres[name] = tri.mean(0)
        for ch, s in slots[name]:
            v[ch, s] = tri
    tris = np.zeros((c, 16, tp), np.float32)
    tris[:, 0:3] = v[:, :, 0].transpose(0, 2, 1)
    tris[:, 3:6] = (v[:, :, 1] - v[:, :, 0]).transpose(0, 2, 1)
    tris[:, 6:9] = (v[:, :, 2] - v[:, :, 0]).transpose(0, 2, 1)
    tris[:, 9] = (np.arange(c * tp).reshape(c, tp) + 1).astype(np.float32)
    boxes = np.zeros((c, 8), np.float32)
    boxes[:, 0:3] = v.min((1, 2))
    boxes[:, 3:6] = v.max((1, 2))
    nt = tp // TILE
    tboxes = np.zeros((c, 8, 128), np.float32)
    tboxes[:, 0:3] = 3.0e37
    tboxes[:, 3:6] = -3.0e37
    vt = v.reshape(c, nt, TILE * 3, 3)
    tboxes[:, 0:3, :nt] = vt.min(2).transpose(0, 2, 1)
    tboxes[:, 3:6, :nt] = vt.max(2).transpose(0, 2, 1)
    # every chunk-0 tile spans the rays' square, so every group is live
    # for every ray of a block and a group's entry is its place
    if not ((tboxes[0, 0:2, :nt] < 0.2).all()
            and (tboxes[0, 3:5, :nt] > 3.8).all()):
        raise AssertionError("a tile's box misses part of the rays' square")
    boxes_t = np.zeros((8, 128), np.float32)
    boxes_t[0:3] = 3.0e37
    boxes_t[3:6] = -3.0e37
    boxes_t[0:6, :c] = boxes[:, 0:6].T
    arrays = {"tris": tris, "boxes": boxes, "boxes_t": boxes_t,
              "tboxes": tboxes, "tile": TILE}

    per = 16
    xy = g.uniform(0.2, 3.8, (n_rays, 2)).astype(np.float32)
    want = np.full(n_rays, -2, np.int32)
    for k, name in enumerate(slots):
        xy[k * per:(k + 1) * per] = centres[name][:2]
        ch, s = winners[name]
        want[k * per:(k + 1) * per] = ch * tp + s
    orig = np.concatenate([xy, np.full((n_rays, 1), 10.0, np.float32)], 1)
    d = np.concatenate([g.uniform(-0.005, 0.005, (n_rays, 2)),
                        -np.ones((n_rays, 1))], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return arrays, orig.astype(np.float32), d, want


# ---------------------------------------------------------------- K1, K4

# Tie triangle copies of the 8-wide tie hierarchy, per case: [(leaf, slot)].
# Leaves: 0 "lanes"; 1 "A" and 2 "B" (root children 1 and 2, A's box
# entered first); 3 "C" and 4 "D" (children 2 and 5 of node 1, identical
# boxes, so equal entry distances).
WIDE_TIES = {
    "lanes": [(0, 12), (0, 7), (0, 6), (0, 1)],
    "leaves": [(2, 2), (1, 9)],
    "equal keys": [(3, 4), (4, 11)],
}
# the copy each kernel's sequential rule returns, per case: K1 visits
# children in ascending (tmin, slot) order, K4 pushes equal keys lowest
# slot first, so it pops the higher slot first; within a leaf both keep
# the first slot of the least t
WIDE_WINNERS = {
    "k1": {"lanes": (0, 1), "leaves": (1, 9), "equal keys": (3, 4)},
    "k4": {"lanes": (0, 1), "leaves": (1, 9), "equal keys": (4, 11)},
}
WIDE_W = 16


def wide_tie_id(leaf: int, slot: int) -> int:
    """The triangle id of slot `slot` of leaf `leaf` in wide_tie_bvh."""
    return 1000 + WIDE_W * leaf + slot


def wide_tie_bvh(seed: int = 0, n_rays: int = 1024):
    """A two-level 8-wide hierarchy (accel/wide.py rows, leaf width 16)
    holding equal-t copies of one triangle per WIDE_TIES case, and rays
    through them. The "lanes" copies sit in slots that a team of 8 lanes
    (2 slots a lane) or of 4 lanes deals to different lanes, and two of
    them to one lane; "leaves" puts a copy in leaf A and in leaf B, whose
    box a ray enters later; "equal keys" in leaves C and D, whose boxes
    are identical. Every other slot of a used leaf holds a seeded filler
    triangle below the copies (z 0.2) or, in A, a lid at z 3 away from the
    rays. Rays start at z 10 and go down within 0.002; ray i goes through
    case i % 8's copies for i % 8 < 3 (so tie rays lie in every warp and
    every CTA of a K4 cluster), the others hit fillers or nothing.

    Returns (arrays: nodes (2, 56), leaves (5, 16, 10), root_ref, depth,
    leaf_width; orig, dir; want {"k1": ids, "k4": ids}, -2 where ray i is
    no tie ray)."""
    g = np.random.default_rng(seed)
    w = WIDE_W
    cases = list(WIDE_TIES)
    leaves = np.zeros((5, w, 10), np.float32)
    leaves[..., 9] = np.int32(-1).view(np.float32)
    centre = {c: np.float32([1.0 + 3.0 * k, 1.0]) for k, c in
              enumerate(cases)}
    leaf_case = {0: "lanes", 1: "leaves", 2: "leaves", 3: "equal keys",
                 4: "equal keys"}

    def put(leaf, slot, v0, v1, v2):
        leaves[leaf, slot, 0:3] = v0
        leaves[leaf, slot, 3:6] = v1 - v0
        leaves[leaf, slot, 6:9] = v2 - v0
        leaves[leaf, slot, 9] = np.int32(wide_tie_id(leaf, slot)).view(
            np.float32)

    for leaf, case in leaf_case.items():
        cx, cy = centre[case]
        copies = {s for lf, s in WIDE_TIES[case] if lf == leaf}
        for slot in range(w):
            if slot in copies:
                put(leaf, slot, np.float32([cx - 0.3, cy - 0.3, 1.0]),
                    np.float32([cx + 0.35, cy - 0.2, 1.0]),
                    np.float32([cx - 0.1, cy + 0.4, 1.0]))
            else:
                b = np.float32([cx + g.uniform(-0.9, 0.9),
                                cy + g.uniform(-0.9, 0.9), 0.2])
                put(leaf, slot, b, b + [0.3, 0.05, 0.0], b + [0.05, 0.3, 0.0])
    # leaf A's lid: its box top at z 3, away from the rays' xy
    cx, cy = centre["leaves"]
    put(1, 15, np.float32([cx + 0.9, cy - 0.95, 3.0]),
        np.float32([cx + 0.95, cy - 0.95, 3.0]),
        np.float32([cx + 0.9, cy - 0.9, 3.0]))
    # leaf D is C's box: the same extremes (copies of C's fillers 0 and 3)
    leaves[4, 0] = leaves[3, 0]
    leaves[4, 3] = leaves[3, 3]
    leaves[4, 0, 9] = np.int32(wide_tie_id(4, 0)).view(np.float32)
    leaves[4, 3, 9] = np.int32(wide_tie_id(4, 3)).view(np.float32)

    def box(leaf):
        ids = leaves[leaf, :, 9].view(np.int32)
        r = leaves[leaf][ids >= 0]
        v = np.concatenate([r[:, 0:3], r[:, 0:3] + r[:, 3:6],
                            r[:, 0:3] + r[:, 6:9]])
        return np.concatenate([v.min(0), v.max(0)])

    cd = np.concatenate([np.minimum(box(3)[:3], box(4)[:3]),
                         np.maximum(box(3)[3:], box(4)[3:])])

    def node_row(children):
        row = np.zeros(56, np.float32)
        row[0:48:6] = np.inf
        refs = np.zeros(8, np.int32)
        for slot, (b, ref) in children.items():
            row[6 * slot:6 * slot + 6] = b
            refs[slot] = ref
        row[48:56] = refs.view(np.float32)
        return row

    node1 = node_row({2: (cd, ~3), 5: (cd, ~4)})
    root = node_row({0: (box(0), ~0), 1: (box(1), ~1), 2: (box(2), ~2),
                     3: (cd, 1)})
    arrays = {"nodes": np.stack([root, node1]), "leaves": leaves,
              "root_ref": 0, "depth": 2, "leaf_width": w}

    xy = np.stack([g.uniform(0.0, 9.0, n_rays),
                   g.uniform(0.0, 2.0, n_rays)], 1).astype(np.float32)
    want = {k: np.full(n_rays, -2, np.int32) for k in WIDE_WINNERS}
    for k, case in enumerate(cases):
        sel = np.arange(n_rays) % 8 == k
        xy[sel] = centre[case] + g.uniform(-0.02, 0.02, (int(sel.sum()), 2))
        for kern, win in WIDE_WINNERS.items():
            want[kern][sel] = wide_tie_id(*win[case])
    orig = np.concatenate([xy, np.full((n_rays, 1), 10.0, np.float32)], 1)
    d = np.concatenate([g.uniform(-0.002, 0.002, (n_rays, 2)),
                        -np.ones((n_rays, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return arrays, orig.astype(np.float32), d.astype(np.float32), want


DEEP_W = 16


def deep_chain_bvh(wide_depth: int, order: str = "near", seed: int = 0,
                   n_rays: int = 1024):
    """An 8-wide hierarchy of `wide_depth` levels that is a chain: each
    inner node has 7 leaf children and one inner child, the deepest 8
    leaves (accel/wide.py rows, leaf width 16, two triangles a leaf).
    Rays start above everything and go down (-z, jittered within 0.01).

    order "near": each level's leaves lie below everything deeper, so the
    inner child's box is entered first and a near-first walk (K1) or a
    packet (K4) descends before it pops a leaf; the packet's stack then
    holds 7 * depth + 1 entries at the bottom, K1's 7 * depth + 8. order
    "far": each level's leaves lie above everything deeper, so the inner
    child is entered last and the stacks stay shallow. Triangles span x
    in [0, 0.85] above the deepest level, and the square [0, 1]^2 there;
    one ray in four has x in [0.85, 1] and reaches the bottom.

    Returns (arrays for convert.wide_from_numpy, orig, dir, tris (n, 3, 3)
    with triangle i of id i)."""
    if order not in ("near", "far"):
        raise ValueError(f"order {order!r}: use near or far")
    g = np.random.default_rng(seed)
    d, w = wide_depth, DEEP_W
    n_leaves = 7 * d + 1
    leaves = np.zeros((n_leaves, w, 10), np.float32)
    leaves[..., 9] = np.int32(-1).view(np.float32)
    tris = []
    leaf_of = []        # (level, leaf index) for each leaf, in level order
    for lv in range(d):
        kids = 8 if lv == d - 1 else 7
        base = lv if order == "near" else d - lv
        span = 1.0 if lv == d - 1 else 0.85
        for j in range(kids):
            leaf = len(leaf_of)
            leaf_of.append(lv)
            for slot in range(2):
                s = g.uniform(0.3, 0.6)
                x0, y0 = g.uniform(0.0, span - s), g.uniform(0.0, 1.0 - s)
                z = 1.0 + base + 0.1 * j + 0.05 * slot
                v0 = np.float32([x0, y0, z])
                v1 = np.float32([x0 + s, y0, z])
                v2 = np.float32([x0, y0 + s, z])
                leaves[leaf, slot, 0:3] = v0
                leaves[leaf, slot, 3:6] = v1 - v0
                leaves[leaf, slot, 6:9] = v2 - v0
                leaves[leaf, slot, 9] = np.int32(len(tris)).view(np.float32)
                tris.append(np.stack([v0, v1, v2]))
    tris = np.asarray(tris, np.float32)

    def leaf_box(leaf):
        r = leaves[leaf, :2]
        v = np.concatenate([r[:, 0:3], r[:, 0:3] + r[:, 3:6],
                            r[:, 0:3] + r[:, 6:9]])
        return np.concatenate([v.min(0), v.max(0)])

    nodes = np.zeros((d, 56), np.float32)
    boxes = [None] * d
    for lv in range(d - 1, -1, -1):        # bottom-up: children boxes first
        first = 7 * lv
        kids = [(leaf_box(first + j), ~(first + j))
                for j in range(8 if lv == d - 1 else 7)]
        if lv < d - 1:
            # the inner child sits in a seeded slot among the leaves
            kids.insert(int(g.integers(0, 8)), (boxes[lv + 1], lv + 1))
        row = np.zeros(56, np.float32)
        refs = np.zeros(8, np.int32)
        for slot, (b, ref) in enumerate(kids):
            row[6 * slot:6 * slot + 6] = b
            refs[slot] = ref
        row[48:56] = refs.view(np.float32)
        nodes[lv] = row
        bs = np.stack([b for b, _ in kids])
        boxes[lv] = np.concatenate([bs[:, :3].min(0), bs[:, 3:].max(0)])
    arrays = {"nodes": nodes, "leaves": leaves, "root_ref": 0, "depth": d,
              "leaf_width": w}

    x = np.where(np.arange(n_rays) % 4 == 3, g.uniform(0.85, 1.0, n_rays),
                 g.uniform(0.0, 1.0, n_rays))
    orig = np.stack([x, g.uniform(0.0, 1.0, n_rays),
                     np.full(n_rays, d + 5.0)], 1).astype(np.float32)
    dir_ = np.concatenate([g.uniform(-0.01, 0.01, (n_rays, 2)),
                           -np.ones((n_rays, 1))], 1)
    dir_ /= np.linalg.norm(dir_, axis=1, keepdims=True)
    return arrays, orig, dir_.astype(np.float32), tris


def brute_closest(tris, orig, dir_, t_max):
    """Closest hit of each ray over all triangles by float64
    Moller-Trumbore: (t, prim), prim -1 on a miss. The reference for
    hierarchies no traversal walks faithfully."""
    o = orig.astype(np.float64)[:, None, :]
    d = dir_.astype(np.float64)[:, None, :]
    v0 = tris[:, 0].astype(np.float64)[None]
    e1 = tris[:, 1].astype(np.float64)[None] - v0
    e2 = tris[:, 2].astype(np.float64)[None] - v0
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    ok = np.abs(det) > 1e-12
    idet = 1.0 / np.where(ok, det, 1.0)
    tv = o - v0
    u = (tv * p).sum(-1) * idet
    q = np.cross(tv, e1)
    v = (d * q).sum(-1) * idet
    t = (e2 * q).sum(-1) * idet
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0) \
        & (t < np.asarray(t_max, np.float64).reshape(-1, 1))
    t = np.where(ok, t, np.inf)
    prim = np.argmin(t, 1)
    best = t[np.arange(len(t)), prim]
    return best, np.where(np.isfinite(best), prim, -1).astype(np.int32)


def deep_chain_forest(wide_depth: int, seed: int = 0, n_rays: int = 1024):
    """A two-chunk treelet forest (accel/forest.py layout: per-chunk
    8-wide rows rooted at node 0, global ids) whose chunks are
    deep_chain_bvh chains of `wide_depth` levels in order "near", the
    second moved by +1.2 in x with its ids after the first's. Rays as in
    deep_chain_bvh over x in [0, 2.2].

    Returns (arrays for convert.forest_from_numpy, orig, dir, tris)."""
    a0, _, _, t0 = deep_chain_bvh(wide_depth, "near", seed, n_rays)
    a1, _, _, t1 = deep_chain_bvh(wide_depth, "near", seed + 1, n_rays)
    shift = np.float32(1.2)
    nodes1 = a1["nodes"].copy()
    nodes1[:, 0:48:6] += shift          # lo.x
    nodes1[:, 3:48:6] += shift          # hi.x
    leaves1 = a1["leaves"].copy()
    leaves1[..., 0] += shift            # v0.x (edges are unchanged)
    ids = leaves1[..., 9].view(np.int32)
    leaves1[..., 9] = np.where(ids >= 0, ids + len(t0), ids).astype(
        np.int32).view(np.float32)
    t1 = t1.copy()
    t1[..., 0] += shift

    def chunk_box(nodes):
        b = nodes[0, 0:48].reshape(8, 6)
        b = b[np.isfinite(b[:, 0])]
        return np.concatenate([b[:, :3].min(0), b[:, 3:].max(0),
                               np.zeros(2, np.float32)])

    arrays = {"nodes": np.stack([a0["nodes"], nodes1]),
              "leaves": np.stack([a0["leaves"], leaves1]),
              "boxes": np.stack([chunk_box(a0["nodes"]),
                                 chunk_box(nodes1)]).astype(np.float32),
              "lvl": wide_depth + 1, "leaf_width": DEEP_W}
    g = np.random.default_rng(seed + 2)
    orig = np.stack([g.uniform(0.0, 2.2, n_rays), g.uniform(0.0, 1.0, n_rays),
                     np.full(n_rays, wide_depth + 5.0)], 1).astype(np.float32)
    dir_ = np.concatenate([g.uniform(-0.01, 0.01, (n_rays, 2)),
                           -np.ones((n_rays, 1))], 1)
    dir_ /= np.linalg.norm(dir_, axis=1, keepdims=True)
    return arrays, orig, dir_.astype(np.float32), np.concatenate([t0, t1])


def binary_chain_bvh(depth: int, near: int = 0):
    """A left-deep binary hierarchy (accel/bvh.py's flat layout) of
    `depth` inner nodes over depth + 1 one-triangle leaves, and one ray
    through all of them: inner node i has inner node i + 1 (the last one
    a leaf) as its left child and a leaf as its right, so a stack walk
    holds one more pending leaf a level and needs depth + 1 entries.
    Triangle k lies in the plane z = k + 2, triangle `near` at z = 1;
    the ray starts at (0.1, 0.1, 0) along +z, so its closest hit is
    triangle `near` at t = 1. The JAX package's binary and packed walks
    keep 96 stack entries (tests/test_torch_backends.py).

    Returns (dict of the BuiltBVH fields node_lo, node_hi, node_right,
    node_count, node_parent, prim_idx, depth; v0, v1, v2; orig, dir)."""
    n = 2 * depth + 1
    n_tris = depth + 1
    z = np.arange(n_tris, dtype=np.float32) + 2.0
    z[near] = 1.0
    v0 = np.stack([np.full(n_tris, -1.0), np.full(n_tris, -1.0), z], 1)
    v1 = np.stack([np.full(n_tris, 3.0), np.full(n_tris, -1.0), z], 1)
    v2 = np.stack([np.full(n_tris, -1.0), np.full(n_tris, 3.0), z], 1)
    lo = np.tile(np.float32([-1.0, -1.0, 0.0]), (n, 1))
    hi = np.tile(np.float32([3.0, 3.0, n_tris + 2.0]), (n, 1))
    right = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    parent = np.full(n, -1, np.int32)
    inner = np.arange(depth)
    # inner i at index i; its right leaf at 2 * depth - i holds triangle
    # i; the leftmost leaf at index depth holds triangle depth
    right[inner] = 2 * depth - inner
    parent[1:depth + 1] = inner
    parent[2 * depth - inner] = inner
    right[2 * depth - inner] = inner
    count[2 * depth - inner] = 1
    right[depth], count[depth] = depth, 1
    arrays = dict(node_lo=lo, node_hi=hi, node_right=right,
                  node_count=count, node_parent=parent,
                  prim_idx=np.arange(n_tris, dtype=np.int32), depth=depth)
    f32 = lambda a: np.asarray(a, np.float32)
    return (arrays, f32(v0), f32(v1), f32(v2), f32([[0.1, 0.1, 0.0]]),
            f32([[0.0, 0.0, 1.0]]))


def sky_env(width: int = 1024, height: int = 512, seed: int = 0,
            sun=(0.3, 0.3), sun_radiance: float = 1000.0,
            sun_texels: float = 3.0) -> np.ndarray:
    """A lat-long HDR sky, (height, width, 3) float32: a blue gradient above
    the horizon, a darker ground below it, a sun disc `sun_texels` texels
    in radius at uv `sun` with radiance ~`sun_radiance`, and seeded
    multiplicative noise (10 %). The env map of the env-lit checks; write
    it with io/hdr.py's write_hdr to load it as a file."""
    g = np.random.default_rng(seed)
    v = ((np.arange(height) + 0.5) / height)[:, None, None]
    u = ((np.arange(width) + 0.5) / width)[None, :, None]
    zenith = np.float32([0.25, 0.45, 1.0])
    horizon = np.float32([0.9, 0.85, 0.8])
    ground = np.float32([0.18, 0.15, 0.12])
    t = np.clip(v / 0.5, 0.0, 1.0)
    sky = zenith * (1.0 - t) + horizon * t
    img = np.where(v < 0.5, sky, ground * (1.2 - 0.4 * v))
    du = (u - sun[0]) * width
    dv = (v - sun[1]) * height
    disc = (du * du + dv * dv) <= sun_texels * sun_texels
    img = np.where(disc, np.float32([1.0, 0.95, 0.85]) * sun_radiance, img)
    img = img * (1.0 + 0.1 * g.standard_normal((height, width, 1)))
    return np.clip(img, 0.0, None).astype(np.float32)


def icosphere(subdiv: int = 3, radius: float = 1.0):
    """An icosahedron subdivided `subdiv` times onto the sphere, as
    scripts/make_test_scenes.py builds it: (V, 3) float64 vertices and
    (F, 3) int64 faces (642 and 1,280 at subdiv 3)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = verts.tolist()
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(verts[a]) + np.asarray(verts[b])
            verts.append((m / np.linalg.norm(m)).tolist())
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.asarray(verts) * radius, np.asarray(faces, np.int64)


def sphere_grid_ply(path: str, grid: int = 17, subdiv: int = 3,
                    seed: int = 0) -> tuple[int, int]:
    """BASELINE config 4's stand-in (scripts/bench_config4.py): radius-0.35
    icospheres on a grid^3 lattice of unit spacing, each centre moved by a
    seeded offset of at most 0.05 per axis, written as binary
    little-endian PLY with shared vertices (float x, y, z; uchar/int
    faces) and no normals, so the loader makes face normals. grid 17,
    subdiv 3: 6,288,640 triangles, 3,154,146 vertices, ~120 MB. Returns
    (triangles, vertices)."""
    v, f = icosphere(subdiv, 0.35)
    offs = np.stack(np.meshgrid(*([np.arange(grid)] * 3), indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    offs += np.random.default_rng(seed).uniform(-0.05, 0.05, offs.shape)
    verts = (v[None] + offs[:, None]).reshape(-1, 3).astype("<f4")
    faces = (f[None] + (np.arange(len(offs)) * len(v))[:, None, None])
    rec = np.zeros(len(offs) * len(f),
                   np.dtype([("k", "u1"), ("i", "<i4", (3,))]))
    rec["k"] = 3
    rec["i"] = faces.reshape(-1, 3)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\nproperty float x\n"
            "property float y\nproperty float z\n"
            f"element face {len(rec)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as fh:
        fh.write(head.encode("ascii"))
        fh.write(verts.tobytes())
        fh.write(rec.tobytes())
    return len(rec), len(verts)


def _pbrt_floats(a) -> str:
    return " ".join(repr(float(x)) for x in np.ravel(a))


def scene_pbrt(obj_path: str, out_dir: str, light: dict | None = None,
               name: str | None = None) -> str:
    """Write the OBJ scene at `obj_path` as PBRT text in `out_dir` and
    return the file's path. `light` (pos/right/up/size/emission and
    optionally normal, as a saved state's area light) becomes an
    `AreaLightSource "diffuse"` quad facing `normal` (right x up without
    it), written first, so both the PBRT parse and a PBF made from it take
    it as the scene's area-light hint.

    Then one `trianglemesh` per material in material order (soup vertices
    with their normals and uv), under the PBRT material whose taxonomy
    gives back the OBJ material's BSDF type: matte, plastic (roughness
    1 - Ns / 5000), glass, mirror, metal. Two have no PBRT name: a rough
    dielectric becomes glass, and an emissive material matte under an
    `AreaLightSource` of its Ke. `map_Kd` files are copied beside the
    file and named by `imagemap` textures; the material names the texture
    in `"texture Kd"` and gives its constant Kd after it, because the
    loaders read a material's Kd as numbers. Bump maps have no PBRT
    counterpart in the loaders and are left out."""
    import os
    import shutil

    from fluctus_tpu_torch.core.types import (
        BXDF_EMISSIVE, BXDF_GGX_ROUGH_DIELECTRIC)
    from fluctus_tpu_torch.scene.loaders.obj import load_obj
    from fluctus_tpu_torch.scene.loaders.pbf import _mtl_to_pbf
    from fluctus_tpu_torch.scene.scene import default_material

    mesh = load_obj(obj_path)
    mats = [default_material()] + mesh.materials
    folder = os.path.dirname(obj_path)
    os.makedirs(out_dir, exist_ok=True)
    out = ["WorldBegin"]
    if light is not None:
        p = np.asarray(light["pos"], np.float64)
        r = np.asarray(light["right"], np.float64) * light["size"][0]
        u = np.asarray(light["up"], np.float64) * light["size"][1]
        if np.dot(np.cross(r, u), light.get("normal", np.cross(r, u))) < 0:
            r, u = u, r          # wind the quad so it faces `normal`
        quad = np.stack([p - r - u, p + r - u, p + r + u, p - r + u])
        out += ["AttributeBegin",
                f'  AreaLightSource "diffuse" "rgb L" '
                f'[{_pbrt_floats(light["emission"])}]',
                f'  Shape "trianglemesh" "point3 P" [{_pbrt_floats(quad)}]',
                '    "integer indices" [0 1 2 0 2 3]', "AttributeEnd"]
    textures = {}
    for mi in np.unique(mesh.mat_id):
        m = mats[mi]
        if m.map_kd and m.map_kd not in textures:
            textures[m.map_kd] = f"tex{len(textures)}"
            shutil.copy(os.path.join(folder, m.map_kd),
                        os.path.join(out_dir, os.path.basename(m.map_kd)))
            out.append(f'Texture "{textures[m.map_kd]}" "spectrum" '
                       f'"imagemap" "string filename" '
                       f'"{os.path.basename(m.map_kd)}"')
    for mi in np.unique(mesh.mat_id):
        m = mats[mi]
        sel = mesh.mat_id == mi
        if m.bsdf_type == BXDF_GGX_ROUGH_DIELECTRIC:
            kind, params = "glass", {"Kt": list(m.ks), "index": [m.ni]}
        else:
            kind, params = _mtl_to_pbf(m)
        decl = {"Kd": "rgb", "Ks": "rgb", "Kt": "rgb", "Kr": "rgb",
                "k": "rgb", "eta": "rgb", "roughness": "float",
                "index": "float"}
        words = [f'"{decl[k]} {k}" [{_pbrt_floats(v)}]'
                 for k, v in params.items() if k in decl]
        if m.map_kd:
            words.insert(0, f'"texture Kd" "{textures[m.map_kd]}"')
        out.append("AttributeBegin")
        out.append(f'  Material "{kind}" ' + " ".join(words))
        if m.bsdf_type == BXDF_EMISSIVE:
            out.append(f'  AreaLightSource "diffuse" "rgb L" '
                       f'[{_pbrt_floats(m.ke)}]')
        pts = np.stack([mesh.v0[sel], mesh.v1[sel], mesh.v2[sel]], 1)
        nrm = np.stack([mesh.n0[sel], mesh.n1[sel], mesh.n2[sel]], 1)
        uv = np.stack([mesh.uv0[sel], mesh.uv1[sel], mesh.uv2[sel]], 1)
        idx = np.arange(pts.shape[0] * 3)
        out += [f'  Shape "trianglemesh" "point3 P" [{_pbrt_floats(pts)}]',
                f'    "integer indices" [{" ".join(map(str, idx))}]',
                f'    "normal N" [{_pbrt_floats(nrm)}]',
                f'    "float uv" [{_pbrt_floats(uv)}]', "AttributeEnd"]
    out.append("WorldEnd")
    path = os.path.join(out_dir, (name or os.path.splitext(
        os.path.basename(obj_path))[0]) + ".pbrt")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


# dds_bytes formats: (pixel-format flags, FourCC, bit count, masks, DXGI
# format, bytes a 4x4 block or a pixel, block-compressed)
_DDS_FORMATS = {
    "DXT1": (0x4, b"DXT1", 0, (), None, 8, True),
    "DXT3": (0x4, b"DXT3", 0, (), None, 16, True),
    "DXT5": (0x4, b"DXT5", 0, (), None, 16, True),
    "ATI1": (0x4, b"ATI1", 0, (), None, 8, True),
    "BC4U": (0x4, b"BC4U", 0, (), None, 8, True),
    "ATI2": (0x4, b"ATI2", 0, (), None, 16, True),
    "BC5U": (0x4, b"BC5U", 0, (), None, 16, True),
    "BC5S": (0x4, b"BC5S", 0, (), None, 16, True),
    "BC1": (0x4, b"DX10", 0, (), 71, 8, True),
    "BC2": (0x4, b"DX10", 0, (), 74, 16, True),
    "BC3": (0x4, b"DX10", 0, (), 77, 16, True),
    "BC4": (0x4, b"DX10", 0, (), 80, 8, True),
    "BC5": (0x4, b"DX10", 0, (), 83, 16, True),
    "BC5_SNORM": (0x4, b"DX10", 0, (), 84, 16, True),
    "BC7": (0x4, b"DX10", 0, (), 98, 16, True),
    "BC7_SRGB": (0x4, b"DX10", 0, (), 99, 16, True),
    "RGBA8": (0x4, b"DX10", 0, (), 28, 4, False),
    "L8": (0x20000, b"", 8, (), None, 1, False),
    "L8A8": (0x20001, b"", 16, (), None, 2, False),
    "P8": (0x20, b"", 8, (), None, 1, False),
    "RGB565": (0x40, b"", 16, (0xF800, 0x7E0, 0x1F), None, 2, False),
    "ARGB4444": (0x41, b"", 16, (0xF00, 0xF0, 0xF, 0xF000), None, 2, False),
    "RGB24": (0x40, b"", 24, (0xFF0000, 0xFF00, 0xFF), None, 3, False),
    "XRGB32": (0x40, b"", 32, (0xFF0000, 0xFF00, 0xFF), None, 4, False),
    "A2R10G10B10": (0x41, b"", 32, (0x3FF00000, 0xFFC00, 0x3FF,
                                    0xC0000000), None, 4, False),
}
DDS_FORMATS = tuple(_DDS_FORMATS)


def dds_bytes(fmt: str, width: int, height: int, seed: int = 0) -> bytes:
    """A DDS file of `width` x `height` in format `fmt` (DDS_FORMATS: the
    FourCC block formats, DX10 ones by DXGI name, and uncompressed L8,
    L8A8, P8 (with a seeded RGBA palette) and masked RGB layouts) over
    seeded random bytes: any 8 or 16 random bytes are a valid block.
    For BC7 the first nine blocks are forced into modes 0-7 and the
    reserved mode 8 (a first byte of zero), since random first bytes reach
    mode 7 and mode 8 only once in 256 blocks."""
    flags, fourcc, bits, masks, dxgi, unit, blocks = _DDS_FORMATS[fmt]
    g = np.random.default_rng(seed)
    if blocks:
        n = ((width + 3) // 4) * ((height + 3) // 4)
    else:
        n = width * height
    body = g.integers(0, 256, (n, unit), dtype=np.uint8)
    if fmt.startswith("BC7"):
        for mode in range(min(9, n)):
            hi = int(g.integers(0, 256))
            body[mode, 0] = 0 if mode == 8 else ((hi << (mode + 1))
                                                 | (1 << mode)) & 0xFF
    masks = tuple(masks) + (0,) * (4 - len(masks))
    header = (b"DDS " + (124).to_bytes(4, "little")
              + np.array([0x1007 | (0x80000 if blocks else 0), height,
                          width, 0, 0, 1], "<u4").tobytes()
              + bytes(44)
              + np.array([32, flags], "<u4").tobytes()
              + (fourcc or bytes(4))
              + np.array((bits,) + masks, "<u4").tobytes()
              + np.array([0x1000, 0, 0, 0, 0], "<u4").tobytes())
    assert len(header) == 128
    if dxgi is not None:
        header += np.array([dxgi, 3, 0, 1, 0], "<u4").tobytes()
    if fmt == "P8":
        header += g.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    return header + body.tobytes()


def _packbits(row: bytes) -> bytes:
    """PackBits (Apple's TN1023): runs of 3 to 128 equal bytes as
    257 - n and the byte, the rest as literals of up to 128 bytes."""
    out = bytearray()
    i, n = 0, len(row)
    lit = bytearray()
    while i < n:
        j = i
        while j < n and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes([len(lit) - 1]) + lit
                lit = bytearray()
            out += bytes([257 - (j - i), row[i]])
            i = j
            continue
        lit.append(row[i])
        i += 1
        if len(lit) == 128:
            out += bytes([127]) + lit
            lit = bytearray()
    if lit:
        out += bytes([len(lit) - 1]) + lit
    return bytes(out)


def _runs_picture(g, h, w, levels):
    """Seeded samples below `levels`, (h, w) ints, where each sample
    repeats its left neighbour with probability 0.6, so run-length coders
    find runs."""
    px = g.integers(0, levels, (h, w))
    keep = g.random((h, w)) < 0.6
    for x in range(1, w):
        px[:, x] = np.where(keep[:, x], px[:, x - 1], px[:, x])
    return px


PSD_MODES = {"1": (0, 1, 1), "L": (1, 8, 1), "P": (2, 8, 1),
             "RGB": (3, 8, 3), "RGBA": (3, 8, 4), "CMYK": (4, 8, 4),
             "LAB": (9, 8, 3)}


def psd_bytes(mode: str, width: int, height: int, rle: bool,
              seed: int = 0) -> bytes:
    """A PSD file (Adobe's layout: header, colour-mode data, image
    resources, layer section, merged composite) of seeded pixels in mode
    "1" (bitmap), "L", "P" (a seeded 256-colour palette), "RGB",
    "RGBA", "CMYK" or "LAB", the composite raw or PackBits-coded a row
    (`rle`). The
    resources hold one entry and the layer section 8 bytes, which a
    reader skips. PIL reads PSD and writes none."""
    g = np.random.default_rng(seed)
    cmode, depth, chans = PSD_MODES[mode]
    levels = 2 if mode == "1" else 256
    planes = [_runs_picture(g, height, width, levels) for _ in range(chans)]
    out = bytearray(b"8BPS" + struct.pack(">H6xHIIHH", 1, chans, height,
                                          width, depth, cmode))
    if mode == "P":
        pal = g.integers(0, 256, (3, 256), dtype=np.uint8).tobytes()
        out += struct.pack(">I", len(pal)) + pal
    else:
        out += struct.pack(">I", 0)
    res = b"8BIM" + struct.pack(">H", 1005) + b"\0\0" \
        + struct.pack(">I", 4) + bytes(4)
    out += struct.pack(">I", len(res)) + res
    out += struct.pack(">I", 8) + struct.pack(">I", 0) + bytes(4)
    rows = []
    for p in planes:
        if mode == "1":
            p = np.packbits(p.astype(np.uint8), axis=1)
        rows.append([bytes(r.astype(np.uint8)) for r in p])
    if not rle:
        out += struct.pack(">H", 0)
        for plane in rows:
            out += b"".join(plane)
        return bytes(out)
    coded = [[_packbits(r) for r in plane] for plane in rows]
    out += struct.pack(">H", 1)
    out += b"".join(struct.pack(">H", len(r)) for plane in coded
                    for r in plane)
    out += b"".join(r for plane in coded for r in plane)
    return bytes(out)


def _sun_rle(stream: bytes) -> bytes:
    """Sun raster RLE: 0x80 n-1 v for runs of 3 to 256 (and any 0x80
    run), 0x80 0 for one 0x80, other bytes as themselves."""
    out = bytearray()
    i, n = 0, len(stream)
    while i < n:
        j = i
        while j < n and j - i < 256 and stream[j] == stream[i]:
            j += 1
        run = j - i
        if run >= 3 or (stream[i] == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, stream[i]])
        elif stream[i] == 0x80:
            out += b"\x80\x00"
            run = 1
        else:
            out += bytes(stream[i:j])
        i += run
    return bytes(out)


def sun_raster_bytes(depth: int, width: int, height: int, rle: bool,
                     seed: int = 0, colors: int = 0,
                     rgb_order: bool = False) -> bytes:
    """A Sun raster file (the SunOS rasterfile layout: 32-byte header,
    colour map, rows padded to 16 bits) of seeded pixels at depth 1, 4,
    8, 24 or 32; `colors` > 0 adds an RGB colour map of that many seeded
    entries (depth 4 or 8); `rle` codes the padded row stream as type 2,
    else type 1 (or type 3, RGB byte order, with `rgb_order`). PIL reads
    Sun raster and writes none."""
    g = np.random.default_rng(seed)
    stride = ((width * depth + 15) // 16) * 2
    if depth <= 8:
        px = _runs_picture(g, height, width, 1 << depth).astype(np.uint8)
        if depth < 8:
            per = 8 // depth
            pad = (-width) % per
            px = np.pad(px, ((0, 0), (0, pad)))
            sh = (8 - depth) - depth * np.arange(per)
            px = (px.reshape(height, -1, per) << sh).sum(-1).astype(
                np.uint8)
    else:
        b = depth // 8
        px = np.stack([_runs_picture(g, height, width, 256)
                       for _ in range(b)], -1).astype(np.uint8).reshape(
            height, width * b)
    rows = np.zeros((height, stride), np.uint8)
    rows[:, :px.shape[1]] = px
    stream = rows.tobytes()
    cmap = b""
    if colors:
        cmap = g.integers(0, 256, (3, colors), dtype=np.uint8).tobytes()
    ftype = 2 if rle else (3 if rgb_order else 1)
    body = _sun_rle(stream) if rle else stream
    return (struct.pack(">8I", 0x59A66A95, width, height, depth,
                        len(body), ftype, 1 if colors else 0, len(cmap))
            + cmap + body)


def _pcx_rle(row: bytes) -> bytes:
    """PCX's RLE of one row: runs of 2 to 63 equal bytes as 0xC0 | n
    and the byte, a byte of 0xC0 or more always as a run."""
    out = bytearray()
    i, n = 0, len(row)
    while i < n:
        j = i
        while j < n and j - i < 63 and row[j] == row[i]:
            j += 1
        if j - i > 1 or row[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), row[i]])
        else:
            out.append(row[i])
        i = j
    return bytes(out)


def _sgi_rle_row(v: np.ndarray, word: str) -> bytes:
    """SGI RLE of one channel's row: runs of 3 to 127 equal samples
    (count, sample), literal stretches (0x80 | count, samples), a zero
    count at the end; samples and counts as bytes or 16-bit words."""
    out, x, w = [], 0, len(v)
    while x < w:
        j = x
        while j < w and j - x < 127 and v[j] == v[x]:
            j += 1
        if j - x >= 3:
            out += [j - x, int(v[x])]
            x = j
            continue
        j = x
        while j < w and j - x < 127 and not (
                j + 2 < w and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        out += [0x80 | (j - x)] + [int(a) for a in v[x:j]]
        x = j
    out.append(0)
    return np.asarray(out, word).tobytes()


def sgi_bytes(px: np.ndarray, bpc: int, rle: bool) -> bytes:
    """An SGI file (the SGI image format's layout) of px (h, w, z) samples
    below 2^(8 bpc), stored bottom row first, 1 or 2 bytes a sample: raw
    planes, or (`rle`) rows coded by `_sgi_rle_row` after the offset and
    length tables."""
    h, w, z = px.shape
    dim = 1 if h == 1 and z == 1 else (2 if z == 1 else 3)
    head = struct.pack(">HBBHHHH", 474, rle, bpc, dim, w, h, z).ljust(
        512, b"\0")
    word = "u1" if bpc == 1 else ">u2"
    planes = px.transpose(2, 0, 1)
    if not rle:
        return head + planes.astype(word).tobytes()
    rows = [_sgi_rle_row(planes[c, y], word) for c in range(z)
            for y in range(h)]
    starts = np.cumsum([512 + 8 * len(rows)] + [len(r) for r in rows[:-1]])
    return (head + np.asarray(starts, ">u4").tobytes()
            + np.asarray([len(r) for r in rows], ">u4").tobytes()
            + b"".join(rows))


def msp_bytes(bits: np.ndarray, version: int) -> bytes:
    """A Windows Paint (MSP) file of the 1-bit rows `bits` (h, w; 1
    white): version 1 raw, or version 2 with a row map and each row coded
    as runs (0 n v) and literals (k, then k bytes), an all-white row as
    count 0."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    words = [0] * 16
    words[0:2] = struct.unpack("<2H", b"DanM" if version == 1 else b"LinS")
    words[2], words[3] = w, h
    for k in range(15):
        words[15] ^= words[k]
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    coded = []
    for r in rows:
        out, x = bytearray(), 0
        while x < len(r) and not (r == 0xFF).all():
            j = x
            while j < len(r) and j - x < 255 and r[j] == r[x]:
                j += 1
            out += bytes([0, j - x, r[x]]) if j - x >= 3 \
                else bytes([j - x]) + r[x:j].tobytes()
            x = j
        coded.append(bytes(out))
    return (head + struct.pack(f"<{h}H", *map(len, coded))
            + b"".join(coded))


def raster_bytes(fmt: str, width: int, height: int, seed: int = 0) -> bytes:
    """A file of seeded pixels in one of the simple raster formats the
    texture decoders read, written here by the format's own layout (PIL
    writes most of them, but the machine with the card has no PIL): "pcx"
    (24-bit, RLE), "dcx" (that PCX as a one-frame DCX), "qoi" (RGBA:
    RGBA, RGB and run ops), "sgi" and "sgi-rle" (RGB, 8-bit, raw or RLE),
    "msp" and "msp-rle" (1-bit, versions 1 and 2), "xbm" and "dib"
    (24-bit BGR, a BMP without its file header)."""
    g = np.random.default_rng(seed)
    rgb = np.stack([_runs_picture(g, height, width, 256) for _ in range(3)],
                   -1).astype(np.uint8)
    bits = (rgb[..., 0] > 127).astype(np.uint8)
    if fmt in ("pcx", "dcx"):
        stride = width + width % 2
        head = bytearray(128)
        head[0:4] = bytes([10, 5, 1, 8])
        head[4:12] = struct.pack("<HHHH", 0, 0, width - 1, height - 1)
        head[65] = 3
        head[66:68] = struct.pack("<H", stride)
        rows = np.zeros((height, 3, stride), np.uint8)
        rows[:, :, :width] = rgb.transpose(0, 2, 1)
        body = b"".join(_pcx_rle(r.tobytes()) for r in rows)
        pcx = bytes(head) + body
        if fmt == "pcx":
            return pcx
        return struct.pack("<III", 0x3ADE68B1, 12, 0) + pcx
    if fmt == "qoi":
        a = np.where(g.random((height, width)) < 0.2, 128, 255)
        px = np.concatenate([rgb, a[..., None].astype(np.uint8)], -1)
        flat = px.reshape(-1, 4)
        out = bytearray(b"qoif" + struct.pack(">II", width, height)
                        + bytes([4, 0]))
        prev, i, n = (0, 0, 0, 255), 0, len(flat)
        while i < n:
            cur = tuple(int(c) for c in flat[i])
            run = 0
            while i < n and run < 62 and tuple(
                    int(c) for c in flat[i]) == prev:
                run += 1
                i += 1
            if run:
                out.append(0xC0 | (run - 1))
                continue
            if cur[3] == prev[3]:
                out += bytes([0xFE]) + bytes(cur[:3])
            else:
                out += bytes([0xFF]) + bytes(cur)
            prev = cur
            i += 1
        return bytes(out + b"\0" * 7 + b"\1")
    if fmt in ("sgi", "sgi-rle"):
        return sgi_bytes(rgb[::-1], 1, fmt == "sgi-rle")
    if fmt in ("msp", "msp-rle"):
        return msp_bytes(bits, 1 if fmt == "msp" else 2)
    if fmt == "xbm":
        rows = np.packbits(bits, axis=1, bitorder="little").reshape(-1)
        vals = ",".join(f"0x{v:02x}" for v in rows)
        return (f"#define t_width {width}\n#define t_height {height}\n"
                f"static char t_bits[] = {{\n{vals}\n}};\n").encode()
    if fmt == "dib":
        stride = (width * 3 + 3) & ~3
        rows = np.zeros((height, stride), np.uint8)
        rows[:, :width * 3] = rgb[::-1, :, ::-1].reshape(height, -1)
        return struct.pack("<IiiHHIIiiII", 40, width, height, 1, 24, 0,
                           rows.size, 2835, 2835, 0, 0) + rows.tobytes()
    raise ValueError(f"unknown raster format {fmt!r}")


RASTER_FORMATS = ("pcx", "dcx", "qoi", "sgi", "sgi-rle", "msp", "msp-rle",
                  "xbm", "dib")


def plane_session(device="cuda", size: int = 24, max_bounces: int = 1,
                  env_val: float | None = 1.0, use_area_light: bool = False,
                  sample_impl: bool = True, tilted: bool = False):
    """tests/test_integrator.py::plane_session on the port: a 1000 x 1000
    Lambertian quad (albedo 0.6) at y = 0 under a constant 32x64 env map
    (none with env_val None), seen from (0, 3, 0) looking down; with
    `tilted`, the camera of tests/test_gradients.py::_camera_grad_session
    (direction (0.35, -1, 0.2)), and with use_area_light the default area
    light. Returns a RenderSession."""
    import dataclasses

    import torch

    from fluctus_tpu_torch.core.types import RenderConfig, default_params
    from fluctus_tpu_torch.render.driver import RenderSession
    from fluctus_tpu_torch.scene import envmap as env_host
    from fluctus_tpu_torch.scene.loaders.obj import MtlMaterial
    from fluctus_tpu_torch.scene.scene import HostScene

    half = 500.0
    v = np.array([[-half, 0.0, -half], [half, 0.0, -half],
                  [half, 0.0, half], [-half, 0.0, half]], np.float32)
    v0, v1, v2 = np.stack([v[0], v[0]]), np.stack([v[2], v[3]]), \
        np.stack([v[1], v[2]])
    n = np.cross(v1 - v0, v2 - v0)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    z2 = np.zeros((2, 2), np.float32)
    host = HostScene(v0=v0, v1=v1, v2=v2, n0=n, n1=n, n2=n, uv0=z2, uv1=z2,
                     uv2=z2, mat_id=np.zeros(2, np.int32),
                     materials=[MtlMaterial(name="d", kd=(0.6, 0.6, 0.6),
                                            ks=(0, 0, 0), ns=0.0, ni=0.0)])
    if env_val is not None:
        host.envmap = env_host.compute_tables(
            np.full((32, 64, 3), env_val, np.float32))
    host.build_bvh(cache_dir=None, use_sbvh=False)
    cfg = RenderConfig(width=size, height=size, max_bounces=max_bounces,
                       use_env_map=env_val is not None,
                       use_area_light=use_area_light,
                       sample_impl=sample_impl,
                       bsdf_types_mask=host.material_types_mask)
    params = default_params(world_radius=host.world_radius(), device=device)
    d = np.array([0.0, -1.0, 0.0])
    r, u = np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, -1.0])
    if tilted:
        d = np.array([0.35, -1.0, 0.2])
        d /= np.linalg.norm(d)
        r = np.cross(d, [0.0, 1.0, 0.0])
        r /= np.linalg.norm(r)
        u = np.cross(r, d)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    params = dataclasses.replace(params, camera=dataclasses.replace(
        params.camera, pos=t([0.0, 3.0, 0.0]), dir=t(d), up=t(u),
        right=t(r)))
    return RenderSession(host_scene=host, scene=host.to_device(device),
                         params=params, cfg=cfg)


def rank_session(spec: dict):
    """The session of a sharded-run spec: spec["scene"] None for
    plane_session(spec["device"], spec["size"], spec["max_bounces"]),
    else a scene path opened through driver.create_session with the env
    map spec["env"] at spec["size"]^2, spec["max_bounces"] bounces and the
    thin-lens aperture spec.get("aperture")."""
    import dataclasses

    import torch

    from fluctus_tpu_torch.core.types import RenderConfig
    from fluctus_tpu_torch.render import driver

    dev = spec["device"]
    if spec.get("scene") is None:
        return plane_session(dev, size=spec["size"],
                             max_bounces=spec["max_bounces"])
    cfg = RenderConfig(width=spec["size"], height=spec["size"],
                       max_bounces=spec["max_bounces"],
                       use_env_map=spec.get("env") is not None)
    sess = driver.create_session(spec["scene"], spec.get("env"), cfg,
                                 cache_dir=None, state_dir=None, device=dev)
    if spec.get("aperture") is not None:
        sess.params = dataclasses.replace(
            sess.params, camera=dataclasses.replace(
                sess.params.camera, aperture_size=torch.tensor(
                    spec["aperture"], dtype=torch.float32, device=dev)))
    return sess


def sharded_run(sess, spec: dict, mesh) -> dict:
    """render_sharded at spec["spp"] and one grad_step_stream over
    spec["grad_rays"] stratified pixels (sample 0, target 0.1, the leaves
    spec["leaves"], a pool of spec["pool"] lanes) on `mesh`: {"img",
    "loss", "n_done", "n_seg", and each new leaf}, on the CPU."""
    import torch

    from fluctus_tpu_torch.integrators import wavefront
    from fluctus_tpu_torch.parallel import mesh as pmesh
    from fluctus_tpu_torch.render import optimize

    s_, p_, cfg = sess.scene, sess.params, sess.cfg
    dev = s_.device
    out = {"img": pmesh.render_sharded(s_, p_, cfg, spec["spp"], mesh)}
    n_pix = cfg.width * cfg.height
    pix = optimize.stratified_pixels(n_pix, spec["grad_rays"], 0, dev)
    target = torch.full((pix.shape[0], 3), 0.1, device=dev)
    diff = {k: optimize._DIFF_GETTERS[k](s_, p_) for k in spec["leaves"]}
    n_seg = wavefront.plan_stream_segments(
        s_, p_, cfg, pix, 0, spec["pool"], deferred=True)[0] + 4
    loss, new, n_done = pmesh.grad_step_stream(
        diff, s_, p_, cfg, pix, 0, target, spec["pool"], n_seg, mesh)
    out.update(loss=loss, n_done=n_done, n_seg=n_seg, **new)
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def rank_worker(rank: int, world: int, init_url: str, out_path: str,
                spec: dict) -> None:
    """One rank of a gloo group (torch.multiprocessing.spawn's target):
    join the group, build the spec's session on spec["device"], run
    sharded_run on a mesh of one local shard, and on rank 0 save the
    results to `out_path` (torch.save). Imports torch and the port only,
    so a spawned child needs neither JAX nor the tests."""
    import torch
    import torch.distributed as dist

    from fluctus_tpu_torch.parallel import distributed, mesh as pmesh

    distributed.initialize(init_url, world, rank, device=spec["device"],
                           backend="gloo")
    try:
        sess = rank_session(spec)
        mesh = pmesh.make_mesh([spec["device"]])
        out = sharded_run(sess, spec, mesh)
        out["mesh_size"] = mesh.size
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


_TIFF_FMT = {3: "H", 4: "I", 7: "B", 16: "Q"}


def tiff_bytes(w: int, h: int, bits, spp: int, photo: int, chunks,
               comp: int = 1, tile=None, rps=None, extra=None, pred: int = 1,
               bo: str = "<", cmap=None, planar: int = 1, fill: int = 1,
               fmt=None, bigtiff: bool = False, tables: bytes | None = None,
               subsampling=None) -> bytes:
    """A TIFF of pre-encoded strips (rps rows each) or tiles (`tile` = (w,
    h)), in the chunk order the file lists (all planes of a planar file,
    plane after plane). `bits` is one depth for every sample or a tuple;
    the tags written: PlanarConfiguration `planar`, FillOrder `fill`,
    SampleFormat `fmt` (a value per sample), ExtraSamples `extra`,
    Predictor `pred`, ColorMap `cmap`, JPEGTables `tables`,
    YCbCrSubSampling `subsampling`. Classic TIFF, or BigTIFF (version 43,
    8-byte offsets and counts, 20-byte entries) with `bigtiff`. PIL
    writes none of planar, fill order 2, predictor 3 or BigTIFF."""
    bits = tuple(bits) if isinstance(bits, (tuple, list)) else (bits,) * spp
    off_type = 16 if bigtiff else 4
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, list(bits)),
            (259, 3, [comp]), (262, 3, [photo]), (277, 3, [spp])]
    for tag, typ, vals in ((266, 3, None if fill == 1 else [fill]),
                           (284, 3, None if planar == 1 else [planar]),
                           (317, 3, None if pred == 1 else [pred]),
                           (320, 3, cmap), (338, 3, extra),
                           (339, 3, fmt), (530, 3, subsampling),
                           (347, 7, None if tables is None
                            else list(tables))):
        if vals is not None:
            tags.append((tag, typ, list(vals)))
    head = 16 if bigtiff else 8
    offs, o = [], head
    for c in chunks:
        offs.append(o)
        o += len(c)
    counts = [len(c) for c in chunks]
    if tile:
        tags += [(322, 4, [tile[0]]), (323, 4, [tile[1]]),
                 (324, off_type, offs), (325, off_type, counts)]
    else:
        tags += [(273, off_type, offs), (278, 4, [rps or h]),
                 (279, off_type, counts)]
    tags.sort()
    ifd_off = o + o % 2
    entry, count_f, inline = ((20, "Q", 8) if bigtiff else (12, "H", 4))
    ext_off = ifd_off + struct.calcsize(count_f) + entry * len(tags) + inline
    ifd, ext = struct.pack(bo + count_f, len(tags)), b""
    for tag, typ, vals in tags:
        raw = struct.pack(bo + _TIFF_FMT[typ] * len(vals), *vals)
        cnt = "Q" if bigtiff else "I"
        if len(raw) <= inline:
            ifd += struct.pack(bo + "HH" + cnt, tag, typ, len(vals)) + \
                raw.ljust(inline, b"\0")
        else:
            ifd += struct.pack(bo + "HH" + cnt + cnt, tag, typ, len(vals),
                               ext_off + len(ext))
            ext += raw + b"\0" * (len(raw) % 2)
    magic = b"II" if bo == "<" else b"MM"
    if bigtiff:
        header = magic + struct.pack(bo + "HHHQ", 43, 8, 0, ifd_off)
    else:
        header = magic + struct.pack(bo + "HI", 42, ifd_off)
    return (header + b"".join(chunks) + b"\0" * (o % 2) + ifd
            + b"\0" * inline + ext)
