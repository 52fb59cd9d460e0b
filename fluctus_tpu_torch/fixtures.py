"""Synthetic inputs that pin K2's tie rules: brute forests holding copies
of one triangle at several (chunk, slot) places, and the place whose id
the visit-list walk must return for a ray through them: the lowest slot of
the group listed first in the chunk visited first.

The tests (tests/test_torch_brute.py, tests/test_torch_kernels.py) and
chip_smoke.py's k2-ties phase read them. Tile 128 throughout; K2 (at
csrc/traverse_brute.cu) deals a group's slots over four teams and a
visit's live groups over a cluster's two CTAs, entry e to CTA e % 2.

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
