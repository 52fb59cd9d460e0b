"""Writes the AVIF files of this directory and avif.json with PIL 12.1.0,
which encodes AVIF with aom 3.12.1 and decodes it with dav1d 1.5.1
through libavif 1.3.0 (the machine with the card has no PIL): run from
the repository root,

    python tests/data/avif/make_avif_data.py

Files whose AV1 frames need no in-loop filter:
- kitchen_floor.avif: assets/kitchen_floor.png, lossless 4:4:4 (quality
  100: quantizer 0, so the frame is coded lossless and the AV1 format
  switches deblocking, CDEF and loop restoration off);
- kitchen_wood.avif: assets/kitchen_wood.png, lossless 4:2:0 (CFL, and
  libyuv's bilinear chroma upsampling in the YUV to RGB step);
- kitchen_floor_n.avif: assets/kitchen_floor_n.png, lossy (quality 75,
  4:4:4) with aom's loop filter, CDEF and loop restoration turned off
  (the transforms and dequantisation);
- alpha_prem.avif: RGBA with a premultiplied alpha item (`prem`);
- screen.avif: few-colour screen content at quality 90 (palette and
  intra block copy);
- grey_limited.avif: a grey image (4:0:0), limited range;
- sequence.avif: a 3-frame `avis` sequence (PIL loads frame 0).

Files whose frames need the in-loop filters or film grain (drawn from a
generator of their own, so that rerunning the script rewrites the files
above byte for byte):
- filters_on.avif: PIL's default settings (deblocking);
- kitchen_floor_filtered.avif: assets/kitchen_floor.png with PIL's
  defaults (quality 75, speed 6, 4:2:0: deblocking);
- kitchen_wood_filtered.avif: assets/kitchen_wood.png at speed 4 with
  CDEF asked for (deblocking, CDEF and loop restoration);
- kitchen_floor_n_filtered.avif: assets/kitchen_floor_n.png at speed 4,
  4:4:4 (deblocking and loop restoration);
- deblocking.avif, cdef.avif, restoration.avif: one tool alone each
  (aom's `loopfilter-control` 0 turns deblocking off);
- film_grain.avif: aom's film grain test vector 1;
- all_422.avif, all_grey.avif: 4:2:2 and 4:0:0 with every tool (speed 4,
  CDEF, film grain test vector 2).

Files made from those (the module's `deepen` rewrites the sequence
header, av1C and pixi of 8-bit files; `grid_avif` writes grids through
libavif's avifEncoderAddImageGrid):
- kitchen_floor_10.avif: kitchen_floor_filtered.avif at 10 bits;
- kitchen_wood_12.avif: kitchen_wood_filtered.avif at 12 bits (profile
  2);
- kitchen_floor_n_grid10.avif: assets/kitchen_floor_n.png as a 2x2 grid
  of 128x128 cells (4:4:4, speed 4, quality 75: deblocking and loop
  restoration), each cell at 10 bits.

Files libavif scales, superres files and first pictures shown by
show_existing_frame (`scaled()`; PIL's aom writes neither superres nor
hidden frames, so `rewrite_key` rewrites the headers of frames it codes:
the sequence header in full, superres with the frame coded at the
downscaled width, a key or intra-only frame made hidden and a frame
header OBU with show_existing_frame appended; `restate` restates ispe
sizes, `retrack` an avis track's first sample and tkhd size):
- kitchen_wood_scaled.avif: assets/kitchen_wood.png at 192x160, stated
  at 256x256 (libyuv's bilinear upscale);
- kitchen_floor_superres.avif: assets/kitchen_floor.png at 128x256
  (speed 4, CDEF), upscaled to 256 by superres (denominator 16);
- kitchen_floor_n_hidden.avif: kitchen_floor_n_filtered.avif's frame
  hidden in slot 3 and shown by show_existing_frame;
- alpha_scaled.avif: alpha_prem.avif's colour and alpha stated at 3/4;
- grid_scaled.avif: kitchen_floor_n_grid10.avif's cells stated at 96x96
  and its output at 192x192;
- superres_12.avif: a pattern at 97x65 with loop restoration (speed 4),
  upscaled to 145 (denominator 12), at 12 bits;
- hidden_intra_grain.avif: film_grain.avif's frame as a hidden
  intra-only frame, shown from slot 5;
- hidden_sequence.avif: sequence.avif whose first sample is a hidden key
  frame with frame ids, shown from slot 1, the track stated at 60x36.

avif.json records, for each file, its size, the SHA-256 of PIL's
`Image.open(f).convert("RGBA")` bytes and their shape, the filters its
frame header turns on (`tools`, as the port reads them), and the
versions above.
"""
import hashlib
import io
import json
import os

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
OFF = {"loopfilter-control": "0", "enable-cdef": "0",
       "enable-restoration": "0"}


def _asset(name):
    return Image.open(os.path.join(REPO, "assets", name)).convert("RGB")


def _screen(g):
    a = np.full((200, 330, 3), 250, np.uint8)
    for _ in range(130):
        r, c = g.integers(0, 192), g.integers(0, 324)
        a[r:r + 7, c:c + 5] = g.integers(0, 80, 3)
    a[::9] = (20, 40, 160)
    return Image.fromarray(a)


def _pattern(g, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / 7 + yy / 11),
                  128 + 90 * np.cos(yy / 5), 128 + 60 * np.sin((xx - yy) / 9),
                  np.linspace(0, 255, w)[None, :].repeat(h, 0)][:c], -1)
    return (a + g.normal(0, 8, a.shape)).clip(0, 255).astype(np.uint8)


def files():
    g = np.random.default_rng(20)
    out = {
        "kitchen_floor.avif": (_asset("kitchen_floor.png"),
                               dict(quality=100, subsampling="4:4:4")),
        "kitchen_wood.avif": (_asset("kitchen_wood.png"),
                              dict(quality=100, subsampling="4:2:0")),
        "kitchen_floor_n.avif": (_asset("kitchen_floor_n.png"),
                                 dict(quality=75, subsampling="4:4:4",
                                      advanced=OFF)),
        "alpha_prem.avif": (Image.fromarray(_pattern(g, 40, 48, 4), "RGBA"),
                            dict(quality=100, alpha_premultiplied=True)),
        "screen.avif": (_screen(g), dict(quality=90, advanced=OFF)),
        "grey_limited.avif": (Image.fromarray(_pattern(g, 33, 47, 1)[..., 0]),
                              dict(quality=80, range="limited",
                                   advanced=OFF)),
        "filters_on.avif": (Image.fromarray(_pattern(g, 32, 32, 3)), {}),
    }
    g = np.random.default_rng(21)
    cdef = {"enable-cdef": "1"}
    every = {"enable-cdef": "1", "film-grain-test": "2"}
    out.update({
        "kitchen_floor_filtered.avif": (_asset("kitchen_floor.png"), {}),
        "kitchen_wood_filtered.avif": (_asset("kitchen_wood.png"),
                                       dict(speed=4, advanced=cdef)),
        "kitchen_floor_n_filtered.avif": (_asset("kitchen_floor_n.png"),
                                          dict(speed=4, subsampling="4:4:4")),
        "deblocking.avif": (Image.fromarray(_pattern(g, 33, 47, 3)),
                            dict(quality=60, advanced={
                                "enable-cdef": "0",
                                "enable-restoration": "0"})),
        "cdef.avif": (Image.fromarray(_pattern(g, 70, 130, 3)),
                      dict(quality=60, advanced={
                          "loopfilter-control": "0", "enable-cdef": "1",
                          "enable-restoration": "0"})),
        "restoration.avif": (Image.fromarray(_pattern(g, 65, 97, 3)),
                             dict(quality=60, speed=4, advanced={
                                 "loopfilter-control": "0",
                                 "enable-cdef": "0"})),
        "film_grain.avif": (Image.fromarray(_pattern(g, 48, 80, 3)),
                            dict(quality=60, advanced={
                                "film-grain-test": "1"})),
        "all_422.avif": (Image.fromarray(_pattern(g, 70, 90, 3)),
                         dict(quality=50, speed=4, subsampling="4:2:2",
                              advanced=every)),
        "all_grey.avif": (Image.fromarray(_pattern(g, 70, 90, 1)[..., 0]),
                          dict(quality=60, speed=4, advanced=every)),
    })
    return out


# ------------------------------------------------------------ rewriting
# PIL's aom encodes 8 bits only; dav1d decodes 10 and 12. AV1's tile
# syntax differs between depths only in palette colours, so a deeper file
# is an 8-bit file whose sequence header (in its av01 items and in av1C)
# says another depth, with av1C's fields and pixi in step.

class _Bits:
    def __init__(self, data):
        self.d, self.p = data, 0

    def f(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.d[self.p >> 3] >> (7 - (self.p & 7))) & 1)
            self.p += 1
        return v

    def uvlc(self):
        z = 0
        while not self.f(1):
            z += 1
        return self.f(z) + (1 << z) - 1 if z < 32 else 2 ** 32 - 1


class _Writer:
    def __init__(self):
        self.bits = []

    def f(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self):
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, b[i:i + 8])), 2)
                     for i in range(0, len(b), 8))


def _seq_color(payload):
    """(bit position of color_config, its fields, the position after it)
    of a sequence header OBU's payload (the AV1 specification's syntax)."""
    b = _Bits(payload)
    profile, _still, reduced = b.f(3), b.f(1), b.f(1)
    if reduced:
        b.f(5)
    else:
        timing = b.f(1)
        dm, bdl = 0, 0
        if timing:
            b.f(32), b.f(32)
            if b.f(1):
                b.uvlc()
            dm = b.f(1)
            if dm:
                bdl = b.f(5) + 1
                b.f(32), b.f(5), b.f(5)
        idd = b.f(1)
        for _ in range(b.f(5) + 1):
            b.f(12)
            if b.f(5) > 7:
                b.f(1)
            if dm and b.f(1):
                b.f(bdl), b.f(bdl), b.f(1)
            if idd and b.f(1):
                b.f(4)
    wb, hb = b.f(4) + 1, b.f(4) + 1
    b.f(wb), b.f(hb)
    if not reduced and b.f(1):
        b.f(4), b.f(3)
    b.f(3)                                   # sb128, filter intra, edge
    if not reduced:
        b.f(4)
        order = b.f(1)
        if order:
            b.f(2)
        sct = 2 if b.f(1) else b.f(1)
        if sct > 0 and not b.f(1):
            b.f(1)
        if order:
            b.f(3)
    b.f(3)                                   # superres, cdef, restoration
    start = b.p
    c = {"profile": profile, "high": b.f(1)}
    c["twelve"] = b.f(1) if profile == 2 and c["high"] else 0
    c["mono"] = 0 if profile == 1 else b.f(1)
    c["desc"] = b.f(1)
    c["cicp"] = (b.f(8), b.f(8), b.f(8)) if c["desc"] else None
    c["range"] = b.f(1)
    depth = 12 if c["twelve"] else 10 if c["high"] else 8
    if c["mono"]:
        c["ss"], c["csp"], c["sep"] = (1, 1), 0, 0
        return start, c, b.p
    if profile == 0:
        c["ss"] = (1, 1)
    elif profile == 1:
        c["ss"] = (0, 0)
    elif depth == 12:
        sx = b.f(1)
        c["ss"] = (sx, b.f(1) if sx else 0)
    else:
        c["ss"] = (1, 0)
    c["csp"] = b.f(2) if c["ss"] == (1, 1) else 0
    c["sep"] = b.f(1)
    return start, c, b.p


def _profile(depth, ss, mono):
    """The profile a stream of this depth and subsampling needs (10-bit
    4:2:2 and every 12-bit stream are profile 2)."""
    if depth == 12 or (tuple(ss) == (1, 0) and not mono):
        return 2
    return 1 if tuple(ss) == (0, 0) and not mono else 0


def _color_bits(w, c, depth):
    """color_config for `depth`; returns the profile (_profile's)."""
    ss, mono = c["ss"], c["mono"]
    profile = _profile(depth, ss, mono)
    w.f(1, depth > 8)
    if profile == 2 and depth > 8:
        w.f(1, depth == 12)
    if profile != 1:
        w.f(1, mono)
    w.f(1, c["desc"])
    if c["desc"]:
        for v in c["cicp"]:
            w.f(8, v)
    w.f(1, c["range"])
    if mono:
        return profile
    if profile == 2 and depth == 12:
        w.f(1, ss[0])
        if ss[0]:
            w.f(1, ss[1])
    if ss == (1, 1):
        w.f(2, c["csp"])
    w.f(1, c["sep"])
    return profile


def deepen_obus(obus: bytes, depth: int) -> bytes:
    """The OBU stream with each sequence header rewritten for `depth`."""
    out, off = b"", 0
    while off < len(obus):
        head = obus[off]
        typ, ext = (head >> 3) & 15, (head >> 2) & 1
        hdr = 1 + ext
        size, n, shift = 0, 0, 0
        while True:
            v = obus[off + hdr + n]
            size |= (v & 127) << shift
            n, shift = n + 1, shift + 7
            if not v & 128:
                break
        payload = obus[off + hdr + n:off + hdr + n + size]
        if typ == 1:
            start, c, end = _seq_color(payload)
            bits = _Bits(payload)
            w = _Writer()
            w.f(3, 0)
            bits.f(3)
            for _ in range(start - 3):
                w.f(1, bits.f(1))
            profile = _color_bits(w, c, depth)
            w.bits[:3] = [(profile >> 2) & 1, (profile >> 1) & 1, profile & 1]
            bits.p = end
            w.f(1, bits.f(1))                # film_grain_params_present
            w.f(1, 1)                        # trailing bits
            payload = w.bytes()
        leb = b""
        v = len(payload)
        while True:
            leb += bytes([(v & 127) | (128 if v > 127 else 0)])
            v >>= 7
            if not v:
                break
        out += bytes([head | 2]) + obus[off + 1:off + hdr] + leb + payload
        off += hdr + n + size
    return out


def _obus(obus: bytes):
    """(header bytes before the size, type, payload) of each OBU."""
    off = 0
    while off < len(obus):
        head = obus[off]
        hdr = 1 + ((head >> 2) & 1)
        size, n, shift = 0, 0, 0
        while True:
            v = obus[off + hdr + n]
            size |= (v & 127) << shift
            n, shift = n + 1, shift + 7
            if not v & 128:
                break
        yield obus[off:off + hdr], (head >> 3) & 15, \
            obus[off + hdr + n:off + hdr + n + size]
        off += hdr + n + size


def _obu(head: bytes, payload: bytes) -> bytes:
    leb, v = b"", len(payload)
    while True:
        leb += bytes([(v & 127) | (128 if v > 127 else 0)])
        v >>= 7
        if not v:
            break
    return bytes([head[0] | 2]) + head[1:] + leb + payload


def _seq_fields(payload: bytes) -> dict:
    """A sequence header's fields (reduced or not, without timing info),
    its color_config bits as they are and film_grain_params_present."""
    b = _Bits(payload)
    s = {"profile": b.f(3), "still": b.f(1), "reduced": b.f(1), "tier": 0}
    if s["reduced"]:
        s["level"] = b.f(5)
    else:
        if b.f(1):
            raise ValueError("sequence headers with timing info are not "
                             "rewritten")
        idd = b.f(1)
        ops = []
        for _ in range(b.f(5) + 1):
            idc, lv = b.f(12), b.f(5)
            ops.append((idc, lv, b.f(1) if lv > 7 else 0))
            if idd and b.f(1):
                b.f(4)
        _, s["level"], s["tier"] = ops[0]
    wb, hb = b.f(4) + 1, b.f(4) + 1
    s["max_w"], s["max_h"] = b.f(wb) + 1, b.f(hb) + 1
    s["ids"] = None
    if not s["reduced"] and b.f(1):
        delta = b.f(4) + 2
        s["ids"] = (delta, b.f(3) + delta + 1)
    s["sb128"], s["fi"], s["edge"] = b.f(1), b.f(1), b.f(1)
    s["tools4"], s["order"], s["jnt"], s["sct"], s["imv"] = 0, 0, 0, 2, 2
    s["order_bits"] = 0
    if not s["reduced"]:
        s["tools4"], s["order"] = b.f(4), b.f(1)
        if s["order"]:
            s["jnt"] = b.f(2)
        s["sct"] = 2 if b.f(1) else b.f(1)
        s["imv"] = (2 if b.f(1) else b.f(1)) if s["sct"] > 0 else 2
        if s["order"]:
            s["order_bits"] = b.f(3) + 1
    s["superres"], s["cdef"], s["lr"] = b.f(1), b.f(1), b.f(1)
    start, _, end = _seq_color(payload)
    bits = _Bits(payload)
    bits.p = start
    s["color"] = [bits.f(1) for _ in range(end - start)]
    s["grain"] = bits.f(1)
    return s


def _seq_write(s: dict, superres: int, max_w: int, max_h: int, wbits: int,
               hbits: int, ids) -> bytes:
    """A sequence header (not reduced, one operating point, no timing
    info) from _seq_fields' `s` with superres, the maximum size and its
    field widths and frame ids ((delta length, id length) or None) set."""
    w = _Writer()
    w.f(3, s["profile"])
    w.f(1, s["still"])
    w.f(3, 0)                     # not reduced, no timing info or delays
    w.f(5, 0)
    w.f(12, 0)
    w.f(5, s["level"])
    if s["level"] > 7:
        w.f(1, s["tier"])
    w.f(4, wbits - 1)
    w.f(4, hbits - 1)
    w.f(wbits, max_w - 1)
    w.f(hbits, max_h - 1)
    w.f(1, ids is not None)
    if ids is not None:
        w.f(4, ids[0] - 2)
        w.f(3, ids[1] - ids[0] - 1)
    for k in ("sb128", "fi", "edge"):
        w.f(1, s[k])
    w.f(4, s["tools4"])
    w.f(1, s["order"])
    if s["order"]:
        w.f(2, s["jnt"])
    for k in ("sct", "imv"):
        if k == "imv" and s["sct"] == 0:
            break
        w.f(1, s[k] == 2)
        if s[k] != 2:
            w.f(1, s[k])
    if s["order"]:
        w.f(3, s["order_bits"] - 1)
    w.f(1, superres)
    w.f(1, s["cdef"])
    w.f(1, s["lr"])
    w.bits += s["color"]
    w.f(1, s["grain"])
    w.f(1, 1)                     # trailing bits
    return w.bytes()


def _frame_prefix(payload: bytes, s: dict) -> dict:
    """The fields of a key or intra-only frame header up to its
    disable_frame_end_update_cdf, and the bit position after them."""
    b = _Bits(payload)
    f = {"type": 0, "show": 1, "err": 1}
    if not s["reduced"]:
        if b.f(1):
            raise ValueError("a show_existing_frame header")
        f["type"], f["show"] = b.f(2), b.f(1)
        if not f["show"]:
            b.f(1)
        if not (f["type"] == 0 and f["show"]):
            f["err"] = b.f(1)
    if f["type"] not in (0, 2):
        raise ValueError("an inter frame")
    f["dcu"] = b.f(1)
    f["sct"] = b.f(1) if s["sct"] == 2 else s["sct"]
    f["imv"] = b.f(1) if f["sct"] and s["imv"] == 2 else None
    if s["ids"]:
        b.f(s["ids"][1])
    override = 0 if s["reduced"] else b.f(1)
    b.f(s["order_bits"])
    if not (f["type"] == 0 and f["show"]):
        refresh = b.f(8)
        if refresh != 0xFF and f["err"] and s["order"]:
            b.f(8 * s["order_bits"])
    if override:
        raise ValueError("frame size override is not rewritten")
    if s["superres"] and b.f(1):
        raise ValueError("a superres frame")
    f["render"] = b.f(1)
    if f["render"]:
        f["rw"], f["rh"] = b.f(16), b.f(16)
    f["intrabc"] = b.f(1) if f["sct"] else 0
    if not s["reduced"] and not f["dcu"]:
        b.f(1)
    f["end"] = b.p
    return f


def _bits_of(data: bytes) -> list:
    return [(v >> (7 - i)) & 1 for v in data for i in range(8)]


def rewrite_key(obus: bytes, frame_type=0, show=True, refresh=0xFF,
                denom=None, up_w=None, ids=None, frame_id=0,
                show_slot=None) -> bytes:
    """An OBU stream whose first frame is a key frame, rewritten: the
    sequence header written out in full (AV1's reduced still-picture form
    has no show_existing_frame), the frame made `frame_type` (0 key, 2
    intra-only), hidden (`show` False: showable, error resilient,
    refreshing the slots of `refresh`) or shown, with superres (`denom`
    9-16, the frame upscaled to `up_w`, whose downscaled width must be the
    coded width) and frame ids ((delta length, id length) and `frame_id`);
    `show_slot` appends a frame header OBU whose show_existing_frame shows
    that slot. The header's fields before disable_frame_end_update_cdf
    are written anew and the rest of the frame OBU copied bit for bit: a
    frame size override of chosen field widths keeps the tile data on a
    byte boundary."""
    items = list(_obus(obus))
    seq = next(p for _, t, p in items if t == 1)
    s = _seq_fields(seq)
    coded_w, h = s["max_w"], s["max_h"]
    if denom is not None:
        up_w = up_w or coded_w
        if max((up_w * 8 + denom // 2) // denom, min(16, up_w)) != coded_w:
            raise ValueError("the downscaled width is not the coded width")
    else:
        up_w = coded_w
    need_w, need_h = max((up_w - 1).bit_length(), 1), \
        max((h - 1).bit_length(), 1)
    out = []
    for head, typ, payload in items:
        if typ not in (1, 6):
            out.append(_obu(head, payload))
            continue
        if typ == 6:
            f = _frame_prefix(payload, s)
            if f["intrabc"] and denom is not None:
                raise ValueError("intra block copy and superres")
            rest = _bits_of(payload)[f["end"]:]
            for override, wb, hb in [(0, need_w, need_h)] + [
                    (1, a, c) for a in range(need_w, 17)
                    for c in range(need_h, 17)]:
                w = _Writer()
                w.f(1, 0)
                w.f(2, frame_type)
                w.f(1, int(show))
                if not show:
                    w.f(1, 1)                        # showable_frame
                if not (frame_type == 0 and show):
                    w.f(1, 1)                        # error_resilient_mode
                w.f(1, f["dcu"])
                if s["sct"] == 2:
                    w.f(1, f["sct"])
                if f["sct"] and s["imv"] == 2:
                    w.f(1, f["imv"])
                if ids is not None:
                    w.f(ids[1], frame_id)
                w.f(1, override)
                w.f(s["order_bits"], 0)
                if not (frame_type == 0 and show):
                    w.f(8, refresh)
                    if refresh != 0xFF and s["order"]:
                        w.f(8 * s["order_bits"], 0)
                if override:
                    w.f(wb, up_w - 1)
                    w.f(hb, h - 1)
                if denom is not None:
                    w.f(1, 1)
                    w.f(3, denom - 9)
                w.f(1, f["render"])
                if f["render"]:
                    w.f(16, f["rw"])
                    w.f(16, f["rh"])
                if f["sct"] and denom is None:
                    w.f(1, f["intrabc"])
                if not f["dcu"]:
                    w.f(1, 1)                # disable_frame_end_update_cdf
                if (len(w.bits) - f["end"]) % 8 == 0:
                    break
            wbits, hbits = wb, hb
            w.bits += rest
            out.append(_obu(head, w.bytes()))
            if show_slot is not None:
                e = _Writer()
                e.f(1, 1)
                e.f(3, show_slot)
                if ids is not None:
                    e.f(ids[1], frame_id)
                e.f(1, 1)
                out.append(_obu(bytes([3 << 3]), e.bytes()))
        else:          # written once the frame has chosen the field widths
            seq_at = len(out)
            out.append(head)
    out[seq_at] = _obu(out[seq_at], _seq_write(
        s, int(denom is not None or s["superres"]), up_w, h, wbits, hbits,
        ids))
    return b"".join(out)


def _boxes(data, pos=0, end=None):
    end = len(data) if end is None else end
    while pos < end:
        size = int.from_bytes(data[pos:pos + 4], "big")
        yield data[pos + 4:pos + 8], data[pos + 8:pos + size]
        pos += size


def _box(typ, payload):
    return (8 + len(payload)).to_bytes(4, "big") + typ + payload


def _u(b, i, n):
    return int.from_bytes(b[i:i + n], "big")


def _ipma(b: bytes, assoc) -> bytes:
    """An ipma payload (version 0, flags 0) with each item's property
    bytes (essential bit and 1-based index) through assoc(id, list)."""
    if b[:4] != b"\0\0\0\0":
        raise ValueError("ipma of version 0 and flags 0 only")
    out, pos = b[:8], 8
    for _ in range(_u(b, 4, 4)):
        iid, c = _u(b, pos, 2), b[pos + 2]
        props = assoc(iid, list(b[pos + 3:pos + 3 + c]))
        out += iid.to_bytes(2, "big") + bytes([len(props)]) + bytes(props)
        pos += 3 + c
    return out


def rewrite(data: bytes, item=lambda iid, typ, b: b, prop=lambda t, p: p,
            new_props=(), assoc=None) -> bytes:
    """An AVIF still image rebuilt as ftyp, meta, mdat: each item's data
    (construction method 0) through item(id, type, bytes), each ipco
    property's payload through prop(type, payload), the (type, payload)
    pairs of `new_props` appended to ipco, and each item's ipma list
    through assoc(id, list) where given; iloc is written anew (version
    1, 4-byte offsets and lengths, one extent an item)."""
    top = dict(_boxes(data))
    meta = top[b"meta"]
    children = list(_boxes(meta, 4))
    iloc = dict(children)[b"iloc"]
    types = {}
    for typ, b in children:
        if typ == b"iinf":
            v = b[0]
            pos = 6 if v == 0 else 8
            for _, e in _boxes(b, pos):
                ev = e[0]
                iid = _u(e, 4, 2 if ev == 2 else 4)
                k = 4 + (2 if ev == 2 else 4) + 2
                types[iid] = e[k:k + 4]
    v = iloc[0]
    off_sz, len_sz, base_sz = iloc[4] >> 4, iloc[4] & 15, iloc[5] >> 4
    idx_sz = iloc[5] & 15 if v in (1, 2) else 0
    entries = []
    count = _u(iloc, 6, 2 if v < 2 else 4)
    pos = 8 if v < 2 else 10
    for _ in range(count):
        iid = _u(iloc, pos, 2 if v < 2 else 4)
        pos += 2 if v < 2 else 4
        method = 0
        if v in (1, 2):
            method = _u(iloc, pos, 2) & 15
            pos += 2
        pos += 2
        base = _u(iloc, pos, base_sz)
        pos += base_sz
        ext, n = [], _u(iloc, pos, 2)
        pos += 2
        for _ in range(n):
            pos += idx_sz
            ext.append((base + _u(iloc, pos, off_sz),
                        _u(iloc, pos + off_sz, len_sz)))
            pos += off_sz + len_sz
        entries.append((iid, method, ext))
    items = []
    for iid, method, ext in entries:
        if method == 1:
            items.append((iid, 1, ext, None))
        else:
            b = b"".join(data[o:o + n] for o, n in ext)
            items.append((iid, 0, None, item(iid, types.get(iid), b)))

    def new_meta(mdat_start):
        body, at = [], mdat_start
        for iid, method, ext, b in items:
            e = iid.to_bytes(2, "big") + method.to_bytes(2, "big") + b"\0\0"
            if method == 1:
                e += len(ext).to_bytes(2, "big") + b"".join(
                    o.to_bytes(4, "big") + n.to_bytes(4, "big")
                    for o, n in ext)
            else:
                e += b"\0\1" + at.to_bytes(4, "big") + \
                    len(b).to_bytes(4, "big")
                at += len(b)
            body.append(e)
        loc = _box(b"iloc", b"\1\0\0\0\x44\0" + len(items).to_bytes(2, "big")
                   + b"".join(body))
        out = b""
        for typ, b in children:
            if typ == b"iloc":
                out += loc
            elif typ == b"iprp":
                pp = b""
                for ptyp, pb in _boxes(b):
                    if ptyp == b"ipco":
                        pp += _box(b"ipco", b"".join(
                            _box(t, prop(t, q)) for t, q in _boxes(pb))
                            + b"".join(_box(t, q) for t, q in new_props))
                    elif ptyp == b"ipma" and assoc is not None:
                        pp += _box(b"ipma", _ipma(pb, assoc))
                    else:
                        pp += _box(ptyp, pb)
                out += _box(b"iprp", pp)
            else:
                out += _box(typ, b)
        return _box(b"meta", meta[:4] + out)

    ftyp = _box(b"ftyp", top[b"ftyp"])
    m = new_meta(0)
    m = new_meta(len(ftyp) + len(m) + 8)
    mdat = b"".join(b for _, method, _, b in items if method == 0)
    return ftyp + m + _box(b"mdat", mdat)


def deepen(data: bytes, depth: int) -> bytes:
    """An 8-bit AVIF still image (any item layout) as a `depth`-bit one:
    every av01 item's sequence header, av1C and pixi rewritten."""
    def prop(t, p):
        if t == b"av1C":
            mono, sx, sy = (p[2] >> 4) & 1, (p[2] >> 3) & 1, (p[2] >> 2) & 1
            b1 = (_profile(depth, (sx, sy), mono) << 5) | (p[1] & 31)
            b2 = (p[2] & 0x9f) | ((depth > 8) << 6) | ((depth == 12) << 5)
            return p[:1] + bytes([b1, b2]) + p[3:4] + (
                deepen_obus(p[4:], depth) if len(p) > 4 else b"")
        if t == b"pixi":
            return p[:5] + bytes([depth] * p[4])
        return p
    return rewrite(data, lambda iid, typ, b: deepen_obus(b, depth)
                   if typ == b"av01" else b, prop)


# ------------------------------------------------------------ grids
def _libavif():
    import ctypes
    import glob
    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(
        os.path.dirname(Image.__file__)), "pillow.libs", "libavif-*"))[0])
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 4
    lib.avifEncoderCreate.restype = vp
    for f, args in (("avifRGBImageSetDefaults", [vp, vp]),
                    ("avifImageRGBToYUV", [vp, vp]),
                    ("avifImageDestroy", [vp]),
                    ("avifEncoderDestroy", [vp]),
                    ("avifEncoderSetCodecSpecificOption", [vp, ctypes.c_char_p,
                                                          ctypes.c_char_p]),
                    ("avifEncoderAddImageGrid", [vp, ctypes.c_uint32,
                                                 ctypes.c_uint32, vp,
                                                 ctypes.c_int]),
                    ("avifEncoderFinish", [vp, vp]),
                    ("avifRWDataFree", [vp])):
        getattr(lib, f).argtypes = args
    return lib


_FORMATS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}


def grid_avif(cells, cols, rows, subsampling="4:2:0", quality=75, speed=6,
              full=True, advanced=None):
    """A grid image written by libavif 1.3.0's avifEncoderAddImageGrid
    (aom 3.12.1): `cells` are (H, W, 3 or 4) uint8 arrays in row-major
    order, every one the same size; 4 channels add an alpha grid. The
    encoder's speed and quality sit at byte offsets 8 and 32 of its
    struct; each image keeps libavif's default CICP (2, 2, 2)."""
    import ctypes
    lib = _libavif()
    images = []
    try:
        for a in cells:
            a = np.ascontiguousarray(a, np.uint8)
            h, w, c = a.shape
            img = lib.avifImageCreate(w, h, 8, _FORMATS[subsampling])
            images.append(img)
            ctypes.memmove(img + 16, (ctypes.c_int * 1)(int(full)), 4)
            rgb = ctypes.create_string_buffer(128)
            lib.avifRGBImageSetDefaults(rgb, img)
            base = ctypes.addressof(rgb)
            ctypes.memmove(base + 12, (ctypes.c_int * 1)(1 if c == 4 else 0),
                           4)
            ctypes.memmove(base + 48, (ctypes.c_uint64 * 1)(a.ctypes.data), 8)
            ctypes.memmove(base + 56, (ctypes.c_uint32 * 1)(w * c), 4)
            if lib.avifImageRGBToYUV(img, rgb):
                raise ValueError("avifImageRGBToYUV failed")
        enc = lib.avifEncoderCreate()
        try:
            ctypes.memmove(enc + 8, (ctypes.c_int * 1)(speed), 4)
            ctypes.memmove(enc + 32, (ctypes.c_int * 2)(quality, quality), 8)
            for k, v in (advanced or {}).items():
                lib.avifEncoderSetCodecSpecificOption(enc, k.encode(),
                                                      v.encode())
            arr = (ctypes.c_void_p * len(images))(*images)
            if lib.avifEncoderAddImageGrid(enc, cols, rows, arr, 2):
                raise ValueError("avifEncoderAddImageGrid failed")
            out = ctypes.create_string_buffer(16)
            if lib.avifEncoderFinish(enc, out):
                raise ValueError("avifEncoderFinish failed")
            ptr, size = np.frombuffer(out.raw, np.uint64)
            data = ctypes.string_at(int(ptr), int(size))
            lib.avifRWDataFree(out)
        finally:
            lib.avifEncoderDestroy(enc)
    finally:
        for img in images:
            lib.avifImageDestroy(img)
    return data


def grid_cells(a, cols, rows):
    """An image cut into cols x rows equal cells, row-major."""
    h, w = a.shape[0] // rows, a.shape[1] // cols
    return [a[r * h:(r + 1) * h, c * w:(c + 1) * w]
            for r in range(rows) for c in range(cols)]


def regrid(data: bytes, size=None, cells=None, ispe=None) -> bytes:
    """A grid file with its grid descriptor's output size set to `size`
    (w, h), the data of cell k (in dimg order) replaced by `cells[k]`, and
    each ispe property of a size in `ispe` ({(w, h): (w2, h2)}) restated."""
    meta = dict(_boxes(dict(_boxes(data))[b"meta"], 4))
    iref = meta[b"iref"]
    dimg = []
    for typ, b in _boxes(iref, 4):
        if typ == b"dimg":
            dimg += [_u(b, 4 + 2 * k, 2) for k in range(_u(b, 2, 2))]

    def item(iid, typ, b):
        if typ == b"grid" and size is not None:
            w, h = size
            big = w > 65535 or h > 65535
            n = 4 if big else 2
            return b[:1] + bytes([int(big)]) + b[2:4] + w.to_bytes(n, "big") \
                + h.to_bytes(n, "big")
        if cells and iid in dimg and dimg.index(iid) in cells:
            return cells[dimg.index(iid)]
        return b

    def prop(t, p):
        if t == b"ispe" and ispe:
            wh = (_u(p, 4, 4), _u(p, 8, 4))
            if wh in ispe:
                w, h = ispe[wh]
                return p[:4] + w.to_bytes(4, "big") + h.to_bytes(4, "big")
        return p
    return rewrite(data, item, prop)


def obus_of(data: bytes) -> bytes:
    """The primary item's AV1 data of a plain (not grid) AVIF file."""
    out = []
    rewrite(data, lambda iid, typ, b: out.append((iid, b)) or b)
    return dict(out)[_u(dict(_boxes(dict(_boxes(data))[b"meta"], 4))[
        b"pitm"], 4, 2)]


def derived() -> dict:
    """{name: bytes} of the deep and grid files, made from files already
    written."""
    def read(name):
        with open(os.path.join(HERE, name), "rb") as f:
            return f.read()
    floor_n = np.asarray(_asset("kitchen_floor_n.png"))
    grid = grid_avif(grid_cells(floor_n, 2, 2), 2, 2, subsampling="4:4:4",
                     quality=75, speed=4)
    return {"kitchen_floor_10.avif": deepen(read(
                "kitchen_floor_filtered.avif"), 10),
            "kitchen_wood_12.avif": deepen(read(
                "kitchen_wood_filtered.avif"), 12),
            "kitchen_floor_n_grid10.avif": deepen(grid, 10)}


def _find_box(data: bytes, path) -> int:
    """The offset of the box at `path` (types from the top level down)."""
    pos, end = 0, len(data)
    for k, typ in enumerate(path):
        while pos < end:
            size = int.from_bytes(data[pos:pos + 4], "big")
            if data[pos + 4:pos + 8] == typ:
                break
            pos += size
        else:
            raise KeyError(path)
        if k < len(path) - 1:
            end = pos + size
            pos += 12 if typ == b"meta" else 8
    return pos


_STBL = (b"moov", b"trak", b"mdia", b"minf", b"stbl")


def retrack(data: bytes, sample0=None, size=None) -> bytes:
    """An `avis` file (one track, its samples in one chunk in mdat, which
    follows moov) with its first sample replaced by `sample0` and its
    tkhd's size restated as `size` (w, h)."""
    d = bytearray(data)
    if size is not None:
        i = _find_box(data, (b"moov", b"trak", b"tkhd"))
        end = i + _u(data, i, 4)
        d[end - 8:end] = (size[0] << 16).to_bytes(4, "big") + \
            (size[1] << 16).to_bytes(4, "big")
    if sample0 is None:
        return bytes(d)
    i = _find_box(data, _STBL + (b"stsz",))
    if _u(data, i + 12, 4):
        raise ValueError("samples of one size")
    old = _u(data, i + 20, 4)
    d[i + 20:i + 24] = len(sample0).to_bytes(4, "big")
    co = _find_box(data, _STBL + (b"stco",))
    if _u(data, co + 12, 4) != 1:
        raise ValueError("more than one chunk")
    at = _u(data, co + 16, 4)
    m = _find_box(data, (b"mdat",))
    if not m < at <= m + _u(data, m, 4) or m < co:
        raise ValueError("the chunk is not in an mdat after moov")
    d = d[:at] + bytes(sample0) + d[at + old:]
    d[m:m + 4] = (_u(data, m, 4) + len(sample0) - old).to_bytes(4, "big")
    return bytes(d)


def first_sample(data: bytes) -> bytes:
    i = _find_box(data, _STBL + (b"stsz",))
    co = _find_box(data, _STBL + (b"stco",))
    at = _u(data, co + 16, 4)
    return data[at:at + _u(data, i + 20, 4)]


def reframe(data: bytes, **kw) -> bytes:
    """A still AVIF file whose av01 items' frames (and av1C's sequence
    header) go through rewrite_key(**kw); with superres the ispe states
    the upscaled width."""
    up_w = kw.get("up_w")

    def prop(t, p):
        if t == b"av1C" and len(p) > 4:
            return p[:4] + rewrite_key(p[4:], **{
                k: v for k, v in kw.items() if k != "show_slot"})
        if t == b"ispe" and up_w:
            return p[:4] + up_w.to_bytes(4, "big") + p[8:]
        return p
    return rewrite(data, lambda iid, typ, b: rewrite_key(b, **kw)
                   if typ == b"av01" else b, prop)


def restate(data: bytes, sizes: dict) -> bytes:
    """A still AVIF file with each ispe of a size in `sizes` ({(w, h):
    (w2, h2)}) restated, and a grid's output size with its item's."""
    def prop(t, p):
        wh = (_u(p, 4, 4), _u(p, 8, 4)) if t == b"ispe" else None
        if wh in sizes:
            w, h = sizes[wh]
            return p[:4] + w.to_bytes(4, "big") + h.to_bytes(4, "big")
        return p

    def item(iid, typ, b):
        if typ == b"grid":
            n = 4 if b[1] & 1 else 2
            wh = (_u(b, 4, n), _u(b, 4 + n, n))
            if wh in sizes:
                w, h = sizes[wh]
                return b[:4] + w.to_bytes(n, "big") + h.to_bytes(n, "big")
        return b
    return rewrite(data, item, prop)


def superres_width(coded: int, denom: int) -> int:
    """The narrowest upscaled width whose superres downscale by denom/8
    is `coded` (dav1d's rounding)."""
    return next(u for u in range(coded, 3 * coded + 16)
                if max((u * 8 + denom // 2) // denom, min(16, u)) == coded)


def _encode(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "AVIF", **kw)
    return buf.getvalue()


def scaled() -> dict:
    """{name: bytes} of the files libavif scales, superres files and
    files whose first picture is shown by show_existing_frame, made from
    the assets (with a generator of their own) and from files already
    written."""
    def read(name):
        with open(os.path.join(HERE, name), "rb") as f:
            return f.read()
    g = np.random.default_rng(22)
    wood = _asset("kitchen_wood.png").resize((192, 160), Image.LANCZOS)
    floor = _asset("kitchen_floor.png").resize((128, 256), Image.LANCZOS)
    sup = _encode(Image.fromarray(_pattern(g, 65, 97, 3)), quality=60,
                  speed=4, advanced={"loopfilter-control": "0",
                                     "enable-cdef": "0"})
    seq = read("sequence.avif")
    return {
        # coded 192x160, stated 256x256: libyuv's bilinear upscale
        "kitchen_wood_scaled.avif": restate(_encode(wood), {
            (192, 160): (256, 256)}),
        # coded 128 wide, upscaled to 256 (denominator 16), deblocked and
        # filtered with CDEF
        "kitchen_floor_superres.avif": reframe(_encode(
            floor, speed=4, advanced={"enable-cdef": "1",
                                      "enable-restoration": "0"}),
            denom=16, up_w=256),
        # a hidden key frame in slot 3, shown by show_existing_frame
        "kitchen_floor_n_hidden.avif": reframe(read(
            "kitchen_floor_n_filtered.avif"), show=False, refresh=0x08,
            show_slot=3),
        # colour and alpha stated at 3/4 of their 48x40
        "alpha_scaled.avif": restate(read("alpha_prem.avif"), {
            (48, 40): (36, 30)}),
        # a grid of 128x128 cells stated at 96x96, the output at 192x192
        "grid_scaled.avif": restate(read("kitchen_floor_n_grid10.avif"), {
            (128, 128): (96, 96), (256, 256): (192, 192)}),
        # 12 bits, upscaled from 97 to 145 (denominator 12), restored
        "superres_12.avif": deepen(reframe(sup, denom=12, up_w=145), 12),
        # film grain's frame as a hidden intra-only frame
        "hidden_intra_grain.avif": reframe(
            read("film_grain.avif"), frame_type=2, show=False,
            refresh=0x21, show_slot=5),
        # the sequence's first sample as a hidden key frame with frame
        # ids, shown by show_existing_frame, the track stated at 60x36
        "hidden_sequence.avif": retrack(seq, rewrite_key(
            first_sample(seq), show=False, refresh=0x02, show_slot=1,
            ids=(5, 9), frame_id=300), size=(60, 36)),
    }


def _tools(path) -> list:
    """The filters the port reads as turned on in the file's frame."""
    import sys
    sys.path.insert(0, REPO)
    from fluctus_tpu_torch.scene import avif
    obus = avif.parse(open(path, "rb").read())[0]
    if isinstance(obus, avif.Grid):            # the first cell's
        obus = obus.cells[0][0]
    frame = avif.decode_av1(obus)
    return [k for k, bit in avif.TOOLS.items() if frame.tools & bit]


def _keep_times(new: bytes, old: bytes) -> bytes:
    """`new` with the creation and modification times of its mvhd, tkhd
    and mdhd boxes (libavif writes the time of writing) taken from `old`,
    the file already here."""
    out = bytearray(new)
    for box in (b"mvhd", b"tkhd", b"mdhd"):
        i, j = new.find(box), old.find(box)
        if i < 0 or j < 0 or new[i + 4] != old[j + 4]:
            continue
        n = 16 if new[i + 4] == 1 else 8     # version 1: 64-bit times
        out[i + 8:i + 8 + n] = old[j + 8:j + 8 + n]
    return bytes(out)


def main():
    record = {"pil": Image.__version__, "libavif": features.version("avif"),
              "files": {}}
    for name, (img, kw) in files().items():
        buf = io.BytesIO()
        img.save(buf, "AVIF", **kw)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    for name, data in derived().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    frames = [Image.fromarray(_pattern(np.random.default_rng(k), 24, 40, 3))
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   quality=100)
    path = os.path.join(HERE, "sequence.avif")
    data = buf.getvalue()
    if os.path.exists(path):
        with open(path, "rb") as f:
            data = _keep_times(data, f.read())
    with open(path, "wb") as f:
        f.write(data)
    for name, data in scaled().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    for name in sorted(os.listdir(HERE)):
        if not name.endswith(".avif"):
            continue
        path = os.path.join(HERE, name)
        rgba = np.asarray(Image.open(path).convert("RGBA"))
        entry = {"bytes": os.path.getsize(path),
                 "sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
                 "shape": list(rgba.shape), "tools": _tools(path)}
        record["files"][name] = entry
    with open(os.path.join(HERE, "avif.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
