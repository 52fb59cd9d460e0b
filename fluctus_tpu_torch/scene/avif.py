"""AVIF decoding through the port's AV1 decoder (`native/av1.cpp`), with
libavif 1.3.0's reading of the file around it, so the RGBA equals PIL
12's `Image.open(...).convert("RGBA")`.

PIL's side, copied here:

- the container as libavif parses it: the `ftyp` brands (`avif` or `avis`
  among the major and compatible brands), the `meta` box (`hdlr` of type
  `pict`, `pitm`, `iloc` with construction methods 0 and 1 and any number
  of extents, `iinf`/`infe`, `iref` and `iprp`/`ipco`/`ipma` with the
  properties `ispe`, `pixi`, `av1C`, `colr`, `auxC`, `irot`, `imir`,
  `clap`, `pasp`), and for a file whose major brand is `avis` the first
  sample of its tracks (`moov`/`trak`/`mdia`/`minf`/`stbl`: `stsd`,
  `stsz`, `stco`/`co64`, `stsc`);
- the alpha item (an `auxl` reference with the alpha `auxC` type) and its
  `prem` reference, which makes the colour premultiplied;
- `grid` items, colour or alpha (libavif's avifParseImageGridBox and its
  checks on the cells: as many `dimg` cells as the grid has, each an
  av01 item with av1C, all alike in size, depth, subsampling, range and
  colour description, at least 64x64, even where the chroma is
  subsampled, covering the output with the last row and column reaching
  into it, and the grid's ispe equal to its output size); the cells are
  joined in `dimg` order and the output cropped from them, and the `colr`
  property read is the grid item's;
- libavif's YUV to RGB step (scene/avif_rgb.py), and PIL's mode: RGBA
  where the file has alpha, else RGB. PIL does not apply `irot`, `imir`
  or `clap` to the pixels (it turns `irot`/`imir` into an EXIF
  orientation), so neither does the port.

AV1 frames decode at 8, 10 and 12 bits with their in-loop filters
(deblocking, CDEF, superres upscaling, loop restoration) and film grain,
as dav1d applies them for libavif, also where the first picture is an
earlier frame that `show_existing_frame` shows; deeper planes are uint16.
A frame whose size differs from the size its item or track states is
scaled to it as libavif scales it (scene/avif_scale.py, colour, alpha and
each grid cell), and avif_rgb.py brings the planes to PIL's 8-bit RGB as
libavif does. A first shown inter frame and the derived items `iovl` and
`tmap` raise UnsupportedImage naming the tool; a file libavif or dav1d
refuses raises ValueError, which the texture pool turns into -1 as PIL's
failure does in the JAX package.

The library is compiled with g++ at first use into the package build
directory; a failed compile raises, it never turns into a missing texture.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from fluctus_tpu_torch.build import build_shared
from fluctus_tpu_torch.scene import avif_scale
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "av1.cpp")
_lib = None

# the bits of Frame.tools
TOOLS = {"deblocking": 1, "CDEF": 2, "loop restoration": 4, "film grain": 8,
         "superres": 16}

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")


def load_library():
    """Build (at first use) and load the decoder."""
    global _lib
    if _lib is None:
        path, _, _ = build_shared(
            _SRC, "av1", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"])
        lib = ctypes.CDLL(path)
        lib.av1_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                   ctypes.c_void_p]
        lib.av1_decode.restype = ctypes.c_int
        lib.av1_planes.argtypes = [ctypes.c_void_p] * 3
        lib.av1_planes.restype = ctypes.c_int
        lib.av1_last_error.argtypes = []
        lib.av1_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class Frame:
    """One decoded AV1 frame: its planes, the sequence header's colour
    description, and `tools`, the filters its frame header turns on (a
    mask of TOOLS)."""

    def __init__(self, info, planes):
        (self.width, self.height, self.ss_x, self.ss_y, self.mono,
         self.bitdepth, self.cp, self.tc, self.mc, self.full_range,
         self.tools) = (int(v) for v in info)
        self.planes = planes


def decode_av1(obus: bytes) -> Frame:
    """The first shown frame of an AV1 OBU stream, as dav1d gives it: uint8
    planes at 8 bits, uint16 deeper."""
    lib = load_library()
    info = np.zeros(11, np.int32)
    rc = lib.av1_decode(obus, len(obus), info.ctypes.data)
    if rc:
        msg = lib.av1_last_error().decode()
        if rc == 2:
            e = UnsupportedImage(f"AVIF images whose AV1 frame needs {msg} "
                                 "are not decoded by the port")
            # the refused frame's size and depth, where it was shown
            e.frame = Frame(info, None) if info[0] else None
            raise e
        raise ValueError(f"AV1: {msg}")
    w, h, sx, sy, mono, depth = (int(v) for v in info[:6])
    cw, ch = (w + sx) >> sx, (h + sy) >> sy
    dt = np.uint8 if depth == 8 else np.uint16
    y = np.empty((h, w), dt)
    u = np.empty((ch, cw), dt)
    v = np.empty((ch, cw), dt)
    lib.av1_planes(y.ctypes.data, u.ctypes.data, v.ctypes.data)
    return Frame(info, (y,) if mono else (y, u, v))


# ------------------------------------------------------------------ boxes
def _bad(what: str):
    raise ValueError(f"AVIF: {what}")


class _Stream:
    """libavif's avifROStream over data[pos:end]: reads that run past the
    end fail, as libavif's parse does."""

    def __init__(self, data, pos, end):
        self.d, self.p, self.e = data, pos, end

    def left(self):
        return self.e - self.p

    def raw(self, n):
        if n > self.e - self.p:
            _bad("truncated box")
        b = self.d[self.p:self.p + n]
        self.p += n
        return b

    def u(self, n):
        return int.from_bytes(self.raw(n), "big")

    def version(self, enforce=None):
        v, flags = self.u(1), self.u(3)
        if enforce is not None and v != enforce:
            _bad(f"box version {v}, not {enforce}")
        return v, flags

    def string(self):
        i = self.d.find(b"\0", self.p, self.e)
        if i < 0:
            _bad("unterminated string")
        out = self.d[self.p:i]
        self.p = i + 1
        return out

    def box(self, top=False):
        """(type, payload stream, size 0?) of the next box; a child box
        must fit its parent (a top-level one is checked by the caller)."""
        size, typ = self.u(4), self.raw(4)
        hdr = 8
        if size == 1:
            size, hdr = self.u(8), 16
        if typ == b"uuid":
            self.raw(16)
            hdr += 16
        if size == 0:
            if not top:
                _bad("box of size 0 inside another")
            return typ, _Stream(self.d, self.p, self.e), True
        if size < hdr:
            _bad(f"box {typ!r} smaller than its header")
        n = size - hdr
        if not top and n > self.left():
            _bad(f"box {typ!r} runs past its parent")
        sub = _Stream(self.d, self.p, min(self.e, self.p + n))
        sub.want = n
        self.p += n
        return typ, sub, False


def _prop(stream, typ):
    """One property of `ipco` or of a sample entry: (type, value), the
    value None for the properties libavif keeps as opaque."""
    if typ == b"ispe":
        stream.version(0)
        return typ, (stream.u(4), stream.u(4))
    if typ == b"av1C":
        b0 = stream.u(1)
        if b0 != 0x81:                      # marker 1, version 1
            _bad("av1C marker or version")
        stream.u(1)
        b2 = stream.u(1)
        stream.raw(1)
        # the depth as libavif reads it: twelve_bit, else high_bitdepth
        return typ, 12 if b2 & 0x20 else 10 if b2 & 0x40 else 8
    if typ == b"colr":
        kind = stream.raw(4)
        if kind == b"nclx":
            cp, tc, mc, b = (stream.u(2), stream.u(2), stream.u(2),
                             stream.u(1))
            if b & 0x7F:
                _bad("nclx reserved bits")
            return typ, ("nclx", cp, tc, mc, b >> 7)
        if kind in (b"rICC", b"prof"):
            return typ, ("icc",)
        return typ, ("other",)
    if typ == b"auxC":
        stream.version(0)
        return typ, stream.string()
    if typ == b"pixi":
        stream.version(0)
        n = stream.u(1)
        if n < 1 or n > 4:
            _bad("pixi channel count")
        depths = [stream.u(1) for _ in range(n)]
        if len(set(depths)) > 1:       # libavif: not implemented
            _bad("pixi depths differ between planes")
        return typ, depths
    if typ == b"irot":
        v = stream.u(1)
        if v & 0xFC:
            _bad("irot reserved bits")
        return typ, v & 3
    if typ == b"imir":
        v = stream.u(1)
        if v & 0xFE:
            _bad("imir reserved bits")
        return typ, v & 1
    if typ == b"pasp":
        return typ, (stream.u(4), stream.u(4))
    if typ == b"clap":
        return typ, tuple(stream.u(4) for _ in range(8))
    if typ in (b"a1op", b"lsel", b"a1lx", b"clli"):
        stream.raw(1)
        return typ, True
    return typ, None


def _ipco(stream):
    out = []
    while stream.left() > 0:
        typ, sub, _ = stream.box()
        out.append(_prop(sub, typ))
    return out


class _Item:
    def __init__(self):
        self.type = None
        self.extents = None
        self.method = 0
        self.props = []
        self.unsupported_essential = False
        self.refs = {}           # reference type -> ids
        self.ipma = False

    def prop(self, typ):
        return next((v for t, v in self.props if t == typ), None)

    def has(self, typ):
        return any(t == typ for t, _ in self.props)


def _item_id(v):
    if v == 0:
        _bad("item id 0")
    return v


def _meta(stream):
    """avifParseMetaBox: {id: _Item}, the primary item id and idat."""
    stream.version(0)
    items, primary, idat, props = {}, None, b"", []
    seen = set()
    first = True

    def item(iid):
        return items.setdefault(iid, _Item())
    ipma_data = []
    while stream.left() > 0:
        typ, sub, _ = stream.box()
        if first:
            if typ != b"hdlr":
                _bad("meta does not start with hdlr")
            first = False
        if typ in seen and typ in (b"hdlr", b"iloc", b"pitm", b"idat",
                                   b"iprp", b"iinf", b"iref"):
            _bad(f"second {typ!r} box")
        seen.add(typ)
        if typ == b"hdlr":
            sub.version(0)
            if sub.u(4) != 0:
                _bad("hdlr pre_defined")
            if sub.raw(4) != b"pict":
                _bad("meta handler is not pict")
            sub.raw(12)
            sub.string()
        elif typ == b"pitm":
            v, _ = sub.version()
            primary = sub.u(2 if v == 0 else 4)
        elif typ == b"idat":
            idat = sub.raw(sub.left())
        elif typ == b"iloc":
            v, _ = sub.version()
            if v > 2:
                _bad("iloc version")
            a, b = sub.u(1), sub.u(1)
            off_sz, len_sz, base_sz = a >> 4, a & 15, b >> 4
            idx_sz = b & 15 if v in (1, 2) else 0
            if any(n not in (0, 4, 8) for n in (off_sz, len_sz, base_sz,
                                                idx_sz)):
                _bad("iloc field size")
            for _ in range(sub.u(2 if v < 2 else 4)):
                it = item(_item_id(sub.u(2 if v < 2 else 4)))
                if it.extents:
                    _bad("second iloc entry for an item")
                method = 0
                if v in (1, 2):
                    method = sub.u(2)
                    if method >> 4:        # libavif: 12 reserved bits of 0
                        _bad("iloc reserved bits")
                    if method not in (0, 1):
                        _bad("iloc construction method")
                sub.u(2)
                base = sub.u(base_sz)
                ext = []
                for _ in range(sub.u(2)):
                    if idx_sz:
                        sub.u(idx_sz)
                    ext.append((base + sub.u(off_sz), sub.u(len_sz)))
                it.extents, it.method = ext, method
        elif typ == b"iinf":
            v, _ = sub.version()
            if v > 1:
                _bad("iinf version")
            for _ in range(sub.u(2 if v == 0 else 4)):
                etyp, e, _ = sub.box()
                if etyp != b"infe":
                    _bad("iinf holds a box that is not infe")
                ev, _ = e.version()
                if ev not in (2, 3):
                    _bad("infe version")
                it = item(_item_id(e.u(2 if ev == 2 else 4)))
                e.u(2)
                it.type = e.raw(4)
                e.string()
                if it.type == b"mime":
                    e.string()
        elif typ == b"iref":
            v, _ = sub.version()
            # libavif reads each reference's fields on from the iref box,
            # past its own size, once its header has checked out; it skips
            # the references of a version it does not know
            while sub.left() > 0:
                rtyp, child, _ = sub.box()
                if v > 1:
                    break
                sub.p = child.p
                frm = _item_id(sub.u(2 if v == 0 else 4))
                for _k in range(sub.u(2)):
                    to = _item_id(sub.u(2 if v == 0 else 4))
                    item(frm).refs.setdefault(rtyp, []).append(to)
        elif typ == b"iprp":
            ptyp, pco, _ = sub.box()
            if ptyp != b"ipco":
                _bad("iprp does not start with ipco")
            props = _ipco(pco)
            versions = set()
            while sub.left() > 0:
                mtyp, m, _ = sub.box()
                if mtyp != b"ipma":
                    _bad("iprp holds a box that is not ipma")
                v, flags = m.version()
                if (v, flags) in versions:
                    _bad("second ipma of one version and flags")
                versions.add((v, flags))
                ipma_data.append((v, flags, m))
    if first:
        _bad("empty meta box")
    prev = 0
    for v, flags, m in ipma_data:
        prev = 0
        for _ in range(m.u(4)):
            iid = _item_id(m.u(2 if v < 1 else 4))
            if iid <= prev:
                _bad("ipma item ids out of order")
            prev = iid
            it = item(iid)
            if it.ipma:
                _bad("second ipma entry for an item")
            it.ipma = True
            for _ in range(m.u(1)):
                x = m.u(2 if flags & 1 else 1)
                essential = bool(x >> (15 if flags & 1 else 7))
                k = x & (0x7FFF if flags & 1 else 0x7F)
                if k == 0:
                    continue
                if k > len(props):
                    _bad("property index out of range")
                ptyp, val = props[k - 1]
                if val is None:
                    if essential:
                        it.unsupported_essential = True
                    continue
                if essential and ptyp == b"a1lx":
                    _bad("a1lx marked essential")
                if not essential and ptyp in (b"a1op", b"lsel"):
                    _bad(f"{ptyp!r} not marked essential")
                it.props.append((ptyp, val))
    return items, primary, idat


def _item_data(data, it, idat):
    if not it.extents:
        _bad("item has no data")
    src = idat if it.method == 1 else data
    out = b""
    for off, length in it.extents:
        if off + length > len(src):
            _bad("item data runs past the file")
        out += src[off:off + length]
    return out


class Grid:
    """A `grid` item as libavif 1.3.0 reads it: `rows` x `cols` cells (the
    AV1 data of each `dimg` reference, in order, with its stated size),
    joined into a `width` x `height` output."""

    def __init__(self, rows, cols, width, height, cells):
        self.rows, self.cols, self.width, self.height = rows, cols, width, \
            height
        self.cells = cells


def _grid(data, items, it, idat):
    """avifParseImageGridBox over the grid item's data, then its cells:
    as many `dimg` references as the grid has cells, each an av01 item
    with av1C and no unknown essential property."""
    payload = _item_data(data, it, idat)
    g = _Stream(payload, 0, len(payload))
    if g.u(1) != 0:
        _bad("grid version")
    flags = g.u(1)
    rows, cols = g.u(1) + 1, g.u(1) + 1
    n = 4 if flags & 1 else 2
    w, h = g.u(n), g.u(n)
    if not w or not h or _too_large((w, h)) or g.left():
        _bad("grid descriptor")
    cells = []
    dimg = it.refs.get(b"dimg", [])
    if len(set(dimg)) != len(dimg):     # ISO/IEC 14496-12: at most once
        _bad("a grid cell referenced twice")
    for iid in dimg:
        cell = items.get(iid)
        if cell is None:
            continue
        if cell.type != b"av01" or cell.unsupported_essential:
            _bad("grid cell that is not a decodable AV1 image")
        if not cell.has(b"av1C"):
            _bad("grid cell lacks av1C")
        _check_pixi(cell, cell)
        cells.append((_item_data(data, cell, idat), cell.prop(b"ispe")))
    if len(cells) != rows * cols:
        _bad("grid cell count")
    _check_pixi(it, items[dimg[0]])
    return Grid(rows, cols, w, h, cells)


def _check_pixi(it, config):
    """libavif: an item's pixi depths match the av1C depth of `config`
    (the item itself, or a grid's first cell)."""
    if any(d != config.prop(b"av1C") for d in it.prop(b"pixi") or []):
        _bad("pixi depth differs from the AV1 configuration's")


def _from_items(data, meta):
    items, primary, idat = meta
    color = items.get(primary)
    if color is None or color.unsupported_essential or color.type is None:
        _bad("no primary item")
    if color.type in (b"iovl", b"tmap"):
        raise UnsupportedImage(f"AVIF {color.type.decode()} items are not "
                               "decoded by the port")
    if color.type not in (b"av01", b"grid"):
        _bad("the primary item is not an AV1 image")
    alpha = None
    for iid, it in sorted(items.items()):
        if iid == primary or it.unsupported_essential or \
                not it.extents or it.type not in (b"av01", b"grid"):
            continue
        if it.prop(b"auxC") in ALPHA_URNS and primary in \
                it.refs.get(b"auxl", []):
            alpha = it
            break
    out = []
    for it in (color, alpha):
        if it is None:
            out.append(None)
            continue
        if not it.has(b"ispe"):
            _bad("image item lacks ispe")
        if it.type == b"grid":
            out.append(_grid(data, items, it, idat))
            continue
        if not it.has(b"av1C"):
            _bad("image item lacks av1C")
        _check_pixi(it, it)
        out.append(_item_data(data, it, idat))
    prem = alpha is not None and any(
        items.get(x) is alpha for x in color.refs.get(b"prem", []))
    return (out[0], color.prop(b"colr"), out[1], prem,
            color.prop(b"ispe"),
            alpha.prop(b"ispe") if alpha else None)


class _Track:
    def __init__(self):
        self.id = 0
        self.size = (0, 0)
        self.refs = {}
        self.formats = []        # (sample entry type, properties)
        self.chunks = []
        self.sample_size = 0
        self.sizes = []
        self.stsc = []
        self.timescale = 0       # mdhd's; PIL divides by the colour track's


def _full(stream, enforce=None):
    v, _ = stream.version()
    if enforce is not None and v not in enforce:
        _bad("box version")
    return v


def _stbl(stream, tr):
    while stream.left() > 0:
        typ, b, _ = stream.box()
        if typ in (b"stco", b"co64"):
            _full(b, (0,))
            tr.chunks = [b.u(4 if typ == b"stco" else 8)
                         for _ in range(b.u(4))]
        elif typ == b"stsc":
            _full(b, (0,))
            tr.stsc = [(b.u(4), b.u(4), b.u(4)) for _ in range(b.u(4))]
            firsts = [f for f, _, _ in tr.stsc]
            if firsts and (firsts[0] != 1 or any(
                    a >= b for a, b in zip(firsts, firsts[1:]))):
                _bad("stsc chunks not increasing from 1")
        elif typ == b"stsz":
            _full(b, (0,))
            tr.sample_size, n = b.u(4), b.u(4)
            if tr.sample_size == 0:
                tr.sizes = [b.u(4) for _ in range(n)]
            else:
                tr.sizes = [tr.sample_size] * n
        elif typ == b"stss":
            _full(b, (0,))
            for _ in range(b.u(4)):
                b.u(4)
        elif typ == b"stts":
            _full(b, (0,))
            for _ in range(b.u(4)):
                b.u(4), b.u(4)
        elif typ == b"stsd":
            _full(b, (0,))
            for _ in range(b.u(4)):
                ftyp, e, _ = b.box()
                e.raw(78)                    # VisualSampleEntry fields
                tr.formats.append((ftyp, _ipco(e) if ftyp == b"av01"
                                   else []))


def _moov(stream):
    tracks = []
    while stream.left() > 0:
        typ, b, _ = stream.box()
        if typ == b"trak":
            tr = _Track()
            while b.left() > 0:
                ttyp, t, _ = b.box()
                if ttyp == b"tkhd":
                    v = _full(t, (0, 1))
                    t.raw(16 if v == 1 else 8)
                    tr.id = t.u(4)
                    t.raw(4)
                    t.raw(8 if v == 1 else 4)
                    t.raw(52)
                    tr.size = (t.u(4) >> 16, t.u(4) >> 16)
                elif ttyp == b"tref":
                    while t.left() > 0:
                        rtyp, r, _ = t.box()
                        while r.left() >= 4:
                            tr.refs.setdefault(rtyp, []).append(r.u(4))
                elif ttyp == b"edts":
                    elst = False
                    while t.left() > 0:
                        etyp, e, _ = t.box()
                        if etyp == b"elst":
                            elst = True
                            v, flags = e.version()
                            if v > 1:
                                _bad("elst version")
                            if flags & 1:
                                if e.u(4) != 1:
                                    _bad("elst entry count")
                                if e.u(8 if v == 1 else 4) == 0:
                                    _bad("elst segment duration 0")
                    if not elst:
                        _bad("edts without elst")
                elif ttyp == b"mdia":
                    while t.left() > 0:
                        mtyp, m, _ = t.box()
                        if mtyp == b"mdhd":
                            v = _full(m, (0, 1))
                            m.raw(16 if v == 1 else 8)
                            tr.timescale = m.u(4)
                            if tr.timescale == 0:
                                _bad("mdhd timescale 0")
                        elif mtyp == b"hdlr":
                            m.version(0)
                            if m.u(4) != 0:
                                _bad("hdlr pre_defined")
                            m.raw(16)         # handler type, reserved
                            m.string()        # its name, NUL-terminated
                        elif mtyp == b"minf":
                            while m.left() > 0:
                                ntyp, n, _ = m.box()
                                if ntyp == b"stbl":
                                    _stbl(n, tr)
            tracks.append(tr)
    return tracks


def _first_sample(data, tr):
    """The track's first sample, after libavif's walk of every sample
    (avifCodecDecodeInputFillFromSampleTable): each chunk's sample count
    from stsc, each size from stsz, every sample within the file."""
    samples, k = [], 0
    for ci, off in enumerate(tr.chunks):
        count = next((n for first, n, _ in reversed(tr.stsc)
                      if first <= ci + 1), 0)
        if count == 0:
            _bad("a chunk without samples")
        for _ in range(count):
            if tr.sample_size:
                size = tr.sample_size
            elif k < len(tr.sizes):
                size = tr.sizes[k]
            else:
                _bad("truncated sample table")
            if off + size > len(data):
                _bad("sample runs past the file")
            samples.append((off, size))
            off += size
            k += 1
    if not samples:
        _bad("track without samples")
    off, size = samples[0]
    return data[off:off + size]


def _from_tracks(data, tracks):
    def ok(t):
        return t.id and t.chunks and any(f == b"av01" for f, _ in t.formats)
    color = next((t for t in tracks if ok(t) and not t.refs.get(b"auxl")),
                 None)
    if color is None:
        _bad("no AV1 colour track")
    if not color.timescale:      # PIL divides by it
        _bad("colour track without mdhd")
    alpha = next((t for t in tracks if ok(t) and color.id in
                  t.refs.get(b"auxl", [])), None)
    for t in (color, alpha):
        if t is not None and not any(
                any(k == b"av1C" for k, _ in p)
                for f, p in t.formats if f == b"av01"):
            _bad("AV1 track without av1C")
    props = next(p for f, p in color.formats if f == b"av01")
    colr = next((v for t, v in props if t == b"colr"), None)
    prem = alpha is not None and alpha.id in color.refs.get(b"prem", [])
    return (_first_sample(data, color), colr,
            _first_sample(data, alpha) if alpha else None, prem,
            color.size, alpha.size if alpha else None)


def parse(data: bytes):
    """(colour OBUs or Grid, colr property, alpha OBUs, Grid or None,
    premultiplied, the colour and alpha sizes the container states) of
    the image PIL
    loads as frame 0, as libavif 1.3.0's avifParse and avifDecoderReset
    read it: the top-level boxes until those the brands need are parsed,
    each of ftyp, meta and moov once and whole."""
    s = _Stream(data, 0, len(data))
    ftyp = meta = tracks = None
    needs_meta = needs_moov = False
    while s.left() > 0:
        if s.left() < 8:
            _bad("truncated box header")
        typ, sub, size0 = s.box(top=True)
        if typ in (b"ftyp", b"meta", b"moov"):
            if size0 or sub.want > sub.left():
                _bad(f"truncated {typ!r} box")
        elif size0:
            _bad("top-level box of size 0")
        if s.p > len(data) and typ not in (b"ftyp", b"meta", b"moov"):
            _bad("box runs past the file")
        if typ == b"ftyp":
            if ftyp is not None:
                _bad("second ftyp")
            if sub.left() < 8 or (sub.left() - 8) % 4:
                _bad("ftyp size")
            major = sub.raw(4)
            sub.raw(4)
            brands = {major} | {sub.raw(4) for _ in range(sub.left() // 4)}
            if not {b"avif", b"avis"} & brands:
                _bad("ftyp names no AVIF brand")
            ftyp = major
            needs_meta, needs_moov = b"avif" in brands, b"avis" in brands
        elif typ == b"meta":
            if meta is not None:
                _bad("second meta")
            meta = _meta(sub)
        elif typ == b"moov":
            if tracks is not None:
                _bad("second moov")
            tracks = _moov(sub)
        if ftyp is not None and (not needs_meta or meta is not None) and \
                (not needs_moov or tracks is not None):
            break
    if ftyp is None:
        _bad("no ftyp")
    if (needs_meta and meta is None) or (needs_moov and tracks is None):
        _bad("truncated file")
    if meta is not None:
        _check_items(meta[0])
    if ftyp == b"avis" or (ftyp != b"avif" and tracks):
        return _from_tracks(data, tracks or [])
    if meta is None:
        _bad("no meta box")
    return _from_items(data, meta)


def _too_large(wh) -> bool:
    """libavif's default size limits (avifDimensionsTooLarge)."""
    return wh[0] > 32768 or wh[1] > 32768 or wh[0] * wh[1] > 16384 ** 2


def _check_items(items):
    """avifDecoderParse's check of every image item with data, whichever
    source is decoded: each needs an ispe property of a size within the
    limits."""
    for it in items.values():
        if it.unsupported_essential or it.type not in (b"av01", b"grid") \
                or not it.extents:
            continue
        wh = it.prop(b"ispe")
        if wh is None or not wh[0] or not wh[1] or _too_large(wh):
            _bad("image item without a valid ispe")


def _limited_to_full(plane: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifLimitedToFullY, which it applies to an alpha plane
    coded in limited range (C division, toward zero)."""
    lo, hi = 16 << (depth - 8), 235 << (depth - 8)
    top = (1 << depth) - 1
    x = (plane.astype(np.int64) - lo) * top + (hi - lo) // 2
    q = np.where(x >= 0, x // (hi - lo), -(-x // (hi - lo)))
    return np.clip(q, 0, top).astype(plane.dtype)


def _frame(obus, refused: list, alpha: bool = False) -> Frame:
    """decode_av1 (of each cell and joined, for a Grid), where a refusal of
    a shown frame is added to `refused` and the frame's size and depth
    returned without planes. An `alpha` frame keeps its first plane,
    brought to full range where coded in limited range (libavif's
    avifImageLimitedToFullAlpha, before it scales the frame)."""
    if isinstance(obus, Grid):
        return _join(obus, refused, alpha)
    try:
        f = decode_av1(obus)
    except UnsupportedImage as e:
        if e.frame is None:
            raise
        refused.append(e)
        return e.frame
    if alpha:
        f.planes = f.planes[:1]
        if not f.full_range:
            f.planes = (_limited_to_full(f.planes[0], f.bitdepth),)
    return f


def _sequence_header(obus: bytes) -> bytes:
    """The stream's last sequence header OBU before its first frame (or
    frame header) OBU, b"" if none; parsing stops at the first OBU that
    does not fit."""
    pos, out = 0, b""
    while pos < len(obus):
        head = obus[pos]
        start = pos + 1 + ((head >> 2) & 1)
        size, n = 0, 0
        while start + n < len(obus) and n < 8:
            size |= (obus[start + n] & 0x7F) << (7 * n)
            n += 1
            if not obus[start + n - 1] & 0x80:
                break
        if not head & 2 or start + n + size > len(obus):
            break
        typ = (head >> 3) & 15
        if typ in (3, 6):
            break
        if typ == 1:
            out = obus[pos:start + n + size]
        pos = start + n + size
    return out


def _to_size(f: Frame, wh, luma_only: bool = False) -> Frame:
    """The frame scaled to its stated size `wh` (None: as it is) as
    libavif scales a decoded tile (avif_scale.py); `luma_only` for an
    alpha frame, whose first plane libavif keeps. A refused frame (no
    planes) takes the size alone; libavif's refusal to scale raises
    ValueError."""
    if wh is None or tuple(wh) == (f.width, f.height):
        return f
    planes = f.planes
    if planes is not None and luma_only:
        planes = planes[:1]
    f.planes, _ = avif_scale.scale_frame(planes, None, f.width, f.height,
                                         f.ss_x, f.ss_y, f.bitdepth, *wh)
    f.width, f.height = wh
    return f


def _join(grid: Grid, refused: list, alpha: bool = False) -> Frame:
    """libavif's grid: every cell decoded and scaled to its stated size,
    the cells alike (size, depth, subsampling, range, colour description),
    covering the output with the last row and column reaching into it, at
    least 64 x 64 and even where the chroma is subsampled, then joined and
    cropped to the output."""
    frames, seq = [], b""
    for obus, wh in grid.cells:
        # libavif decodes the cells with one dav1d context, so a cell
        # without a sequence header takes the one before it
        own = _sequence_header(obus)
        f = _frame(obus if own or not seq else seq + obus, refused, alpha)
        seq = own or seq
        frames.append(_to_size(f, wh, alpha))
    first = frames[0]

    def key(f):
        return (f.width, f.height, f.bitdepth, f.ss_x, f.ss_y, f.mono,
                f.full_range, f.cp, f.tc, f.mc)
    if any(key(f) != key(first) for f in frames):
        _bad("grid cells differ")
    tw, th, W, H = first.width, first.height, grid.width, grid.height
    if tw * grid.cols < W or th * grid.rows < H or \
            tw * (grid.cols - 1) >= W or th * (grid.rows - 1) >= H:
        _bad("grid cells do not cover the output")
    sub_x = not first.mono and first.ss_x
    sub_y = not first.mono and first.ss_x and first.ss_y
    if tw < 64 or th < 64 or (sub_x and (W % 2 or tw % 2)) or \
            (sub_y and (H % 2 or th % 2)):
        _bad("grid cell size")
    out = Frame([W, H, first.ss_x, first.ss_y, first.mono, first.bitdepth,
                 first.cp, first.tc, first.mc, first.full_range,
                 first.tools], None)
    if any(f.planes is None for f in frames):
        return out
    planes = []
    for p in range(len(first.planes)):
        sx, sy = (first.ss_x, first.ss_y) if p else (0, 0)
        pw, ph = (W + sx) >> sx, (H + sy) >> sy
        cw, ch = (tw + sx) >> sx, (th + sy) >> sy
        plane = np.empty((ph, pw), first.planes[0].dtype)
        for k, f in enumerate(frames):
            r, c = divmod(k, grid.cols)
            y0, x0 = r * ch, c * cw
            if y0 < ph and x0 < pw:
                plane[y0:y0 + ch, x0:x0 + cw] = \
                    f.planes[p][:ph - y0, :pw - x0]
        planes.append(plane)
    out.planes = tuple(planes)
    return out


def decode_avif(data: bytes) -> np.ndarray:
    """AVIF bytes -> (H, W, 4) uint8 RGBA, top row first."""
    from fluctus_tpu_torch.scene.avif_rgb import to_rgb
    color_obus, colr, alpha_obus, prem, size, alpha_size = parse(data)
    for wh in (size, alpha_size):     # libavif's default size limits
        if wh is not None and (not wh[0] or not wh[1] or _too_large(wh)):
            raise ValueError("AVIF: image size out of libavif's limits")
    # what the port lacks is raised only once libavif's own failures are
    # ruled out: it decodes both items, brings a limited-range alpha to
    # full range, scales each to its stated size, then fails unless the
    # alpha matches the colour in size and depth
    refused: list = []
    grid = isinstance(color_obus, Grid)
    frame = _to_size(_frame(color_obus, refused), None if grid else size)
    alpha = None
    if alpha_obus is not None:
        a = _frame(alpha_obus, refused, True)
        if not isinstance(alpha_obus, Grid):
            a = _to_size(a, alpha_size, True)
        if (a.width, a.height) != (frame.width, frame.height) or \
                a.bitdepth != frame.bitdepth:
            raise ValueError("AVIF: the alpha item differs from the colour "
                             "item in size or depth")
        alpha = a.planes[0] if a.planes else None
    if refused:
        raise refused[0]
    rgba = to_rgb(frame, colr, alpha, prem)
    if size is None or tuple(size) == rgba.shape[1::-1]:
        return rgba
    # a grid's output size, not its item's ispe, sizes libavif's image; PIL
    # sizes its own from the ispe and reads libavif's RGB(A) bytes into it
    # row after row, and fails where they are too few
    c = 3 if alpha_obus is None else 4
    w, h = size
    flat = rgba[..., :c].reshape(-1)
    if flat.size < w * h * c:
        raise ValueError("AVIF: a grid's output holds fewer pixels than its "
                         "stated size")
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :c] = flat[:w * h * c].reshape(h, w, c)
    return out
