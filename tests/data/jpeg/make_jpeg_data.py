"""Writes the JPEG files of this directory and jpeg.json, with PIL 12.1.0
and the libjpeg-turbo 3 it bundles (the machine with the card has no PIL):
run from the repository root,

    python tests/data/jpeg/make_jpeg_data.py

PIL writes only Huffman-coded baseline and progressive JPEG, so this
script holds its own small encoders in numpy:

- `QM`: the QM arithmetic encoder of ITU-T T.81 Annex D as libjpeg's
  jcarith.c codes it (its probability state table, carry handling and
  termination), with the context modelling of Annex F (DC conditioning
  from DAC bounds L and U, AC's Kx) for sequential scans and of Annex G
  for the four progressive scan kinds;
- `dct_components`: the quantized DCT blocks of an RGB or grey picture
  (libjpeg's YCbCr equations, box-averaged chroma, quality-scaled Annex K
  tables);
- `lossless`: the lossless process of Annex H with Huffman coding (the
  seven predictors, the point transform Pt, restart intervals of whole
  MCU rows, optimal tables built as Annex K.2 builds them).

Files:
- arith_*.jpg: SOF9 and SOF10, colour (4:2:0, 4:4:4) and grey, with and
  without restart intervals and DAC conditioning, one progressive file
  cut after its third scan (block-smoothed by libjpeg);
- lossless_*.jpg: SOF3 with each predictor 1-7, a point transform of 2,
  restarts, grey, 4:2:0 sampling (component ids 1, 2, 3: RGB to libjpeg,
  which converts no colours of a lossless image and upsamples it by box
  replication), RGB named by an Adobe marker;
- prog_cut{1,3,6}.jpg: a PIL progressive file cut after its 1st, 3rd or
  6th scan, then EOI (block-smoothed); prog_grey_cut2.jpg likewise;
- damaged_*.jpg: seeded damage PIL reads through: bit flips in the
  entropy data, a wrong restart number, bytes before a marker;
- kitchen_{floor,floor_n,wood}.lossless.jpg: assets/kitchen_*.png as SOF3,
  predictor 1, Pt 0, components 'R', 'G', 'B' (so no colour conversion).

jpeg.json records, for each file, the SHA-256 of PIL's
`Image.open(f).convert("RGBA")` bytes and its shape, and the PIL and
libjpeg-turbo versions. Every file is one PIL decodes.
"""
import hashlib
import io
import json
import os
import struct

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU-T T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
ARITAB = [qe << 16 | mps << 8 | sw << 7 | lps for qe, lps, mps, sw in QE]


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class QM:
    """jcarith.c's arith_encode / finish_pass on a byte buffer."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self.out.append(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)


# ------------------------------------------------------------------ DCT
_STD_Q = [np.array(t).reshape(64)[np.argsort(ZIGZAG)] for t in (
    [16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24,
     22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72,
     92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87, 95, 98, 103, 104, 103,
     62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99],
    [17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99])]


def quant_table(k: int, quality: int) -> np.ndarray:
    """jcparam.c's quality scaling of Annex K table k, natural order."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((_STD_Q[k] * scale + 50) // 100, 1, 255).astype(np.int64)


_C = np.array([[np.sqrt((1 if u == 0 else 2) / 8) *
                np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
               for u in range(8)])


def dct_components(px: np.ndarray, sampling, quality=85):
    """(components, tables): each component a dict of its sampling
    factors, blocks (bh, bw, 64) of quantized coefficients in natural
    order, real block counts, and its table index; px (H, W, 3) RGB or
    (H, W) grey uint8."""
    px = px.astype(np.float64)
    if px.ndim == 2:
        planes = [px]
    else:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.16874 * r - 0.33126 * g + 0.5 * b + 128,
                  0.5 * r - 0.41869 * g - 0.08131 * b + 128]
    h, w = px.shape[:2]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    tables = [quant_table(0, quality), quant_table(1, quality)]
    comps = []
    for k, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        fh, fv = hmax // hs, vmax // vs
        ph, pw = mcuy * vmax * 8, mcux * hmax * 8
        full = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
        small = full.reshape(ph // fv, fv, pw // fh, fh).mean((1, 3))
        bh, bw = small.shape[0] // 8, small.shape[1] // 8
        blk = small.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        coef = np.einsum("ux,abxy,vy->abuv", _C, blk, _C).reshape(bh, bw, 64)
        q = tables[min(k, 1)]
        dw, dh = -(-w * hs // hmax), -(-h * vs // vmax)
        comps.append({"h": hs, "v": vs, "tq": min(k, 1),
                      "coef": np.round(coef / q).astype(np.int64),
                      "wib": -(-dw // 8), "hib": -(-dh // 8)})
    return comps, tables


def frame_header(sof: int, w: int, h: int, comps, ids=None) -> bytes:
    body = struct.pack(">BHHB", 8, h, w, len(comps))
    for k, c in enumerate(comps):
        body += bytes([ids[k] if ids else k + 1, c["h"] << 4 | c["v"],
                       c.get("tq", 0)])
    return segment(sof, body)


def scan_header(comp_idx, tables, ss, se, ah, al, ids=None) -> bytes:
    body = bytes([len(comp_idx)])
    for k, t in zip(comp_idx, tables):
        body += bytes([ids[k] if ids else k + 1, t])
    return segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


def mcu_blocks(comps, idx):
    """The blocks of a scan over comps[idx] in MCU order: (k, by, bx)
    tuples a unit, one unit an MCU."""
    if len(idx) == 1:
        c = comps[idx[0]]
        return [[(idx[0], by, bx)] for by in range(c["hib"])
                for bx in range(c["wib"])]
    c0 = comps[0]
    mcuy, mcux = c0["coef"].shape[0] // c0["v"], c0["coef"].shape[1] // c0["h"]
    units = []
    for my in range(mcuy):
        for mx in range(mcux):
            u = []
            for k in idx:
                c = comps[k]
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        u.append((k, my * c["v"] + by, mx * c["h"] + bx))
            units.append(u)
    return units


class ArithScan:
    """One arithmetic-coded scan (Annex F sequential, Annex G
    progressive), as jcarith.c's encode_mcu* code it."""

    def __init__(self, comps, idx, prog, ss, se, ah, al, dac, restart):
        self.comps, self.idx, self.prog = comps, idx, prog
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.dac_l, self.dac_u, self.dac_k = dac
        self.restart = restart
        self.qm = QM()
        self.fixed = bytearray([113, 0, 0, 0])
        self.reset_stats()

    def reset_stats(self):
        self.dc_stats = bytearray(64)
        self.ac_stats = bytearray(256)
        self.last_dc = {k: 0 for k in self.idx}
        self.ctx = {k: 0 for k in self.idx}

    def magnitude(self, st_list, st, v, k=None):
        """Figures F.8 and F.9 for |value| - 1 = v; st is the index of
        the magnitude category's first bin in st_list."""
        enc = self.qm.encode
        m = 0
        if v:
            enc(st_list, st, 1)
            m = 1
            v2 = v
            if k is None:   # DC: X1 = 20
                st = 20
                while v2 >> 1:
                    v2 >>= 1
                    enc(st_list, st, 1)
                    m <<= 1
                    st += 1
            else:
                v2 >>= 1
                if v2:
                    enc(st_list, st, 1)
                    m <<= 1
                    st = 189 if k <= self.dac_k else 217
                    while v2 >> 1:
                        v2 >>= 1
                        enc(st_list, st, 1)
                        m <<= 1
                        st += 1
        enc(st_list, st, 0)
        st += 14
        mm = m
        while mm >> 1:
            mm >>= 1
            enc(st_list, st, 1 if mm & v else 0)
        return m

    def dc(self, k, value):
        enc, stats = self.qm.encode, self.dc_stats
        st = self.ctx[k]
        v = value - self.last_dc[k]
        if v == 0:
            enc(stats, st, 0)
            self.ctx[k] = 0
            return
        self.last_dc[k] = value
        enc(stats, st, 1)
        if v > 0:
            enc(stats, st + 1, 0)
            st += 2
            self.ctx[k] = 4
        else:
            v = -v
            enc(stats, st + 1, 1)
            st += 3
            self.ctx[k] = 8
        m = self.magnitude(stats, st, v - 1)
        if m < (1 << self.dac_l) >> 1:
            self.ctx[k] = 0
        elif m > (1 << self.dac_u) >> 1:
            self.ctx[k] += 8

    def ac(self, blk, ss, se, shift):
        enc, stats = self.qm.encode, self.ac_stats
        vals = [int(np.sign(x)) * (abs(int(x)) >> shift)
                for x in blk[ZIGZAG]]
        ke = se
        while ke > 0 and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc(stats, st, 0)
            while vals[k] == 0:
                enc(stats, st + 1, 0)
                st += 3
                k += 1
            v = vals[k]
            enc(stats, st + 1, 1)
            enc(self.fixed, 0, 0 if v > 0 else 1)
            self.magnitude(stats, st + 2, abs(v) - 1, k)
            k += 1
        if k <= se:
            enc(stats, 3 * (k - 1), 1)

    def ac_refine(self, blk):
        enc, stats = self.qm.encode, self.ac_stats
        zz = [int(x) for x in blk[ZIGZAG]]
        def shifted(x, s):
            return abs(x) >> s
        ke = self.se
        while ke > 0 and shifted(zz[ke], self.al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and shifted(zz[kex], self.ah) == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc(stats, st, 0)
            while True:
                v = shifted(zz[k], self.al)
                if v:
                    if v >> 1:
                        enc(stats, st + 2, v & 1)
                    else:
                        enc(stats, st + 1, 1)
                        enc(self.fixed, 0, 0 if zz[k] > 0 else 1)
                    break
                enc(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= self.se:
            enc(stats, 3 * (k - 1), 1)

    def run(self) -> bytes:
        units = mcu_blocks(self.comps, self.idx)
        out = bytearray()
        rst = 0
        for u, unit in enumerate(units):
            if self.restart and u and u % self.restart == 0:
                self.qm.finish()
                out += self.qm.out + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                self.qm = QM()
                self.reset_stats()
            for k, by, bx in unit:
                blk = self.comps[k]["coef"][by, bx]
                if not self.prog:
                    self.dc(k, int(blk[0]))
                    self.ac(blk, 1, 63, 0)
                elif self.ss == 0 and self.ah == 0:
                    self.dc(k, int(blk[0]) >> self.al)
                elif self.ss == 0:
                    self.qm.encode(self.fixed, 0, (int(blk[0]) >> self.al) & 1)
                elif self.ah == 0:
                    self.ac(blk, self.ss, self.se, self.al)
                else:
                    self.ac_refine(blk)
        self.qm.finish()
        return bytes(out + self.qm.out)


SIMPLE_PROGRESSION = [   # jcparam.c jpeg_simple_progression, YCbCr
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0)]
GREY_PROGRESSION = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def arith_jpeg(px, sampling, progressive=False, restart=0, dac=None,
               quality=85, jfif=True) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with libjpeg's simple
    progression) of px; dac = (L, U, Kx) writes a DAC segment for table
    0."""
    comps, tables = dct_components(px, sampling, quality)
    h, w = px.shape[:2]
    out = b"\xff\xd8"
    if jfif:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for k in range(min(len(comps), 2)):
        out += segment(0xDB, bytes([k]) + bytes(
            int(x) for x in tables[k][ZIGZAG]))
    lu_k = (0, 1, 5)
    if dac:
        lu_k = dac
        out += segment(0xCC, bytes([0, dac[1] << 4 | dac[0], 16, dac[2]]))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += frame_header(0xCA if progressive else 0xC9, w, h, comps)
    if not progressive:
        scans = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    else:
        scans = SIMPLE_PROGRESSION if len(comps) == 3 else GREY_PROGRESSION
    for idx, ss, se, ah, al in scans:
        out += scan_header(idx, [0] * len(idx), ss, se, ah, al)
        out += ArithScan(comps, list(idx), progressive, ss, se, ah, al,
                         lu_k, restart).run()
    return out + b"\xff\xd9"


# ------------------------------------------------------------ Huffman
def optimal_table(freq):
    """(bits[1..16], values) from symbol frequencies (T.81 Annex K.2,
    jchuff.c jpeg_gen_optimal_table)."""
    freq = list(freq) + [0] * (257 - len(freq))
    freq[256] = 1
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [j for n in range(1, 33) for j in range(256) if codesize[j] == n]
    return bits[1:17], vals


def huffman_codes(bits, vals):
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, value, length):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def category(d: int) -> int:
    return int(abs(d)).bit_length()


def lossless(planes, sampling, predictor=1, pt=0, restart_rows=0,
             ids=None, app=b"") -> bytes:
    """A lossless Huffman JPEG (SOF3, Annex H) of uint8 planes (already
    downsampled to `sampling`), one interleaved scan, predictor 1-7,
    point transform pt, a restart every `restart_rows` MCU rows."""
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    hs, ws = [], []
    for p, (h, v) in zip(planes, sampling):
        hs.append(p.shape[0])
        ws.append(p.shape[1])
    height = max(hh * vmax // v for hh, (h, v) in zip(hs, sampling))
    width = max(ww * hmax // h for ww, (h, v) in zip(ws, sampling))
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    # the differences of every sample as the decoder predicts it, with the
    # first-row / first-column rules and a reset at each restart
    x = [(p.astype(np.int64) >> pt) for p in planes]
    diffs = []
    for k, (p, (h, v)) in enumerate(zip(x, sampling)):
        ph, pw = p.shape
        dd = np.zeros_like(p)
        for r in range(ph):
            mcu_row = r // v
            first = r == 0 or (restart_rows and mcu_row % restart_rows == 0
                               and r % v == 0)
            for c in range(pw):
                if first:
                    pred = (1 << (7 - pt)) if c == 0 else p[r, c - 1]
                elif c == 0:
                    pred = p[r - 1, 0]
                else:
                    ra, rb, rc = p[r, c - 1], p[r - 1, c], p[r - 1, c - 1]
                    pred = [None, ra, rb, rc, ra + rb - rc,
                            ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                            (ra + rb) >> 1][predictor]
                dd[r, c] = p[r, c] - pred
        diffs.append(dd)
    # samples in MCU order (dummy samples past a component's edge repeat
    # its last difference 0)
    order = []
    for my in range(mcuy):
        for mx in range(mcux):
            for k, (h, v) in enumerate(sampling):
                for y in range(v):
                    for xx in range(h):
                        r, c = my * v + y, mx * h + xx
                        d = diffs[k]
                        ok = r < d.shape[0] and c < d.shape[1]
                        order.append((my, k, int(d[r, c]) if ok else 0))
    tabs = {}
    for tb in range(min(len(planes), 2)):
        freq = [0] * 17
        for _, k, d in order:
            if min(k, 1) == tb:
                freq[category(d)] += 1
        tabs[tb] = optimal_table(freq)
    out = b"\xff\xd8" + app
    for tb, (bits, vals) in tabs.items():
        out += segment(0xC4, bytes([tb]) + bytes(bits) + bytes(vals))
    if restart_rows:
        out += segment(0xDD, struct.pack(">H", restart_rows * mcux))
    comps = [{"h": h, "v": v} for h, v in sampling]
    out += frame_header(0xC3, width, height, comps, ids)
    out += scan_header(list(range(len(planes))),
                       [min(k, 1) << 4 for k in range(len(planes))],
                       predictor, 0, 0, pt, ids)
    codes = {tb: huffman_codes(*t) for tb, t in tabs.items()}
    bw = BitWriter()
    rst = 0
    for i, (my, k, d) in enumerate(order):
        if (restart_rows and my and my % restart_rows == 0 and
                i and order[i - 1][0] != my):
            out += bw.flush() + bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            bw = BitWriter()
        s = category(d)
        code, length = codes[min(k, 1)][s]
        bw.put(code, length)
        if s:
            bw.put(d if d > 0 else d - 1, s)
    return out + bw.flush() + b"\xff\xd9"


# ------------------------------------------------------------ pictures
def picture(h, w, seed):
    """Seeded RGB of gradients, edges and noise."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                   (x * y) % 256], -1)
    px[h // 3:h // 2, w // 4:w // 2] = (250, 20, 60)
    return np.clip(px + g.integers(-18, 19, px.shape), 0, 255).astype(
        np.uint8)


def pil_jpeg(px, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


def scan_starts(data: bytes):
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0xDA]


def cut_after(data: bytes, scans: int) -> bytes:
    """The file up to its scan number scans + 1, then EOI."""
    return data[:scan_starts(data)[scans]] + b"\xff\xd9"


def entropy_start(data: bytes) -> int:
    p = 2
    while True:
        m = data[p + 1]
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        if m == 0xDA:
            return p + 2 + n
        p += 2 + n


def damaged(data: bytes, seed: int, flips: int) -> bytes:
    """Seeded single-bit flips in the entropy data of the first scan."""
    g = np.random.default_rng(seed)
    d = bytearray(data)
    s0 = entropy_start(data)
    for _ in range(flips):
        i = int(g.integers(s0, len(d) - 2))
        d[i] ^= 1 << int(g.integers(0, 8))
    return bytes(d)


def restart_markers(data: bytes):
    s0 = entropy_start(data)
    return [i for i in range(s0, len(data) - 1)
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def files() -> dict:
    out = {}
    pic = picture(48, 64, 19)
    grey = pic[..., 1]
    out["arith_seq_420_dac_rst.jpg"] = arith_jpeg(
        pic, [(2, 2), (1, 1), (1, 1)], restart=3, dac=(1, 4, 3))
    out["arith_seq_444.jpg"] = arith_jpeg(pic, [(1, 1)] * 3, quality=92)
    out["arith_seq_grey.jpg"] = arith_jpeg(grey, [(1, 1)], quality=70)
    out["arith_prog_420_rst.jpg"] = arith_jpeg(
        pic, [(2, 2), (1, 1), (1, 1)], progressive=True, restart=5,
        dac=(2, 6, 12))
    out["arith_prog_grey.jpg"] = arith_jpeg(grey, [(1, 1)],
                                            progressive=True)
    out["arith_prog_cut3.jpg"] = cut_after(out["arith_prog_420_rst.jpg"], 3)
    rgb = [pic[..., k] for k in range(3)]
    for p in range(1, 8):
        out[f"lossless_p{p}.jpg"] = lossless(rgb, [(1, 1)] * 3, predictor=p)
    out["lossless_p4_pt2_rst.jpg"] = lossless(
        rgb, [(1, 1)] * 3, predictor=4, pt=2, restart_rows=5)
    out["lossless_grey_p7_pt1.jpg"] = lossless([grey], [(1, 1)],
                                               predictor=7, pt=1)
    sub = [rgb[0]] + [rgb[k][::2, ::2] for k in (1, 2)]
    out["lossless_rgb420_p6.jpg"] = lossless(
        sub, [(2, 2), (1, 1), (1, 1)], predictor=6)
    adobe = segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    out["lossless_adobe_rgb_p5.jpg"] = lossless(rgb, [(1, 1)] * 3,
                                                predictor=5, app=adobe)
    prog = pil_jpeg(picture(72, 96, 23), quality=85, progressive=True)
    for k in (1, 3, 6):
        out[f"prog_cut{k}.jpg"] = cut_after(prog, k)
    out["prog_grey_cut2.jpg"] = cut_after(
        pil_jpeg(picture(72, 96, 23)[..., 0], progressive=True), 2)
    base = pil_jpeg(picture(72, 96, 29), quality=85)
    out["damaged_flips.jpg"] = damaged(base, 7, 3)
    rst = pil_jpeg(picture(72, 96, 29), quality=85, restart_marker_blocks=4)
    marks = restart_markers(rst)
    d = bytearray(rst)
    d[marks[3] + 1] = 0xD0 + ((d[marks[3] + 1] - 0xD0 + 3) & 7)
    out["damaged_rst_number.jpg"] = bytes(d)
    d = bytearray(rst)
    d[marks[5]:marks[5]] = b"\x5a\x00\x11"
    out["damaged_bytes_before_rst.jpg"] = bytes(d)
    out["damaged_prog_flips.jpg"] = damaged(prog, 11, 2)
    out["damaged_arith_flips.jpg"] = damaged(
        out["arith_seq_420_dac_rst.jpg"], 5, 2)
    for name in ("kitchen_floor", "kitchen_floor_n", "kitchen_wood"):
        px = np.asarray(Image.open(os.path.join(
            REPO, "assets", f"{name}.png")).convert("RGB"))
        out[f"{name}.lossless.jpg"] = lossless(
            [px[..., k] for k in range(3)], [(1, 1)] * 3, predictor=1,
            ids=b"RGB")
    return out


def record(name: str) -> dict:
    path = os.path.join(HERE, name)
    rgba = np.asarray(Image.open(path).convert("RGBA"))
    return {"bytes": os.path.getsize(path),
            "sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
            "shape": list(rgba.shape)}


def main():
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    names = sorted(n for n in os.listdir(HERE) if n.endswith(".jpg"))
    rec = {"pil": Image.__version__,
           "libjpeg_turbo": features.version("libjpeg_turbo"),
           "files": {n: record(n) for n in names}}
    with open(os.path.join(HERE, "jpeg.json"), "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
