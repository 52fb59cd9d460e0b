"""Write the AV1 default CDFs and quantizer lookups that `native/av1.cpp`
decodes with (the block between its `// BEGIN TABLES` and `// END
TABLES` lines) from the read-only data of the dav1d 1.5.1 that libavif
1.3.0 links in (the `libavif-01e67780.so.16.3.0` that Pillow 12.1.0's
wheel ships).

    python3 -m fluctus_tpu_torch.scene.av1_cdf_gen /path/to/libavif.so

Film grain's Gaussian sequence is dav1d's `dav1d_gaussian_sequence`.
The quantizer matrices come from the aom 3.12.1 encoder in the same
library (its `iwt_matrix_ref`, the spec's Quantizer_Matrix), written as
base64. dav1d keeps the default CDFs as one `CdfModeContext`, one key-frame
y-mode table, one motion-vector component, and four `CdfCoefContext` (one per
quantizer context, 6208 bytes apart). Each CDF is stored inverted
(32768 - cumulative probability), with a trailing adaptation counter, in
rows padded to 4, 8 or 16 entries. `TABLES` below names the file offset
where each table starts in that library, its dimensions, its number of
symbols and the padded row length; the script refuses a library whose
SHA-256 is not LIBRARY_SHA256 (the offsets hold for that file only) and
checks, for every table, that each row is decreasing and ends in zeros, so a
wrong offset fails here rather than in a decode. The output keeps the
spec's symbol counts (one counter after the N - 1 values) and, where dav1d
orders by its own block-size or block-level enums, the spec's order.
"""
from __future__ import annotations

import base64
import hashlib
import os
import sys

import numpy as np


# Pillow 12.1.0's libavif-01e67780.so.16.3.0
LIBRARY_SHA256 = ("c425e503cfeb820cec080fc4b16285ce"
                  "0a8f0664f58a1a590a8de2332bc3d4fd")

# name: (offset, dims, symbols, padded row length, row stride in entries)
MODE = {
    "kfym": (0x479a80, (5, 5), 13, 16),
    "uv_mode_nocfl": (0x478160, (13,), 13, 16),
    "uv_mode_cfl": (0x478160 + 13 * 32, (13,), 14, 16),
    "cfl_alpha": (0x478720, (6,), 16, 16),
    "txtp_inter1": (0x4787e0, (2,), 16, 16),
    "txtp_inter2": (0x478820, (), 12, 16),
    "txtp_intra1": (0x478840, (2, 13), 7, 8),
    "txtp_intra2": (0x4789e0, (3, 13), 5, 8),
    "cfl_sign": (0x478c50, (), 8, 8),
    "angle_delta": (0x478c60, (8,), 7, 8),
    "filter_intra": (0x478ce0, (), 5, 8),
    "seg_id": (0x478cf0, (3,), 8, 8),
    "pal_y_size": (0x478d20, (7,), 7, 8),
    "pal_uv_size": (0x478d20 + 7 * 16, (7,), 7, 8),
    "delta_q": (0x4792c0, (), 4, 4),
    "delta_lf": (0x4792c8, (), 4, 4),
    "restore_switchable": (0x4792f0, (), 3, 4),
    "restore_wiener": (0x4792f8, (), 2, 2),
    "restore_sgrproj": (0x4792fc, (), 2, 2),
    "txtp_inter3": (0x479300, (4,), 2, 2),
    "txpart": (0x479368, (7, 3), 2, 2),
    "skip": (0x4793bc, (3,), 2, 2),
    "pal_y": (0x4793c8, (7, 3), 2, 2),
    "pal_uv": (0x47941c, (2,), 2, 2),
    "intrabc": (0x479424, (), 2, 2),
    "mv_joint": (0x479a60, (), 4, 4),
    "mv_classes": (0x4799e0, (), 11, 16),
    "mv_sign": (0x479a00, (), 2, 2),
    "mv_class0": (0x479a04, (), 2, 2),
    "mv_bits": (0x479a1c, (10,), 2, 2),
}
# dav1d's partition[5][4][16] runs from its 128x128 level down to 8x8
PARTITION = 0x4784a0
PART_SYMS = (8, 10, 10, 10, 4)
# color_map[2][7][5][8]: y then uv, palette sizes 2..8
COLOR_MAP = 0x478e00
# txsz[4][3][4]: max tx 8x8 has 2 symbols, the larger ones 3
TXSZ = 0x479260
# use_filter_intra[22][2] in dav1d's block-size order (128x128 first)
FILTER_INTRA = 0x479310
DAV1D_BS = ("128x128", "128x64", "64x128", "64x64", "64x32", "64x16",
            "32x64", "32x32", "32x16", "32x8", "16x64", "16x32", "16x16",
            "16x8", "16x4", "8x32", "8x16", "8x8", "8x4", "4x16", "4x8",
            "4x4")
SPEC_BS = ("4x4", "4x8", "8x4", "8x8", "8x16", "16x8", "16x16", "16x32",
           "32x16", "32x32", "32x64", "64x32", "64x64", "64x128", "128x64",
           "128x128", "4x16", "16x4", "8x32", "32x8", "16x64", "64x16")
# CdfCoefContext[4], 6208 bytes apart
COEF = 0x472060
COEF_STRIDE = 6208
COEF_FIELDS = (  # name, byte offset in the struct, dims, symbols, padded row
    ("eob16", 0, (2, 2), 5, 8), ("eob32", 64, (2, 2), 6, 8),
    ("eob64", 128, (2, 2), 7, 8), ("eob128", 192, (2, 2), 8, 8),
    ("eob256", 256, (2, 2), 9, 16), ("eob512", 384, (2,), 10, 16),
    ("eob1024", 448, (2,), 11, 16), ("base_eob", 512, (5, 2, 4), 3, 4),
    ("base", 832, (5, 2, 41), 4, 4), ("br", 4112, (4, 2, 21), 4, 4),
    ("eob_hi", 5456, (5, 2, 11), 2, 2), ("txb_skip", 5896, (5, 13), 2, 2),
    ("dc_sign", 6156, (2, 3), 2, 2),
)
# dav1d_dq_tbl[3][256][2]: (dc, ac) at 8, 10 and 12 bits
DQ = 0x479ec0
# aom's iwt_matrix_ref[15][2][3344]: the spec's Quantizer_Matrix for
# levels 0-14, luma then chroma, every transform size's weights in a row
QM = 0x3e3d20
QM_SIZE = 15 * 2 * 3344
# dav1d_gaussian_sequence[2048]: film grain's Gaussian values (int16)
GAUSSIAN = 0x46f9c0


def _rows(u16, off, dims, syms, pad):
    n = int(np.prod(dims)) if dims else 1
    start = off // 2
    a = u16[start:start + n * pad].reshape(n, pad)
    rows = a[:, :syms - 1]
    for r, row in enumerate(a):
        vals = row[:syms - 1].astype(np.int64)
        if np.any(np.diff(vals) > 0) or vals.max() > 32768 or \
                np.any(row[syms - 1:] != 0):
            raise SystemExit(f"table at {off:#x} row {r} is not a CDF: "
                             f"{row.tolist()}")
    return rows


def _emit(name, rows, dims, syms):
    """C array with the spec's layout: N - 1 values and a 0 counter."""
    full = np.zeros((rows.shape[0], syms), np.int64)
    full[:, :syms - 1] = rows
    shape = "".join(f"[{d}]" for d in dims) + f"[{syms}]"
    body = ",\n".join("  " + ",".join(str(int(v)) for v in r) for r in full)
    return f"static const uint16_t D_{name}{shape} = {{\n{body}}};\n"


def generate(lib_path: str) -> str:
    data = open(lib_path, "rb").read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != LIBRARY_SHA256:
        raise ValueError(f"{lib_path} has sha256 {digest}, not that of "
                         "the libavif-01e67780.so.16.3.0 the offsets are "
                         "for")
    u16 = np.frombuffer(data[:len(data) // 2 * 2], "<u2")
    out = [f"// Written by av1_cdf_gen.py from {os.path.basename(lib_path)}"
           f"\n// (sha256 {digest}); do not edit.\n"]
    for name, (off, dims, syms, pad) in MODE.items():
        out.append(_emit(name, _rows(u16, off, dims, syms, pad), dims, syms))
    for lvl, syms in enumerate(PART_SYMS):
        name = ("p128", "p64", "p32", "p16", "p8")[lvl]
        rows = _rows(u16, PARTITION + lvl * 4 * 32, (4,), syms, 16)
        out.append(_emit(name, rows, (4,), syms))
    for plane, pname in enumerate(("y", "uv")):
        for n in range(2, 9):
            off = COLOR_MAP + ((plane * 7 + n - 2) * 5) * 16
            out.append(_emit(f"color_{pname}{n}",
                             _rows(u16, off, (5,), n, 8), (5,), n))
    for cat in range(4):
        syms = 2 if cat == 0 else 3
        out.append(_emit(f"txsz{cat}", _rows(u16, TXSZ + cat * 24, (3,),
                                             syms, 4), (3,), syms))
    fi = _rows(u16, FILTER_INTRA, (22,), 2, 2)
    fi = fi[[DAV1D_BS.index(b) for b in SPEC_BS]]
    out.append(_emit("use_filter_intra", fi, (22,), 2))
    for name, off, dims, syms, pad in COEF_FIELDS:
        rows = np.concatenate([
            _rows(u16, COEF + q * COEF_STRIDE + off, dims, syms, pad)
            for q in range(4)])
        if name == "eob_hi":   # dav1d indexes by eob bin, the spec by bin - 2
            rows = rows.reshape(4, 5, 2, 11, 1)[:, :, :, 2:].reshape(-1, 1)
            dims = (5, 2, 9)
        if name == "base":     # the spec's 42nd context is never coded
            r = rows.reshape(4, 5, 2, 41, 3)
            rows = np.concatenate([r, r[:, :, :, -1:]], 3).reshape(-1, 3)
            dims = (5, 2, 42)
        out.append(_emit(name, rows, (4,) + dims, syms))
    dq = u16[DQ // 2:DQ // 2 + 3 * 512].reshape(3, 256, 2)
    if dq[:, 0].tolist() != [[4, 4]] * 3 or dq[:, 255].tolist() != [
            [1336, 1828], [5347, 7312], [21387, 29247]]:
        raise SystemExit("quantizer table not found")
    for i, name in enumerate(("dc_q", "ac_q")):
        out.append(f"static const uint16_t {name.upper()}[3][256] = {{\n"
                   + ",\n".join("  {" + ",".join(str(int(v)) for v in
                                                  dq[d, :, i]) + "}"
                                 for d in range(3)) + "};\n")
    gauss = np.frombuffer(data[GAUSSIAN:GAUSSIAN + 4096], "<i2")
    if gauss[:4].tolist() != [56, 568, -180, 172] or np.any(gauss % 4) or \
            np.abs(gauss).max() >= 2048:
        raise SystemExit("film grain's Gaussian sequence not found")
    out.append("static const int16_t GAUSSIAN[2048] = {\n"
               + ",\n".join("  " + ",".join(str(int(v)) for v in
                                            gauss[i:i + 16])
                             for i in range(0, 2048, 16)) + "};\n")
    qm = data[QM:QM + QM_SIZE]
    if list(qm[:4]) != [32, 43, 73, 97] or max(qm) > 255:
        raise SystemExit("quantizer matrices not found")
    b64 = base64.b64encode(qm).decode()
    out.append("// the quantizer matrices, base64\n"
               "static const char QM_B64[] =\n"
               + "\n".join(f'  "{b64[i:i + 76]}"'
                           for i in range(0, len(b64), 76)) + ";\n")
    return "".join(out)


def main(argv):
    if len(argv) != 2:
        raise SystemExit(__doc__)
    text = generate(argv[1])
    dst = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                       "av1.cpp")
    with open(dst) as f:
        src = f.read()
    head, rest = src.split("// BEGIN TABLES\n", 1)
    _, tail = rest.split("// END TABLES\n", 1)
    with open(dst, "w") as f:
        f.write(head + "// BEGIN TABLES\n" + text + "// END TABLES\n" + tail)
    print(f"wrote the tables of {dst} ({len(text)} bytes)")


if __name__ == "__main__":
    main(sys.argv)
