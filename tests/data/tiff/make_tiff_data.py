"""Writes the TIFF files of this directory and tiff.json, with PIL 12.1.0
and the libtiff 4.7.1 it bundles (the machine with the card has no PIL
and no zstd module): run from the repository root,

    python tests/data/tiff/make_tiff_data.py

From a 96x64 crop of assets/kitchen_wood.png:

- CCITT, written by PIL: modified Huffman (tiff_ccitt), 32771
  (tiff_raw_16, whose word alignment libtiff's decoder reads back
  differently from its encoder), T.4 1D, T.4 2D with byte-aligned EOLs
  (T4Options 5) and T.6, of a dithered bilevel picture;
- LZMA (an .xz stream, with the horizontal predictor) and Zstandard
  strips, written by fluctus_tpu_torch.fixtures.tiff_bytes (PIL's writer
  stores both uncompressed);
- CMYK samples as new-style JPEG, written by PIL;
- old-style JPEG in both layouts libtiff reads (fixtures.ojpeg_tiff_bytes
  around a PIL JPEG stream), old-style LZW (fixtures.lzw_compat_bytes),
  ThunderScan 4-bit (fixtures.thunderscan_bytes), YCbCr 2x2 blocks under
  Deflate (fixtures.ycbcr_blocks), 12-bit grey, palette with alpha, 1-bit
  tiles and planar Lab.

tiff.json records, for each file, the SHA-256 of PIL's
`Image.open(f).convert("RGBA")` bytes and its shape, and the PIL and
libtiff versions.
"""
import hashlib
import io
import json
import lzma
import os
import sys
import zlib

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def _pil(im, **kw):
    f = io.BytesIO()
    im.save(f, "TIFF", **kw)
    return f.getvalue()


def files() -> dict:
    """{file name: bytes}."""
    sys.path.insert(0, REPO)
    import zstandard
    from fluctus_tpu_torch import fixtures as fx
    wood = Image.open(os.path.join(REPO, "assets", "kitchen_wood.png"))
    crop = wood.convert("RGB").crop((40, 40, 136, 104))
    px = np.asarray(crop)
    w, h = crop.size
    out = {}
    bw = crop.convert("1")                       # Floyd-Steinberg dither
    out["ccitt_mh.tif"] = _pil(bw, compression="tiff_ccitt")
    out["ccitt_rlew.tif"] = _pil(bw, compression="tiff_raw_16")
    out["ccitt_g3_1d.tif"] = _pil(bw, compression="group3")
    out["ccitt_g3_2d.tif"] = _pil(bw, compression="group3",
                                  tiffinfo={292: 5})
    out["ccitt_g4.tif"] = _pil(bw, compression="group4")
    rows = px.astype(np.int16)
    delta = np.concatenate([rows[:, :1], np.diff(rows, axis=1)], 1)
    out["lzma_pred2.tif"] = fx.tiff_bytes(
        w, h, 8, 3, 2, [lzma.compress(delta.astype(np.uint8).tobytes())],
        comp=34925, pred=2)
    out["zstd.tif"] = fx.tiff_bytes(
        w, h, 8, 3, 2, [zstandard.ZstdCompressor(level=19).compress(
            px[r:r + 16].tobytes()) for r in range(0, h, 16)], comp=50000,
        rps=16)
    out["cmyk_jpeg.tif"] = _pil(crop.convert("CMYK"), compression="jpeg")
    f = io.BytesIO()
    crop.save(f, "JPEG", quality=90)
    for layout in ("jif", "tables"):
        out[f"ojpeg_{layout}.tif"] = fx.ojpeg_tiff_bytes(
            f.getvalue(), w, h, layout, subsampling=(2, 2))
    out["lzw_old.tif"] = fx.tiff_bytes(
        w, h, 8, 3, 2, [fx.lzw_compat_bytes(px.tobytes())], comp=5)
    grey = np.asarray(crop.convert("L"))
    out["thunderscan.tif"] = fx.tiff_bytes(
        w, h, 4, 1, 1, [fx.thunderscan_bytes(grey >> 4)], comp=32809)
    ycc = np.asarray(crop.convert("YCbCr"))
    out["ycbcr22_deflate.tif"] = fx.tiff_bytes(
        w, h, 8, 3, 6, [zlib.compress(fx.ycbcr_blocks(
            ycc[..., 0], ycc[::2, ::2, 1], ycc[::2, ::2, 2], 2, 2))], comp=8)
    v12 = grey.astype(np.uint16) * 16 + 7
    bits = np.unpackbits(v12.astype(">u2").view(np.uint8).reshape(
        h, w, 2), axis=2)[..., 4:].reshape(h, -1)
    out["grey12.tif"] = fx.tiff_bytes(w, h, 12, 1, 1, [np.packbits(
        bits, axis=1).tobytes()])
    g = np.random.default_rng(5)
    cmap = list(g.integers(0, 65536, 768))
    pa = np.stack([grey, px[..., 1]], -1)
    out["palette_alpha.tif"] = fx.tiff_bytes(
        w, h, 8, 2, 3, [zlib.compress(pa.tobytes())], comp=8, extra=[2],
        cmap=cmap)
    tiles = []
    b1 = np.asarray(bw, np.uint8)
    for ty in range(0, h, 32):
        for tx in range(0, w, 32):
            t = np.zeros((32, 32), np.uint8)
            part = b1[ty:ty + 32, tx:tx + 32]
            t[:part.shape[0], :part.shape[1]] = part
            tiles.append(zlib.compress(np.packbits(t, axis=1).tobytes()))
    out["tiles_1bit.tif"] = fx.tiff_bytes(w, h, 1, 1, 1, tiles, comp=8,
                                          tile=(32, 32))
    lab = np.asarray(crop.convert("LAB"))
    out["planar_lab.tif"] = fx.tiff_bytes(
        w, h, 8, 3, 8, [zlib.compress(lab[..., k].tobytes())
                        for k in range(3)], comp=8, planar=2)
    return out


def main():
    record = {"pil": Image.__version__, "libtiff": features.version("libtiff"),
              "files": {}}
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        record["files"][name] = {
            "sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
            "shape": list(rgba.shape)}
    with open(os.path.join(HERE, "tiff.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
