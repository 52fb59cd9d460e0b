"""Writes the files of this directory and raster.json with PIL 12.1.0
(the machine with the card has no PIL): run from the repository root,

    python tests/data/raster/make_raster_data.py

PIL's last raster test formats, from a 64x48 crop of
assets/kitchen_wood.png:

- PNM: PIL's test formats P0CMYK and PyCMYK (CMYK), PyRGBA and PyP
  (palette indices with no palette), raw rows at maxval 255, and PyRGBA
  and P0CMYK at maxval 1000 (two bytes a sample, scaled);
- IM: the types PIL widens to float ("L 8", "L 8S", "L 16S", "L 32"),
  reads as int32 ("L 32 S"), reads through its bit decoder ("L*12",
  "L*5"), 2- and 4-bit palette indices ("B2", "B4") and green, red and
  blue planes ("RGB3");
- IPTC: band records holding a PGM and a greyscale PNG.

raster.json records, for each file, the SHA-256 of PIL's
`Image.open(f).convert("RGBA")` bytes and its shape, and the PIL
version.
"""
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def _crop():
    return np.asarray(Image.open(os.path.join(REPO, "assets",
                                              "kitchen_wood.png"))
                      .convert("RGB"))[:48, :64]


def _im(kind: bytes, w: int, h: int, body: bytes) -> bytes:
    head = b"Image type: %s image\r\nImage size (x*y): %d*%d\r\n" % (
        kind, w, h)
    return head + b"\0" * (512 - len(head) - 1) + b"\x1a" + body


def files() -> dict:
    sys.path.insert(0, REPO)
    from fluctus_tpu_torch import fixtures
    rgb = _crop()
    h, w = rgb.shape[:2]
    grey = rgb.mean(-1).astype(np.uint8)
    cmyk = np.concatenate([255 - rgb, (255 - rgb.max(-1))[..., None]], -1)
    rgba = np.concatenate([rgb, grey[..., None]], -1)
    out = {}
    for magic, px in ((b"P0CMYK", cmyk), (b"PyCMYK", cmyk),
                      (b"PyRGBA", rgba), (b"PyP", grey)):
        out[f"{magic.decode().lower()}.ppm"] = \
            b"%s\n%d %d\n255\n" % (magic, w, h) + px.tobytes()
    for magic, px in ((b"PyRGBA", rgba), (b"P0CMYK", cmyk)):
        v = (px.astype(np.int64) * 1000 // 255).astype(">u2")
        out[f"{magic.decode().lower()}_1000.ppm"] = \
            b"%s\n%d %d\n1000\n" % (magic, w, h) + v.tobytes()
    up = grey[::-1]                       # IM rows are bottom row first
    out["l8.im"] = _im(b"L 8", w, h, up.tobytes())
    out["l8s.im"] = _im(b"L 8S", w, h, (up.astype(np.int16) - 64)
                        .astype(np.int8).tobytes())
    out["l16s.im"] = _im(b"L 16S", w, h, (up.astype("<i2") - 40).tobytes())
    out["l32.im"] = _im(b"L 32", w, h, up.astype("<u4").tobytes())
    out["l32_s.im"] = _im(b"L 32 S", w, h, (up.astype("<i4") - 30)
                          .tobytes())
    g = np.random.default_rng(22)
    for bits in (12, 5):
        n = (w * h * bits + 7) // 8 + h
        out[f"lstar{bits}.im"] = _im(b"L*%d" % bits, w, h, g.integers(
            0, 256, n, dtype=np.uint8).tobytes())
    for kind, bits in ((b"B2", 2), (b"B4", 4)):
        idx = (up >> (8 - bits)).astype(np.uint8)
        packed = np.packbits(np.unpackbits(idx[..., None], axis=-1)[
            ..., 8 - bits:].reshape(h, -1), axis=1)
        out[f"{kind.decode().lower()}.im"] = _im(kind, w, h,
                                                 packed.tobytes())
    out["rgb3.im"] = _im(b"RGB3", w, h, b"".join(
        np.ascontiguousarray(rgb[::-1, :, k]).tobytes() for k in (1, 0, 2)))
    buf = io.BytesIO()
    Image.fromarray(grey).save(buf, "PNG")
    pgm = b"P5\n%d %d\n255\n" % (w, h) + grey.tobytes()
    out["band_pgm.iptc"] = fixtures.iptc_bytes(w, h, layers=3, band=1,
                                               payload=pgm)
    out["band_png.iptc"] = fixtures.iptc_bytes(w, h, layers=4, band=2,
                                               payload=buf.getvalue())
    return out


def main():
    record = {"pil": Image.__version__, "files": {}}
    for name, data in files().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        rgba = np.asarray(Image.open(path).convert("RGBA"))
        record["files"][name] = {
            "bytes": len(data), "shape": list(rgba.shape),
            "sha256": hashlib.sha256(rgba.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "raster.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
