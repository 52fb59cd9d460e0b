"""Writes the AVIF files of this directory and avif.json with PIL 12.1.0,
which encodes AVIF with aom 3.12.1 and decodes it with dav1d 1.5.1
through libavif 1.3.0 (the machine with the card has no PIL): run from
the repository root,

    python tests/data/avif/make_avif_data.py

Files (every AV1 frame in them needs no in-loop filter, except the last):
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
- sequence.avif: a 3-frame `avis` sequence (PIL loads frame 0);
- filters_on.avif: PIL's default settings (deblocking on), which the
  port refuses naming the tool.

avif.json records, for each file, its size, the SHA-256 of PIL's
`Image.open(f).convert("RGBA")` bytes and their shape (or, for
filters_on.avif, the tool the port names), and the versions above.
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
    return out


def main():
    record = {"pil": Image.__version__, "libavif": features.version("avif"),
              "files": {}}
    for name, (img, kw) in files().items():
        buf = io.BytesIO()
        img.save(buf, "AVIF", **kw)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    frames = [Image.fromarray(_pattern(np.random.default_rng(k), 24, 40, 3))
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   quality=100)
    with open(os.path.join(HERE, "sequence.avif"), "wb") as f:
        f.write(buf.getvalue())
    for name in sorted(os.listdir(HERE)):
        if not name.endswith(".avif"):
            continue
        path = os.path.join(HERE, name)
        rgba = np.asarray(Image.open(path).convert("RGBA"))
        entry = {"bytes": os.path.getsize(path),
                 "sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
                 "shape": list(rgba.shape)}
        if name == "filters_on.avif":
            entry["raises"] = "deblocking"
        record["files"][name] = entry
    with open(os.path.join(HERE, "avif.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
