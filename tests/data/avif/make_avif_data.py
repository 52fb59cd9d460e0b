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


def _tools(path) -> list:
    """The filters the port reads as turned on in the file's frame."""
    import sys
    sys.path.insert(0, REPO)
    from fluctus_tpu_torch.scene import avif
    frame = avif.decode_av1(avif.parse(open(path, "rb").read())[0])
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
