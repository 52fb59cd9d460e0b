"""Writes the WebP files of this directory and webp.json, with PIL 12.1.0
and the libwebp 1.6.0 it bundles (the machine with the card has no PIL,
so it cannot encode WebP): run from the repository root,

    python tests/data/webp/make_webp_data.py

- kitchen_{floor,floor_n,wood}.lossless.webp: assets/kitchen_*.png as
  lossless WebP (method 4, exact), and .q80.webp the same at quality 80;
- wood_alpha.q80.webp: kitchen_wood with a seeded alpha plane, lossy at
  quality 80 (alpha quality 60, so its ALPH chunk is VP8L-compressed);
- anim2.webp: a 2-frame animation (lossless) of two crops of the floor;
- feature_*.webp: 64x48 seeded pictures through libwebp's advanced
  encoder API (called through ctypes on PIL's bundled libwebp), for the
  options PIL's save does not expose: 4 token partitions, 4 segments,
  the simple loop filter, filter sharpness, raw ALPH with each filter,
  and near-lossless.

webp.json records, for each file, the SHA-256 of PIL's
`Image.open(f).convert("RGBA")` bytes and its shape, and the PIL and
libwebp versions.
"""
import ctypes
import glob
import hashlib
import io
import json
import os

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
LIBS = os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                    "pillow.libs")


def _lib():
    for dep in glob.glob(os.path.join(LIBS, "libsharpyuv*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(glob.glob(os.path.join(LIBS, "libwebp-*"))[0])


_INT, _F = ctypes.c_int, ctypes.c_float


class _Config(ctypes.Structure):   # WebPConfig
    _fields_ = [(n, _F if n in ("quality", "target_PSNR") else _INT)
                for n in (
        "lossless quality method image_hint target_size target_PSNR "
        "segments sns_strength filter_strength filter_sharpness "
        "filter_type autofilter alpha_compression alpha_filtering "
        "alpha_quality pass_ show_compressed preprocessing partitions "
        "partition_limit emulate_jpeg_size thread_level low_memory "
        "near_lossless exact use_delta_palette use_sharp_yuv qmin "
        "qmax").split()]


class _Writer(ctypes.Structure):   # WebPMemoryWriter
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32)]


_P, _U = ctypes.c_void_p, ctypes.c_uint32


class _Picture(ctypes.Structure):   # WebPPicture
    _fields_ = [("use_argb", _INT), ("colorspace", _INT), ("width", _INT),
                ("height", _INT), ("y", _P), ("u", _P), ("v", _P),
                ("y_stride", _INT), ("uv_stride", _INT), ("a", _P),
                ("a_stride", _INT), ("pad1", _U * 2), ("argb", _P),
                ("argb_stride", _INT), ("pad2", _U * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", _INT),
                ("extra_info", _P), ("stats", _P), ("error_code", _INT),
                ("progress_hook", _P), ("user_data", _P),
                ("pad3", _U * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", _U * 8), ("memory_", _P), ("memory_argb_", _P),
                ("pad7", _P * 2)]


def encode(rgba: np.ndarray, **options) -> bytes:
    """libwebp's WebPEncode of an (h, w, 4) uint8 picture."""
    lib = _lib()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    cfg = _Config()
    abi = 0x0210
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      _F(options.pop("quality", 75.0)), abi)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    pic.width, pic.height, pic.use_argb = w, h, cfg.lossless
    assert lib.WebPPictureImportRGBA(ctypes.byref(pic),
                                     rgba.ctypes.data_as(_P), w * 4)
    wr = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
    pic.custom_ptr = ctypes.cast(ctypes.byref(wr), _P).value
    assert lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)), \
        pic.error_code
    out = ctypes.string_at(wr.mem, wr.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    return out


def seeded(h: int, w: int, seed: int) -> np.ndarray:
    """An RGBA picture of gradients, edges and noise."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                   (x * y) % 256, 128 + 100 * np.sin(x / 5.0)], -1)
    px = px + g.integers(-20, 21, px.shape)
    px[:, w // 2:, 3] = 255
    return np.clip(px, 0, 255).astype(np.uint8)


def files() -> dict:
    out = {}
    for name in ("kitchen_floor", "kitchen_floor_n", "kitchen_wood"):
        im = Image.open(os.path.join(REPO, "assets", f"{name}.png"))
        for tag, kw in (("lossless", dict(lossless=True, method=4,
                                          exact=True)),
                        ("q80", dict(quality=80, method=4))):
            buf = io.BytesIO()
            im.save(buf, "WEBP", **kw)
            out[f"{name}.{tag}.webp"] = buf.getvalue()
    wood = Image.open(os.path.join(REPO, "assets", "kitchen_wood.png"))
    a = seeded(*wood.size[::-1], 1)[..., 3]
    wood = wood.convert("RGBA")
    wood.putalpha(Image.fromarray(a))
    buf = io.BytesIO()
    wood.save(buf, "WEBP", quality=80, alpha_quality=60, method=4)
    out["wood_alpha.q80.webp"] = buf.getvalue()
    floor = Image.open(os.path.join(REPO, "assets", "kitchen_floor.png"))
    frames = [floor.crop((0, 0, 96, 64)), floor.crop((64, 32, 160, 96))]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=True, duration=80)
    out["anim2.webp"] = buf.getvalue()
    pic = seeded(48, 64, 2)
    for name, kw in (
            ("partitions4", dict(quality=60.0, partitions=2, segments=1)),
            ("segments4", dict(quality=40.0, segments=4, sns_strength=100,
                               filter_strength=60)),
            ("simple_filter", dict(quality=30.0, filter_type=0,
                                   filter_strength=80)),
            ("sharpness7", dict(quality=20.0, filter_sharpness=7,
                                filter_strength=100)),
            ("alpha_raw_filters", dict(quality=70.0, alpha_compression=0,
                                       alpha_filtering=2)),
            ("near_lossless", dict(lossless=1, near_lossless=40))):
        out[f"feature_{name}.webp"] = encode(pic, method=4, **kw)
    return out


def main():
    record = {"pil": Image.__version__, "libwebp": features.version("webp"),
              "files": {}}
    for name, data in sorted(files().items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        record["files"][name] = {
            "sha256": hashlib.sha256(rgba.tobytes()).hexdigest(),
            "shape": list(rgba.shape), "bytes": len(data)}
    with open(os.path.join(HERE, "webp.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
