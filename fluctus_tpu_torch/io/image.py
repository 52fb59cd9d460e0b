"""Image export (counterpart of `fluctus_tpu/io/image.py`; reference:
CLContext::saveImage, src/clcontext.cpp:386-465).

`.hdr` goes through the RGBE writer (`io/hdr.py`, the same bytes as the
JAX package's file). Every other frame is quantized to 8-bit RGB as the
JAX package quantizes it; the port writes PNG with its own encoder (zlib,
filter 0), whose pixels equal those of the PNG that PIL writes there. An
extension PIL would write but the port does not (`.jpg`, `.bmp`, ...)
raises ValueError.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from fluctus_tpu_torch.io.hdr import write_hdr


def save_image(path: str, img: np.ndarray) -> None:
    """Save an (H, W, 3) float image. .hdr: linear RGBE; .png: 8-bit RGB
    with u8 = clip(img * 255 + 0.5), the caller having applied the
    postprocess and tonemap."""
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".hdr", ".png"):
        raise ValueError(f"cannot write {ext or 'extension-less'} images: "
                         "the port writes .png and .hdr")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if ext == ".hdr":
        write_hdr(path, img)
        return
    u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(u8))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(u8: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes: 8-bit RGB or grey, one IDAT,
    every row with filter 0."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    h, w = u8.shape[:2]
    ctype = 2 if u8.ndim == 3 else 0
    rows = u8.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
