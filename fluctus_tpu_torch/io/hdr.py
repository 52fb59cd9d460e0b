"""Radiance RGBE (.hdr) reader and writer in NumPy (counterpart of
`fluctus_tpu/io/hdr.py`, the same arithmetic, so both packages read and
write the same bits; reference: src/rgbe/rgbe.cpp, Ward's RLE format).

Reads RLE-compressed and flat scanlines; writes flat ones.
"""
from __future__ import annotations

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: lines until empty line, then resolution line
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res_line = data[pos:eol].decode("ascii").split()
    pos = eol + 1
    if len(res_line) != 4 or res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"{path}: unsupported resolution line {res_line}")
    height, width = int(res_line[1]), int(res_line[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or raw[off] != 2 or raw[off + 1] != 2 \
                or (int(raw[off + 2]) << 8 | int(raw[off + 3])) != width:
            # flat (non-RLE) scanline
            row = raw[off:off + width * 4].reshape(width, 4)
            rgbe[y] = row
            off += width * 4
            continue
        off += 4
        for c in range(4):
            x = 0
            while x < width:
                n = int(raw[off])
                off += 1
                if n > 128:  # run
                    rgbe[y, x:x + n - 128, c] = raw[off]
                    off += 1
                    x += n - 128
                else:  # literal
                    rgbe[y, x:x + n, c] = raw[off:off + n]
                    off += n
                    x += n
    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # 2^(e-128-8)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(
        np.float32)


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 RGBE."""
    maxc = img.max(axis=-1)
    _, expo = np.frexp(maxc)
    # decode uses 2^(E-136) = 2^(e-8); encode must scale by 256/2^e
    scale = np.where(maxc >= 1e-32, np.ldexp(256.0, -expo), 0.0)
    rgbe = np.zeros(img.shape[:-1] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc >= 1e-32, expo + 128, 0).astype(np.uint8)
    return rgbe


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 as an uncompressed Radiance .hdr file."""
    h, w, _ = img.shape
    header = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
              + f"-Y {h} +X {w}\n".encode("ascii"))
    with open(path, "wb") as f:
        f.write(header)
        f.write(float_to_rgbe(np.asarray(img, np.float32)).tobytes())
