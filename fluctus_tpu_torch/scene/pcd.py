"""Kodak Photo CD: the 768x512 base image, as PIL 12's PcdImagePlugin
and its C decoder (PcdDecode.c) give it through
`Image.open(...).convert("RGBA")`.

The header sector at byte 2048 starts "PCD_"; the low two bits of its
byte 1538 are the orientation (1: turned 90 degrees counter-clockwise,
3: 270, the others upright). The base image starts at sector 96: each
pair of rows is 3 * 768 bytes, the two rows' luma and then one row of
each chroma at half width, shared by both rows; the samples are Kodak
PhotoYCC, unpacked to RGB by PIL's "YCC;P" tables (scene/pilmodes.py).
A file that ends before the last pair is damage.
"""
from __future__ import annotations

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import photoycc_to_rgb

W, H = 768, 512
OFFSET = 96 * 2048


def decode_pcd(data: bytes) -> np.ndarray:
    """Photo CD bytes -> (H, W, 4) uint8 RGBA, top row first."""
    head = data[2048:2048 + 1539]
    if not head.startswith(b"PCD_") or len(head) < 1539:
        raise ValueError("PCD: not a PCD file")
    orientation = head[1538] & 3
    chunk = 3 * W
    body = data[OFFSET:OFFSET + chunk * (H // 2)]
    if len(body) < chunk * (H // 2):
        raise ValueError("PCD: image file is truncated")
    pairs = np.frombuffer(body, np.uint8).reshape(H // 2, chunk)
    luma = pairs[:, :2 * W].reshape(H, W)
    cols = np.arange(W) // 2
    c1 = np.repeat(pairs[:, 2 * W + cols], 2, 0)
    c2 = np.repeat(pairs[:, 2 * W + W // 2 + cols], 2, 0)
    rgb = photoycc_to_rgb(np.stack([luma, c1, c2], -1))
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, 3)
    rgba = np.full(rgb.shape[:2] + (4,), 255, np.uint8)
    rgba[..., :3] = rgb
    return rgba
