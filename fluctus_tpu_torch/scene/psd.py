"""A PSD decoder that gives what PIL's `Image.open(...).convert("RGBA")`
gives: the merged composite after the layer section, as PIL's
PsdImagePlugin reads it.

A 26-byte header (8BPS, version 1, channels, height, width, depth,
colour mode), the colour-mode data (for an indexed image a 768-byte
palette stored as 256 reds, 256 greens, 256 blues), the image resources
and the layer section (skipped), then the composite: compression 0 (one
plane a channel) or 1 (PackBits, after a table of each row's byte count;
each channel's stream decoded on from where the counts put it). Modes:
bitmap (1 bit, a set bit white, as PIL reads it), grey, duotone and
multichannel as grey, indexed, RGB and, with four channels, RGBA, and
CMYK (PIL reads each plane inverted and converts as its TIFF CMYK) and
Lab (converted as PIL converts LAB, scene/lab.py, with alpha 0); extra
channels are not read. PIL's PackBits rules: 0x80 is a no-op, a run or
literal that passes the end of a row is damage. 16- and 32-bit files are
no PIL mode (damage).
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.lab import lab_to_rgb

# (colour mode, depth) -> PIL mode
MODES = {(0, 1): "1", (0, 8): "L", (1, 8): "L", (2, 8): "P", (3, 8): "RGB",
         (4, 8): "CMYK", (7, 8): "L", (8, 8): "L", (9, 8): "LAB"}


def _packbits_rows(data: bytes, pos: int, row_bytes: int,
                   n_rows: int) -> np.ndarray:
    """PIL's PackbitsDecode: n_rows rows of row_bytes from `pos`."""
    out = bytearray()
    x = 0
    end = len(data)
    need = row_bytes * n_rows
    while len(out) < need:
        if pos >= end:
            raise ValueError("PackBits: truncated data")
        b = data[pos]
        if b == 0x80:
            pos += 1
            continue
        if b & 0x80:
            if pos + 1 >= end:
                raise ValueError("PackBits: truncated data")
            n = 257 - b
            chunk = bytes([data[pos + 1]]) * n
            pos += 2
        else:
            n = b + 1
            if pos + 1 + n > end:
                raise ValueError("PackBits: truncated data")
            chunk = data[pos + 1:pos + 1 + n]
            pos += 1 + n
        if x + n > row_bytes:
            raise ValueError("PackBits: a packet passes the end of a row")
        out += chunk
        x = (x + n) % row_bytes
    return np.frombuffer(bytes(out), np.uint8).reshape(n_rows, row_bytes)


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 26 or not data.startswith(b"8BPS") or \
            struct.unpack_from(">H", data, 4)[0] != 1:
        raise ValueError("PSD: bad header")
    n_chan, h, w, bits, cmode = struct.unpack_from(">HIIHH", data, 12)
    mode = MODES.get((cmode, bits))
    if mode is None:
        raise ValueError(f"PSD: no PIL mode for {bits}-bit colour mode "
                         f"{cmode}")
    channels = {"RGB": 3, "CMYK": 4, "LAB": 3}.get(mode, 1)
    if channels > n_chan:
        raise ValueError("PSD: not enough channels")
    if mode == "RGB" and n_chan == 4:
        mode, channels = "RGBA", 4
    if w == 0 or h == 0:
        raise ValueError("PSD: empty image")
    pos = 26

    def section():
        nonlocal pos
        if pos + 4 > len(data):
            raise ValueError("PSD: truncated")
        size = struct.unpack_from(">I", data, pos)[0]
        body = data[pos + 4:pos + 4 + size]
        pos += 4 + size
        return body

    mode_data = section()
    if mode == "P" and len(mode_data) != 768:
        raise UnsupportedImage("PSD indexed images without a 768-byte "
                               "palette are not decoded by the port")
    section()                                   # image resources
    section()                                   # layer and mask info
    if pos + 2 > len(data):
        raise ValueError("PSD: truncated")
    comp = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    row_bytes = (w + 7) // 8 if mode == "1" else w
    if comp == 0:
        planes = []
        for c in range(channels):
            px = data[pos + c * w * h:pos + c * w * h + row_bytes * h]
            if len(px) != row_bytes * h:
                raise ValueError("PSD: truncated image data")
            planes.append(np.frombuffer(px, np.uint8).reshape(h, row_bytes))
    elif comp == 1:
        counts = data[pos:pos + 2 * channels * h]
        if len(counts) != 2 * channels * h:
            raise ValueError("PSD: truncated row counts")
        counts = np.frombuffer(counts, ">u2").astype(np.int64)
        pos += 2 * channels * h
        planes = []
        for c in range(channels):
            planes.append(_packbits_rows(data, pos, row_bytes, h))
            pos += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise ValueError(f"PSD: compression {comp}")
    rgba = np.full((h, w, 4), 255, np.uint8)
    if mode == "1":
        rgba[..., :3] = (np.unpackbits(planes[0], axis=1)[:, :w]
                         * 255)[..., None]
    elif mode == "L":
        rgba[..., :3] = planes[0][..., None]
    elif mode == "P":
        pal = np.frombuffer(mode_data, np.uint8).reshape(3, 256).T
        rgba[..., :3] = pal[planes[0]]
    elif mode == "CMYK":
        # PIL reads each plane inverted (raw mode "C;I" ...), then CMYK to
        # RGB with nk = 255 - k: each channel nk - MULDIV255(c, nk)
        c = 255 - np.stack(planes, -1).astype(np.int64)
        nk = 255 - c[..., 3:4]
        t = c[..., :3] * nk + 128
        rgba[..., :3] = np.clip(nk - ((t + (t >> 8)) >> 8), 0, 255)
    elif mode == "LAB":
        # PIL stores the planes as they are (a and b offset by 128) and
        # converts through LittleCMS, which scene/lab.py reproduces; the
        # transform copies the pixel's fourth byte, which PIL's PSD reader
        # leaves 0, into alpha
        rgba[..., :3] = lab_to_rgb(np.stack(planes, -1))
        rgba[..., 3] = 0
    else:
        for c in range(channels):
            rgba[..., c] = planes[c]
    return rgba
