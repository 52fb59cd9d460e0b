"""A Mac OS icon (ICNS) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's IcnsImagePlugin).

A big-endian "icns" header (magic, file length), then members of a
4-byte code and a length that counts its own 8 bytes. PIL picks the
largest (width, height, scale) whose code is present, in its SIZES
table, and reads every member of that size in the table's order:

- a PNG member (codes ic07-ic14 and icp4-icp6 whose bytes start with the
  PNG magic) is decoded by scene/png.py without its tRNS chunk, as PIL's
  icon takes the PNG's mode and pixels but not its info; its size must be
  one PIL allows for the icon; it wins over RGB members of the size;
- an RGB member (is32, il32, ih32, it32 after its four zero bytes) holds
  3 * w * h bytes of interleaved RGB, or else each band in turn in PIL's
  run-length code (a byte n < 128: n + 1 literal bytes; n >= 128: the
  next byte n - 125 times), read on from the member's start as PIL's
  read_32 reads the file;
- a mask member (s8mk, l8mk, h8mk, t8mk) holds w * h alpha bytes.

A JPEG 2000 member (codes as PNG's; a raw codestream or a JP2 file, the
member's bytes read alone) is decoded by scene/jpeg2000.py and held to
the same size check; a member that is neither PNG nor JPEG 2000 (the bare
"\r\n\x87\n" signature PIL accepts and then cannot open among them), and
RLE bands that overrun or end early, are damage.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.jpeg2000 import decode_jpeg2000
from fluctus_tpu_torch.scene.png import decode_png

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a",
        b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")
_PNG_CODES = {b"ic10", b"ic09", b"ic14", b"ic08", b"ic13", b"ic07", b"icp6",
              b"ic12", b"icp5", b"ic11", b"icp4"}
# PIL's IcnsFile.SIZES, in its order: (w, h, scale) -> member codes
SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",),
    (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"),
    (64, 64, 1): (b"icp6",), (32, 32, 2): (b"ic12",),
    (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}


def members(data: bytes) -> dict:
    """PIL's IcnsFile directory: {code: (start, length)}."""
    _, filesize = struct.unpack_from(">4sI", data)
    dct, i = {}, 8
    while i < filesize:
        sig, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise ValueError("ICNS: invalid block header")
        i += 8
        dct[sig] = (i, size - 8)
        i += size - 8
    return dct


def decode_icns(data: bytes) -> np.ndarray:
    """ICNS bytes -> (H, W, 4) uint8 RGBA, top row first."""
    dct = members(data)
    sizes = [s for s, codes in SIZES.items() if any(c in dct for c in codes)]
    if not sizes:
        raise ValueError("ICNS: no 32-bit icon resources")
    best = max(sizes)
    channels = {}
    for code in SIZES[best]:
        if code not in dct:
            continue
        if code in _PNG_CODES:
            channels["RGBA"] = _png_member(data, *dct[code], sizes)
        elif code.endswith(b"mk"):
            channels["A"] = _mask(data, dct[code][0], best)
        else:
            start, length = dct[code]
            if code == b"it32":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError("ICNS: it32 without its zero bytes")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb(data, start, length, best)
    if "RGBA" in channels:
        return channels["RGBA"]
    if "RGB" not in channels:
        raise ValueError("ICNS: a mask without its RGB member")
    rgb = channels["RGB"]
    rgba = np.full(rgb.shape[:2] + (4,), 255, np.uint8)
    rgba[..., :3] = rgb
    if "A" in channels:
        rgba[..., 3] = channels["A"]
    return rgba


def _pixels(size) -> tuple[int, int]:
    return size[0] * size[2], size[1] * size[2]


def _rgb(data: bytes, start: int, length: int, size) -> np.ndarray:
    """PIL's read_32: (h, w, 3) uint8."""
    w, h = _pixels(size)
    n = w * h
    if length == n * 3:
        raw = data[start:start + length]
        if len(raw) < n * 3:
            raise ValueError("ICNS: not enough image data")
        return np.frombuffer(raw, np.uint8).reshape(h, w, 3)
    out = np.empty((3, n), np.uint8)
    pos = start
    for band in range(3):
        parts, left = [], n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                parts.append(data[pos:pos + 1] * count)
                pos += 1
            else:
                count = b + 1
                parts.append(data[pos:pos + count])
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"ICNS: error reading channel [{left} left]")
        raw = b"".join(parts)
        if len(raw) < n:
            raise ValueError("ICNS: not enough image data")
        out[band] = np.frombuffer(raw[:n], np.uint8)
    return out.T.reshape(h, w, 3)


def _mask(data: bytes, start: int, size) -> np.ndarray:
    """PIL's read_mk: (h, w) uint8 alpha."""
    w, h = _pixels(size)
    raw = data[start:start + w * h]
    if len(raw) < w * h:
        raise ValueError("ICNS: not enough mask data")
    return np.frombuffer(raw, np.uint8).reshape(h, w)


def _png_member(data: bytes, start: int, length: int, sizes) -> np.ndarray:
    """PIL's read_png_or_jpeg2000 and its icon size check."""
    sig = data[start:start + 12]
    if sig[:8] == PNG_MAGIC:
        rgba = decode_png(data[start:], transparency=False)
    elif sig.startswith(_J2K[:2]) or sig == _J2K[2]:
        rgba = decode_jpeg2000(data[start:start + length])
    else:
        raise ValueError("ICNS: unsupported icon subimage format")
    h, w = rgba.shape[:2]
    for s in sizes:                  # PIL's size setter
        sw, sh = s[0] * s[2], s[1] * s[2]
        if sh / h == sw // w:
            return rgba
    raise ValueError("ICNS: not one of the icon's allowed sizes")
