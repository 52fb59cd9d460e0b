"""A Mac OS icon (ICNS) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's IcnsImagePlugin) where
the member PIL picks is PNG.

A big-endian "icns" header (magic, file length), then members of a
4-byte code and a length that counts its own 8 bytes. PIL picks the
largest (width, height, scale) whose code is present, in its SIZES
table, and loads the members of that size. A PNG member (codes ic07-ic14
and icp4-icp6 whose bytes start with the PNG magic) is decoded by
scene/png.py without its tRNS chunk, as PIL's icon takes the PNG's mode
and pixels but not its info; its size must be one PIL allows for the
icon. A JPEG 2000 member, or RLE RGB and mask members beside the chosen
size, raise UnsupportedImage; a member that is neither PNG nor JPEG 2000
is damage.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
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
    present = [c for c in SIZES[best] if c in dct]
    if any(c not in _PNG_CODES for c in present):
        raise UnsupportedImage("ICNS icons whose largest member is RLE RGB "
                               "are not decoded by the port")
    start = dct[present[0]][0]
    sig = data[start:start + 12]
    if sig[:8] != PNG_MAGIC:
        if sig.startswith(_J2K[:2]) or sig == _J2K[2]:
            raise UnsupportedImage("ICNS JPEG 2000 members are not decoded "
                                   "by the port")
        raise ValueError("ICNS: unsupported icon subimage format")
    rgba = decode_png(data[start:], transparency=False)
    h, w = rgba.shape[:2]
    for s in sizes:                  # PIL's size setter
        sw, sh = s[0] * s[2], s[1] * s[2]
        if sh / h == sw // w:
            return rgba
    raise ValueError("ICNS: not one of the icon's allowed sizes")
