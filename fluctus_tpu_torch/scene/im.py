"""An IFUNC Image Memory (IM) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's ImImagePlugin rules).

A text header of "Key: value" lines (CR LF, LF or LF CR), at most 100
bytes each, ends at a NUL or a ^Z; the pixels start after the first ^Z.
"Image type" names the mode and PIL's raw mode, "Image size (x*y)" the
size (512x512 if absent), and a "Lut" key puts a 768-byte table (all
reds, then greens, then blues) before the pixels: a table that is not
grey turns "L" into "P" and "LA" into "PA" through it, a grey one is
ignored, as PIL ignores the lookup tables it keeps. Rows are stored
bottom row first; the first frame is read.

Decoded: the types PIL writes (its SAVE table): "0 1", "L 1" and "B1"
(1-bit rows), "Greyscale"/"Grayscale" (L or P), "LA" and "PA" (LA or
PA, line-interleaved), "RGB", "RGBA", "RGBX", "CMYK" and "YCC" (one
plane of each band a row; YCC through PIL's own YCbCr -> RGB, see
scene/pilmodes.py), "X 24" (interleaved RGB), "L 32S" (int32), "L 16",
"L 16L" and "L 16B" (16-bit), "L 32F" (float32), the integer types PIL
widens to float ("L 8", "L 8S", "L 16S", "L 32", "L 32 F") or reads as
int32 ("L 32 S"), the "L*n" types of other widths through PIL's bit
decoder, "B2" and "B4" (2- and 4-bit palette indices) and "RGB3"/"RYB3"
(green, red and blue planes). The types PIL has no unpacker for ("PA",
"RLB", "RYB") fail as PIL fails.
"""
from __future__ import annotations

import re

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import readline, rows, to_rgba

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_TAGS = ("Comment", "Date", "Digitalization equipment",
         "File size (no of images)", "Lut", "Name", "Scale (x,y)",
         "Image size (x*y)", "Image type")
# PIL's OPEN table: image type -> (mode, raw mode)
_OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    _OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    _OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    _OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    _OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
_OPEN["L 32S image"] = _OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    _OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

_MODES = {m for m, _ in _OPEN.values()}
# (mode, line-interleaved raw mode) -> bands stored a row
_LINE = {("LA", "LA;L"): 2, ("PA", "PA;L"): 2, ("RGB", "RGB;L"): 3,
         ("RGBA", "RGBA;L"): 4, ("RGB", "RGBX;L"): 4, ("CMYK", "CMYK;L"): 4,
         ("YCbCr", "YCbCr;L"): 3}
# raw mode of one word a pixel -> its numpy type (PIL's unpackers: "F;n"
# widens the integer to float, "I;32" reads an int32)
_WORDS = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32S": "<i4",
          "I;32": "<i4", "F;32F": "<f4", "F;8": "u1", "F;8S": "i1",
          "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4"}


def _bits(data: bytes, pos: int, w: int, h: int, bits: int) -> np.ndarray:
    """PIL's "bit" decoder as ImImagePlugin calls it for the ifunc95 types
    of other widths (bits, pad 8, fill 3, unsigned, bottom row first):
    bytes shifted into a buffer above the bits it holds, pixels taken from
    its low end; at a row's end the count (not the buffer) goes to 0, so
    the rest of the last byte is OR-ed into the next one."""
    out = np.zeros((h, w), np.float32)
    mask, buf, cnt, x, y = (1 << bits) - 1, 0, 0, 0, h - 1
    for byte in data[pos:]:
        buf |= byte << cnt
        cnt += 8
        while cnt >= bits:
            d = buf & mask
            buf = byte >> (8 - (cnt - bits)) if cnt > 32 else buf >> bits
            cnt -= bits
            out[y, x] = d
            x += 1
            if x >= w:
                y, x, cnt = y - 1, 0, 0
                if y < 0:
                    return out
    raise ValueError("image file is truncated")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _header(data: bytes):
    """PIL's header loop -> (info dict, raw mode, offset of the pixels)."""
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, n, pos = "L", 0, 0
    if b"\n" not in data[:100]:
        raise ValueError("IM: not an IM file")
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        line, pos = readline(data, pos)
        s += line
        if len(s) > 100:
            raise ValueError("IM: not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise ValueError("IM: syntax error in the header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in _OPEN:
            v, rawmode = _OPEN[v]
        if k != "Comment":
            info[k] = v
        n += k in _TAGS
    if not n:
        raise ValueError("IM: not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise ValueError("IM: file truncated")
    return info, rawmode, pos


def decode_im(data: bytes) -> np.ndarray:
    """IM bytes -> (H, W, 4) uint8 RGBA, top row first."""
    info, rawmode, pos = _header(data)
    size, mode = info["Image size (x*y)"], info["Image type"]
    if not (isinstance(size, tuple) and len(size) == 2
            and all(isinstance(v, int) and v > 0 for v in size)):
        raise ValueError("IM: bad size")
    if mode not in _MODES:
        raise ValueError(f"IM: unknown image type {mode}")
    w, h = size
    palette = None
    if "Lut" in info:
        lut = np.frombuffer(data[pos:pos + 768], np.uint8)
        pos += len(lut)
        if len(lut) < 768:
            raise ValueError("IM: truncated lookup table")
        grey = bool(np.all((lut[:256] == lut[256:512])
                           & (lut[:256] == lut[512:])))
        if mode in ("L", "LA", "P", "PA") and not grey:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = lut.reshape(3, 256).T
    if rawmode in ("1", "L", "P") and mode == rawmode:
        if rawmode == "1":
            r = rows(data, pos, h, (w + 7) // 8, bottom_up=True)
            return to_rgba("1", np.unpackbits(r, axis=1)[:, :w])
        return to_rgba(mode, rows(data, pos, h, w, bottom_up=True), palette)
    if rawmode == "RGB" and mode == "RGB":
        r = rows(data, pos, h, 3 * w, bottom_up=True)
        return to_rgba("RGB", r.reshape(h, w, 3))
    if (mode, rawmode) in _LINE:
        nb = _LINE[mode, rawmode]
        r = rows(data, pos, h, nb * w, bottom_up=True)
        px = r.reshape(h, nb, w).transpose(0, 2, 1)
        return to_rgba(mode, px, palette)
    if rawmode in _WORDS and mode in ("I;16", "I;16L", "I;16B", "I", "F"):
        dt = np.dtype(_WORDS[rawmode])
        r = rows(data, pos, h, dt.itemsize * w, bottom_up=True)
        v = np.ascontiguousarray(r).view(dt).reshape(h, w)
        if mode == "F":
            v = v.astype(np.float32)
        return to_rgba("F" if mode == "F" else "I", v)
    if mode == "F" and rawmode[2:].isdigit():
        return to_rgba("F", _bits(data, pos, w, h, int(rawmode[2:])))
    if rawmode in ("P;2", "P;4"):
        # packed indices, first pixel in the high bits, into a palette of
        # zeros: PIL gives these images no palette, and converts them black
        n = int(rawmode[2:])
        r = rows(data, pos, h, (w * n + 7) // 8, bottom_up=True)
        idx = np.unpackbits(r, axis=1).reshape(h, -1, n)[:, :w]
        idx = (idx * (1 << np.arange(n - 1, -1, -1))).sum(-1).astype(np.uint8)
        return to_rgba("P", idx, np.zeros((256, 3), np.uint8))
    if rawmode in ("RGB;T", "RYB;T"):
        # three planes, green, red, blue, each bottom row first
        px = np.stack([rows(data, pos + k * w * h, h, w, bottom_up=True)
                       for k in (1, 0, 2)], -1)
        return to_rgba("RGB", px)
    raise ValueError(f"IM: no unpacker for type {info['Image type']} (raw "
                     f"mode {rawmode})")
