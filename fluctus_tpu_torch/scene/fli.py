"""Autodesk FLI / FLC animations: the first frame, as PIL 12's
FliImagePlugin and its C decoder (FliDecode.c) give it through
`Image.open(...).convert("RGBA")`.

The 128-byte header (magic 0xAF11 or 0xAF12, flags 0 or 3, its reserved
fields zero) gives the size. The palette starts grey (index i is (i, i,
i)) and takes the first COLOR_256 (type 4) or COLOR_64 (type 11, values
shifted left by 2 and kept to 8 bits) chunk among the first frame's
chunks, skipping one prefix chunk (0xF100). The first frame is read at
offset 128 whatever precedes it (a prefix chunk there is damage, as in
PIL) onto a zeroed picture through its chunks: BLACK (13), BRUN (15, byte
run-length rows), COPY (16, raw rows), LC (12, byte deltas) and SS2 (7,
word deltas); PSTAMP (18) and the colour chunks are skipped and any
other chunk type is damage. Every bound PIL's decoder checks is checked
here in the same order, so a damaged frame fails where PIL's does.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import to_rgba


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def accept(head: bytes) -> bool:
    return (len(head) >= 16 and _i16(head, 4) in (0xAF11, 0xAF12)
            and _i16(head, 14) in (0, 3))


def _palette(data: bytes, pos: int, shift: int) -> np.ndarray:
    """FliImageFile._palette from the colour chunk's data at `pos`."""
    pal = [(a, a, a) for a in range(256)]
    i = 0
    packets = _i16(data, pos)
    pos += 2
    for _ in range(packets):
        s = data[pos:pos + 2]
        pos += 2
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            pal[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1
    return (np.asarray(pal, np.int64) & 0xFF).astype(np.uint8)


def _find_palette(data: bytes) -> np.ndarray:
    """FliImageFile._open's search of the first frame's chunks."""
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    pos = 128
    s = data[pos:pos + 16]
    pos += len(s)
    if _i16(s, 4) == 0xF100:
        pos = 128 + _i32(s)
        s = data[pos:pos + 16]
        pos += len(s)
    if _i16(s, 4) != 0xF1FA:
        return grey
    size = None
    for _ in range(_i16(s, 6)):
        if size is not None:
            pos += size - 6
        s = data[pos:pos + 6]
        pos += len(s)
        kind = _i16(s, 4)
        if kind in (4, 11):
            return _palette(data, pos, 2 if kind == 11 else 0)
        size = _i32(s)
        if not size:
            break
    return grey


def _frame(buf: bytes, w: int, h: int) -> np.ndarray:
    """FliDecode.c on one frame's bytes -> (h, w) palette indices."""
    im = np.zeros((h, w), np.uint8)
    n = len(buf)
    if n < 8:
        raise ValueError("FLI: frame overrun")
    if _i16(buf, 4) != 0xF1FA:
        raise ValueError("FLI: not a frame chunk")
    chunks = _i16(buf, 6)
    ptr, left = 16, n - 16
    for _ in range(chunks):
        if left < 10:
            raise ValueError("FLI: frame overrun")
        end = ptr + left                  # ERR_IF_DATA_OOB's bound
        d = ptr + 6
        kind = _i16(buf, ptr + 4)

        def oob(k):
            if d + k > end:
                raise ValueError("FLI: chunk overrun")

        if kind in (4, 11, 18):
            pass
        elif kind == 7:                   # SS2: word deltas
            lines = _i16(buf, d)
            d += 2
            y = line = 0
            while line < lines and y < h:
                row = im[y]
                oob(2)
                packets = _i16(buf, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise ValueError("FLI: SS2 skip past the end")
                        row = im[y]
                    else:
                        row[w - 1] = packets & 0xFF
                    oob(2)
                    packets = _i16(buf, d)
                    d += 2
                x = p = 0
                while p < packets:
                    oob(2)
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        oob(4)
                        i = 256 - buf[d + 1]
                        if x + 2 * i > w:
                            break
                        row[x:x + 2 * i] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, d + 2), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > w:
                            break
                        oob(2 + i)
                        row[x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                raise ValueError("FLI: SS2 lines left")
        elif kind == 12:                  # LC: byte deltas
            y = _i16(buf, d)
            ymax = y + _i16(buf, d + 2)
            d += 4
            while y < ymax and y < h:
                row = im[y]
                oob(1)
                packets = buf[d]
                d += 1
                x = p = 0
                while p < packets:
                    oob(2)
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > w:
                            break
                        oob(3)
                        row[x:x + i] = buf[d + 2]
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > w:
                            break
                        oob(2 + i)
                        row[x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise ValueError("FLI: LC lines left")
        elif kind == 13:                  # BLACK
            im[:] = 0
        elif kind == 15:                  # BRUN: byte runs
            for y in range(h):
                row = im[y]
                d += 1
                x = 0
                while x < w:
                    oob(2)
                    c = buf[d]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > w:
                            break
                        oob(i + 1)
                        row[x:x + i] = np.frombuffer(buf, np.uint8, i, d + 1)
                        d += i + 1
                    else:
                        i = c
                        if x + i > w:
                            break
                        row[x:x + i] = buf[d + 1]
                        d += 2
                    x += i
                if x != w:
                    raise ValueError("FLI: BRUN row unfinished")
        elif kind == 16:                  # COPY
            if d + w * h > end:
                raise ValueError("FLI: COPY overrun")
            im[:] = np.frombuffer(buf, np.uint8, w * h, d).reshape(h, w)
        else:
            raise ValueError(f"FLI: unknown chunk type {kind}")
        advance = struct.unpack_from("<i", buf, ptr)[0]
        if advance == 0:
            raise ValueError("FLI: chunk of size 0")
        if advance < 0 or advance > left:
            raise ValueError("FLI: chunk past the frame")
        ptr += advance
        left -= advance
    return im


def decode_fli(data: bytes) -> np.ndarray:
    """FLI / FLC bytes -> (H, W, 4) uint8 RGBA of the first frame, top
    row first."""
    s = data[:128]
    if not (accept(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise ValueError("FLI: not an FLI/FLC file")
    w, h = _i16(s, 8), _i16(s, 10)
    if w == 0 or h == 0:
        raise ValueError("FLI: empty picture")
    pal = _find_palette(data)
    head = data[128:132]
    if not head:
        raise EOFError("FLI: missing frame size")
    size = _i32(head)
    buf = data[128:128 + size]
    # PIL's loop: a frame (an odd byte short allowed) that is not all
    # there is "image file is truncated"
    if size == 0 or len(buf) + len(buf) % 2 < size:
        raise ValueError("FLI: image file is truncated")
    return to_rgba("P", _frame(buf, w, h), pal)
