"""A GIF decoder (the first frame) that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's GifImagePlugin rules).

LZW with clear and end codes and a full 4,096-entry table, global and
local colour tables, interlaced rows, and the graphic-control extension's
transparent index. As in PIL: a colour table that is the identity grey
ramp is no palette (the image is grey, the index its value); the image is
the logical screen, grown to hold the frame, filled with the transparent
index (0 without one) where the frame does not reach; the transparent
index has alpha 0; an index past the colour table reads black. A code
stream that ends (or meets its end code) before the frame is full, and
other damage, raise ValueError, which the pool turns into -1, as PIL
fails on them.
"""
from __future__ import annotations

import numpy as np


def _byte(data: bytes, pos: int) -> int:
    if pos >= len(data):
        raise ValueError("GIF: truncated file")
    return data[pos]


def _blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data sub-blocks at `pos` up to their terminator, joined."""
    out = []
    while True:
        n = _byte(data, pos)
        pos += 1
        if n == 0:
            return b"".join(out), pos
        if pos + n > len(data):
            raise ValueError("GIF: truncated sub-block")
        out.append(data[pos:pos + n])
        pos += n


def _palette(p: bytes) -> np.ndarray | None:
    """PIL's _is_palette_needed: None for the identity grey ramp."""
    ent = np.frombuffer(p, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(ent))
    if (ent == ramp[:, None]).all():
        return None
    return ent


def _lzw(code: bytes, min_size: int, n_out: int) -> np.ndarray:
    """Decode n_out indices (codes after them are not read)."""
    if not 1 <= min_size <= 11:
        raise ValueError("GIF: bad LZW code size")
    clear = 1 << min_size
    end = clear + 1
    out = bytearray()
    prefix = [0] * 4096
    suffix = [0] * 4096
    length = [0] * 4096
    for i in range(clear):
        suffix[i] = i
        length[i] = 1
    size = min_size + 1
    nxt = end + 1
    prev = -1
    acc = bits = 0
    pos = 0
    nbytes = len(code)
    while len(out) < n_out:
        while bits < size:
            if pos >= nbytes:
                raise ValueError("GIF: the image data ends early")
            acc |= code[pos] << bits
            pos += 1
            bits += 8
        c = acc & ((1 << size) - 1)
        acc >>= size
        bits -= size
        if c == clear:
            size = min_size + 1
            nxt = end + 1
            prev = -1
            continue
        if c == end:
            raise ValueError("GIF: the end code comes early")
        if prev < 0:
            if c >= clear:
                raise ValueError("GIF: bad first LZW code")
            out.append(c)
            prev = c
            continue
        if c < nxt:
            entry = c
        elif c == nxt and nxt < 4096:
            entry = -1                       # KwKwK
        else:
            raise ValueError("GIF: bad LZW code")
        # the string of `entry` (or prev + first of prev)
        src = prev if entry < 0 else entry
        s = bytearray(length[src])
        k = src
        for i in range(length[src] - 1, -1, -1):
            s[i] = suffix[k]
            k = prefix[k]
        first = s[0]
        if entry < 0:
            s.append(first)
        out += s
        if nxt < 4096:
            prefix[nxt] = prev
            suffix[nxt] = first
            length[nxt] = length[prev] + 1
            nxt += 1
            if nxt == (1 << size) and size < 12:
                size += 1
        prev = c
    return np.frombuffer(bytes(out[:n_out]), np.uint8)


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(s, h, step) for s, step in
                           ((0, 8), (4, 8), (2, 4), (1, 2))]).astype(np.int64)


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> (H, W, 4) uint8 RGBA of the first frame, top row
    first."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    sw, sh = int.from_bytes(data[6:8], "little"), \
        int.from_bytes(data[8:10], "little")
    flags = data[10]
    pos = 13
    gpal = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            raise ValueError("GIF: truncated colour table")
        gpal = _palette(data[pos:pos + n])
        pos += n
    trans = None
    while True:
        b = _byte(data, pos)
        pos += 1
        if b == 0x3B:                               # trailer: no image
            raise ValueError("GIF: no image")
        if b == 0x21:                               # extension
            label = _byte(data, pos)
            block, pos2 = None, pos + 1
            n = _byte(data, pos2)
            if n:
                if pos2 + 1 + n > len(data):
                    raise ValueError("GIF: truncated extension")
                block = data[pos2 + 1:pos2 + 1 + n]
            if label == 0xF9 and block is not None and block[0] & 1:
                trans = block[3] if len(block) > 3 else None
            _, pos = _blocks(data, pos2)
            continue
        if b != 0x2C:
            continue                                # PIL skips a stray byte
        if pos + 9 > len(data):
            raise ValueError("GIF: truncated image descriptor")
        x0, y0, fw, fh = (int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2],
                                         "little") for i in range(4))
        iflags = data[pos + 8]
        pos += 9
        pal = gpal
        if iflags & 0x80:
            n = 3 << ((iflags & 7) + 1)
            if pos + n > len(data):
                raise ValueError("GIF: truncated colour table")
            pal = _palette(data[pos:pos + n])
            pos += n
        min_size = _byte(data, pos)
        code, _ = _blocks(data, pos + 1)
        break
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    if w <= 0 or h <= 0:
        raise ValueError("GIF: empty image")
    idx = np.full((h, w), trans if trans is not None else 0, np.uint8)
    frame = _lzw(code, min_size, fw * fh).reshape(fh, fw)
    if iflags & 0x40:                               # interlaced rows
        rows = np.empty_like(frame)
        rows[_interlaced_rows(fh)] = frame
        frame = rows
    idx[y0:y0 + fh, x0:x0 + fw] = frame
    rgba = np.empty((h, w, 4), np.uint8)
    if pal is None:
        rgba[..., :3] = idx[..., None]
    else:
        table = np.zeros((256, 3), np.uint8)
        table[:len(pal)] = pal[:256]
        rgba[..., :3] = table[idx]
    rgba[..., 3] = 255
    if trans is not None:
        rgba[..., 3][idx == trans] = 0
    return rgba
