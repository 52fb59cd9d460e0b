"""An IM Tools (IMT) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's ImtImagePlugin).

Text lines "key value" ("width", "height", "pixel n8"; lines that start
with "*" are comments) up to a form feed (0x0C), after which come
width * height grey bytes, top row first. PIL reads the header through
a 100-byte buffer, and the port walks the same bytes: a line of one
byte or of more than 100, or one that is no "key value", ends the header
without the form feed, and then PIL has no pixels to load.
"""
from __future__ import annotations

import re

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import rows, to_rgba

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def decode_imt(data: bytes) -> np.ndarray:
    """IMT bytes -> (H, W, 4) uint8 RGBA, top row first."""
    buffer, fpos = data[:100], min(100, len(data))
    if b"\n" not in buffer:
        raise ValueError("IMT: not an IM Tools file")
    w = h = 0
    grey = False
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, fpos = data[fpos:fpos + 1], fpos + 1
        if not s:
            raise ValueError("IMT: no image data")
        if s == b"\x0c":
            offset = min(fpos, len(data)) - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += data[fpos:fpos + 100]
            fpos += 100
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            raise ValueError("IMT: no image data")
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            raise ValueError("IMT: no image data")
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            grey = True
    if not grey or w <= 0 or h <= 0:
        raise ValueError("IMT: no grey image")
    return to_rgba("L", rows(data, offset, h, w))
