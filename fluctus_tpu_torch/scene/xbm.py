"""An X11 bitmap (XBM) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's XbmImagePlugin and
XbmDecode rules).

The header's `#define ..._width` and `_height` lines (and an optional
hot spot) are matched in the first 512 bytes by PIL's own expression, up
to `_bits[]`; then each byte is the two characters after an 'x' (a
character that is no hex digit counts 0), bits least significant first,
a set bit white, (width + 7) // 8 bytes a row.
"""
from __future__ import annotations

import re

import numpy as np

# PIL's xbm_head
HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _i
    _HEX[bytes([_c]).upper()[0]] = _i


def decode_xbm(data: bytes) -> np.ndarray:
    """XBM bytes -> (H, W, 4) uint8 RGBA, top row first."""
    m = HEAD.match(data[:512])
    if not m:
        raise ValueError("XBM: bad header")
    w, h = int(m.group("width")), int(m.group("height"))
    n = (w + 7) // 8 * h
    body = np.frombuffer(data, np.uint8)[m.end():]
    xs = np.flatnonzero(body == ord("x"))
    # XbmDecode: the 'x' found, the two characters after it, then the
    # search goes on three bytes later
    picked = []
    nxt = 0
    for x in xs:
        if x < nxt:
            continue
        if x + 3 > len(body):
            break
        picked.append(x)
        nxt = x + 3
        if len(picked) == n:
            break
    if len(picked) < n:
        raise ValueError("XBM: truncated image data")
    at = np.asarray(picked, np.int64)
    vals = (_HEX[body[at + 1]] << 4) + _HEX[body[at + 2]]
    rows = vals.astype(np.uint8).reshape(h, (w + 7) // 8)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = (bits * 255)[..., None]
    return rgba
