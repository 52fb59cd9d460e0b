"""An XV thumbnail decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's XVThumbImagePlugin).

The magic "P7 332", the rest of its line, comment lines that start with
"#", then a line whose first two words are the width and the height;
w * h bytes follow, each an index into the fixed RGB332 palette (red
r * 255 // 7 from the top three bits, green from the next three, blue
b * 255 // 3 from the low two).
"""
from __future__ import annotations

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import readline, rows, to_rgba

_I = np.arange(256)
PALETTE = np.stack([(_I >> 5) * 255 // 7, ((_I >> 2) & 7) * 255 // 7,
                    (_I & 3) * 255 // 3], -1).astype(np.uint8)


def decode_xvthumb(data: bytes) -> np.ndarray:
    """XV thumbnail bytes -> (H, W, 4) uint8 RGBA, top row first."""
    pos = 6

    _, pos = readline(data, pos)
    while True:
        s, pos = readline(data, pos)
        if not s:
            raise ValueError("XV thumbnail: unexpected end of file")
        if s[0] != 35:
            break
    w, h = (int(v) for v in s.strip().split(maxsplit=2)[:2])
    if w <= 0 or h <= 0:
        raise ValueError("XV thumbnail: empty image")
    return to_rgba("P", rows(data, pos, h, w), PALETTE)
