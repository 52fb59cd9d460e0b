"""An X11 pixmap (XPM) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's XpmImagePlugin and
XpmDecoder rules).

After the "/* XPM */" magic, the first line that starts with
`"w h ncolours chars_per_pixel` is the header. Each of the next ncolours
lines is a key of chars_per_pixel bytes and its "c" value: "#rrggbb" (or
any hex number, its low 24 bits) or "None"; any other colour name is
damage, as in PIL. The pixels are the bytes between the first and the
last double quote of each later line (a line "/* pixels */" skipped
once), cut into keys, until w * h are read. Up to 256 colours the image
is "P" and a "None" key is no colour: a pixel that uses it is damage, and
PIL's transparency takes the key's bytes as the alphas of the first
palette entries; above 256 it is "RGB" and a transparency key fails PIL's
conversion.
"""
from __future__ import annotations

import re

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import readline, to_rgba

_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def decode_xpm(data: bytes) -> np.ndarray:
    """XPM bytes -> (H, W, 4) uint8 RGBA, top row first."""
    pos = 9

    while True:
        line, pos = readline(data, pos)
        if not line:
            raise ValueError("XPM: broken file")
        m = _HEAD.match(line)
        if m:
            break
    w, h, n, bpp = (int(m.group(k)) for k in range(1, 5))
    palette, trans = {}, None
    for _ in range(n):
        line, pos = readline(data, pos)
        line = line.rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    trans = c
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("XPM: cannot read this file")
                break
        else:
            raise ValueError("XPM: cannot read this file")
    rgb_mode = n > 256
    keys = list(palette)
    index = {k: i for i, k in enumerate(keys)}
    need = w * h
    px, header = [], False
    while len(px) < need:
        line, pos = readline(data, pos)
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if key not in index:
                raise ValueError("XPM: pixel key not in the palette")
            px.append(index[key])
    if len(px) < need or w <= 0 or h <= 0:
        raise ValueError("XPM: not enough image data")
    idx = np.asarray(px[:need], np.int64).reshape(h, w)
    pal = np.asarray([palette[k] for k in keys], np.uint8).reshape(-1, 3)
    if rgb_mode:
        if trans is not None:
            raise ValueError("XPM: PIL cannot convert an RGB key to alpha")
        return to_rgba("RGB", pal[idx])
    if trans is not None:
        pal4 = np.full((max(len(pal), len(trans)), 4), 255, np.uint8)
        pal4[:len(pal), :3] = pal
        pal4[:len(trans), 3] = np.frombuffer(trans, np.uint8)
        pal = pal4
    return to_rgba("P", idx.astype(np.uint8), pal)
