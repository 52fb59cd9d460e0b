"""A Windows Paint (MSP) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL's MspImagePlugin rules).

A 32-byte header of 16 little-endian words whose XOR is zero (magic,
width, height, ...), then 1-bit rows, a set bit white, (width + 7) // 8
bytes each: raw for version 1 ("DanM"); for version 2 ("LinS") a map of
each row's byte count, then the rows, RLE-coded (0 n v: v repeated n
times; k > 0: the k bytes after it), a row of count 0 all white. PIL
joins the decoded rows as they come, so a row that decodes to another
length shifts the rows after it.
"""
from __future__ import annotations

import struct

import numpy as np


def decode_msp(data: bytes) -> np.ndarray:
    """MSP bytes -> (H, W, 4) uint8 RGBA, top row first."""
    if len(data) < 32 or not data.startswith((b"DanM", b"LinS")):
        raise ValueError("MSP: bad header")
    words = struct.unpack_from("<16H", data)
    check = 0
    for v in words:
        check ^= v
    if check:
        raise ValueError("MSP: bad checksum")
    w, h = words[2], words[3]
    row_bytes = (w + 7) // 8
    if data.startswith(b"DanM"):
        px = data[32:32 + row_bytes * h]
    else:
        if len(data) < 32 + 2 * h:
            raise ValueError("MSP: truncated row map")
        rowmap = struct.unpack_from(f"<{h}H", data, 32)
        pos = 32 + 2 * h
        out = bytearray()
        for n in rowmap:
            if n == 0:
                out += b"\xff" * row_bytes
                continue
            row = data[pos:pos + n]
            pos += n
            if len(row) != n:
                raise ValueError("MSP: truncated row")
            i = 0
            while i < n:
                kind = row[i]
                i += 1
                if kind == 0:
                    if i + 2 > n:
                        raise ValueError("MSP: corrupted row")
                    out += bytes([row[i + 1]]) * row[i]
                    i += 2
                else:
                    out += row[i:i + kind]
                    i += kind
        px = bytes(out[:row_bytes * h])
    if len(px) != row_bytes * h:
        raise ValueError("MSP: not enough image data")
    rows = np.frombuffer(px, np.uint8).reshape(h, row_bytes)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = (np.unpackbits(rows, axis=1)[:, :w] * 255)[..., None]
    return rgba
