"""A FITS decoder that gives what PIL's `Image.open(...).convert("RGBA")`
gives (PIL 12's FitsImagePlugin and FitsGzipDecoder rules).

80-byte cards "KEYWORD = value / comment", the first SIMPLE = T; an END
card ends a header unit, padded to 2,880 bytes. The first unit whose
NAXIS is not 0 gives the image: NAXIS1 the width, NAXIS2 the height (1
and NAXIS1 for one axis), BITPIX the mode (8: "L", 16: "I;16", 32: "I",
-32 and -64: "F"). The data begins at the first card after a unit that
is no SIMPLE or XTENSION card. PIL reads it in its own raw modes, that
is little-endian (16-bit samples, int32 and float32 words, a float64
file read as float32 words; FITS stores big-endian), bottom row first,
and ignores BZERO and BSCALE; the port does the same. A tile-compressed
image (XTENSION 'BINTABLE', ZIMAGE T, ZCMPTYPE 'GZIP_1') is gunzipped
from the end of the table, each pixel the low ZBITPIX / 8 bytes of a
4-byte word, rows reversed, as PIL's fits_gzip decoder does.
"""
from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import rows, to_rgba

_MODES = {8: ("L", None), 16: ("I", "<u2"), 32: ("I", "<i4"),
          -32: ("F", "<f4"), -64: ("F", "<f4")}


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """PIL's _parse_headers -> (decoder, offset, size, BITPIX) or None."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'"
            and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "gzip"
    size = _size(headers, prefix)
    if not size:
        return None
    return decoder, offset, size, int(headers[prefix + b"BITPIX"])


def decode_fits(data: bytes) -> np.ndarray:
    """FITS bytes -> (H, W, 4) uint8 RGBA, top row first."""
    headers: dict = {}
    in_progress, found, pos = False, None, 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError("FITS: truncated file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                try:
                    found = _parse(headers)
                except KeyError as e:
                    raise ValueError(f"FITS: no card {e}") from None
            in_progress = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise ValueError("FITS: not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("FITS: no image data")
    decoder, offset, (w, h), bits = found
    if bits not in _MODES or w <= 0 or h <= 0:
        raise ValueError(f"FITS: no mode for BITPIX {bits}")
    mode, word = _MODES[bits]
    size = 1 if word is None else np.dtype(word).itemsize
    start = offset + pos - 80
    if decoder == "gzip":
        try:
            value = gzip.decompress(data[start:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"FITS: {e}") from None
        n = min(bits // 8, 4)
        words = np.frombuffer(value[:len(value) // 4 * 4], np.uint8)
        if n <= 0 or len(words) < 4 * w * h:
            raise ValueError("FITS: not enough image data")
        raw = words[:4 * w * h].reshape(h, w, 4)[::-1, :, 4 - n:]
        raw = np.ascontiguousarray(raw).reshape(h, w * n)
    else:
        raw = rows(data, start, h, size * w, bottom_up=True)
    if word is None:
        return to_rgba("L", raw)
    v = np.ascontiguousarray(raw).view(word).reshape(h, w)
    return to_rgba(mode, v)
