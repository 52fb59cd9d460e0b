"""IPTC/NAA image records, as PIL 12's IptcImagePlugin gives them through
`Image.open(...).convert("RGBA")`.

Records are 0x1C, a record and a dataset number, and a big-endian 15-bit
length (or, above 128, that many minus 128 bytes of length). The records
up to the first (8, 10) describe the picture: (3, 60) its layers and
whether it is a component of a multi-band picture, (3, 20) and (3, 30)
its width and height, (3, 120) its compression (1 raw, 5 JPEG), (3, 65)
the band a component holds. The (8, 10) records that follow are joined
into one image: raw bytes are read as a PGM of that size (PIL prepends a
P5 header; scene/pnm.py), JPEG bytes as a file of their own (through
imageformat, so scene/jpeg.py for JPEG). One layer that is no component
gives that image as it is; a component of 3 (RGB) or 4 (CMYK) layers
puts its greyscale image into its band (Python's index rules: band 0 is
the last) beside zero bands, as PIL merges them.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene import imageformat
from fluctus_tpu_torch.scene.imageformat import UnsupportedImage
from fluctus_tpu_torch.scene.jpeg import decode_jpeg_samples
from fluctus_tpu_torch.scene.pilmodes import to_rgba
from fluctus_tpu_torch.scene.pnm import decode_pnm

_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(data: bytes, pos: int):
    """PIL's IptcImageFile.field -> (tag or None, size, position after)."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise ValueError("IPTC: invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("IPTC: illegal field length")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(data[pos:pos + size - 128])
        pos += s[3] - 128
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def _bytes(info: dict, key) -> bytes:
    """A record's bytes; one that is missing, empty or repeated fails in
    PIL (its value is None or a list there)."""
    v = info.get(key)
    if not isinstance(v, bytes):
        raise ValueError(f"IPTC: record {key} missing, empty or repeated")
    return v


def _pil_mode(body: bytes, kind: str):
    """PIL's mode of an image that a band record holds, read from its
    header (Image.merge takes a band of mode "L" only), or None for a
    format whose mode the port does not read."""
    if kind == "pnm":
        from fluctus_tpu_torch.scene.pnm import MODES, _token, magic
        m = magic(body)
        mode = MODES.get(m)
        if mode == "L":         # PIL's mode I past a maxval of 255
            pos = len(m) + 1
            for _ in range(3):
                tok, pos = _token(body, pos)
            mode = "I" if int(tok) > 255 else "L"
        return mode
    if kind == "png":
        if len(body) < 26:
            return "?"
        depth, ctype = body[24], body[25]
        if ctype == 0:
            return {1: "1", 16: "I;16"}.get(depth, "L")
        return {2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}.get(ctype, "?")
    if kind in ("qoi", "webp"):
        return "RGB"          # RGB or RGBA, never merged
    return None


def decode_iptc(data: bytes) -> np.ndarray:
    """IPTC bytes -> (H, W, 4) uint8 RGBA, top row first."""
    info, pos = {}, 0
    while True:
        offset = pos
        tag, size, pos = _field(data, pos)
        if not tag or tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos += len(value) if value else 0
        if tag in info:
            if not isinstance(info[tag], list):
                info[tag] = [info[tag]]
            info[tag].append(value)
        else:
            info[tag] = value
    kind = _bytes(info, (3, 60))
    layers, component = kind[0], kind[1]
    if layers == 1 and not component:
        mode, band = "L", None
    else:
        mode = {3: "RGB", 4: "CMYK"}.get(layers) if component else None
        if mode is None:
            raise ValueError("IPTC: no mode for these layers")
        band = _bytes(info, (3, 65))[0] - 1 if (3, 65) in info else 0
    w, h = _i(_bytes(info, (3, 20))), _i(_bytes(info, (3, 30)))
    if w <= 0 or h <= 0:
        raise ValueError("IPTC: empty picture")
    compression = {1: "raw", 5: "jpeg"}.get(_i(_bytes(info, (3, 120))))
    if compression is None:
        raise ValueError("IPTC: unknown image compression")
    if tag != (8, 10):
        raise ValueError("IPTC: no image records")
    parts, pos = [], offset
    while True:
        tag, size, pos = _field(data, pos)
        if tag != (8, 10):
            break
        part = data[pos:pos + size]
        parts.append(part)
        pos += len(part)
    body = b"".join(parts)
    if compression == "raw":
        inner = decode_pnm(b"P5\n%d %d\n255\n" % (w, h) + body)
        grey = True
    else:
        kind = imageformat.sniff(body)
        if kind is None:
            raise ValueError("IPTC: image records PIL does not identify")
        grey = False
        if kind == "jpeg":
            samples = decode_jpeg_samples(body)
            grey = samples.shape[2] == 1
            inner = to_rgba("L" if grey else "RGB",
                            samples[..., 0] if grey else samples)
        elif band is None:
            inner = imageformat.decode(body, kind)
        else:
            # Image.merge checks the mode of every band but the first
            # ("L"), and copies a first band of one byte a pixel as it is
            inner_mode = _pil_mode(body, kind)
            first = band % (3 if mode == "RGB" else 4) == 0
            if inner_mode is None or (first and inner_mode not in (
                    "L", "1", "RGB", "RGBA", "LA")):
                raise UnsupportedImage(
                    f"IPTC band records holding {kind} images of PIL's "
                    f"mode {inner_mode} are not decoded by the port")
            inner = imageformat.decode(body, kind)
            grey = inner_mode == "L" or (first and inner_mode == "1")
    if band is None:
        return inner
    if not grey:
        raise ValueError("IPTC: a band record that is not greyscale")
    bands = [np.zeros(inner.shape[:2], np.uint8)] * (3 if mode == "RGB"
                                                      else 4)
    bands[band] = inner[..., 0]
    return to_rgba(mode, np.stack(bands, -1))
