"""A Blizzard mipmap (BLP) decoder that gives what PIL's
`Image.open(...).convert("RGBA")` gives (PIL 12's BlpImagePlugin, its
BLP1 and BLP2 decoders); the first mipmap.

The header (little-endian): BLP1 "BLP1", the compression (0: JPEG, 1:
palette), an alpha flag, width, height, the encoding (4 or 5 for a
palette) and a subtype; BLP2 "BLP2", a type word, then one byte each of
compression (1), encoding (1: palette, 2: DXT), alpha flag and alpha
encoding (0: DXT1, 1: DXT3, 7: DXT5) and a mips byte, width and height.
Then 16 mip offsets and 16 lengths, and a 256-entry BGRA palette (PIL
takes as many entries as the file holds).

The image is RGBA when the alpha flag is set, else RGB, and PIL fills
it from one stream of bytes, whatever the stream's own layout:
- palette: each byte of the first mip (BLP2 reads it at its offset,
  BLP1 right after the palette) gives R, G, B and, with alpha, the
  palette entry's A;
- DXT (BLP2): rows of 4 x 4 blocks through PIL's own Python decoders
  (565 colours shifted, not replicated; DXT1's 3-colour blocks, and a
  transparent black that is R, G, B 0 without alpha; DXT3 and DXT5 give
  four bytes a pixel even without alpha), 4 * ceil(w / 4) pixels a row;
- JPEG (BLP1): the shared JPEG header, then the mip, decoded by
  scene/jpeg.py and read as BGR.
The stream is cut into rows of the image's width, so a width that is not
a multiple of 4, or bytes that do not match the mode, shear the picture
as in PIL. CMYK JPEG raises UnsupportedImage.
"""
from __future__ import annotations

import struct

import numpy as np

from fluctus_tpu_torch.scene.pilmodes import to_rgba


def _stream_image(stream: bytes, w: int, h: int, alpha: bool) -> np.ndarray:
    """PIL's set_as_raw: the first w * h pixels of `stream`."""
    bpp = 4 if alpha else 3
    if len(stream) < w * h * bpp:
        raise ValueError("BLP: not enough image data")
    px = np.frombuffer(stream[:w * h * bpp], np.uint8).reshape(h, w, bpp)
    return to_rgba("RGBA" if alpha else "RGB", px)


def _palette_stream(data: bytes, pos: int, length: int, palette: np.ndarray,
                    alpha: bool) -> bytes:
    idx = np.frombuffer(data[pos:pos + length], np.uint8)
    if len(idx) < length:
        raise ValueError("BLP: truncated file read")
    return palette[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]].tobytes()


def _565(c: np.ndarray) -> np.ndarray:
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2,
                     (c & 0x1F) << 3], -1)


def _le(b: np.ndarray) -> np.ndarray:
    """Little-endian integer of the last axis' bytes."""
    v = np.zeros(b.shape[:-1], np.int64)
    for k in range(b.shape[-1]):
        v |= b[..., k].astype(np.int64) << (8 * k)
    return v


def _colours(blocks: np.ndarray, dxt1: bool):
    """(..., 16, 3) colours of DXT colour blocks (bytes 0-7 of `blocks`)
    and the mask of DXT1's transparent texels."""
    c0, c1 = _le(blocks[..., 0:2]), _le(blocks[..., 2:4])
    code = (_le(blocks[..., 4:8])[..., None] >> (2 * np.arange(16))) & 3
    p0, p1 = _565(c0)[..., None, :], _565(c1)[..., None, :]
    four = (c0 > c1) if dxt1 else np.ones(c0.shape, bool)
    f = four[..., None, None]
    cand = [np.broadcast_to(p0, p1.shape), p1,
            np.where(f, (2 * p0 + p1) // 3, (p0 + p1) // 2),
            np.where(f, (2 * p1 + p0) // 3, 0)]
    rgb = np.choose(code[..., None], cand)
    return rgb, (code == 3) & ~four[..., None]


def _dxt_stream(data: bytes, pos: int, w: int, h: int, enc: int,
                alpha: bool) -> bytes:
    bw, bh = (w + 3) // 4, (h + 3) // 4
    size = 8 if enc == 0 else 16
    raw = data[pos:pos + bw * bh * size]
    if len(raw) < bw * bh * size:
        raise ValueError("BLP: truncated file read")
    blocks = np.frombuffer(raw, np.uint8).reshape(bh, bw, size)
    if enc == 0:
        rgb, clear = _colours(blocks, True)
        a = np.where(clear, 0, 255)
        bpp = 4 if alpha else 3
    else:
        rgb, _ = _colours(blocks[..., 8:], False)
        bpp = 4
        if enc == 1:
            nib = np.stack([blocks[..., :8] & 15, blocks[..., :8] >> 4], -1)
            a = nib.reshape(bh, bw, 16).astype(np.int64) * 17
        else:
            a0 = blocks[..., 0].astype(np.int64)[..., None]
            a1 = blocks[..., 1].astype(np.int64)[..., None]
            c = (_le(blocks[..., 2:8])[..., None] >> (3 * np.arange(16))) & 7
            a = np.where(c == 0, a0, np.where(c == 1, a1, np.where(
                a0 > a1, ((8 - c) * a0 + (c - 1) * a1) // 7,
                np.where(c == 6, 0, np.where(
                    c == 7, 255, ((6 - c) * a0 + (c - 1) * a1) // 5)))))
    px = np.concatenate([rgb, a[..., None]], -1)[..., :bpp]
    # (bh, bw, 4 rows, 4 columns, bpp) -> rows of every block's texels
    px = px.reshape(bh, bw, 4, 4, bpp).transpose(0, 2, 1, 3, 4)
    return px.astype(np.uint8).tobytes()


def decode_blp(data: bytes) -> np.ndarray:
    """BLP bytes -> (H, W, 4) uint8 RGBA, top row first."""
    magic = data[:4]
    (compression,) = struct.unpack_from("<i", data, 4)
    if magic == b"BLP1":
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        w, h, encoding = struct.unpack_from("<IIi", data, 12)
        pos = 28
    else:
        encoding, alpha, alpha_enc = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
        w, h = struct.unpack_from("<II", data, 12)
        pos = 20
    if w <= 0 or h <= 0:
        raise ValueError("BLP: empty image")
    offsets = struct.unpack_from("<16I", data, pos)
    lengths = struct.unpack_from("<16I", data, pos + 64)
    pos += 128
    if magic == b"BLP1" and compression == 0:
        return _jpeg(data, pos, offsets, lengths, w, h)
    if magic == b"BLP1" and (compression != 1 or encoding not in (4, 5)):
        raise ValueError("BLP: unsupported BLP1 encoding")
    palette = np.frombuffer(data[pos:pos + 1024], np.uint8)
    if len(palette) < 1024:
        raise ValueError("BLP: truncated palette")
    palette = palette.reshape(256, 4)
    if magic == b"BLP1":
        return _stream_image(_palette_stream(
            data, pos + 1024, lengths[0], palette, alpha), w, h, alpha)
    if compression != 1:
        raise ValueError(f"BLP: unknown compression {compression}")
    if encoding == 1:
        stream = _palette_stream(data, offsets[0], lengths[0], palette,
                                 alpha)
    elif encoding == 2 and alpha_enc in (0, 1, 7):
        stream = _dxt_stream(data, offsets[0], w, h, alpha_enc, alpha)
    else:
        raise ValueError(f"BLP: unknown encoding {encoding}/{alpha_enc}")
    return _stream_image(stream, w, h, alpha)


def _jpeg(data, pos, offsets, lengths, w, h) -> np.ndarray:
    from fluctus_tpu_torch.scene import jpeg
    (size,) = struct.unpack_from("<I", data, pos)
    pos += 4
    header = data[pos:pos + size]
    pos = max(pos + size, offsets[0])
    body = data[pos:pos + lengths[0]]
    if len(header) < size or len(body) < lengths[0]:
        raise ValueError("BLP: truncated file read")
    rgb = jpeg.decode_jpeg(header + body)[..., 2::-1].tobytes()  # as BGR
    if len(rgb) < w * h * 3:
        raise ValueError("BLP: not enough image data")
    px = np.frombuffer(rgb[:w * h * 3], np.uint8).reshape(h, w, 3)
    return to_rgba("RGB", px)        # alpha or not, A is 255
