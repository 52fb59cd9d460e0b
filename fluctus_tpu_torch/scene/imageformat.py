"""Image-file dispatch for texture import: the format is read from the
file's signature, as PIL identifies it, and the port's own decoders give
what PIL's `Image.open(...).convert("RGBA")` gives, which is what the JAX
package's TexturePool loads.

Decoded: PNG (scene/png.py), baseline and extended-sequential JPEG
(scene/jpeg.py), BMP (scene/bmp.py) and TGA (scene/tga.py, which has no
signature: a file none of the others claims is read as TGA when its header
is one). A well-formed file in another format PIL reads (GIF, TIFF,
PPM/PGM/PBM, WebP, progressive or arithmetic-coded JPEG, ...) raises
`UnsupportedImage`, so a map the JAX package would load is never dropped
without notice; a file whose data is damaged raises another error, which
the pool turns into -1 as the JAX package does.
"""
from __future__ import annotations

import numpy as np


class UnsupportedImage(ValueError):
    """A well-formed image in a format or variant the port does not
    decode."""


# signatures of formats PIL reads and the port does not decode
_UNPORTED = (
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
    (b"\x00\x00\x01\x00", "ICO"), (b"8BPS", "PSD"), (b"DDS ", "DDS"),
)


def sniff(data: bytes) -> str:
    """The image format of `data` by its signature: "png", "jpeg", "bmp"
    or "tga". Raises UnsupportedImage naming a format the port does not
    decode, and ValueError for bytes no decoder claims."""
    from fluctus_tpu_torch.scene import tga     # it imports this module
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:2] == b"BM":
        return "bmp"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise UnsupportedImage("WebP images are not decoded by the port")
    for sig, name in _UNPORTED:
        if data.startswith(sig):
            raise UnsupportedImage(f"{name} images are not decoded by the "
                                   "port")
    if len(data) > 2 and data[:1] == b"P" and data[1:2] in b"1234567" \
            and data[2:3].isspace():
        raise UnsupportedImage("PPM/PGM/PBM images are not decoded by the "
                               "port")
    if tga.accept(data):
        return "tga"
    raise ValueError("not an image format the port recognises")


def decode(data: bytes, kind: str) -> np.ndarray:
    """Image bytes of format `kind` -> (H, W, 4) uint8 RGBA, top row
    first. The decoders import this module, so they are imported here."""
    if kind == "png":
        from fluctus_tpu_torch.scene.png import decode_png
        return decode_png(data)
    if kind == "jpeg":
        from fluctus_tpu_torch.scene.jpeg import decode_jpeg
        return decode_jpeg(data)
    if kind == "bmp":
        from fluctus_tpu_torch.scene.bmp import decode_bmp
        return decode_bmp(data)
    from fluctus_tpu_torch.scene.tga import decode_tga
    return decode_tga(data)
