"""Texture import and atlas packing (counterpart of
`fluctus_tpu/scene/textures.py`; reference: src/texture.cpp:16-41,
src/scene.cpp:304-320, src/clcontext.cpp:570-611).

Images are decoded by the port's own readers (scene/imageformat.py picks
one by the file's signature, as PIL identifies it), which give what the
JAX package's PIL `convert("RGBA")` gives. As there, a missing file, one
no PIL plugin identifies, or one whose data is damaged leaves the slot at
-1. A well-formed file in a format the port does not decode raises, so no
map the JAX package would load is dropped without notice.
"""
from __future__ import annotations

import importlib
import lzma
import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from fluctus_tpu_torch.scene import imageformat


@dataclass
class HostTexture:
    name: str
    rgba: np.ndarray  # (H, W, 4) uint8, bottom row first


@dataclass
class TexturePool:
    textures: list = field(default_factory=list)
    _by_name: dict = field(default_factory=dict)

    def try_import(self, path: str, name: str) -> int:
        """Load-or-reuse by name; -1 when the file is missing, is in no
        format PIL identifies, or is damaged (reference:
        src/scene.cpp:304-320 tryImportTexture). Raises UnsupportedImage
        for a format the port does not decode."""
        if not name:
            return -1
        if name in self._by_name:
            return self._by_name[name]
        if not os.path.exists(path):
            return -1
        with open(path, "rb") as f:
            data = f.read()
        try:
            kind = imageformat.sniff(data)
        except imageformat.UnsupportedImage as e:
            raise imageformat.UnsupportedImage(f"{path}: {e}") from None
        if kind is None:
            return -1
        # native decoders: a failed build raises, never -1 (the codecs
        # inside TIFF and ICNS build where they are first called)
        if kind in ("jpeg", "webp", "jpeg2000", "avif"):
            importlib.import_module(
                f"fluctus_tpu_torch.scene.{kind}").load_library()
        try:
            rgba = imageformat.decode(data, kind)
        except imageformat.UnsupportedImage as e:
            raise imageformat.UnsupportedImage(f"{path}: {e}") from None
        except (ValueError, IndexError, EOFError, struct.error, zlib.error,
                lzma.LZMAError):
            return -1                 # damaged or truncated, as PIL fails
        # uv (0, 0) is the bottom-left texel (the reference loads with
        # IL_ORIGIN_LOWER_LEFT), so flip the top-first rows
        rgba = np.ascontiguousarray(rgba[::-1])
        idx = len(self.textures)
        self.textures.append(HostTexture(name=name, rgba=rgba))
        self._by_name[name] = idx
        return idx

    def pack(self):
        """-> (data (total,) u8, offsets, widths, heights); a 1-byte
        placeholder when there are no textures."""
        if not self.textures:
            return (np.zeros(1, np.uint8), np.zeros(1, np.int64),
                    np.ones(1, np.int64), np.ones(1, np.int64))
        blobs, offs, ws, hs = [], [], [], []
        off = 0
        for t in self.textures:
            h, w = t.rgba.shape[:2]
            flat = t.rgba.reshape(-1)
            blobs.append(flat)
            offs.append(off)
            ws.append(w)
            hs.append(h)
            off += flat.size
        return (np.concatenate(blobs), np.asarray(offs, np.int64),
                np.asarray(ws, np.int64), np.asarray(hs, np.int64))
