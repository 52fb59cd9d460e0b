"""Encapsulated PostScript (EPS): what the JAX package's pool gives
depends on Ghostscript, and so does the port's.

PIL opens an EPS header by itself, but rasterises the page by running
Ghostscript at load. Where PIL finds no Ghostscript
(`EpsImagePlugin.has_ghostscript()` false: no "gs" on the path, or on
Windows none of "gswin32c", "gswin64c", "gs"), its load raises and the
JAX pool leaves the slot at -1, and so does the port. Where Ghostscript
exists, PIL would render the file and the port cannot, so it raises
UnsupportedImage naming EPS.
"""
from __future__ import annotations

import shutil
import sys

import numpy as np

from fluctus_tpu_torch.scene.imageformat import UnsupportedImage


def has_ghostscript() -> bool:
    """Whether PIL would find a Ghostscript binary on the path."""
    names = (("gswin32c", "gswin64c", "gs") if sys.platform.startswith("win")
             else ("gs",))
    return any(shutil.which(n) is not None for n in names)


def decode_eps(data: bytes) -> np.ndarray:
    """Raises: UnsupportedImage with Ghostscript, ValueError (the slot
    stays -1) without it."""
    if has_ghostscript():
        raise UnsupportedImage("EPS images are rendered by Ghostscript "
                               "under PIL and are not decoded by the port")
    raise ValueError("EPS: unable to locate Ghostscript")
