"""Build shared libraries from the package's C++ and CUDA sources at first use.

Outputs go to `fluctus_tpu_torch/build/` (listed in .gitignore), keyed by
a hash of the source, the headers it includes and the compiler command, so
a changed source, header or flag rebuilds. A failed compile raises with
the compiler's output.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    d = os.path.join(_PKG, "build")
    os.makedirs(d, exist_ok=True)
    return d


def build_shared(src: str, stem: str, cmd: list[str], deps=()):
    """Compile `src` with `cmd + [src, "-o", out]` unless a library built
    from the same source, headers `deps` and command exists. Returns
    (path, log, seconds); log and seconds are empty and 0 for a cached
    library."""
    h = hashlib.sha1(" ".join(cmd).encode())
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:12]
    out = os.path.join(build_dir(), f"lib{stem}_{tag}.so")
    if os.path.exists(out):
        return out, "", 0.0
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(cmd + [src, "-o", tmp], capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {os.path.basename(src)} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic, so concurrent builders never see a stub
    return out, proc.stdout + proc.stderr, secs
