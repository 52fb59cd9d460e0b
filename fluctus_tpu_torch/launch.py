"""The host side of every kernel launch of the port.

Every launcher in `csrc/` has the one C signature

    extern "C" int name(const long long* a, int n)

taking the launch's device pointers, sizes and flags, and last its CUDA
stream, as n 64-bit integers in the order its source lists them. It
launches on that stream and returns cudaGetLastError(), or -1 when n or
an argument is out of its range.

`load_library` builds a source with nvcc at first use (build.py), loads it
and resolves each launcher's address once. `launch` then calls a launcher
through `csrc/fastcall.cpp`, a CPython extension with one METH_FASTCALL
function and no torch headers, built with the host compiler: no ctypes
conversion per argument. Per launch a wrapper pays for its checks
(`check`), its outputs, one current-device read, one raw-stream read
(`torch._C._cuda_getCurrentRawStream`, no `torch.cuda.Stream` object) and
the call; it enters `torch.cuda.device` only when the tensors lie on
another device than the current one. A non-zero result raises.
`scripts/probe_launch_floor.py` times each of these steps.
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import sysconfig
import threading
import types

import torch

from fluctus_tpu_torch.build import build_shared

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]
_FASTCALL_SRC = os.path.join(CSRC, "fastcall.cpp")
_lock = threading.Lock()
_fastcall = None
_runtime = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def fastcall():
    """The extension's `call(address, *args)`, built (at first use) with the
    host compiler against this interpreter's headers."""
    global _fastcall
    with _lock:
        if _fastcall is None:
            inc = sysconfig.get_paths()["include"]
            header = os.path.join(inc, "Python.h")
            if not os.path.exists(header):
                raise RuntimeError(f"building fastcall needs {header}")
            path, _, _ = build_shared(
                _FASTCALL_SRC, "fastcall",
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{inc}"],
                deps=[header])
            spec = importlib.util.spec_from_file_location("fastcall", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _fastcall = mod.call
    return _fastcall


class Launcher:
    """One launcher of a loaded library: its name, the kernel it launches
    (for messages) and its address."""
    __slots__ = ("name", "kern", "addr")

    def __init__(self, cdll: ctypes.CDLL, name: str, kern: str):
        self.name = name
        self.kern = kern
        self.addr = ctypes.cast(getattr(cdll, name), ctypes.c_void_p).value


def load_library(src: str, stem: str, entries: dict, deps=(),
                 info: dict | None = None):
    """Build `src` with nvcc (NVCC_FLAGS) unless built, load it and
    resolve its launchers {name: kernel}. Returns a namespace of
    Launchers; `info` receives the build's path, log and seconds."""
    path, log, secs = build_shared(src, stem, [nvcc()] + NVCC_FLAGS,
                                   deps=deps)
    if info is not None:
        info.update(path=path, log=log, seconds=secs)
    fastcall()
    cdll = ctypes.CDLL(path)
    return types.SimpleNamespace(
        **{name: Launcher(cdll, name, kern) for name, kern in entries.items()})


def _resolve_runtime():
    global _runtime
    torch.cuda.init()
    _runtime = (fastcall(), torch._C._cuda_getDevice,
                torch._C._cuda_getCurrentRawStream)
    return _runtime


def call(entry: Launcher, device: int, *args) -> int:
    """Call `entry` with `args` and the current stream of CUDA device
    `device` (an index); returns its result."""
    fc, get_device, raw_stream = _runtime or _resolve_runtime()
    if device == get_device():
        return fc(entry.addr, *args, raw_stream(device))
    with torch.cuda.device(device):
        return fc(entry.addr, *args, raw_stream(device))


def launch(entry: Launcher, device: int, *args) -> None:
    """`call`, raising on a non-zero result."""
    fc, get_device, raw_stream = _runtime or _resolve_runtime()
    rc = (fc(entry.addr, *args, raw_stream(device))
          if device == get_device() else call(entry, device, *args))
    if rc:
        raise RuntimeError(
            f"{entry.kern} launch failed: "
            + (f"CUDA error {rc}" if rc > 0 else "arguments out of range")
            + f" ({entry.name})")


def check(kern: str, name: str, x: torch.Tensor, dtype: torch.dtype,
          shape: tuple) -> None:
    """Raise unless x is a contiguous CUDA tensor of `dtype` and `shape`."""
    if not (x.is_cuda and x.dtype is dtype and x.shape == shape
            and x.is_contiguous()):
        raise ValueError(
            f"{kern}: {name} must be a contiguous CUDA {dtype} tensor of "
            f"shape {tuple(shape)}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}" + ("" if x.is_contiguous() else ", not contiguous"))


def check_aligned(kern: str, name: str, x: torch.Tensor, n: int) -> None:
    """Raise unless x's data starts on an n-byte boundary (a kernel reads
    its rows with n-byte loads)."""
    if x.data_ptr() % n:
        raise ValueError(f"{kern}: {name} must start on a {n}-byte "
                         f"boundary for the kernel's vector loads")
