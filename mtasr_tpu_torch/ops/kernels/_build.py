"""Build the CUDA kernels of `mtasr_tpu_torch/csrc/` at first use and load
them with ctypes.

Each `csrc/<name>.cu` is compiled on its own by `nvcc` for `sm_90a` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library lands in `csrc/build/` (git-ignored) under a
name keyed by a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as is. Only the repository's own
sources are compiled.

Every C entry point takes its pointers and the stream as `void*` and
returns `cudaGetLastError()`; `check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()                      # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}   # one build at a time per name
build_seconds: Dict[str, float] = {}   # name -> nvcc wall time, this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of mtasr_tpu_torch "
                       "are built from source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str, entry: str, argtypes) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu` (compiled if needed), with
    `entry`'s argument types declared (every pointer and the stream as
    c_void_p, so ctypes never cuts one to 32 bits). Libraries of different
    names build concurrently when called from several threads."""
    lib = _libs.get(name)
    if lib is not None:     # the launch path: no lock once loaded
        return lib
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)   # atomic: parallel processes agree
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.mtasr_error_string.argtypes = [ctypes.c_int]
        lib.mtasr_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error: a refused launch never runs,
    and a later synchronize would not report it."""
    if code != 0:
        msg = lib.mtasr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")
