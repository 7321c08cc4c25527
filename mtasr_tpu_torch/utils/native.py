"""ctypes bindings for the port's host C++ (counterpart of
`mtasr_tpu/utils/native.py`): `native/audio_loader.cpp`, a batch WAV decoder
that downmixes and normalises each row in parallel threads, and
`native/wer_kernel.cpp`, the WER scorer's edit-distance alignment.

Each source under `mtasr_tpu_torch/native/` is compiled by `g++` at first
use into `native/build/` (git-ignored), under a name keyed by a hash of the
source and the flags, as `ops/kernels/_build.py` builds the CUDA libraries:
an edited source is rebuilt, and parallel processes agree through an atomic
rename. The flags are the JAX package's (`native/Makefile`), so the two
libraries give the same bits. These are host helpers: where the library
cannot be built every binding returns None (with one warning naming the
compiler's complaint), and each caller keeps its Python path, as the JAX
package does.

The functions, their arguments, results and status codes are the JAX
module's: `wav_header_native`, `wav_load_batch_native` (a row's status: 0
ok, 1 unreadable, 2 another sample rate: the caller resamples it in Python,
3 an encoding the loader does not decode), `wer_align_native`,
`wer_align_ops_native`, `wer_align_batch_native` and `cpwer_native`.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = NATIVE / "build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")
# library name -> (source, extra flags)
SOURCES = {"wer": ("wer_kernel.cpp", ()),
           "audio": ("audio_loader.cpp", ("-pthread",))}

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64, _i32 = ctypes.c_int64, ctypes.c_int32
# entry point -> (restype, argtypes)
_SIGNATURES = {
    "wer": {
        "wer_align": (_i64, [_i32p, _i64, _i32p, _i64, _i64p]),
        "wer_align_ops": (_i64, [_i32p, _i64, _i32p, _i64, _i64p, _u8p]),
        "wer_align_batch": (None, [_i32p, _i64p, _i32p, _i64p, _i64, _i64p]),
        "cpwer_best_perm": (None, [_i32p, _i64p, _i32p, _i64p, _i64, _i64p,
                                   _i64p, _i64p]),
    },
    "audio": {
        "wav_header": (ctypes.c_int, [ctypes.c_char_p, _i64p, _i32p, _i32p]),
        "wav_load": (_i64, [ctypes.c_char_p, _i32, _i32, _f32p, _i64,
                            _i32p]),
        "wav_load_batch": (None, [ctypes.c_char_p, _i64p, _i64, _i32, _i32,
                                  _f32p, _i64, _i64p, _i32p, _i32]),
    },
}

_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()
_log = logging.getLogger("mtasr_tpu_torch.native")


def library_path(name: str) -> Path:
    src, extra = SOURCES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + extra).encode())
    h.update((NATIVE / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """The library `name` ("wer" or "audio"), compiled if it is not built
    yet; raises RuntimeError with the compiler's output if it fails."""
    out = library_path(name)
    if out.exists():
        return out
    src, extra = SOURCES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *extra, "-o", str(tmp), str(NATIVE / src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {src}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {src}:\n{res.stdout}\n"
                           f"{res.stderr}")
    os.replace(tmp, out)      # atomic: parallel processes agree
    return out


def get_lib(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library `name` with every entry point's types declared,
    or None (after one warning) where it cannot be built or loaded."""
    if name in _libs:
        return _libs[name]
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            lib = ctypes.CDLL(str(build(name)))
            for entry, (res, args) in _SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = res, args
        except (RuntimeError, OSError) as e:
            _log.warning("native %s library unavailable, the Python path "
                         "runs instead: %s", name, e)
            lib = None
        _libs[name] = lib
        return lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def wav_header_native(path: str) -> Optional[Tuple[int, int, int]]:
    """(n_frames, sample_rate, channels) from the WAV header, or None (an
    unreadable file, or no library)."""
    lib = get_lib("audio")
    if lib is None:
        return None
    n, sr, ch = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    if lib.wav_header(path.encode(), ctypes.byref(n), ctypes.byref(sr),
                      ctypes.byref(ch)) != 0:
        return None
    return int(n.value), int(sr.value), int(ch.value)


def wav_load_batch_native(
    paths: Sequence[str], out: np.ndarray, target_sr: int,
    *, normalize: bool = True, n_threads: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode B WAV files in parallel into out [B, cap] float32 (row b gets
    lens[b] samples, the rest untouched). Returns (lens, status) or None
    without the library; status per row as in the module docstring."""
    lib = get_lib("audio")
    if lib is None:
        return None
    if out.dtype != np.float32 or out.ndim != 2 or \
            not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a C-contiguous float32 [B, cap] array")
    B, cap = out.shape
    if len(paths) != B:
        raise ValueError(f"{len(paths)} paths for {B} rows")
    encoded = [p.encode() for p in paths]
    off = np.zeros(B + 1, np.int64)
    off[1:] = np.cumsum([len(p) for p in encoded])
    lens = np.zeros(B, np.int64)
    status = np.zeros(B, np.int32)
    if n_threads <= 0:
        n_threads = min(B, os.cpu_count() or 1)
    lib.wav_load_batch(b"".join(encoded), _ptr(off, _i64p), B, target_sr,
                       1 if normalize else 0, _ptr(out, _f32p), cap,
                       _ptr(lens, _i64p), _ptr(status, _i32p), n_threads)
    return lens, status


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32))


def wer_align_native(lab_ids: Sequence[int],
                     rec_ids: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """(all, cor, sub, del, ins), or None without the library."""
    lib = get_lib("wer")
    if lib is None:
        return None
    lab, rec = _as_i32(lab_ids), _as_i32(rec_ids)
    counts = np.zeros(5, np.int64)
    lib.wer_align(_ptr(lab, _i32p), len(lab), _ptr(rec, _i32p), len(rec),
                  _ptr(counts, _i64p))
    return tuple(int(x) for x in counts)


def wer_align_ops_native(
        lab_ids: Sequence[int], rec_ids: Sequence[int]
) -> Optional[Tuple[Tuple[int, ...], np.ndarray]]:
    """The counts and the traceback, left to right (1 cor, 2 sub, 3 del,
    4 ins), from which the verbose alignment is rebuilt; or None."""
    lib = get_lib("wer")
    if lib is None:
        return None
    lab, rec = _as_i32(lab_ids), _as_i32(rec_ids)
    counts = np.zeros(5, np.int64)
    ops = np.zeros(len(lab) + len(rec), np.uint8)
    n_ops = lib.wer_align_ops(_ptr(lab, _i32p), len(lab), _ptr(rec, _i32p),
                              len(rec), _ptr(counts, _i64p),
                              _ptr(ops, _u8p))
    return tuple(int(x) for x in counts), ops[:int(n_ops)]


def _pack(seqs: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(seqs) + 1, np.int64)
    off[1:] = np.cumsum([len(s) for s in seqs])
    flat = np.zeros(int(off[-1]), np.int32)
    for i, s in enumerate(seqs):
        flat[off[i]:off[i + 1]] = np.asarray(s, np.int32)
    return flat, off


def wer_align_batch_native(lab_seqs: Sequence[Sequence[int]],
                           rec_seqs: Sequence[Sequence[int]]
                           ) -> Optional[np.ndarray]:
    """[P, 5] counts of P pairs, or None."""
    lib = get_lib("wer")
    if lib is None:
        return None
    if len(lab_seqs) != len(rec_seqs):
        raise ValueError("as many reference as hypothesis sequences")
    lab_flat, lab_off = _pack(lab_seqs)
    rec_flat, rec_off = _pack(rec_seqs)
    out = np.zeros((len(lab_seqs), 5), np.int64)
    lib.wer_align_batch(_ptr(lab_flat, _i32p), _ptr(lab_off, _i64p),
                        _ptr(rec_flat, _i32p), _ptr(rec_off, _i64p),
                        len(lab_seqs), _ptr(out, _i64p))
    return out


def cpwer_native(ref_seqs: Sequence[Sequence[int]],
                 hyp_seqs: Sequence[Sequence[int]]
                 ) -> Optional[Tuple[float, Tuple[int, ...]]]:
    """(WER %, the permutation) of the best assignment of hypothesis
    streams to reference streams (every one of the K! enumerated), the
    shorter list padded with empty streams; or None."""
    lib = get_lib("wer")
    if lib is None:
        return None
    K = max(len(ref_seqs), len(hyp_seqs))
    ref_flat, ref_off = _pack(list(ref_seqs) + [[]] * (K - len(ref_seqs)))
    hyp_flat, hyp_off = _pack(list(hyp_seqs) + [[]] * (K - len(hyp_seqs)))
    err, total = ctypes.c_int64(), ctypes.c_int64()
    perm = np.zeros(K, np.int64)
    lib.cpwer_best_perm(_ptr(ref_flat, _i32p), _ptr(ref_off, _i64p),
                        _ptr(hyp_flat, _i32p), _ptr(hyp_off, _i64p), K,
                        ctypes.byref(err), ctypes.byref(total),
                        _ptr(perm, _i64p))
    return 100.0 * err.value / max(total.value, 1), \
        tuple(int(p) for p in perm)
