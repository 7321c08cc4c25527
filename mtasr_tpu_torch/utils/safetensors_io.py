"""The safetensors file format, read and written by the port itself
(counterpart of `mtasr_tpu/utils/torch_interop.py:99-125`, which uses the
`safetensors` package; the GPU machine has none).

A file is an 8-byte little-endian header length N, N bytes of JSON header
({name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}, padded with spaces to a multiple of 8), then the tensors' raw
little-endian bytes, offsets counted from the end of the header. Written
files carry `__metadata__ {"format": "pt"}`, which HF `from_pretrained`
asks for, and lay the tensors out largest element first so each one is
aligned to its element size, as the `safetensors` package does.

`SafetensorsFile` reads one tensor at a time from a memory map: a tensor is
a CPU view of the mapped file (`torch.frombuffer`, no copy) until the
caller copies it, so a 3 GB model directory is never held twice on the
host. bf16 is read by its header name ("BF16"): numpy has no bf16.

`convert_state_dict` is `convert_torch_state_dict`'s fix-up of an HF
state dict: the positional conv's weight norm fused (serving) or kept as
`weight_g` / `weight_v` (training), and `gru_rel_pos_const` [1, H, 1, 1]
flattened to [H].
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, Iterator, Mapping, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _as_tensor(value) -> torch.Tensor:
    """A CPU tensor over `value`'s data: a torch tensor (moved to the host
    if it lives on a device) or a numpy array (ml_dtypes' bf16 included,
    as the JAX package hands it out)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    a = np.ascontiguousarray(value)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _raw_bytes(t: torch.Tensor) -> memoryview:
    return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def save_file(tensors: Mapping[str, object], path: str) -> int:
    """Write `tensors` (name -> torch tensor or numpy array, on any device:
    each is brought to the host on its own) to `path` with metadata
    {"format": "pt"}; returns the bytes written."""
    metas = []
    for name, value in tensors.items():
        if isinstance(value, torch.Tensor):
            dtype, shape = value.dtype, tuple(value.shape)
        else:
            dtype = _as_tensor(np.empty(0, np.asarray(value).dtype)).dtype
            shape = tuple(np.shape(value))
        if dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {dtype} has no safetensors name")
        metas.append((name, dtype, shape))
    # largest element first (then by name): every offset stays aligned
    metas.sort(key=lambda m: (-m[1].itemsize, m[0]))
    header: Dict[str, object] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, dtype, shape in metas:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        header[name] = {"dtype": _NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name, _, _ in metas:
            f.write(_raw_bytes(_as_tensor(tensors[name])))
    return 8 + len(text) + offset


class SafetensorsFile:
    """One safetensors file, memory-mapped: `keys()`, `metadata` and
    `get(name)`, a CPU tensor viewing the map (copy it, e.g. with
    `.to(device)`, before writing to it)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
            # a private (copy-on-write) map: torch wants a writable buffer,
            # and nothing is copied unless written
            self._map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                         if size else b"")
        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self._entries: Dict[str, dict] = header
        self._base = 8 + n
        for name, e in header.items():
            if e["dtype"] not in _DTYPES:
                raise TypeError(f"{path}: {name} has dtype {e['dtype']}, "
                                "which the port does not read")
            begin, end = e["data_offsets"]
            want = int(np.prod(e["shape"], dtype=np.int64)) * \
                _DTYPES[e["dtype"]].itemsize
            if end - begin != want or self._base + end > size:
                raise ValueError(f"{path}: {name} has a malformed entry")

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype = _DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        shape = tuple(e["shape"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        offset = self._base + begin
        if offset % dtype.itemsize:      # unaligned: copy the bytes
            raw = torch.frombuffer(self._map, dtype=torch.uint8,
                                   count=end - begin, offset=offset).clone()
            return raw.view(dtype).reshape(shape)
        return torch.frombuffer(self._map, dtype=dtype,
                                count=(end - begin) // dtype.itemsize,
                                offset=offset).reshape(shape)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of `path`, as memory-mapped CPU views."""
    f = SafetensorsFile(path)
    return {name: f.get(name) for name in f.keys()}


def dir_files(path: str) -> list:
    """The `*.safetensors` files of a model directory, sorted; raises if
    there is none."""
    files = sorted(fn for fn in os.listdir(path)
                   if fn.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors in {path}")
    return [os.path.join(path, fn) for fn in files]


def iter_dir(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, memory-mapped CPU tensor) of every tensor of every
    `*.safetensors` file of a directory, one at a time."""
    for fn in dir_files(path):
        f = SafetensorsFile(fn)
        for name in f.keys():
            yield name, f.get(name)


# ---------------------------------------------------------------------------
# HF state-dict fix-ups (convert_torch_state_dict)
# ---------------------------------------------------------------------------
_PARAM_G = "parametrizations.weight.original0"
_PARAM_V = "parametrizations.weight.original1"


def _fuse(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch weight_norm with dim=2, g * v / max(||v||, 1e-12) with the norm
    over (out, in) per kernel position, in numpy in v's precision as the
    JAX package computes it (float32 for a bf16 or f16 v)."""
    work = v.dtype if v.dtype in (torch.float32, torch.float64) \
        else torch.float32
    nv, ng = v.to(work).numpy(), g.to(work).numpy()
    norm = np.sqrt((nv ** 2).sum(axis=(0, 1), keepdims=True))
    return torch.from_numpy(ng * nv / np.maximum(norm, 1e-12)).to(v.dtype)


def convert_state_dict(flat: Mapping[str, torch.Tensor],
                       fuse_weight_norm: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """An HF state dict's names and shapes as the port's parameters take
    them: `parametrizations.weight.original0/1` (or `weight_g` /
    `weight_v`) fused into `weight`, or with `fuse_weight_norm=False` kept
    as `weight_g` / `weight_v`; `gru_rel_pos_const` flattened to [H]."""
    out: Dict[str, torch.Tensor] = {}
    pairs: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        for suffix, slot in ((_PARAM_G, "g"), (_PARAM_V, "v"),
                             ("weight_g", "g"), ("weight_v", "v")):
            if key.endswith("." + suffix):
                pairs.setdefault(key[:-len(suffix) - 1], {})[slot] = value
                break
        else:
            if key.endswith("gru_rel_pos_const"):
                value = value.reshape(-1)
            out[key] = value
    for base, gv in pairs.items():
        if fuse_weight_norm:
            out[base + ".weight"] = _fuse(gv["g"].cpu(), gv["v"].cpu())
        else:
            out[base + ".weight_g"] = gv["g"]
            out[base + ".weight_v"] = gv["v"]
    return out
