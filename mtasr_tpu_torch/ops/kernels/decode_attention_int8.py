"""One-token attention over the int8 KV cache (counterpart of
`mtasr_tpu/ops/pallas/decode_attention.py::decode_attention_int8`).

`decode_attention_int8` launches the CUDA kernel of
`csrc/decode_attention_int8.cu` for CUDA tensors and takes
`decode_attention_int8_plain` for CPU tensors. The kernel replaces the TPU
kernel `decode_attention_int8` (`decode_attention.py:354`, body
`_kernel_int8` at `:244-328`). The TPU kernel expanded q block-diagonally
over all heads to feed its matrix unit one dot; every int8 product
accumulates exactly in int32, so the per-head form computes the same
function. Like the bf16 decode kernel, it splits each (batch row, kv head)
over a thread-block cluster of `cluster_size_int8` blocks; the head of the
`.cu` file says what bounds it on the H100 and how the design answers
that. `int8_cache_attention` is the function in plain PyTorch.
"""
from __future__ import annotations

import torch

from mtasr_tpu_torch.ops.kernels import _build
from mtasr_tpu_torch.ops.kernels import decode_attention as _da
from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as _chunk
from mtasr_tpu_torch.ops.kernels.decode_attention_chunk import (
    int8_cache_attention,
)

_ARGS = [_build.P] * 7 + [_build.I] * 6 + [_build.F, _build.P]
SLOT_BYTES = 8192         # int8 bytes of a ring slot (`kSlotBytes`)
# scores a block keeps in shared memory (`kScoreFloats` of the .cu file); a
# longer slice keeps them in a global scratch the wrapper allocates
SCORE_FLOATS = 24576


def cluster_size_int8(B: int, Hkv: int, S: int, sms: int = 132,
                      D: int = 64) -> int:
    """The blocks one (batch row, kv head) is split over, one cluster:
    `decode_attention.cluster_size`'s rule with the int8 kernel's ring tile
    (the groups of 4 key rows, padded to 16 bytes, that fit 8 KB: 128 keys
    at D = 64)."""
    return _da.cluster_size(B, Hkv, S, sms, D,
                            tile=SLOT_BYTES // (-(-D // 16) * 16) // 4 * 4)


def build():
    """The kernel's library, built from csrc/decode_attention_int8.cu."""
    return _build.load("decode_attention_int8",
                       "decode_attention_int8_launch", _ARGS)


def decode_attention_int8_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, kv_scale: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch."""
    out, _ = int8_cache_attention(q[:, None], k_cache, v_cache, kv_scale,
                                  mask[:, None])
    return out[:, 0].to(q.dtype)


def decode_attention_int8(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_scale: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D] (RoPE applied); k_cache/v_cache [B, S, Hkv*D] int8 with
    this step's K/V written; kv_scale [B, 2*Hkv, S] bf16, interleaved rows;
    mask [B, S] bool, True where a slot is attendable. Returns [B, Hq, D]
    in q's dtype.

    On CUDA: q and kv_scale bf16, all contiguous and 16-byte aligned;
    Hq / Hkv in [1, 8]; D a multiple of 4 up to 256."""
    if q.dim() != 3:
        raise ValueError("decode_attention_int8: q [B, Hq, D] expected")
    dims = _chunk.check_cache_inputs("decode_attention_int8", q, k_cache,
                                     v_cache, kv_scale, mask)
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_cache, v_cache, kv_scale,
                                           mask)
    _chunk.check_launch_inputs("decode_attention_int8", True, q, k_cache,
                               v_cache, kv_scale, mask, dims)
    B, S, Hq, Hkv, D = dims
    C = cluster_size_int8(B, Hkv, S, _da.sm_count(q.device), D)
    G = Hq // Hkv
    scratch = (torch.empty((B, Hkv, G, S), dtype=torch.float32,
                           device=q.device)
               if G * -(-S // C) > SCORE_FLOATS else None)
    out = torch.empty_like(q)
    lib = build()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_int8_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_scale.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, S, Hq, Hkv,
            D, C, float(D ** -0.5), _build.stream_of(q))
    _build.check(lib, code, "decode_attention_int8")
    decode_attention_int8.launches += 1
    decode_attention_int8.last_cluster = C
    return out


decode_attention_int8.launches = 0
decode_attention_int8.last_cluster = None   # the C of the last launch
