"""One-token attention over the int8 KV cache (counterpart of
`mtasr_tpu/ops/pallas/decode_attention.py::decode_attention_int8`).

`decode_attention_int8` launches the CUDA kernel of
`csrc/decode_attention_chunk.cu` at chunk length 1 for CUDA tensors and
takes `decode_attention_int8_plain` for CPU tensors. The kernel replaces
the TPU kernel `decode_attention_int8` (`decode_attention.py:354`, body
`_kernel_int8` at `:244-328`). The TPU kernel expanded q block-diagonally
over all heads to feed its matrix unit one dot; every int8 product
accumulates exactly in int32, so the per-head form of the chunk kernel
computes the same function. The head of that `.cu` file says what bounds
it on the H100 and how the design answers that; `int8_cache_attention` is
the function in plain PyTorch.
"""
from __future__ import annotations

import torch

from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as _chunk
from mtasr_tpu_torch.ops.kernels.decode_attention_chunk import (
    int8_cache_attention,
)


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

    On CUDA: q and kv_scale bf16, all contiguous; Hq / Hkv in [1, 8]; D a
    multiple of 4 up to 256."""
    if q.dim() != 3:
        raise ValueError("decode_attention_int8: q [B, Hq, D] expected")
    dims = _chunk.check_cache_inputs("decode_attention_int8", q, k_cache,
                                     v_cache, kv_scale, mask)
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_cache, v_cache, kv_scale,
                                           mask)
    out = _chunk.launch("decode_attention_int8", True, q, k_cache, v_cache,
                        kv_scale, mask, 1, dims)
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
