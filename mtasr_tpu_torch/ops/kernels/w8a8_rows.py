"""The w8a8 linear's activation path around its int8 GEMM
(`models/layers.py::linear` on a `QuantLinear` of mode "w8a8"): each row of
x quantized to int8 with its scale, and the int32 product rescaled to x's
dtype, two launches of `csrc/w8a8_rows.cu`. They replace no TPU kernel:
the JAX package (`mtasr_tpu/models/layers.py:43-69`) leaves these
elementwise passes to XLA, which fuses them; run as PyTorch operations
they were 13 kernels a linear, each writing an f32 or int32 copy of the
activation.

`w8a8_quantize` and `w8a8_rescale` launch the kernels for CUDA tensors and
take `w8a8_quantize_plain` / `w8a8_rescale_plain` (the lines `linear` ran
before the kernels, unchanged) for CPU tensors. The kernels compute the
plain versions' function bit for bit; the .cu file's note says how, what
bounds them on the H100 and how the design answers it. The launch plans
(`quantize_plan`, `rescale_plan`) are pure functions of the shapes."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mtasr_tpu_torch.ops.int8 import INV127
from mtasr_tpu_torch.ops.kernels import _build
from mtasr_tpu_torch.ops.kernels.decode_attention import sm_count

_ARGS = [_build.I] + [_build.P] * 5 + [_build.I] * 7 + [_build.P]
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
QUANT_UNIT = 16        # elements a quantize unit (16-byte loads, `Unit`)
REGISTER_BYTES = 128   # x a thread keeps in registers (`kResident`)
SCALAR_RESIDENT = 16   # units of one element a thread keeps (`kResident`)
MAX_THREADS = 1024
RESCALE_UNIT = 8       # columns a rescale thread (16-byte accesses)
RESCALE_THREADS = 128
THREADS_PER_SM = 2048  # the H100's resident threads and blocks an SM
BLOCKS_PER_SM = 32


def build():
    """The library of both kernels, built from csrc/w8a8_rows.cu if
    needed."""
    return _build.load("w8a8_rows", "w8a8_rows_launch", _ARGS)


class QuantizePlan(NamedTuple):
    unit: int       # 16 (16-byte accesses) or 1
    threads: int    # a block, which takes one row at a time
    blocks: int     # the grid, striding over the rows


class RescalePlan(NamedTuple):
    unit: int       # 8 (16-byte accesses) or 1
    grid_x: int     # column tiles of RESCALE_THREADS * unit
    grid_y: int     # row groups, striding over the rows


def quantize_plan(M: int, K: int, itemsize: int, aligned: bool,
                  sms: int = 132) -> QuantizePlan:
    """Units of 16 where a row is whole 16-byte words (else 1 element);
    the fewest warps whose registers hold the row (at most 1024 threads:
    past that a thread reads its further units twice); as many blocks as
    the card keeps resident, at most one a row."""
    unit = QUANT_UNIT if aligned and K % QUANT_UNIT == 0 else 1
    resident = REGISTER_BYTES // (QUANT_UNIT * itemsize) \
        if unit == QUANT_UNIT else SCALAR_RESIDENT
    per_thread = -(-(K // unit) // resident)
    threads = min(MAX_THREADS, max(32, -(-per_thread // 32) * 32))
    blocks = min(M, sms * min(BLOCKS_PER_SM, THREADS_PER_SM // threads))
    return QuantizePlan(unit, threads, max(1, blocks))


def rescale_plan(M: int, N: int, aligned: bool,
                 sms: int = 132) -> RescalePlan:
    """8 columns a thread where a row is whole 16-byte words (else 1);
    enough row groups that the grid fills the card's resident threads, at
    most one a row."""
    unit = RESCALE_UNIT if aligned and N % RESCALE_UNIT == 0 else 1
    grid_x = -(-N // (RESCALE_THREADS * unit))
    full = sms * THREADS_PER_SM // RESCALE_THREADS
    return RescalePlan(unit, grid_x,
                       max(1, min(M, 65535, -(-full // grid_x))))


def w8a8_quantize_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch."""
    xf = x.float()
    sx = (xf.abs().amax(-1, keepdim=True) * INV127).clamp_min(1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def w8a8_rescale_plain(acc: torch.Tensor, sx: torch.Tensor,
                       scale: torch.Tensor, bias: Optional[torch.Tensor],
                       dtype: torch.dtype) -> torch.Tensor:
    """The same function in plain PyTorch."""
    y = (acc.float() * sx * scale).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _check(what: str, *tensors) -> None:
    """Contiguous, and on the first tensor's device; on CUDA, no
    gradient."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{what}: every input must be contiguous on "
                             f"{dev}")
    if dev.type == "cpu":
        return
    _build.require_cuda(tensors[0], what)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{what}: the kernel has no backward "
                                  "(serving only)")


def w8a8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] -> (q int8 [M, K], sx f32 [M, 1]): sx = max(max|row| *
    f32(1/127), 1e-12), q = clamp(round_half_even(x / sx), -127, 127).
    x bf16 or float32, contiguous, K >= 1 (on either device); on CUDA no
    gradient."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"w8a8_quantize: x {tuple(x.shape)} is not [M, K] "
                         "with K >= 1")
    if x.dtype not in _DTYPES:
        raise TypeError(f"w8a8_quantize: x is {x.dtype}, not bf16 or "
                        "float32")
    _check("w8a8_quantize", x)
    if x.device.type == "cpu":
        return w8a8_quantize_plain(x)
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    plan = quantize_plan(M, K, x.element_size(), _aligned(x, q),
                         sm_count(x.device))
    lib = build()
    with torch.cuda.device(x.device):
        code = lib.w8a8_rows_launch(
            0, x.data_ptr(), sx.data_ptr(), None, None, q.data_ptr(), M, K,
            _DTYPES[x.dtype], plan.unit, plan.threads, plan.blocks, 1,
            _build.stream_of(x))
    _build.check(lib, code, "w8a8_quantize")
    w8a8_quantize.launches += 1
    return q, sx


def w8a8_rescale(acc: torch.Tensor, sx: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """acc int32 [M, N] (the product of `w8a8_quantize`'s q with the int8
    weight), sx f32 [M, 1], the weight's scale f32 [N] and an optional
    bias [N] -> y [M, N] in `dtype` (bf16 or float32): (f32(acc) * sx) *
    scale rounded to `dtype`, then bias (cast to `dtype`) added in f32 and
    rounded again. Every input contiguous (on either device); on CUDA no
    gradient."""
    if acc.dim() != 2:
        raise ValueError(f"w8a8_rescale: acc {tuple(acc.shape)} is not "
                         "[M, N]")
    M, N = acc.shape
    if acc.dtype != torch.int32 or sx.dtype != torch.float32 or \
            scale.dtype != torch.float32 or dtype not in _DTYPES:
        raise TypeError("w8a8_rescale: acc must be int32, sx and scale "
                        f"float32, the result bf16 or float32 (not {dtype})")
    if sx.shape != (M, 1) or scale.shape != (N,) or \
            (bias is not None and bias.shape != (N,)):
        raise ValueError(f"w8a8_rescale: sx {tuple(sx.shape)}, scale "
                         f"{tuple(scale.shape)} and bias are not [{M}, 1], "
                         f"[{N}], [{N}]")
    _check("w8a8_rescale", acc, sx, scale, bias)
    if acc.device.type == "cpu":
        return w8a8_rescale_plain(acc, sx, scale, bias, dtype)
    if bias is not None:
        bias = bias.to(dtype)
    y = torch.empty((M, N), dtype=dtype, device=acc.device)
    plan = rescale_plan(M, N, _aligned(acc, scale, bias, y),
                        sm_count(acc.device))
    lib = build()
    with torch.cuda.device(acc.device):
        code = lib.w8a8_rows_launch(
            1, acc.data_ptr(), sx.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), M, N,
            _DTYPES[dtype], plan.unit, RESCALE_THREADS, plan.grid_x,
            plan.grid_y, _build.stream_of(acc))
    _build.check(lib, code, "w8a8_rescale")
    w8a8_rescale.launches += 1
    return y


w8a8_quantize.launches = 0
w8a8_rescale.launches = 0
