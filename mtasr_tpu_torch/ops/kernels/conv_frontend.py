"""WavLM conv layer 0 with its LayerNorm and gelu, fused
(counterpart of `mtasr_tpu/ops/pallas/conv_frontend.py::conv0_fused`).

`conv0_fused` launches the CUDA kernel of `csrc/conv_frontend.cu` for a
CUDA tensor and takes `conv0_plain` for a CPU tensor. The kernel replaces
the TPU kernel `_conv0_kernel_call` (`conv_frontend.py:172`, body
`_kernel` at `:95-116`). On the H100 it is bound by the bytes of its
output and the erf of every element; the source note in the .cu file says
how the design answers that. CUDA C++ rather than Triton: one build route
for all three kernels of the slice.

Unlike the TPU kernel, any S >= K is taken (no `supported()` gate, no
silent fallback) and gelu is exact (erf), as in the JAX golden
`_conv0_xla`.

When an input requires a gradient, `conv0_fused` runs `Conv0Function`: its
forward is the kernel, its backward autograd through `conv0_plain`, as the
JAX package's backward is the vjp of its XLA composition
(`conv_frontend.py:37-39`, `:191-218`). The training recipes freeze the
feature extractor, so that backward runs only when someone unfreezes it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mtasr_tpu_torch.ops.kernels import _build

_ARGS = [_build.P] * 6 + [_build.I] * 6 + [_build.F] + [_build.I] * 2 \
    + [_build.P]


def build():
    """The kernel's library, built from csrc/conv_frontend.cu if needed."""
    return _build.load("conv_frontend", "conv0_fused_launch", _ARGS)


def conv0_plain(wave: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                gamma: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None, *, stride: int,
                eps: float = 1e-5, fuse_ln: bool = True,
                fuse_act: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch, computed in float32:
    wave [B, S], weight [O, 1, K] -> [B, T_out, O] in the wave's dtype."""
    y = F.conv1d(wave[:, None, :].float(), weight.float(),
                 None if bias is None else bias.float(), stride=stride)
    y = y.transpose(1, 2)
    if fuse_ln:
        mu = y.mean(-1, keepdim=True)
        var = ((y - mu) ** 2).mean(-1, keepdim=True)
        y = (y - mu) * torch.rsqrt(var + eps)
        if gamma is not None:
            y = y * gamma.float()
        if beta is not None:
            y = y + beta.float()
    if fuse_act:
        y = F.gelu(y)
    return y.to(wave.dtype)


class Conv0Function(torch.autograd.Function):
    """The kernel forward; the backward is autograd through the plain
    version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, wave, weight, bias, gamma, beta, stride, eps, fuse_ln,
                fuse_act):
        ctx.save_for_backward(wave, weight, bias, gamma, beta)
        ctx.kw = dict(stride=stride, eps=eps, fuse_ln=fuse_ln,
                      fuse_act=fuse_act)
        return _conv0_kernel(wave, weight, bias, gamma, beta, **ctx.kw)

    @staticmethod
    def backward(ctx, dout):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        with torch.enable_grad():
            out = conv0_plain(*inputs, **ctx.kw)
            wrt = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, dout))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in inputs) + (None,) * 4


def conv0_fused(wave: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                gamma: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None, *, stride: int,
                eps: float = 1e-5, fuse_ln: bool = True,
                fuse_act: bool = True) -> torch.Tensor:
    """wave [B, S]; weight [O, 1, K]; bias/gamma/beta [O] or None.
    Returns [B, (S - K) // stride + 1, O] in the wave's dtype.

    On CUDA: wave bf16 and contiguous, O a power of two in [32, 1024]."""
    if wave.dim() != 2 or weight.dim() != 3 or weight.shape[1] != 1:
        raise ValueError(f"conv0_fused: wave [B, S] and weight [O, 1, K] "
                         f"expected, got {tuple(wave.shape)} and "
                         f"{tuple(weight.shape)}")
    B, S = wave.shape
    O, _, K = weight.shape
    if S < K:
        raise ValueError(f"conv0_fused: {S} samples < kernel {K}")
    for name, t in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        if t is not None and tuple(t.shape) != (O,):
            raise ValueError(f"conv0_fused: {name} must be [{O}]")
    if wave.device.type == "cpu":
        return conv0_plain(wave, weight, bias, gamma, beta, stride=stride,
                           eps=eps, fuse_ln=fuse_ln, fuse_act=fuse_act)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (wave, weight, bias, gamma, beta)):
        return Conv0Function.apply(wave, weight, bias, gamma, beta, stride,
                                   eps, fuse_ln, fuse_act)
    return _conv0_kernel(wave, weight, bias, gamma, beta, stride=stride,
                         eps=eps, fuse_ln=fuse_ln, fuse_act=fuse_act)


def _conv0_kernel(wave, weight, bias, gamma, beta, *, stride, eps, fuse_ln,
                  fuse_act):
    B, S = wave.shape
    O, _, K = weight.shape
    _build.require_cuda(wave, "conv0_fused")
    if wave.dtype != torch.bfloat16:
        raise TypeError(f"conv0_fused: wave must be bf16, got {wave.dtype}")
    if not wave.is_contiguous():
        raise ValueError("conv0_fused: wave must be contiguous")
    if O % 32 or O & (O - 1) or O > 1024:
        raise ValueError(f"conv0_fused: O={O} (a power of two in [32, 1024])")

    def f32(t, fill):
        if t is None:
            return torch.full((O,), fill, dtype=torch.float32,
                              device=wave.device)
        return t.to(device=wave.device, dtype=torch.float32).contiguous()

    w = weight.to(device=wave.device, dtype=torch.float32).reshape(O, K)
    w = w.contiguous()
    b, g, bt = f32(bias, 0.0), f32(gamma, 1.0), f32(beta, 0.0)
    T_out = (S - K) // stride + 1
    out = torch.empty((B, T_out, O), dtype=wave.dtype, device=wave.device)
    lib = build()
    with torch.cuda.device(wave.device):
        code = lib.conv0_fused_launch(
            wave.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(),
            bt.data_ptr(), out.data_ptr(), B, S, T_out, O, K, stride,
            float(eps), int(fuse_ln), int(fuse_act), _build.stream_of(wave))
    _build.check(lib, code, "conv0_fused")
    conv0_fused.launches += 1
    return out


conv0_fused.launches = 0
