"""Plain NN primitives (counterpart of `mtasr_tpu/models/layers.py`).

Parameters live in standard `nn.Linear` / `nn.Conv1d` / `nn.Embedding` /
`nn.LayerNorm` containers, whose weights are already in the torch layouts
the JAX tree keeps (Linear [out, in], Conv1d [out, in/groups, k]); these
functions compute with them the way the JAX package does: weights cast to
the activation dtype, normalisations reduced in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mtasr_tpu_torch.ops.kernels.w8a8_rows import w8a8_quantize, w8a8_rescale
from mtasr_tpu_torch.parallel.collectives import reduce_from_tp
from mtasr_tpu_torch.utils import profiling


class QuantLinear(nn.Module):
    """An int8 linear for serving (`utils/quantize.py`): `weight_q8a8`
    (int8 activations at run time too) or `weight_q8` (weight only), int8
    [out, in], with the per-output-row `scale` (f32 [out]) and, if the
    linear had one, its `bias`: the JAX tree's keys, held as buffers."""

    def __init__(self, in_features: int, out_features: int, mode: str,
                 bias_dtype=None, device=None):
        super().__init__()
        if mode not in ("w8", "w8a8"):
            raise ValueError(f"quantize mode {mode!r} not in w8 / w8a8")
        self.mode = mode
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer(self.weight_key, torch.empty(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(
            out_features, dtype=torch.float32, device=device))
        if bias_dtype is None:
            self.bias = None
        else:
            self.register_buffer("bias", torch.empty(
                out_features, dtype=bias_dtype, device=device))

    @property
    def weight_key(self) -> str:
        return "weight_q8a8" if self.mode == "w8a8" else "weight_q8"

    @property
    def weight_int8(self) -> torch.Tensor:
        return getattr(self, self.weight_key)


class RMSNorm(nn.Module):
    """An RMSNorm's scale (`ops/norms.py::rms_norm` computes with it)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [N, K]^T int8 -> [M, N] int32, exact. On CUDA,
    cuBLASLt through `torch._int_mm`, which refuses M <= 16: such an
    activation is padded with zero rows to 32 (zero rows quantize to zero
    and are sliced off). The weight goes in as the transposed view of its
    contiguous [out, in] buffer, the layout cuBLASLt's int8 path takes."""
    M = xq.shape[0]
    if xq.device.type == "cuda" and M <= 16:
        xq = F.pad(xq, (0, 0, 0, 32 - M))
    return torch._int_mm(xq, wq.t())[:M]


def linear(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """y = x W^T + b, with W cast to x's dtype; a `QuantLinear` computes as
    `mtasr_tpu/models/layers.py:43-69` does: w8a8 quantizes each row of x
    (scale max|x| / 127, at least 1e-12), multiplies int8 x int8 into
    int32 and rescales in f32 (`ops/kernels/w8a8_rows.py`: two kernels on
    a card, their plain versions on the CPU; the program's counters
    `mtasr.int8.w8a8_linears` and `.w8a8_kernels` count the calls and
    those that ran the kernels); w8 dequantizes the weight into x's
    dtype."""
    if isinstance(m, QuantLinear):
        if m.mode == "w8a8":
            xq, sx = w8a8_quantize(x.reshape(-1, x.shape[-1]).contiguous())
            acc = _int8_matmul(xq, m.weight_int8)
            y = w8a8_rescale(acc, sx, m.scale, m.bias, x.dtype)
            profiling.count("mtasr.int8.w8a8_linears")
            if xq.is_cuda:     # the two kernels ran (else the plain lines)
                profiling.count("mtasr.int8.w8a8_kernels")
            return y.reshape(*x.shape[:-1], m.out_features)
        w = m.weight_int8.to(x.dtype) * m.scale.to(x.dtype)[:, None]
        y = F.linear(x, w)
        return y if m.bias is None else y + m.bias.to(x.dtype)
    b = m.bias.to(x.dtype) if m.bias is not None else None
    return F.linear(x, m.weight.to(x.dtype), b)


def row_linear(m: nn.Module, x: torch.Tensor, tp,
               partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A row-parallel linear: this rank's partial product (plus `partial`,
    float32), summed over the tp group in float32, then the bias, rounded
    once to x's dtype. `linear` itself without a group (`tp` None)."""
    if tp is None:
        y = linear(m, x)
        return y if partial is None else y + partial.to(y.dtype)
    y = F.linear(x, m.weight.to(x.dtype)).float()
    if partial is not None:
        y = y + partial
    y = reduce_from_tp(y, tp)
    if m.bias is not None:
        y = y + m.bias.float()
    return y.to(x.dtype)


def embed(m: nn.Embedding, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows of the table. Out-of-range ids are clipped into the table, as
    the JAX package does (torch would raise where `jnp.take` read NaN)."""
    w = m.weight if dtype is None else m.weight.to(dtype)
    return w[ids.clamp(0, w.shape[0] - 1)]


def layer_norm(m: nn.LayerNorm, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in float32 (`layers.py:88-94`), cast back."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * m.weight.float() + m.bias.float()
    return y.to(x.dtype)


def group_norm(m: nn.LayerNorm, x_bct: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """torch GroupNorm semantics on [B, C, T], computed in float32; the
    affine parameters sit in a LayerNorm-shaped container (HF's key
    name is `layer_norm` for both)."""
    B, C, T = x_bct.shape
    xf = x_bct.float().reshape(B, num_groups, C // num_groups, T)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, T)
    y = y * m.weight.float()[None, :, None] + m.bias.float()[None, :, None]
    return y.to(x_bct.dtype)


def conv1d(m: nn.Module, x_btc: torch.Tensor, stride: int = 1,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """Conv over time on [B, T, C] -> [B, T', C_out] (`m.weight` may be a
    composed weight: `wavlm.WeightNormConv1d`)."""
    b = m.bias.to(x_btc.dtype) if m.bias is not None else None
    y = F.conv1d(x_btc.transpose(1, 2), m.weight.to(x_btc.dtype), b,
                 stride=stride, padding=padding, groups=groups)
    return y.transpose(1, 2)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool = False) -> torch.Tensor:
    """Inverted dropout (`mtasr_tpu/models/layers.py:275-280`): keep each
    element with probability 1 - rate, from `generator` (on x's device),
    and scale the kept ones by 1 / (1 - rate) in x's dtype. The identity
    when deterministic, at rate 0, or without a generator."""
    if deterministic or rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


def remat_layer(fn, generator: Optional[torch.Generator], *args):
    """fn(*args) under `torch.utils.checkpoint`: its activations are
    recomputed in backward. The recomputation replays the dropout masks:
    the generator's state is taken here and restored when fn runs again
    (checkpoint replays only the default generators by itself). After the
    backward the generator is left where the first layer's replay ended;
    the trainer gives every step a fresh generator."""
    state = None if generator is None else generator.get_state()

    def run(*a):
        if state is not None:
            generator.set_state(state)
        return fn(*a)
    return checkpoint(run, *args, use_reentrant=False)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, torch nn.GELU's default."""
    return F.gelu(x)


# The JAX package's odd polynomial for erf on [-3.9, 3.9]
# (`mtasr_tpu/models/layers.py:222-232`), the coefficients of x * P(x^2)
# from the lowest power up; f32 max abs error 3.4e-4.
_ERF_POLY = (1.126774549484253, -0.3686739504337311, 0.10251989960670471,
             -0.020142648369073868, 0.0027008887846022844,
             -0.00023893950856290758, 1.3233010577096138e-05,
             -4.136108486818557e-07, 5.55044232797286e-09)


def erf_approx(x: torch.Tensor) -> torch.Tensor:
    """erf by the polynomial, f32 Horner in the JAX package's order
    (`layers.py:235-242`): the argument clamped to [-3.9, 3.9]."""
    u = x.clamp(-3.9, 3.9)
    u2 = u * u
    p = torch.full_like(u, _ERF_POLY[-1])
    for c in _ERF_POLY[-2::-1]:
        p = p * u2 + c
    return u * p


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """gelu's exact form on the polynomial erf, computed in float32 and
    rounded once to x's dtype (`layers.py:245-250`)."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + erf_approx(xf * 2.0 ** -0.5))
    return y.to(x.dtype)


# WavLM's activations by config name (`hidden_act`,
# `feat_extract_activation`), the JAX package's table (`layers.py:253-260`)
ACT = {
    "gelu": gelu,
    "gelu_fast": fast_gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def resolve_act(name: str, impl: str = "auto"):
    """The activation `name`; for gelu, `impl` ("auto", "exact" or "fast":
    the config's `gelu_impl`) selects the erf: "fast" the polynomial
    (`fast_gelu`), the others the exact erf. The JAX package's "auto" takes
    the polynomial on the TPU alone (`layers.py:263-272`); the port keeps
    the exact erf on the card too (`csrc/conv_frontend.cu:11-13`)."""
    if name == "gelu" and impl == "fast":
        return fast_gelu
    return ACT[name]
