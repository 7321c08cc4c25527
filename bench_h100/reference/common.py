"""Helpers shared by the reference's components."""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def float32_exact():
    """float32 products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fake_quant(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """x rounded to `bits`-bit symmetric integers, one scale for each row
    of the last axis (max |x| over the row); x itself without `bits`."""
    if not bits:
        return x
    qmax = 2 ** (bits - 1) - 1
    s = (x.abs().amax(-1, keepdim=True) / qmax).clamp_min(1e-12)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def weight(w: Weights, name: str) -> torch.Tensor:
    """The float32 weight of the linear (or table) `name`: a float tensor
    as it is, an int8 one (`name.weight_q8a8` / `.weight_q8` with a scale a
    row) dequantized."""
    if f"{name}.weight" in w:
        return w[f"{name}.weight"].float()
    for key in ("weight_q8a8", "weight_q8"):
        if f"{name}.{key}" in w:
            scale = w[f"{name}.scale"].float()
            return w[f"{name}.{key}"].float() * scale[:, None]
    raise KeyError(f"no weight for {name}")


def bias(w: Weights, name: str) -> Optional[torch.Tensor]:
    b = w.get(f"{name}.bias")
    return None if b is None else b.float()


def linear(w: Weights, name: str, x: torch.Tensor,
           quant: Optional[int] = None) -> torch.Tensor:
    y = fake_quant(x, quant) @ fake_quant(weight(w, name), quant).t()
    b = bias(w, name)
    return y if b is None else y + b


def layer_norm(w: Weights, name: str, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + eps) * w[f"{name}.weight"].float()
            + w[f"{name}.bias"].float())
