"""Decoder LoRA: insertion, the merged weights, and the offline merge
(counterpart of `mtasr_tpu/train/lora.py`; PEFT's LoRA on q/k/v/o with
r = 16, alpha = 32 in the reference recipe).

The adapters live in `model.decoder_lora`, a `DecoderLoRA` whose parameter
names are the JAX tree's flat keys (`decoder_lora.<layer>.<proj>.lora_A`
[r, in] and `.lora_B` [out, r]); r and alpha, which the JAX tree keeps as
`__meta__` leaves, are plain attributes. Training applies the branch to
the activations (`models/llama.py::_lora_linear`); decoding folds it into
the weights, W' = W + (alpha / r) B A in float32 (`merged`, for a call, or
`merge_decoder_lora`, for good).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from mtasr_tpu_torch.parallel.mesh import tp_local

TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


class LoRAPair(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, r: int, dtype=None,
                 device=None):
        super().__init__()
        self.lora_A = nn.Parameter(torch.zeros(r, in_dim, dtype=dtype,
                                               device=device))
        self.lora_B = nn.Parameter(torch.zeros(out_dim, r, dtype=dtype,
                                               device=device))


class DecoderLoRA(nn.ModuleDict):
    """{layer index: {proj name: LoRAPair}}, with r and alpha."""

    def __init__(self, pairs: Dict[str, Dict[str, LoRAPair]], r: float,
                 alpha: float):
        super().__init__({li: nn.ModuleDict(p) for li, p in pairs.items()})
        self.r, self.alpha = float(r), float(alpha)

    @property
    def scale(self) -> float:
        return self.alpha / max(self.r, 1.0)


def _proj(model: nn.Module, li: str, name: str) -> nn.Linear:
    return getattr(model.decoder.model.layers[li].self_attn, name)


def init_decoder_lora(model: nn.Module, generator: torch.Generator,
                      target_modules: Sequence[str] = TARGETS, r: int = 16,
                      alpha: float = 32.0,
                      layers: Optional[Sequence[int]] = None,
                      dtype: torch.dtype = torch.float32) -> DecoderLoRA:
    """Attach `model.decoder_lora`: lora_A ~ U(-b, b) with
    b = sqrt(6 / ((1 + 5) / 2) / in) (kaiming-uniform, a = sqrt(5), as
    PEFT and the JAX package draw it), lora_B = 0, so the branch starts at
    zero. `generator` lives on the model's device. Returns the module."""
    device = next(model.parameters()).device
    pairs: Dict[str, Dict[str, LoRAPair]] = {}
    for li in model.decoder.model.layers:
        if layers is not None and int(li) not in layers:
            continue
        for name in target_modules:
            out_dim, in_dim = _proj(model, li, name).weight.shape
            pair = LoRAPair(in_dim, out_dim, r, dtype, device)
            bound = math.sqrt(6.0 / ((1 + 5) / 2.0) / in_dim)
            with torch.no_grad():
                pair.lora_A.uniform_(-bound, bound, generator=generator)
            pairs.setdefault(li, {})[name] = pair
    model.decoder_lora = DecoderLoRA(pairs, r, alpha)
    return model.decoder_lora


def apply_decoder_lora(model: nn.Module,
                       lora: DecoderLoRA) -> Dict[str, torch.Tensor]:
    """The merged weights W + scale * B @ A (float32, cast to W's dtype),
    by parameter name; the model is not changed. A tensor-parallel W
    takes its rank's slice of the product."""
    out = {}
    for li, projs in lora.items():
        for name, ab in projs.items():
            w = _proj(model, li, name).weight
            key = f"decoder.model.layers.{li}.self_attn.{name}.weight"
            delta = tp_local(model, key, (ab.lora_B.float()
                                          @ ab.lora_A.float()) * lora.scale)
            out[key] = (w.float() + delta).to(w.dtype)
    return out


@contextlib.contextmanager
def merged(model: nn.Module):
    """For the duration, the decoder's weights carry the LoRA (exact at
    inference, where its dropout is off: `generate` runs under this, as
    the JAX engine merges per call); restored afterwards."""
    lora = getattr(model, "decoder_lora", None)
    if lora is None:
        yield
        return
    params = dict(model.named_parameters())
    saved = {}
    with torch.no_grad():
        for key, w in apply_decoder_lora(model, lora).items():
            saved[key] = params[key].detach().clone()
            params[key].copy_(w)
    try:
        yield
    finally:
        with torch.no_grad():
            for key, w in saved.items():
                params[key].copy_(w)


def merge_decoder_lora(model: nn.Module) -> nn.Module:
    """Fold `model.decoder_lora` into the decoder weights and drop it
    (the offline merge of the reference's merge_adapter.py)."""
    lora = getattr(model, "decoder_lora", None)
    if lora is None:
        return model
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, w in apply_decoder_lora(model, lora).items():
            params[key].copy_(w)
    del model.decoder_lora
    return model
