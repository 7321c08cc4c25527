"""Int8 weights for serving (counterpart of `mtasr_tpu/utils/quantize.py`).

Symmetric per-output-row quantization, in float32:

    w_int8[o, i] = round(w[o, i] / s[o]),  s[o] = max(max_i |w[o, i]|, 127e-12) / 127

(`torch.round` rounds half to even, as `jnp.round` does; / 127 is a
product with `ops.int8.INV127`, as jitted JAX computes it). The model is
quantized in place: each chosen `nn.Linear` is replaced by a `QuantLinear`
holding `weight_q8a8` (w8a8: int8 activations too) or `weight_q8` (w8:
weight only), `scale` and the bias, under the JAX tree's keys, so a
quantized JAX tree loads into a quantized port model by name
(`utils/convert.py::load_flat`). `models/layers.py::linear` dispatches on
the container. `init_quantized_llama` builds a random decoder in that form
directly, for a geometry whose float weights would not fit beside their
int8 copy.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
from torch import nn

from mtasr_tpu_torch.config import LlamaConfig
from mtasr_tpu_torch.models.layers import QuantLinear
from mtasr_tpu_torch.models.llama import Llama
from mtasr_tpu_torch.ops.int8 import INV127

MIN_OUT_DIM = 256   # narrower linears stay in their float type
# uniform int8 in [-127, 127] has std 73.3: this scale dequantizes it to a
# std of 0.02 (`mtasr_tpu/utils/quantize.py:172-173`, the same constant)
INIT_SCALE = 0.02 / 73.3


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float -> (int8 [out, in], f32 scale [out]). max |w| of a
    row is max(-min, max) (one pass, no |w| copy), and the rounding and
    clamp run in place on the quotient: the same values in fewer passes,
    which the host quantizer of a streamed load feels."""
    wf = w.float()
    lo, hi = torch.aminmax(wf, dim=1, keepdim=True)
    scale = torch.maximum(-lo, hi).clamp_min(127e-12) * INV127
    wq = (wf / scale).round_().clamp_(-127, 127).to(torch.int8)
    return wq, scale[:, 0]


# the flat names whose weights `quantize_decoder_for_serving` quantizes:
# the LLaMA layers' q/k/v/o and MLP projections and the output head
_DECODER_QUANT = re.compile(
    r"^decoder\.(model\.layers\.\d+\.(self_attn\.[qkvo]_proj"
    r"|mlp\.(gate|up|down)_proj)|lm_head)\.weight$")


def decoder_quant_key(name: str) -> bool:
    """Whether the flat parameter `name` is one the serving quantizer
    targets (`model_io.py::_decoder_quant_key`)."""
    return _DECODER_QUANT.match(name) is not None


def quantize_host(w: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    """One weight quantized on the host, for a streamed load: {"weight_q8a8"
    or "weight_q8": int8 [out, in], "scale": f32 [out]}, bit-equal to
    `quantize_weight` on the device (the same float32 operations)."""
    wq, scale = quantize_weight(w.cpu())
    return {"weight_q8a8" if mode == "w8a8" else "weight_q8": wq,
            "scale": scale}


@torch.no_grad()
def quantize_linear(weight: torch.Tensor, bias, mode: str) -> QuantLinear:
    out_dim, in_dim = weight.shape
    q = QuantLinear(in_dim, out_dim, mode,
                    bias_dtype=None if bias is None else bias.dtype,
                    device=weight.device)
    wq, scale = quantize_weight(weight)
    q.weight_int8.copy_(wq)
    q.scale.copy_(scale)
    if bias is not None:
        q.bias.copy_(bias)
    return q


def _quantize_child(parent: nn.Module, name: str, mode: str) -> None:
    lin = getattr(parent, name)
    if isinstance(lin, nn.Linear) and lin.out_features >= MIN_OUT_DIM:
        setattr(parent, name, quantize_linear(lin.weight, lin.bias, mode))


def quantize_tree(module: nn.Module, mode: str) -> None:
    """Every `nn.Linear` under `module` with at least MIN_OUT_DIM outputs
    (`quantize_tree`, `quantize.py:52-59`)."""
    for name, child in list(module.named_children()):
        if isinstance(child, nn.Linear):
            _quantize_child(module, name, mode)
        else:
            quantize_tree(child, mode)


def quantize_decoder_for_serving(model: nn.Module, mode: str) -> None:
    """The LLaMA layers' attention and MLP linears and the output head; the
    embedding table stays (gather only). A head tied to the embeddings
    gets a quantized `lm_head` of its own, whatever its width, so the
    logits product streams int8 (`quantize.py:129-151`)."""
    dec = model.decoder
    c = getattr(dec, "cfg", None)
    if c is not None and (c.kv_lora_rank is not None
                          or c.n_routed_experts is not None):
        raise NotImplementedError(
            f"{mode} serving of a DeepSeek-V3 decoder (latent attention, "
            "experts) is not implemented")
    for layer in dec.model.layers.values():
        quantize_tree(layer.self_attn, mode)
        quantize_tree(layer.mlp, mode)
    if isinstance(getattr(dec, "lm_head", None), nn.Linear):
        _quantize_child(dec, "lm_head", mode)
    elif not hasattr(dec, "lm_head"):
        dec.lm_head = quantize_linear(dec.model.embed_tokens.weight, None,
                                      mode)


def quantize_encoder_for_serving(model: nn.Module, mode: str) -> None:
    """The WavLM layers' q/k/v/out projections and feed-forward denses and
    the feature projection, slot by slot (`quantize.py:91-115`); norms,
    the rel-pos gate, the convolutions and the adapter stay."""
    enc = model.encoder
    for layer in enc.encoder.layers.values():
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _quantize_child(layer.attention, name, mode)
        quantize_tree(layer.feed_forward, mode)
    _quantize_child(enc.feature_projection, "projection", mode)


def quantize_for_serving(model: nn.Module, mode: str = "w8",
                         scope: str = "decoder") -> nn.Module:
    """Quantize the composite model in place and return it. scope
    "decoder" (the weight-streaming decode loop) or "all" (the encoder's
    transformer too)."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"quantize mode {mode!r} not in w8 / w8a8")
    if scope not in ("decoder", "all"):
        raise ValueError(f"quantize scope {scope!r} not in decoder / all")
    quantize_decoder_for_serving(model, mode)
    if scope == "all":
        quantize_encoder_for_serving(model, mode)
    return model


@torch.no_grad()
def init_quantized_llama(cfg: LlamaConfig, generator: torch.Generator,
                         device, mode: str = "w8a8") -> Llama:
    """A LLaMA decoder with random weights built directly in int8 serving
    form (`mtasr_tpu/utils/quantize.py::init_quantized_llama_params`): the
    layers' q/k/v/o and MLP projections and an `lm_head` (tied or not) are
    `QuantLinear`s whose int8 weights are drawn uniform in [-127, 127]
    from `generator` (on `device`) straight into their buffers, with every
    scale INIT_SCALE; the embedding (N(0, 0.02^2)) and the norms (1) are
    bf16. No float copy of a quantized weight is ever allocated, so the
    device holds the final footprint and no more. The keys, shapes and
    dtypes are `quantize_decoder_for_serving`'s on a decoder whose linears
    are all MIN_OUT_DIM wide or wider; like the JAX function, no linear
    gets a bias."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"quantize mode {mode!r} not in w8 / w8a8")
    with torch.device("meta"):
        dec = Llama(cfg).to(torch.bfloat16)
        for layer in dec.model.layers.values():
            for parent in (layer.self_attn, layer.mlp):
                for name, lin in list(parent.named_children()):
                    setattr(parent, name, QuantLinear(
                        lin.in_features, lin.out_features, mode))
        dec.lm_head = QuantLinear(cfg.hidden_size, cfg.vocab_size, mode)
    dec = dec.to_empty(device=device)
    for m in dec.modules():
        if isinstance(m, QuantLinear):
            m.weight_int8.random_(-127, 128, generator=generator)
            m.scale.fill_(INIT_SCALE)
    dec.model.embed_tokens.weight.normal_(0.0, 0.02, generator=generator)
    for p in dec.parameters():
        if p.dim() == 1:
            p.fill_(1.0)
    return dec.eval()
