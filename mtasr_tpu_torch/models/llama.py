"""LLaMA decoder with a preallocated KV cache (counterpart of
`mtasr_tpu/models/llama.py`).

The composite model hands the decoder plain `inputs_embeds` and
`position_ids` (the `[prefix | speech | suffix]` splice is built outside),
so the decoder is splice-agnostic. The KV cache keeps the JAX package's
merged-lane `[B, S_max, Hkv*D]` layout per layer, bf16 or int8. A cached
forward routes as the JAX package's does (`models/llama.py:304-378`),
without its TPU lane-width gate: L = 1 through `decode_attention` (#4) or
`decode_attention_int8` (#6), 1 < L <= 16 through `decode_attention_chunk`
(#5) or `decode_attention_int8_chunk` (#7), longer prefills through plain
attention (XLA in the JAX package as well), which for an int8 cache is
dequantized attention in the activation dtype.

Training runs the forward without a cache (attention is plain PyTorch, as
it is XLA in the JAX package), with the decoder LoRA applied to the
activations (`_lora_linear`: dropout on the branch input, the low-rank
product in float32, as `mtasr_tpu/models/llama.py:177-197`) and, with
`cfg.remat`, each layer recomputed in backward.

Parameter names are the JAX tree's flat keys under `decoder.`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from mtasr_tpu_torch.config import LlamaConfig
from mtasr_tpu_torch.models.layers import (
    QuantLinear, dropout, embed, linear, remat_layer,
)
from mtasr_tpu_torch.ops.attention import dot_product_attention
from mtasr_tpu_torch.ops.int8 import INV127
from mtasr_tpu_torch.ops.kernels.decode_attention import decode_attention
from mtasr_tpu_torch.ops.kernels.decode_attention_chunk import (
    MAX_L as CHUNK_MAX_L, decode_attention_chunk, decode_attention_int8_chunk,
)
from mtasr_tpu_torch.ops.kernels.decode_attention_int8 import (
    decode_attention_int8,
)
from mtasr_tpu_torch.ops.norms import rms_norm
from mtasr_tpu_torch.ops.rope import (
    apply_rotary_emb, compute_rope_freqs, rope_cos_sin,
)


@dataclass
class KVCache:
    """Per-layer [B, S_max, Hkv*D] key / value buffers and the [B, S_max]
    slot-validity mask (False = empty or padding). Written in place.

    int8 (`init(..., quantized=True)`): int8 buffers, and per layer one
    `kv_scale` [B, 2*Hkv, S_max] bf16 of per-(row, slot, head) symmetric
    scales with kv head h's k scales in row 2h and its v scales in row
    2h+1, interleaved as the JAX package writes them (`llama.py:258-262`;
    its docstrings at `:52-54` and `decode_attention.py:341-342` say "k rows
    then v rows", which the code does not do)."""
    k: List[torch.Tensor]
    v: List[torch.Tensor]
    valid: torch.Tensor
    kv_scale: Optional[List[torch.Tensor]] = None

    @classmethod
    def init(cls, cfg: LlamaConfig, batch: int, max_len: int,
             dtype: torch.dtype, device, quantized: bool = False
             ) -> "KVCache":
        shape = (batch, max_len, cfg.num_key_value_heads * cfg.head_dim_)
        n = cfg.num_hidden_layers
        buf = torch.int8 if quantized else dtype
        scales = None
        if quantized:
            scales = [torch.zeros((batch, 2 * cfg.num_key_value_heads,
                                   max_len), dtype=torch.bfloat16,
                                  device=device) for _ in range(n)]
        return cls(
            k=[torch.zeros(shape, dtype=buf, device=device)
               for _ in range(n)],
            v=[torch.zeros(shape, dtype=buf, device=device)
               for _ in range(n)],
            valid=torch.zeros((batch, max_len), dtype=torch.bool,
                              device=device),
            kv_scale=scales)

    @property
    def max_len(self) -> int:
        return self.k[0].shape[1]


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L, H, D] -> (int8 [B, L, H, D], bf16 scale [B, L, H]). The scale
    is rounded to bf16 before quantizing, so the stored int8 values are
    multiples of the scale the kernels read (`llama.py:103-114`)."""
    xf = x.float()
    s = (xf.abs().amax(-1) * INV127).clamp_min(1e-8).to(torch.bfloat16)
    q = torch.clamp(torch.round(xf / s[..., None].float()), -127, 127)
    return q.to(torch.int8), s


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class _SelfAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim_
        b = cfg.attention_bias
        self.q_proj = nn.Linear(H, cfg.num_attention_heads * D, bias=b)
        self.k_proj = nn.Linear(H, cfg.num_key_value_heads * D, bias=b)
        self.v_proj = nn.Linear(H, cfg.num_key_value_heads * D, bias=b)
        self.o_proj = nn.Linear(cfg.num_attention_heads * D, H, bias=b)


class _MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        H, I, b = cfg.hidden_size, cfg.intermediate_size, cfg.mlp_bias
        self.gate_proj = nn.Linear(H, I, bias=b)
        self.up_proj = nn.Linear(H, I, bias=b)
        self.down_proj = nn.Linear(I, H, bias=b)


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.self_attn = _SelfAttention(cfg)
        self.mlp = _MLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)


class _Model(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleDict({str(i): _DecoderLayer(cfg)
                                     for i in range(cfg.num_hidden_layers)})
        self.norm = RMSNorm(cfg.hidden_size)


class Llama(nn.Module):
    """Parameter container of the decoder (`model.*`, and `lm_head` when
    the embeddings are not tied)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _Model(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)
        self._rope: Dict[torch.device, Tuple[torch.Tensor, float]] = {}

    def rope_freqs(self, device) -> Tuple[torch.Tensor, float]:
        """(inv_freq, attention_scaling), kept on `device` so a decode step
        makes no host-to-device copy."""
        key = torch.device(device)
        if key not in self._rope:
            cfg = self.cfg
            inv, scaling = compute_rope_freqs(cfg.head_dim_, cfg.rope_theta,
                                              cfg.rope_scaling)
            self._rope[key] = (torch.from_numpy(inv).to(device), scaling)
        return self._rope[key]


def embed_tokens(dec: Llama, cfg: LlamaConfig, input_ids: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    return embed(dec.model.embed_tokens, input_ids, dtype)


def lm_head(dec: Llama, cfg: LlamaConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    head = getattr(dec, "lm_head", None)
    if isinstance(head, QuantLinear):   # a quantized head wins, tied or not
        return linear(head, hidden)
    w = head.weight if head is not None else dec.model.embed_tokens.weight
    return hidden @ w.to(hidden.dtype).t()


def _lora_linear(m: nn.Module, x: torch.Tensor, ab: Optional[nn.Module],
                 scale: float, generator: Optional[torch.Generator],
                 rate: float) -> torch.Tensor:
    """linear() plus the PEFT LoRA branch y += scale * B(A(drop(x))),
    dropout on the branch input only, the branch in float32."""
    y = linear(m, x)
    if ab is None:
        return y
    xl = dropout(x.float(), rate, generator)
    delta = (xl @ ab.lora_A.float().t()) @ ab.lora_B.float().t()
    return y + (delta * scale).to(y.dtype)


def _attention(att: _SelfAttention, cfg: LlamaConfig, x: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor,
               layer_idx: int, kv_cache: Optional[KVCache],
               cache_offset: int, lora_layer: Optional[nn.Module] = None,
               lora_scale: float = 1.0,
               generator: Optional[torch.Generator] = None,
               lora_dropout: float = 0.0) -> torch.Tensor:
    B, L, _ = x.shape
    D, Hq, Hkv = cfg.head_dim_, cfg.num_attention_heads, \
        cfg.num_key_value_heads

    def proj(name, inp):
        ab = getattr(lora_layer, name, None) if lora_layer is not None \
            else None
        return _lora_linear(getattr(att, name), inp, ab, lora_scale,
                            generator, lora_dropout)

    q = proj("q_proj", x).reshape(B, L, Hq, D)
    k = proj("k_proj", x).reshape(B, L, Hkv, D)
    v = proj("v_proj", x).reshape(B, L, Hkv, D)
    q, k = apply_rotary_emb(q, k, cos, sin)
    if kv_cache is None:
        out = dot_product_attention(q, k, v, mask=mask, scale=D ** -0.5)
        return proj("o_proj", out.reshape(B, L, Hq * D))
    # In place: the step's K/V go straight into their slots of the
    # preallocated cache (the JAX package, immutable, wrote a new buffer with
    # dynamic_update_slice). Attention then reads what was written: for an
    # int8 cache the round-tripped K/V, not the fresh ones.
    kc, vc = kv_cache.k[layer_idx], kv_cache.v[layer_idx]
    end = cache_offset + L
    kvs = None
    if kv_cache.kv_scale is not None:
        k8, ks = _quantize_kv(k)
        v8, vs = _quantize_kv(v)
        kc[:, cache_offset:end] = k8.reshape(B, L, Hkv * D)
        vc[:, cache_offset:end] = v8.reshape(B, L, Hkv * D)
        kvs = kv_cache.kv_scale[layer_idx]
        kvs[:, :, cache_offset:end] = torch.stack(
            [ks, vs], dim=-1).reshape(B, L, 2 * Hkv).transpose(1, 2)
    else:
        kc[:, cache_offset:end] = k.reshape(B, L, Hkv * D)
        vc[:, cache_offset:end] = v.reshape(B, L, Hkv * D)
    if L == 1:
        qd, md = q[:, 0].contiguous(), mask[:, 0, 0, :].contiguous()
        out = (decode_attention(qd, kc, vc, md) if kvs is None else
               decode_attention_int8(qd, kc, vc, kvs, md))[:, None]
    elif L <= CHUNK_MAX_L:
        qc, mc = q.contiguous(), mask[:, 0].contiguous()
        out = (decode_attention_chunk(qc, kc, vc, mc) if kvs is None else
               decode_attention_int8_chunk(qc, kc, vc, kvs, mc))
    else:
        S = kc.shape[1]
        kd = kc.reshape(B, S, Hkv, D).to(x.dtype)
        vd = vc.reshape(B, S, Hkv, D).to(x.dtype)
        if kvs is not None:   # dequantized in the activation dtype
            kd = kd * kvs[:, 0::2].transpose(1, 2)[..., None].to(x.dtype)
            vd = vd * kvs[:, 1::2].transpose(1, 2)[..., None].to(x.dtype)
        out = dot_product_attention(q, kd, vd, mask=mask, scale=D ** -0.5)
    return linear(att.o_proj, out.reshape(B, L, Hq * D))


def lora_layer(lora: Optional[nn.Module], idx: int) -> Optional[nn.Module]:
    """The LoRA pairs of decoder layer `idx` (None where it has none);
    `lora` is a `train.lora.DecoderLoRA`, keyed by layer index."""
    if lora is None or str(idx) not in lora:
        return None
    return lora[str(idx)]


def _mlp(mlp: _MLP, x: torch.Tensor) -> torch.Tensor:
    return linear(mlp.down_proj, torch.nn.functional.silu(
        linear(mlp.gate_proj, x)) * linear(mlp.up_proj, x))


def llama_forward(dec: Llama, cfg: LlamaConfig, inputs_embeds: torch.Tensor,
                  position_ids: torch.Tensor, *,
                  key_valid_mask: Optional[torch.Tensor] = None,
                  kv_cache: Optional[KVCache] = None, cache_offset: int = 0,
                  compute_logits: bool = True, logits_to_keep: int = 0,
                  lora: Optional[nn.Module] = None, lora_dropout: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  layer_callback: Optional[Callable[[int, torch.Tensor],
                                                    torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (logits [B, L or logits_to_keep, V], or the final hidden
    states, and the cache). Query row i (absolute position cache_offset + i)
    attends to slot j iff j <= cache_offset + i and the slot is valid.

    `lora` (the model's `decoder_lora`, without a cache only) adds its
    branch to q/k/v/o; `generator` drives its input dropout (none without
    one). `layer_callback(i, hidden)` (the cross-attention adapters)
    rewrites layer i's hidden states after the self-attention residual,
    before the MLP's norm (`mtasr_tpu/models/llama.py:524-528`), with or
    without a cache, and inside the recomputed layer under remat."""
    if lora is not None and kv_cache is not None:
        raise ValueError("the LoRA branch runs without a cache; a cached "
                         "forward takes merged weights (train/lora.py)")
    B, L, _ = inputs_embeds.shape
    device = inputs_embeds.device
    inv_freq, scaling = dec.rope_freqs(device)
    cos, sin = rope_cos_sin(inv_freq, position_ids, scaling,
                            dtype=inputs_embeds.dtype)

    S = kv_cache.max_len if kv_cache is not None else L
    j = torch.arange(S, device=device)[None, None, :]
    i_abs = cache_offset + torch.arange(L, device=device)[None, :, None]
    mask = j <= i_abs                                         # [1, L, S]
    if kv_cache is not None:
        kv_cache.valid[:, cache_offset:cache_offset + L] = (
            key_valid_mask if key_valid_mask is not None else True)
        mask = mask & kv_cache.valid[:, None, :]
    elif key_valid_mask is not None:
        mask = mask & key_valid_mask[:, None, :]
    mask = mask[:, None]                                      # [B, 1, L, S]

    def layer(idx, hidden):
        lp = dec.model.layers[str(idx)]
        h = rms_norm(hidden, lp.input_layernorm.weight, cfg.rms_norm_eps)
        hidden = hidden + _attention(
            lp.self_attn, cfg, h, cos, sin, mask, idx, kv_cache,
            cache_offset, lora_layer=lora_layer(lora, idx),
            lora_scale=lora.scale if lora is not None else 1.0,
            generator=generator, lora_dropout=lora_dropout)
        if layer_callback is not None:
            hidden = layer_callback(idx, hidden)
        h = rms_norm(hidden, lp.post_attention_layernorm.weight,
                     cfg.rms_norm_eps)
        return hidden + _mlp(lp.mlp, h)

    hidden = inputs_embeds
    remat = cfg.remat and kv_cache is None and torch.is_grad_enabled()
    for idx in range(cfg.num_hidden_layers):
        hidden = (remat_layer(layer, generator, idx, hidden) if remat
                  else layer(idx, hidden))
    hidden = rms_norm(hidden, dec.model.norm.weight, cfg.rms_norm_eps)
    if logits_to_keep:
        hidden = hidden[:, -logits_to_keep:, :]
    if compute_logits:
        return lm_head(dec, cfg, hidden), kv_cache
    return hidden, kv_cache
