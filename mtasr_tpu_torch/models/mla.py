"""Multi-head latent attention (DeepSeek-V3's MLA, as Moonlight-16B-A3B
has it), a layer of `llama_forward` when the decoder config sets
`kv_lora_rank`. The port's own: the JAX package has no such decoder. The
equations are the source's (`transformers`' `modeling_deepseek_v3.py`):

    q            = q_proj(h), per head [q_nope (dn) | q_pe (dr)]
    [c_kv | k_pe] = kv_a_proj_with_mqa(h), r + dr wide
    c_kv         = RMSNorm(c_kv) with eps 1e-6 (the source module's
                   default: it is not given the config's rms_norm_eps)
    k_pe         one key of dr for every head
    rope         on q_pe and k_pe, pairing dimensions (2i, 2i + 1): as the
                 source does it (`rope_interleave`), de-interleaved first,
                 then rotate-half, so a rotated vector is the pairs'
                 rotation in the order [evens | odds] (the same dot
                 products)
    [k_nope | v] = kv_b_proj(c_kv), dn + dv a head
    scale        (dn + dr)^-0.5 (no rope scaling, so no mscale)

The cache holds one latent a slot: [c_kv | rotated k_pe], r + dr values
(576 for Moonlight, 1152 bytes a slot-layer in bf16), in `KVCache.k`
([B, S_max, r + dr] a layer; `KVCache.v` is empty). It is written by
`index_copy_` at the device-side slots, as the LLaMA cache is.

Two forms of the same function:

* expanded (a prefill, L > 16): `kv_b_proj` up-projects each read slot's
  latent to k_nope and v, then plain attention over the slots up to the
  last query's (the valid ones; later slots are masked anyway);
* absorbed (a decode step and chunks of L <= 16): W_uk is folded into the
  query, q_lat = q_nope W_uk (r wide), so a score is [q_lat | q_pe] .
  [c_kv | k_pe] against the latent itself; the weights P read the latent's
  c_kv, o_lat = P c_kv, and W_uv comes after: o = o_lat W_uv^T. Scores and
  the softmax in float32, P rounded to the activation dtype before P c_kv,
  as the LLaMA path's attention does.

Both are plain PyTorch (batched matrix products): there is no TPU kernel
to port, and at the served S_max the latent read is a few per cent of a
step's bytes.

Not implemented, and refused by name: an int8 latent cache (`kv_quant`),
sharding by head (tp), the LoRA branch (training's `decoder_lora`), and
the source's q-LoRA (`config.check_deepseek`)."""
from __future__ import annotations

import torch
from torch import nn

from mtasr_tpu_torch.config import LlamaConfig
from mtasr_tpu_torch.models.layers import RMSNorm, linear
from mtasr_tpu_torch.ops.attention import NEG_INF
from mtasr_tpu_torch.ops.norms import rms_norm
from mtasr_tpu_torch.ops.rope import apply_rotary_emb

KV_NORM_EPS = 1e-6      # kv_a_layernorm's eps: the source module's default
ABSORBED_MAX_L = 16     # longer chunks (the prefill) take the expanded form


class LatentAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        H, n = cfg.hidden_size, cfg.num_attention_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        r, b = cfg.kv_lora_rank, cfg.attention_bias
        self.q_proj = nn.Linear(H, n * (dn + dr), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(H, r + dr, bias=b)
        self.kv_a_layernorm = RMSNorm(r)
        self.kv_b_proj = nn.Linear(r, n * (dn + dv), bias=False)
        self.o_proj = nn.Linear(n * dv, H, bias=b)


def latent_width(cfg: LlamaConfig) -> int:
    """Values a cache slot holds: kv_lora_rank + qk_rope_head_dim."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., d] in the order x0, x2, ..., x1, x3, ...: the source's
    `apply_rotary_pos_emb_interleave` view, after which rotate-half rotates
    the pairs (2i, 2i + 1)."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2).flatten(-2)


def _attend(scores: torch.Tensor, mask: torch.Tensor, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """Scaled float32 scores, masked (True = attend), softmax, rounded to
    `dtype`."""
    logits = (scores.float() * scale).masked_fill(~mask, NEG_INF)
    return torch.softmax(logits, dim=-1).to(dtype)


def latent_attention(att: LatentAttention, cfg: LlamaConfig, x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor, mask: torch.Tensor,
                     layer_idx: int, kv_cache, slots: torch.Tensor,
                     n_read: int) -> torch.Tensor:
    """x [B, L, H] (normed); cos / sin [B, L, dr]; mask [B, 1, L, S] (True
    = attend); `slots` [L] the cache slots of this chunk on the device;
    `n_read` the slots the expanded form reads (the last query's slot + 1
    where the host knows it, else the whole cache). Without a cache the
    chunk attends to itself (expanded). Returns [B, L, H]."""
    if getattr(att, "tp", None) is not None:
        raise NotImplementedError("latent attention under tp (sharding by "
                                  "head) is not implemented")
    B, L, _ = x.shape
    n, dn, dr, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, \
        cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    scale = (dn + dr) ** -0.5
    q = linear(att.q_proj, x).reshape(B, L, n, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c_kv, k_pe = linear(att.kv_a_proj_with_mqa, x).split([r, dr], dim=-1)
    c_kv = rms_norm(c_kv, att.kv_a_layernorm.weight, KV_NORM_EPS)
    q_pe, k_pe = apply_rotary_emb(deinterleave(q_pe),
                                  deinterleave(k_pe)[:, :, None], cos, sin)
    latent = torch.cat([c_kv, k_pe[:, :, 0]], dim=-1)         # [B, L, r+dr]
    if kv_cache is None:
        lat, m = latent, mask
    else:
        if kv_cache.kv_scale is not None:
            raise NotImplementedError("an int8 latent cache (kv_quant) is "
                                      "not implemented")
        kc = kv_cache.k[layer_idx]
        kc.index_copy_(1, slots, latent.to(kc.dtype))
        if L <= ABSORBED_MAX_L:
            return _absorbed(att, cfg, q_nope, q_pe, kc, mask, scale)
        lat, m = kc[:, :n_read], mask[..., :n_read]
    return _expanded(att, cfg, q_nope, q_pe, lat.to(x.dtype), m, scale)


def _expanded(att, cfg, q_nope, q_pe, lat, mask, scale) -> torch.Tensor:
    """Attention with each read slot's latent up-projected to per-head
    keys and values (lat [B, S, r + dr])."""
    B, L, n, dn = q_nope.shape
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    S = lat.shape[1]
    kv = linear(att.kv_b_proj, lat[..., :r]).reshape(B, S, n, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    k_pe = lat[..., r:]
    scores = (torch.einsum("blhd,bshd->bhls", q_nope.float(), k_nope.float())
              + torch.einsum("blhd,bsd->bhls", q_pe.float(), k_pe.float()))
    p = _attend(scores, mask, scale, v.dtype)
    out = torch.einsum("bhls,bshd->blhd", p.float(), v.float()).to(v.dtype)
    return linear(att.o_proj, out.reshape(B, L, n * dv))


def _absorbed(att, cfg, q_nope, q_pe, kc, mask, scale) -> torch.Tensor:
    """Attention over the latent cache kc [B, S, r + dr] itself: W_uk
    folded into the query, W_uv applied to the weighted latent."""
    B, L, n, dn = q_nope.shape
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    dt = kc.dtype
    w = att.kv_b_proj.weight.to(dt).reshape(n, dn + dv, r)
    w_uk, w_uv = w[:, :dn], w[:, dn:]
    # q_lat [n, B*L, r]: one product a head
    q_lat = torch.bmm(q_nope.to(dt).permute(2, 0, 1, 3).reshape(n, B * L, dn),
                      w_uk)
    # rows h*L + l of [B, n*L, r + dr]: one product a batch row against
    # its latent, heads and queries folded into M
    qf = torch.cat([q_lat.reshape(n, B, L, r).permute(1, 0, 2, 3),
                    q_pe.to(dt).permute(0, 2, 1, 3)], dim=-1)
    scores = torch.bmm(qf.reshape(B, n * L, r + q_pe.shape[-1]),
                       kc.transpose(1, 2))                    # [B, n*L, S]
    p = _attend(scores.reshape(B, n, L, -1), mask, scale, dt)
    o_lat = torch.bmm(p.reshape(B, n * L, -1), kc[..., :r])  # [B, n*L, r]
    o = torch.bmm(o_lat.reshape(B, n, L, r).permute(1, 0, 2, 3)
                  .reshape(n, B * L, r), w_uv.transpose(1, 2))  # [n, B*L, dv]
    o = o.reshape(n, B, L, dv).permute(1, 2, 0, 3).reshape(B, L, n * dv)
    return linear(att.o_proj, o)
