"""The LLaMA-family decoder (RMSNorm, SwiGLU, rotary positions without
scaling, grouped-query attention, no biases), plain float32, over whole
sequences: a row is [BOS | its valid speech frames | the tokens it was
served], positions 0, 1, ... in that order, causal. What the served
decode computes step by step through its cache, this computes in one
pass, layer by layer, so that int8 weights are dequantized one layer at a
time."""
from __future__ import annotations

from typing import List, Optional

import torch

from bench_h100.reference.common import Weights, fake_quant, linear, weight


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rotary(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [R, H, L, D] rotated by positions pos [R, L] (rotate-half form)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = pos[:, None, :, None].double() * inv                # [R,1,L,D/2]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def served_logits(w: Weights, dec: dict, speech: List[torch.Tensor],
                  tokens: List[torch.Tensor], bos_id: int,
                  quant: Optional[int] = None,
                  prefix: str = "decoder.") -> List[torch.Tensor]:
    """speech: per row its valid speech frames [n_i, hidden] (projected to
    the decoder's width); tokens: per row the served tokens [m_i]. Returns
    per row the logits [m_i, vocab] that predict each served token: at the
    last speech frame for the first, then after each token for the next."""
    p = prefix
    device = speech[0].device
    R = len(speech)
    Hd = dec["hidden_size"]
    Hq, Hkv = dec["num_attention_heads"], dec["num_key_value_heads"]
    D = dec.get("head_dim") or Hd // Hq
    eps, theta = dec["rms_norm_eps"], dec["rope_theta"]
    table = w[f"{p}model.embed_tokens.weight"]
    lens = [1 + s.shape[0] + t.shape[0] - 1 for s, t in zip(speech, tokens)]
    L = max(lens)
    x = torch.zeros((R, L, Hd), device=device)
    for i, (s, t) in enumerate(zip(speech, tokens)):
        row = torch.cat([table[torch.tensor([bos_id], device=device)].float(),
                         s.float(), table[t[:-1].to(device)].float()])
        x[i, :row.shape[0]] = row
    pos = torch.arange(L, device=device)[None].expand(R, L)
    valid = pos < torch.tensor(lens, device=device)[:, None]
    allowed = (pos[:, None, :] <= pos[:, :, None]) & valid[:, None, :]
    for li in range(dec["num_hidden_layers"]):
        lp = f"{p}model.layers.{li}"
        h = rms_norm(x, w[f"{lp}.input_layernorm.weight"], eps)
        q = linear(w, f"{lp}.self_attn.q_proj", h, quant)
        k = linear(w, f"{lp}.self_attn.k_proj", h, quant)
        v = linear(w, f"{lp}.self_attn.v_proj", h, quant)
        q = rotary(q.reshape(R, L, Hq, D).transpose(1, 2), pos, theta)
        k = rotary(k.reshape(R, L, Hkv, D).transpose(1, 2), pos, theta)
        v = v.reshape(R, L, Hkv, D).transpose(1, 2)
        k, v = fake_quant(k, quant), fake_quant(v, quant)
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
        scores = (q @ k.transpose(-1, -2)) * D ** -0.5
        scores = scores.masked_fill(~allowed[:, None], float("-inf"))
        att = (torch.softmax(scores, -1) @ v).transpose(1, 2)
        x = x + linear(w, f"{lp}.self_attn.o_proj",
                       att.reshape(R, L, Hq * D), quant)
        h = rms_norm(x, w[f"{lp}.post_attention_layernorm.weight"], eps)
        g = linear(w, f"{lp}.mlp.gate_proj", h, quant)
        u = linear(w, f"{lp}.mlp.up_proj", h, quant)
        x = x + linear(w, f"{lp}.mlp.down_proj",
                       g * torch.sigmoid(g) * u, quant)
    x = rms_norm(x, w[f"{p}model.norm.weight"], eps)
    head = (weight(w, f"{p}lm_head") if not dec["tie_word_embeddings"]
            else table.float())
    head = fake_quant(head, quant)
    out = []
    for i, (s, t) in enumerate(zip(speech, tokens)):
        first = s.shape[0]                  # the last speech frame's row
        hs = x[i, first:first + t.shape[0]]
        out.append(fake_quant(hs, quant) @ head.t())
    return out
