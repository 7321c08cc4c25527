"""The DeepSeek-V3-family decoder (Moonlight-16B-A3B: multi-head latent
attention, a sigmoid-routed mixture of experts with shared experts after
`first_k_dense_replace` dense layers, no biases), plain float32, over
whole sequences: a row is [BOS | its valid speech frames | the tokens it
was served], positions 0, 1, ... in that order, causal. What the served
decode computes step by step through its latent cache, this computes in
one pass, layer by layer, each layer's weights cast to float32 when the
layer runs (a layer of 64 experts is 2.2 GB).

The equations are `transformers`' `modeling_deepseek_v3.py`:

* latent attention: q = q_proj(h) per head [nope | rope]; [c | k_pe] =
  kv_a_proj_with_mqa(h); c normed with eps 1e-6 (the source module's
  default, not the config's rms_norm_eps); [k_nope | v] = kv_b_proj(c)
  per head; one k_pe for all heads; rope rotating the pairs (2i, 2i + 1)
  in place (the source de-interleaves q_pe and k_pe first and writes the
  pairs as [evens | odds], a permutation of both, so the same scores);
  scale (nope + rope)^-0.5, with no rope scaling so no mscale;
* the router: the top k of sigmoid(gate(h)) + e_score_correction_bias
  (the bias selects, never weights), the sigmoid at those normalized by
  their sum + 1e-20 and times routed_scaling_factor; each token's k
  experts' SwiGLU summed with those weights, plus the shared experts'.

Departures: none in the equations; the routed experts are read from the
program's stacked layout (`experts.gate_up_proj` [E * 2I, H], an
expert's gate rows then its up rows; `experts.down_proj` [E * H, I]),
the same numbers as the source's per-expert linears.

With `quant` every linear's weight and input and the cached latent are
rounded to that many bits (`common.fake_quant`); the router stays in
float32, as the source computes it whatever the precision."""
from __future__ import annotations

from typing import List, Optional

import torch

from bench_h100.reference.common import Weights, fake_quant, linear, weight

KV_NORM_EPS = 1e-6


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope_pairs(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., L, d] rotated by positions pos [..., L] in the pairs
    (2i, 2i + 1)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = pos[..., None].double() * inv
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x0 * cos - x1 * sin
    out[..., 1::2] = x1 * cos + x0 * sin
    return out


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, quant: Optional[int]) -> torch.Tensor:
    xq = fake_quant(x, quant)
    g = xq @ fake_quant(gate, quant).t()
    h = g * torch.sigmoid(g) * (xq @ fake_quant(up, quant).t())
    return fake_quant(h, quant) @ fake_quant(down, quant).t()


def experts(w: Weights, p: str, dec: dict, x: torch.Tensor,
            quant: Optional[int]) -> torch.Tensor:
    """The routed and shared experts of one layer over tokens x [N, H]."""
    E, k = dec["n_routed_experts"], dec["num_experts_per_tok"]
    H, I = dec["hidden_size"], dec["moe_intermediate_size"]
    s = torch.sigmoid(x @ weight(w, f"{p}.gate").t())
    top = torch.topk(s + w[f"{p}.gate.e_score_correction_bias"].float(), k,
                     dim=-1).indices
    wt = s.gather(1, top)
    if dec["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * dec["routed_scaling_factor"]
    gu = w[f"{p}.experts.gate_up_proj"].float().reshape(E, 2 * I, H)
    dn = w[f"{p}.experts.down_proj"].float().reshape(E, H, I)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, slot = torch.nonzero(top == e, as_tuple=True)
        if len(tok):
            y[tok] += wt[tok, slot, None] * swiglu(
                x[tok], gu[e, :I], gu[e, I:], dn[e], quant)
    del gu, dn
    sp = f"{p}.shared_experts"
    return y + swiglu(x, weight(w, f"{sp}.gate_proj"),
                      weight(w, f"{sp}.up_proj"),
                      weight(w, f"{sp}.down_proj"), quant)


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
    Hd, n = dec["hidden_size"], dec["num_attention_heads"]
    dn, dr, dv = dec["qk_nope_head_dim"], dec["qk_rope_head_dim"], \
        dec["v_head_dim"]
    r, eps, theta = dec["kv_lora_rank"], dec["rms_norm_eps"], \
        dec["rope_theta"]
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
        a = f"{lp}.self_attn"
        h = rms_norm(x, w[f"{lp}.input_layernorm.weight"], eps)
        q = linear(w, f"{a}.q_proj", h, quant).reshape(
            R, L, n, dn + dr).transpose(1, 2)
        ckv = linear(w, f"{a}.kv_a_proj_with_mqa", h, quant)
        c = rms_norm(ckv[..., :r], w[f"{a}.kv_a_layernorm.weight"],
                     KV_NORM_EPS)
        k_pe = rope_pairs(ckv[..., r:], pos, theta)
        lat = fake_quant(torch.cat([c, k_pe], -1), quant)    # the cache
        c, k_pe = lat[..., :r], lat[..., r:]
        kv = linear(w, f"{a}.kv_b_proj", c, quant).reshape(
            R, L, n, dn + dv).transpose(1, 2)
        q_pe = rope_pairs(q[..., dn:], pos[:, None], theta)
        scores = (q[..., :dn] @ kv[..., :dn].transpose(-1, -2)
                  + q_pe @ k_pe[:, None].transpose(-1, -2)) \
            * (dn + dr) ** -0.5
        scores = scores.masked_fill(~allowed[:, None], float("-inf"))
        att = (torch.softmax(scores, -1) @ kv[..., dn:]).transpose(1, 2)
        del q, kv, scores
        x = x + linear(w, f"{a}.o_proj", att.reshape(R, L, n * dv), quant)
        h = rms_norm(x, w[f"{lp}.post_attention_layernorm.weight"], eps)
        m = f"{lp}.mlp"
        if li < dec["first_k_dense_replace"]:
            x = x + swiglu(h, weight(w, f"{m}.gate_proj"),
                           weight(w, f"{m}.up_proj"),
                           weight(w, f"{m}.down_proj"), quant)
        else:
            x = x + experts(w, m, dec, h.reshape(R * L, Hd),
                            quant).reshape(R, L, Hd)
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
