"""The plain DeepSeek-V3 decoder (Moonlight-16B-A3B's block), float32, for
the CPU tests: a whole sequence in one pass, no cache, no kernel, nothing
of the port. It follows `transformers`' `modeling_deepseek_v3.py`:

* RMSNorm: x / sqrt(mean(x^2) + eps) * g (float32 throughout);
* latent attention: q = q_proj(h) per head [nope | pe]; [c | k_pe] =
  kv_a_proj_with_mqa(h); c normed with eps 1e-6 (the source module's
  default); [k_nope | v] = kv_b_proj(c) per head; k_pe one for all heads;
  rope on q_pe and k_pe rotating the pairs (2i, 2i + 1) in place (the
  source de-interleaves first and writes the pairs out as [evens | odds]:
  a permutation of both q and k, so the same scores); scale
  (nope + rope)^-0.5; causal and key-valid mask;
* the MLP: layers before `first_k_dense_replace` a SwiGLU; the others a
  sigmoid router (the top k of sigmoid + e_score_correction_bias chosen,
  the sigmoid at those normalized by their sum + 1e-20 and scaled by
  routed_scaling_factor), each token's k experts summed with those
  weights, plus the shared experts' SwiGLU.

Departures: none in the equations. The routed experts are read from the
port's stacked layout (`experts.gate_up_proj` [E * 2I, H],
`experts.down_proj` [E * H, I]), the same numbers as the source's
per-expert linears."""
from __future__ import annotations

from typing import Dict

import torch

KV_NORM_EPS = 1e-6


def rms_norm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope_pairs(x, pos, dim, theta):
    """x [..., L, dim] rotated in the pairs (2i, 2i + 1) by positions pos
    [..., L] (broadcast)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float64)
                           / dim))
    ang = pos[..., None].double() * inv
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x0 * cos - x1 * sin
    out[..., 1::2] = x1 * cos + x0 * sin
    return out


def swiglu(x, gate, up, down):
    g = x @ gate.float().t()
    return (g * torch.sigmoid(g) * (x @ up.float().t())) @ down.float().t()


def experts(w: Dict[str, torch.Tensor], p: str, dec: dict, x):
    """The routed and shared experts of one layer over tokens x [N, H]."""
    E, k = dec["n_routed_experts"], dec["num_experts_per_tok"]
    H, I = dec["hidden_size"], dec["moe_intermediate_size"]
    s = torch.sigmoid(x @ w[f"{p}.gate.weight"].float().t())
    top = torch.topk(s + w[f"{p}.gate.e_score_correction_bias"].float(), k,
                     dim=-1).indices
    wt = s.gather(1, top)
    if dec.get("norm_topk_prob", True):
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    wt = wt * dec["routed_scaling_factor"]
    gu = w[f"{p}.experts.gate_up_proj"].float().reshape(E, 2 * I, H)
    dn = w[f"{p}.experts.down_proj"].float().reshape(E, H, I)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, slot = torch.nonzero(top == e, as_tuple=True)
        if len(tok):
            y[tok] += wt[tok, slot, None] * swiglu(x[tok], gu[e, :I],
                                                   gu[e, I:], dn[e])
    sp = f"{p}.shared_experts"
    return y + swiglu(x, w[f"{sp}.gate_proj.weight"],
                      w[f"{sp}.up_proj.weight"], w[f"{sp}.down_proj.weight"])


def layer(w: Dict[str, torch.Tensor], lp: str, li: int, dec: dict, x, pos,
          allowed):
    """One decoder layer over x [R, L, H]; allowed [R, L, L] (query,
    key)."""
    R, L, Hd = x.shape
    n = dec["num_attention_heads"]
    dn, dr, dv = dec["qk_nope_head_dim"], dec["qk_rope_head_dim"], \
        dec["v_head_dim"]
    r, eps = dec["kv_lora_rank"], dec["rms_norm_eps"]
    h = rms_norm(x, w[f"{lp}.input_layernorm.weight"], eps)
    a = f"{lp}.self_attn"
    q = (h @ w[f"{a}.q_proj.weight"].float().t()).reshape(R, L, n, dn + dr)
    q = q.transpose(1, 2)                                      # [R,n,L,.]
    ckv = h @ w[f"{a}.kv_a_proj_with_mqa.weight"].float().t()
    c, k_pe = ckv[..., :r], ckv[..., r:]
    c = rms_norm(c, w[f"{a}.kv_a_layernorm.weight"], KV_NORM_EPS)
    kv = (c @ w[f"{a}.kv_b_proj.weight"].float().t()).reshape(
        R, L, n, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    theta = dec["rope_theta"]
    q_pe = rope_pairs(q[..., dn:], pos[:, None], dr, theta)
    k_pe = rope_pairs(k_pe, pos, dr, theta)[:, None]           # [R,1,L,dr]
    scores = (q[..., :dn] @ k_nope.transpose(-1, -2)
              + q_pe @ k_pe.transpose(-1, -2)) * (dn + dr) ** -0.5
    scores = scores.masked_fill(~allowed[:, None], float("-inf"))
    att = (torch.softmax(scores, -1) @ v).transpose(1, 2)
    x = x + att.reshape(R, L, n * dv) @ w[f"{a}.o_proj.weight"].float().t()
    h = rms_norm(x, w[f"{lp}.post_attention_layernorm.weight"], eps)
    m = f"{lp}.mlp"
    if li < dec.get("first_k_dense_replace", 0) or \
            dec.get("n_routed_experts") is None:
        return x + swiglu(h, w[f"{m}.gate_proj.weight"],
                          w[f"{m}.up_proj.weight"], w[f"{m}.down_proj.weight"])
    return x + experts(w, m, dec, h.reshape(R * L, Hd)).reshape(R, L, Hd)


def decoder_logits(w: Dict[str, torch.Tensor], dec: dict, embeds, pos,
                   key_valid, prefix: str = "decoder."):
    """embeds [R, L, H] float32, pos [R, L], key_valid [R, L] bool ->
    logits [R, L, V] (causal, keys masked by key_valid)."""
    R, L, _ = embeds.shape
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    allowed = causal[None] & key_valid[:, None, :]
    x = embeds.float()
    for li in range(dec["num_hidden_layers"]):
        x = layer(w, f"{prefix}model.layers.{li}", li, dec, x, pos, allowed)
    x = rms_norm(x, w[f"{prefix}model.norm.weight"], dec["rms_norm_eps"])
    head = w[f"{prefix}lm_head.weight"] if not dec["tie_word_embeddings"] \
        else w[f"{prefix}model.embed_tokens.weight"]
    return x @ head.float().t()
