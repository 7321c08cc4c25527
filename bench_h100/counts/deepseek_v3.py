"""The DeepSeek-V3-family decoder (multi-head latent attention, a sigmoid-
routed mixture of experts with shared experts after dense layers): its
model operations in one served SOT call (`counts/__init__.py` states the
contract).

Per position and layer: the projections q_proj, kv_a_proj_with_mqa and
o_proj; the router (H x E); the experts each token is routed to (top k)
and the shared ones, or the dense SwiGLU in the first
`first_k_dense_replace` layers. Latent attention has two forms of the
published equations, and each phase counts the lesser:

* expanded: kv_b_proj up-projects each key's latent (r x n (dn + dv)),
  then a score is dn + dr wide and a value dv;
* absorbed: W_uk and W_uv act on each query (r x n dn, r x n dv), then a
  score is r + dr wide and a weighted latent r.

At the prefill the two up-projections cost the same (keys and queries are
the same positions) and the expanded scores are narrower; in a decode
step the absorbed form projects one query instead of every cached key."""
from __future__ import annotations

from typing import Dict, Sequence


def _attention(dec: dict, queries: float, keys: float,
               pairs: float) -> float:
    """The lesser form's operations of `queries` queries and `keys` keys a
    head set, with `pairs` valid (query, key) pairs, over the heads."""
    n, r = dec["num_attention_heads"], dec["kv_lora_rank"]
    dn, dr, dv = dec["qk_nope_head_dim"], dec["qk_rope_head_dim"], \
        dec["v_head_dim"]
    up = 2 * r * n * (dn + dv)
    expanded = keys * up + 2 * n * pairs * (dn + dr + dv)
    absorbed = queries * up + 2 * n * pairs * (2 * r + dr)
    return min(expanded, absorbed)


def _token_ops(dec: dict) -> float:
    """Operations of one position through every layer's products but the
    attention (projections, router, experts)."""
    Hd, n, r = dec["hidden_size"], dec["num_attention_heads"], \
        dec["kv_lora_rank"]
    dn, dr, dv = dec["qk_nope_head_dim"], dec["qk_rope_head_dim"], \
        dec["v_head_dim"]
    proj = Hd * n * (dn + dr) + Hd * (r + dr) + n * dv * Hd
    dense = dec["first_k_dense_replace"]
    L = dec["num_hidden_layers"]
    Im = dec["moe_intermediate_size"]
    moe = Hd * dec["n_routed_experts"] + 3 * Hd * Im * (
        dec["num_experts_per_tok"] + dec["n_shared_experts"])
    return 2 * (L * proj + dense * 3 * Hd * dec["intermediate_size"]
                + (L - dense) * moe)


def call_ops(dec: dict, n_valid: Sequence[int], T8: int, steps: int,
             int8: bool) -> Dict[str, float]:
    if int8:
        raise ValueError("the DeepSeek-V3 family is served in bf16 only")
    B = len(n_valid)
    Hd, V, L = dec["hidden_size"], dec["vocab_size"], \
        dec["num_hidden_layers"]
    Lp = 1 + T8
    ops = B * Lp * _token_ops(dec) + 2 * B * Hd * V
    pairs = sum(sum(min(i + 1, 1 + n) for i in range(Lp)) for n in n_valid)
    ops += L * _attention(dec, B * Lp, B * Lp, pairs)
    for t in range(1, steps + 1):
        keys = sum(1 + n + t for n in n_valid)
        ops += B * _token_ops(dec) + 2 * B * Hd * V
        ops += L * _attention(dec, B, keys, keys)
    return {"bf16": float(ops), "int8": 0.0}
