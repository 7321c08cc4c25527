"""The LLaMA-family decoder (grouped-query attention, a SwiGLU MLP, no
biases): its model operations in one served SOT call (`counts/__init__.py`
states the contract)."""
from __future__ import annotations

from typing import Dict, Sequence

from bench_h100.roofline import (
    attention_ops, decode_attention_call, decoder_layer_params, head_dim,
)


def call_ops(dec: dict, n_valid: Sequence[int], T8: int, steps: int,
             int8: bool) -> Dict[str, float]:
    B = len(n_valid)
    Hd, V = dec["hidden_size"], dec["vocab_size"]
    D, Hq, Ld = head_dim(dec), dec["num_attention_heads"], \
        dec["num_hidden_layers"]
    W = decoder_layer_params(dec)
    Lp = 1 + T8
    lin = 2 * B * Lp * W * Ld + 2 * B * Hd * V
    pairs = sum(sum(min(i + 1, 1 + n) for i in range(Lp)) for n in n_valid)
    prefill_att = Ld * attention_ops(D, Hq * pairs)
    lin += steps * 2 * B * (Ld * W + Hd * V)
    _, dec_att = decode_attention_call(dec, n_valid, T8, steps, int8)
    if int8:
        return {"bf16": prefill_att, "int8": lin + dec_att}
    return {"bf16": prefill_att + lin + dec_att, "int8": 0.0}
