"""The yardstick's arithmetic: the card's published peaks, the roofline
bound of a kernel from the bytes and operations its inputs need, and the
operations of a whole served call, all counted from shapes.

`PEAK_OPS`, `HBM_BYTES_S`, `bound` and `attention_ops` are copies of
`chip_smoke.py:305-307`, `:355` and `:439` (NVIDIA's H100 SXM data
sheet, dense rates). A kernel's bytes count each input byte it needs read
once and each output byte written once: the keys and values of the valid
cache slots of each row, not the whole preallocated cache; its operations
count the valid (query, key) pairs. A call's model operations count each
matrix product once at the shapes the call runs (the padded bucket, every
row of every decode step), with no recomputation; the decoder's part is
its family's (`counts/`)."""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12


def bound(n_bytes: float, n_ops: float, kind: str) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_ops(D: int, n_query_key_pairs: float) -> float:
    """q.k and p.v of every (query, head, valid key): 4 D operations."""
    return 4 * D * n_query_key_pairs


# -- lengths ---------------------------------------------------------------
def conv_len(enc: dict, n: int) -> int:
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
    return n


def conv_lens(enc: dict, n: int) -> List[int]:
    out = []
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def adapter_lens(enc: dict, n: int) -> List[int]:
    out = []
    for _ in range(enc["num_adapter_layers"]):
        n = (n - 1) // enc["adapter_stride"] + 1
        out.append(n)
    return out


def head_dim(dec: dict) -> int:
    return dec.get("head_dim") or dec["hidden_size"] // dec[
        "num_attention_heads"]


# -- kernels -----------------------------------------------------------------
def decode_attention_call(dec: dict, n_valid: Sequence[int], T8: int,
                          steps: int, int8: bool) -> Tuple[float, float]:
    """(bytes, operations) of #4 (or, `int8`, #6) over one call's decode
    steps: every layer, every step t = 1..steps, every row with
    1 + n_valid + t valid slots (BOS, its speech frames, its t tokens)."""
    D, Hq, Hkv = head_dim(dec), dec["num_attention_heads"], \
        dec["num_key_value_heads"]
    kv_bytes_per_key = 2 * Hkv * D * (1 if int8 else 2) + \
        (2 * Hkv * 2 if int8 else 0)
    qo_bytes = 2 * Hq * D * 2
    keys = 0
    mask = 0
    for t in range(1, steps + 1):
        keys += sum(1 + n + t for n in n_valid)
        mask += len(n_valid) * (1 + T8 + t)
    rows_steps = len(n_valid) * steps
    L = dec["num_hidden_layers"]
    n_bytes = L * (keys * kv_bytes_per_key + rows_steps * qo_bytes + mask)
    return n_bytes, L * attention_ops(D, Hq * keys)


def flash_attention_call(enc: dict, B: int, T0: int,
                         kv_lens: Sequence[int]) -> Tuple[float, float]:
    """(bytes, operations) of #2 over one encode: every layer reads q, k,
    v [B, T0, E], the bias table [H, T0, T0], the gate [B, H, T0] and the
    key lengths, and writes [B, T0, E]; every query against its row's
    valid keys."""
    E, H = enc["hidden_size"], enc["num_attention_heads"]
    D = E // H
    per_layer = (4 * B * T0 * E * 2 + H * T0 * T0 * 2 + B * H * T0 * 2
                 + 4 * B)
    L = enc["num_hidden_layers"]
    return L * per_layer, L * attention_ops(D, H * T0 * sum(kv_lens))


# -- whole calls --------------------------------------------------------------
def encoder_ops(enc: dict, B: int, S: int, kv_lens: Sequence[int]) -> float:
    """Products of the encoder over B padded rows of S samples: the conv
    stack, the feature projection, the positional conv, the layers
    (projections, attention over the valid keys, feed-forward) and the
    adapter's convs."""
    ops, c_in = 0.0, 1
    Ts = conv_lens(enc, S)
    for T, c_out, k in zip(Ts, enc["conv_dim"], enc["conv_kernel"]):
        ops += 2 * B * T * c_out * c_in * k
        c_in = c_out
    T0, E, F = Ts[-1], enc["hidden_size"], enc["intermediate_size"]
    H = enc["num_attention_heads"]
    ops += 2 * B * T0 * c_in * E
    ops += 2 * B * T0 * E * (E // enc["num_conv_pos_embedding_groups"]) \
        * enc["num_conv_pos_embeddings"]
    per_layer = 2 * B * T0 * (4 * E * E + 2 * E * F + (E // H) * 8)
    ops += enc["num_hidden_layers"] * (
        per_layer + attention_ops(E // H, H * T0 * sum(kv_lens)))
    for T in adapter_lens(enc, T0):
        ops += 2 * B * T * 2 * E * E * enc["adapter_kernel_size"]
    return ops


def decoder_layer_params(dec: dict) -> int:
    Hd, I = dec["hidden_size"], dec["intermediate_size"]
    D, Hq, Hkv = head_dim(dec), dec["num_attention_heads"], \
        dec["num_key_value_heads"]
    return Hd * (Hq + 2 * Hkv) * D + Hq * D * Hd + 3 * Hd * I


def sot_call_ops(enc: dict, dec: dict, n_samples: Sequence[int], S: int,
                 steps: int, int8: bool,
                 family: str = "llama") -> Dict[str, float]:
    """{"bf16": ops, "int8": ops} of one served SOT call: the encoder and
    the projection to the decoder here, and the decoder's part (the
    prefill over [BOS | speech], logits of the last frame only, and
    `steps` decode steps of every row) from the family's count
    (`bench_h100.counts.<family>`); with `int8` the decoder's int8 operations
    apart."""
    B = len(n_samples)
    kv0 = [conv_len(enc, n) for n in n_samples]
    T8 = adapter_lens(enc, conv_len(enc, S))[-1]
    n_valid = [adapter_lens(enc, k)[-1] for k in kv0]
    decoder = importlib.import_module(
        f"bench_h100.counts.{family}").call_ops(dec, n_valid, T8, steps, int8)
    bf16 = encoder_ops(enc, B, S, kv0) + \
        2 * B * T8 * enc["hidden_size"] * dec["hidden_size"]
    return {"bf16": bf16 + decoder["bf16"], "int8": decoder["int8"]}


def ctc_call_ops(enc: dict, sep_hidden: int, talkers: int, vocab: int,
                 n_samples: Sequence[int], S: int) -> Dict[str, float]:
    """{"bf16": ops} of one CTC call: the encoder, the separator (its
    projection, two LSTM layers, the talkers' branches) and the talkers'
    heads over vocab + 1 outputs, all at the padded length."""
    B = len(n_samples)
    T0 = conv_len(enc, S)
    kv0 = [conv_len(enc, n) for n in n_samples]
    E, Hs = enc["hidden_size"], sep_hidden
    ops = encoder_ops(enc, B, S, kv0)
    ops += 2 * B * T0 * E * Hs + 2 * 2 * B * T0 * (2 * Hs) * (4 * Hs)
    ops += talkers * 2 * B * T0 * (Hs * Hs + Hs * E + E * (vocab + 1))
    return {"bf16": ops, "int8": 0.0}


def ideal_seconds(ops: Dict[str, float]) -> float:
    return sum(v / PEAK_OPS[k] for k, v in ops.items())
