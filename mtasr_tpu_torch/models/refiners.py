"""The per-speaker extractor behind the `softmax` CTC bridge (counterpart of
the live part of `mtasr_tpu/models/refiners.py`): soft per-frame speaker
routing of the mixed 50 Hz features by the CTC heads' non-blank
posteriors, a speaker tag a stream, a band-masked cross-attention repair
against the unrouted features, and the K streams concatenated along time.

`mha` keeps torch `nn.MultiheadAttention`'s packed `in_proj_weight` /
`in_proj_bias` layout and computes its scores in float32; masked scores
get -1e30. The band mask |i - j| <= band is closed-form.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mtasr_tpu_torch.models.layers import gelu, layer_norm, linear


def resample_to_len_1d(x_bt: torch.Tensor, t_target: int) -> torch.Tensor:
    """[B, T] -> [B, t_target] with `F.interpolate`'s nearest semantics:
    floor(i * T / t_target), the positions in float32."""
    T = x_bt.shape[1]
    if T == t_target:
        return x_bt
    i = torch.arange(t_target, dtype=torch.float32, device=x_bt.device)
    idx = torch.floor(i * (T / t_target)).long().clamp(0, T - 1)
    return x_bt[:, idx]


def nonblank_from_logits(logits_btv: torch.Tensor,
                         blank_id: int) -> torch.Tensor:
    """1 - P(blank) per frame, from a float32 softmax."""
    return 1.0 - torch.softmax(logits_btv.float(), dim=-1)[..., blank_id]


class MHA(nn.Module):
    """`nn.MultiheadAttention`'s parameters: packed q/k/v in_proj and the
    output projection."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


def mha(p: MHA, q_in: torch.Tensor, kv_in: torch.Tensor, n_heads: int,
        attn_mask: torch.Tensor) -> torch.Tensor:
    """`F.multi_head_attention_forward` (self or cross); attn_mask bool
    (True = keep), broadcastable to [B, H, T, S]."""
    B, T, E = q_in.shape
    S = kv_in.shape[1]
    D = E // n_heads
    w_q, w_k, w_v = p.in_proj_weight.to(q_in.dtype).chunk(3, dim=0)
    b_q, b_k, b_v = p.in_proj_bias.to(q_in.dtype).chunk(3, dim=0)
    q = (q_in @ w_q.t() + b_q).reshape(B, T, n_heads, D)
    k = (kv_in @ w_k.t() + b_k).reshape(B, S, n_heads, D)
    v = (kv_in @ w_v.t() + b_v).reshape(B, S, n_heads, D)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        * (D ** -0.5)
    logits = torch.where(attn_mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q_in.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, E)
    return linear(p.out_proj, out)


def band_mask(T: int, S: int, band: int, device=None) -> torch.Tensor:
    """[T, S] bool, True where |i - j| <= band (keep)."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    return (i - j).abs() <= band


class CrossRepair(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.ln_q = nn.LayerNorm(d_model)
        self.ln_kv = nn.LayerNorm(d_model)
        self.attn = MHA(d_model)
        self.ffn = nn.ModuleDict({"0": nn.LayerNorm(d_model),
                                  "1": nn.Linear(d_model, 4 * d_model),
                                  "3": nn.Linear(4 * d_model, d_model)})


def cross_repair(p: CrossRepair, x_refined: torch.Tensor,
                 x_mem: torch.Tensor, n_heads: int,
                 band: int) -> torch.Tensor:
    """Band-masked cross-attention of x_refined onto x_mem, then a
    pre-norm GELU feed-forward, each with its residual."""
    q = layer_norm(p.ln_q, x_refined)
    kv = layer_norm(p.ln_kv, x_mem)
    m = band_mask(x_refined.shape[1], x_mem.shape[1], band,
                  x_refined.device)[None, None]
    y = x_refined + mha(p.attn, q, kv, n_heads, m)
    h = layer_norm(p.ffn["0"], y)
    return y + linear(p.ffn["3"], gelu(linear(p.ffn["1"], h)))


class ExtractorConcat(nn.Module):
    """`init_extractor_concat` with the repair and no stream LayerNorm, as
    the composite builds it for the softmax bridge."""

    def __init__(self, d_in: int, d_model: int, k_spk: int):
        super().__init__()
        self.proj_in = nn.Linear(d_in, d_model)
        self.spk_tags = nn.Parameter(torch.zeros(k_spk, d_model))
        self.repair = CrossRepair(d_model)


def extractor_concat_softmax(p: ExtractorConcat, x_m: torch.Tensor,
                             blank_id: int,
                             logits_list: Sequence[torch.Tensor], k_spk: int,
                             n_heads: int = 8,
                             band_repair: int = 24) -> torch.Tensor:
    """x_m [B, Tm, d_in] -> [B, K * Tm, d_model]: stream k is the projected
    features weighted by the softmax over the K heads' non-blank
    posteriors (the logits held constant), plus tag k, repaired against
    the unweighted projection."""
    Tm = x_m.shape[1]
    X = linear(p.proj_in, x_m)
    A = [resample_to_len_1d(nonblank_from_logits(lg.detach(), blank_id), Tm)
         for lg in logits_list]
    W = torch.softmax(torch.stack(A, dim=-1), dim=-1).to(X.dtype)
    streams = []
    for k in range(k_spk):
        Xk = X * W[..., k:k + 1] + p.spk_tags[k][None, None].to(X.dtype)
        streams.append(cross_repair(p.repair, Xk, X, n_heads, band_repair))
    return torch.cat(streams, dim=1)
