"""The CTC-guided refiners and the per-speaker extractors (counterpart of
`mtasr_tpu/models/refiners.py`).

The live part is the extractor behind the `softmax` CTC bridge: soft
per-frame speaker routing of the mixed 50 Hz features by the CTC heads'
non-blank posteriors, a speaker tag a stream, a band-masked cross-attention
repair against the unrouted features, and the K streams concatenated along
time. No config wires the rest, in the JAX package or here; it is ported
as the library the JAX module offers: the guidance signals (non-blank
posterior, entropy, resampled to a length), the continuous refiner's
blocks (CTC-guided low-pass blend, band-masked self-attention, soft speaker
router) with `continuous_refiner` / `ctc_guided_refiner`, the sigmoid-gated
extractor (`extractor_concat_nng`) and the frame-guided one
(`extractor_concat_frame_guided`).

`mha` keeps torch `nn.MultiheadAttention`'s packed `in_proj_weight` /
`in_proj_bias` layout and computes its scores in float32; masked scores
get -1e30. The band mask |i - j| <= band is closed-form. Parameter names
are the JAX trees'.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtasr_tpu_torch.models.layers import gelu, layer_norm, linear


def resample_to_len_1d(x_bt: torch.Tensor, t_target: int,
                       mode: str = "nearest") -> torch.Tensor:
    """[B, T] -> [B, t_target] with `F.interpolate`'s semantics, the
    positions in float32: nearest, floor(i * T / t_target); linear,
    align_corners=False."""
    T = x_bt.shape[1]
    if T == t_target:
        return x_bt
    i = torch.arange(t_target, dtype=torch.float32, device=x_bt.device)
    if mode == "nearest":
        idx = torch.floor(i * (T / t_target)).long().clamp(0, T - 1)
        return x_bt[:, idx]
    if mode != "linear":
        raise ValueError(f"resample mode {mode!r}: nearest or linear")
    pos = (i + 0.5) * (T / t_target) - 0.5
    lo = torch.floor(pos).long().clamp(0, T - 1)
    hi = (lo + 1).clamp(0, T - 1)
    w = (pos - lo).clamp(0.0, 1.0)
    return x_bt[:, lo] * (1 - w) + x_bt[:, hi] * w


def entropy_from_logits(logits_btv: torch.Tensor) -> torch.Tensor:
    """The entropy of each frame's float32 softmax."""
    logp = torch.log_softmax(logits_btv.float(), dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)


def nonblank_from_logits(logits_btv: torch.Tensor,
                         blank_id: int) -> torch.Tensor:
    """1 - P(blank) per frame, from a float32 softmax."""
    return 1.0 - torch.softmax(logits_btv.float(), dim=-1)[..., blank_id]


def build_guidance_from_ctc_logits(
        logits_list: Sequence[torch.Tensor], blank_id: int, t_target: int,
        resample_mode: str = "nearest", aggregate: str = "max"
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor,
           torch.Tensor]:
    """Each head's non-blank posterior A and entropy H at t_target frames,
    and the global A (the heads' max, or mean, clipped to [0, 1]) and H
    (their mean)."""
    A_list = [resample_to_len_1d(nonblank_from_logits(lg, blank_id),
                                 t_target, resample_mode)
              for lg in logits_list]
    H_list = [resample_to_len_1d(entropy_from_logits(lg), t_target,
                                 resample_mode) for lg in logits_list]
    A_stack = torch.stack(A_list, -1)
    A_global = (A_stack.amax(-1) if aggregate == "max"
                else A_stack.mean(-1)).clamp(0.0, 1.0)
    return A_list, H_list, A_global, torch.stack(H_list, -1).mean(-1)


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
    """`init_extractor_concat`: by default with the repair and no stream
    LayerNorm, as the composite builds it for the softmax bridge."""

    def __init__(self, d_in: int, d_model: int, k_spk: int,
                 use_repair: bool = True, use_stream_ln: bool = False):
        super().__init__()
        self.proj_in = nn.Linear(d_in, d_model)
        self.spk_tags = nn.Parameter(torch.zeros(k_spk, d_model))
        if use_repair:
            self.repair = CrossRepair(d_model)
        if use_stream_ln:
            self.ln_stream = nn.LayerNorm(d_model)


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
        if hasattr(p, "repair"):
            Xk = cross_repair(p.repair, Xk, X, n_heads, band_repair)
        streams.append(Xk)
    return torch.cat(streams, dim=1)


def extractor_concat_nng(p: ExtractorConcat, x_m: torch.Tensor,
                         blank_id: int, logits_list: Sequence[torch.Tensor],
                         k_spk: int, n_heads: int = 8, band_repair: int = 24,
                         resample_mode: str = "nearest",
                         route_alpha: float = 6.0,
                         route_beta: float = 0.5) -> torch.Tensor:
    """The sigmoid-gated extractor: stream k weighted by sigmoid(alpha *
    (A_k - beta)), not normalised over the heads (speakers may overlap),
    then repaired, tagged and, with `ln_stream`, normalised."""
    Tm = x_m.shape[1]
    X = linear(p.proj_in, x_m)
    A = torch.stack([resample_to_len_1d(
        nonblank_from_logits(lg.detach(), blank_id), Tm, resample_mode)
        for lg in logits_list], dim=-1)
    W = torch.sigmoid(route_alpha * (A - route_beta)).to(X.dtype)
    streams = []
    for k in range(k_spk):
        Xk = X * W[..., k:k + 1]
        if hasattr(p, "repair"):
            Xk = cross_repair(p.repair, Xk, X, n_heads, band_repair)
        Xk = Xk + p.spk_tags[k][None, None].to(X.dtype)
        if hasattr(p, "ln_stream"):
            Xk = layer_norm(p.ln_stream, Xk)
        streams.append(Xk)
    return torch.cat(streams, dim=1)


# ---------------------------------------------------------------------------
# the continuous refiner and its blocks
# ---------------------------------------------------------------------------
class DynamicLPF(nn.Module):
    """A depthwise low-pass conv (`dw`, [C, 1, k]) and the generator of its
    blend coefficients from (A, H)."""

    def __init__(self, d_in: int, k: int = 9):
        super().__init__()
        self.gen = nn.ModuleDict({"0": nn.Linear(2, d_in),
                                  "2": nn.Linear(d_in, k)})
        self.dw = nn.Conv1d(d_in, d_in, k, groups=d_in, bias=False)


def dynamic_lpf(p: DynamicLPF, x: torch.Tensor, A: torch.Tensor,
                H: torch.Tensor) -> torch.Tensor:
    """center * x + (1 - center) * lowpass(x): `center` is the middle tap
    of a softmax over k coefficients generated per frame from (A, H)."""
    k = p.dw.weight.shape[-1]
    coeff = torch.softmax(linear(p.gen["2"], F.silu(linear(
        p.gen["0"], torch.stack([A, H], -1).to(x.dtype)))), dim=-1)
    y = F.conv1d(x.transpose(1, 2), p.dw.weight.to(x.dtype),
                 padding=k // 2, groups=x.shape[-1]).transpose(1, 2)
    center = coeff[..., k // 2][..., None]
    return center * x + (1 - center) * y


class LocalSelfAttn(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.ln = nn.LayerNorm(d_model)
        self.attn = MHA(d_model)


def local_self_attn(p: LocalSelfAttn, x: torch.Tensor, n_heads: int,
                    band: int) -> torch.Tensor:
    """Pre-norm self-attention within |i - j| <= band, with its residual."""
    qkv = layer_norm(p.ln, x)
    m = band_mask(x.shape[1], x.shape[1], band, x.device)[None, None]
    return x + mha(p.attn, qkv, qkv, n_heads, m)


class SoftRouter(nn.Module):
    def __init__(self, d_model: int, k_spk: int):
        super().__init__()
        self.mix = nn.Linear(k_spk, 1)
        self.proj = nn.Linear(d_model, d_model)


def soft_router(p: SoftRouter, x: torch.Tensor,
                A_list: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
    """x scaled per frame by 0.5 + 0.5 * sigmoid(mix(softmax over the
    heads' A)), then projected; x itself without guidance."""
    if not A_list:
        return x
    w = torch.softmax(torch.stack(list(A_list), -1).to(x.dtype), dim=-1)
    g = torch.sigmoid(linear(p.mix, w))[..., 0]
    return linear(p.proj, x * (0.5 + 0.5 * g[..., None]))


class _RefinerBlock(nn.Module):
    def __init__(self, d_model: int, k_spk: int):
        super().__init__()
        self.lpf = DynamicLPF(d_model)
        self.lsa = LocalSelfAttn(d_model)
        self.repair = CrossRepair(d_model)
        if k_spk > 0:
            self.router = SoftRouter(d_model, k_spk)


class ContinuousRefiner(nn.Module):
    """`init_continuous_refiner`: the input projection, n_layers blocks
    (low-pass blend, local self-attention, the router with K_spk > 0, the
    repair) and the output LayerNorm."""

    def __init__(self, d_in: int, d_model: int, n_layers: int = 2,
                 k_spk: int = 0):
        super().__init__()
        self.inp = nn.Linear(d_in, d_model)
        self.blocks = nn.ModuleDict({str(i): _RefinerBlock(d_model, k_spk)
                                     for i in range(n_layers)})
        self.out_ln = nn.LayerNorm(d_model)


def continuous_refiner(p: ContinuousRefiner, x_m: torch.Tensor,
                       A_global: Optional[torch.Tensor],
                       H_global: Optional[torch.Tensor],
                       A_list: Optional[Sequence[torch.Tensor]] = None,
                       n_heads: int = 8, band_local: int = 16,
                       band_repair: int = 24) -> torch.Tensor:
    """x_m [B, T, d_in] -> [B, T, d_model], guided by A / H [B, T] (zeros
    when absent; H defaults to A), the blocks repairing against the
    projected input."""
    B, T, _ = x_m.shape
    if A_global is None:
        A_global = torch.zeros((B, T), dtype=x_m.dtype, device=x_m.device)
    if H_global is None:
        H_global = A_global
    y = linear(p.inp, x_m)
    mem = linear(p.inp, x_m)
    for i in range(len(p.blocks)):
        blk = p.blocks[str(i)]
        y = y + dynamic_lpf(blk.lpf, y, A_global, H_global)
        y = local_self_attn(blk.lsa, y, n_heads, band_local)
        if hasattr(blk, "router"):
            y = soft_router(blk.router, y, A_list)
        y = cross_repair(blk.repair, y, mem, n_heads, band_repair)
    return layer_norm(p.out_ln, y)


def ctc_guided_refiner(p: ContinuousRefiner, x_m: torch.Tensor,
                       blank_id: int, logits_list: Sequence[torch.Tensor],
                       aggregate: str = "max",
                       resample_mode: str = "nearest", **kw) -> torch.Tensor:
    """`continuous_refiner` guided by the CTC heads' logits (held
    constant)."""
    A_list, _, A_global, H_global = build_guidance_from_ctc_logits(
        [lg.detach() for lg in logits_list], blank_id, x_m.shape[1],
        resample_mode, aggregate)
    return continuous_refiner(p, x_m, A_global, H_global, A_list, **kw)


# ---------------------------------------------------------------------------
# the frame-guided per-speaker extractor
# ---------------------------------------------------------------------------
class ExtractorFrameGuided(nn.Module):
    """`init_extractor_frame_guided`: projections of the mixed and the
    separated features, the speaker tags, the fusion (one linear, or an
    MLP of `fuse_hidden`), a LayerNorm and a feed-forward."""

    def __init__(self, d_in_m: int, d_in_s: int, d_model: int, k_spk: int,
                 fuse_hidden: int = 0):
        super().__init__()
        self.proj_m = nn.Linear(d_in_m, d_model)
        self.proj_s = nn.Linear(d_in_s, d_model)
        self.spk_tags = nn.Parameter(torch.zeros(k_spk, d_model))
        self.ln = nn.LayerNorm(d_model)
        self.ffn = nn.ModuleDict({"0": nn.Linear(d_model, 4 * d_model),
                                  "2": nn.Linear(4 * d_model, d_model)})
        self.fuse = nn.ModuleDict(
            {"0": nn.Linear(2 * d_model, fuse_hidden),
             "3": nn.Linear(fuse_hidden, d_model)} if fuse_hidden > 0
            else {"0": nn.Linear(2 * d_model, d_model)})


def _smooth_mean_1d(A: torch.Tensor, win: int) -> torch.Tensor:
    """A moving mean of `win` frames over [B, T], the edges repeated."""
    if win <= 1:
        return A
    pad = (win - 1) // 2
    x = F.pad(A[:, None], (pad, pad), mode="replicate")
    kernel = torch.full((1, 1, win), 1.0 / win, dtype=A.dtype,
                        device=A.device)
    return F.conv1d(x, kernel)[:, 0]


def _resample_time_nd(x: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T0, D] -> [B, T, D], linear (align_corners=False)."""
    B, T0, D = x.shape
    flat = x.transpose(1, 2).reshape(B * D, T0)
    out = resample_to_len_1d(flat, T, mode="linear")
    return out.reshape(B, D, T).transpose(1, 2)


def extractor_concat_frame_guided(
    p: ExtractorFrameGuided, x_m: torch.Tensor, blank_id: int,
    sep_hidden_list: Sequence[torch.Tensor],
    logits_list: Sequence[torch.Tensor], *, smooth_win: int = 3,
    entropy_lambda: float = 0.0, prob_floor: float = 0.0,
    gate_mode: str = "pow", gate_gamma: float = 1.0, gate_cap: float = 1.25,
    tag_scale: float = 1.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_m [B, Tm, d_in_m], K separated streams [B, Tk, d_in_s] and their
    heads' logits [B, Tk, V] -> ([B, K * Tm, d_model], an all-True mask):
    per speaker, frame gates from 1 - P(blank) (down-weighted by entropy,
    floored, smoothed, resampled to Tm), the mixed and the resampled
    separated features fused frame by frame and blended in by
    sigmoid(gate), the tag, then LayerNorm and a residual feed-forward."""
    B, Tm, _ = x_m.shape
    X = linear(p.proj_m, x_m)
    streams = []
    for k in range(len(sep_hidden_list)):
        lg = logits_list[k].detach()
        A = nonblank_from_logits(lg, blank_id)
        if entropy_lambda > 0:
            A = A * torch.sigmoid(-entropy_lambda * entropy_from_logits(lg))
        if prob_floor > 0:
            A = A * (A >= prob_floor)
        A = resample_to_len_1d(_smooth_mean_1d(A, smooth_win), Tm,
                               mode="linear")
        if gate_mode == "pow":
            w = (A.clamp_min(0.0) ** gate_gamma).clamp_max(gate_cap)
        else:
            w = gate_cap * torch.sigmoid(gate_gamma * (A - 0.5))
        Hk = _resample_time_nd(
            linear(p.proj_s, sep_hidden_list[k].to(x_m.dtype)), Tm)
        fused_in = torch.cat([X, Hk], dim=-1)
        if "3" in p.fuse:
            Yk = linear(p.fuse["3"], gelu(linear(p.fuse["0"], fused_in)))
        else:
            Yk = linear(p.fuse["0"], fused_in)
        s = torch.sigmoid(w)[..., None].to(X.dtype)
        Xk = (1.0 - s) * X + s * Yk
        Xk = Xk + tag_scale * p.spk_tags[k][None, None].to(X.dtype)
        Xk = layer_norm(p.ln, Xk)
        Xk = Xk + linear(p.ffn["2"], gelu(linear(p.ffn["0"], Xk)))
        streams.append(Xk)
    return torch.cat(streams, dim=1), torch.ones(
        (B, len(sep_hidden_list) * Tm), dtype=torch.bool, device=x_m.device)
