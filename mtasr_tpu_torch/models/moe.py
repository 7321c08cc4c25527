"""A mixture of experts with shared experts (DeepSeek-V3's MoE, as
Moonlight-16B-A3B has it), the MLP of decoder layers `first_k_dense_replace`
on when the config sets `n_routed_experts`. The port's own: the JAX
package has no such decoder. The router is the source's
(`transformers`' `DeepseekV3TopkRouter`, with `n_group` = `topk_group` = 1):

    logits  = gate(h), in float32
    s       = sigmoid(logits)
    experts = the top k of s + e_score_correction_bias (the bias selects
              and never weights)
    weights = s at those experts / (their sum + 1e-20) (`norm_topk_prob`),
              times `routed_scaling_factor`
    y       = sum over the k of weight * Expert_e(h) + Shared(h)

Every expert is a SwiGLU of width `moe_intermediate_size`; the shared
experts are one SwiGLU of `n_shared_experts` times that width
(`llama._mlp`). The routed experts are stored 2-D: `experts.gate_up_proj`
[E * 2I, H] (an expert's gate rows, then its up rows) and
`experts.down_proj` [E * H, I].

Dispatch has shapes that do not depend on the routing, so a decode step
still replays from a CUDA graph with no host read: the T * k (token,
expert) pairs are sorted by expert on the device (stable), the experts'
offsets into the sorted order found by `searchsorted`, and the grouped
kernel (`ops/kernels/moe_experts.py`) reads them from device memory. The
combine gathers each token's k outputs back and sums them, weighted, in
float32: no atomics, so a replay is bit-stable. While spans are kept
(`profiling.tracing`), each layer's per-expert counts, and which experts
had any, are added, in place and inside the graph, to a [layers, 2, E]
device tally (`tally`), which the engine reads at the end of a traced call
(`read_tally`); untraced, the tally costs nothing. A step graph is
captured once a call, so the choice holds for the whole call."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from mtasr_tpu_torch.config import LlamaConfig
from mtasr_tpu_torch.ops.kernels.moe_experts import moe_experts
from mtasr_tpu_torch.utils.profiling import annotate, count, tracing

PAIRS = "mtasr.decoder.moe.pairs"
PAIRS_MAX = "mtasr.decoder.moe.pairs_max"
EXPERTS_READ = "mtasr.decoder.moe.experts_read"


class _Router(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                               cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts))


class _Experts(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        E, H, I = cfg.n_routed_experts, cfg.hidden_size, \
            cfg.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty(E * 2 * I, H))
        self.down_proj = nn.Parameter(torch.empty(E * H, I))


class MoE(nn.Module):
    def __init__(self, cfg: LlamaConfig, shared: nn.Module):
        super().__init__()
        self.gate = _Router(cfg)
        self.experts = _Experts(cfg)
        self.shared_experts = shared


def route(moe: MoE, cfg: LlamaConfig, x: torch.Tensor):
    """x [T, H] -> (top-k experts [T, k] long, their weights [T, k]
    float32)."""
    gate = moe.gate
    s = torch.sigmoid(x.float() @ gate.weight.float().t())
    top = torch.topk(s + gate.e_score_correction_bias.float(),
                     cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, top)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return top, w * cfg.routed_scaling_factor


def dispatch(top: torch.Tensor, n_experts: int):
    """top [T, k] -> (order [T*k]: pair index (t * k + j) of each sorted
    position, rows [T*k] int32: its token, offsets [E + 1] int32: each
    expert's start in the sorted order, counts [E] int32: each expert's
    pairs), all on the device."""
    flat = top.reshape(-1)
    experts, order = torch.sort(flat, stable=True)
    bounds = torch.arange(n_experts + 1, device=flat.device,
                          dtype=experts.dtype)
    offsets = torch.searchsorted(experts, bounds).to(torch.int32)
    rows = torch.div(order, top.shape[1], rounding_mode="floor")
    return (order, rows.to(torch.int32), offsets,
            offsets[1:] - offsets[:-1])


def tally(dec: nn.Module, cfg: LlamaConfig, device) -> torch.Tensor:
    """The decoder's [expert layers, 2, E] int64 tally: [:, 0] the routed
    pairs of each expert, [:, 1] the forwards in which it had any (so its
    weights were read). Made on `device` at first use (outside any graph:
    a traced call's prefill runs first)."""
    t = dec.__dict__.get("_moe_tally")
    if t is None or t.device != torch.device(device):
        n = sum(cfg.moe_layer(i) for i in range(cfg.num_hidden_layers))
        t = torch.zeros((n, 2, cfg.n_routed_experts), dtype=torch.long,
                        device=device)
        dec.__dict__["_moe_tally"] = t
    return t


def reset_tally(dec: nn.Module) -> None:
    """Zero the decoder's tally, if it has one (a traced call's start)."""
    t = dec.__dict__.get("_moe_tally")
    if t is not None:
        t.zero_()


def read_tally(dec: nn.Module) -> Optional[Dict[str, int]]:
    """The tally's numbers since it was last zeroed, added to the counters
    (one host read), and the tally zeroed: `mtasr.decoder.moe.pairs`, the
    routed pairs; `.pairs_max`, the sum over layers of the busiest
    expert's pairs; `.experts_read`, over layers and forwards, the experts
    that had pairs. None for a decoder without experts or before its
    first expert layer ran."""
    t = dec.__dict__.get("_moe_tally")
    if t is None:
        return None
    read = dict(zip((PAIRS, PAIRS_MAX, EXPERTS_READ), (
        int(v) for v in torch.stack([
            t[:, 0].sum(), t[:, 0].max(dim=1).values.sum(),
            t[:, 1].sum()]).tolist())))
    t.zero_()
    for name, n in read.items():
        count(name, n)
    return read


def moe_forward(moe: MoE, cfg: LlamaConfig, x: torch.Tensor, shared_mlp,
                tally_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, L, H] (normed) -> [B, L, H]; `shared_mlp(module, x)` computes
    the shared experts; `tally_row` [2, E], where given, takes this layer's
    counts."""
    if getattr(moe, "tp", None) is not None:
        raise NotImplementedError("experts under tp are not implemented")
    B, L, H = x.shape
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    xt = x.reshape(B * L, H)
    with annotate("mtasr.decoder.moe.route"):
        top, w = route(moe, cfg, xt)
        order, rows, offsets, counts = dispatch(top, E)
        if tally_row is not None:
            tally_row[0].add_(counts)
            tally_row[1].add_(counts > 0)
    with annotate("mtasr.decoder.moe.experts"):
        y = moe_experts(xt, rows, offsets, counts, moe.experts.gate_up_proj,
                        moe.experts.down_proj)                # [T*k, H]
        y = torch.empty_like(y).index_copy_(0, order, y)      # pair order
        out = (y.view(B * L, k, H).float() * w[..., None]).sum(1)
        out = out.to(x.dtype).reshape(B, L, H)
    with annotate("mtasr.decoder.moe.shared"):
        return out + shared_mlp(moe.shared_experts, x)
