"""The sparse-slot CTC bridge (counterpart of
`mtasr_tpu/models/sparse_slot.py`): spikes of a CTC head's non-blank
posterior, the top k kept, Gaussian pooling of the CTC-rate features
around each into a slot, and the mixed features cross-attending to the
slots.

No config wires it, in the JAX package or here: it is the library function
the JAX module offers. The greedy spike scan runs over time with a
min-distance rule and a three-point local maximum (the reference's policy);
the top-k prune sorts stably, so that equal scores keep the lower index
first, as `lax.top_k` does. Slots are padded to a static count and masked.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtasr_tpu_torch.models.layers import layer_norm, linear
from mtasr_tpu_torch.models.refiners import MHA, mha


def find_spikes(A: torch.Tensor, thresh: float = 0.6, min_dist: int = 4,
                max_spikes: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """A [B, T] -> (spike positions [B, min(T, max_spikes)], left-packed
    and padded with -1; their count [B], at most max_spikes). Left to
    right, a frame is taken where A >= thresh, A is a local maximum of its
    three frames, and the last spike is min_dist or more frames back."""
    B, T = A.shape
    left = F.pad(A, (1, 0), value=-1.0)[:, :T]
    right = F.pad(A, (0, 1), value=-1.0)[:, 1:]
    local_max = (A >= left) & (A >= right) & (A >= thresh)
    last = torch.full((B,), -min_dist - 1, dtype=torch.long, device=A.device)
    taken = torch.zeros((B, T), dtype=torch.bool, device=A.device)
    for t in range(T):
        take = local_max[:, t] & ((t - last) >= min_dist)
        last = torch.where(take, t, last)
        taken[:, t] = take
    order = torch.argsort((~taken).to(torch.int8), dim=1, stable=True)
    pos = torch.where(taken.gather(1, order), order, -1)
    count = taken.sum(1).clamp_max(max_spikes)
    return pos[:, :max_spikes], count


def prune_spikes_topk(A: torch.Tensor, spikes: torch.Tensor, k: int,
                      r: int = 8) -> torch.Tensor:
    """The k spikes with the highest mean A over their +-r frames,
    [B, S] -> [B, k] padded with -1."""
    T = A.shape[1]
    csum = F.pad(torch.cumsum(A, dim=1), (1, 0))
    pos = spikes.clamp(0, T - 1)
    lo = (pos - r).clamp(0, T)
    hi = (pos + r + 1).clamp(0, T)
    local_mean = (csum.gather(1, hi) - csum.gather(1, lo)) / \
        (hi - lo).clamp_min(1)
    scores = torch.where(spikes >= 0, local_mean, -1e9)
    k_eff = min(k, spikes.shape[1])
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k_eff], top_idx[:, :k_eff]
    out = torch.where(top_scores > -1e8, spikes.gather(1, top_idx), -1)
    return F.pad(out, (0, k - k_eff), value=-1)


def spike_pool_gaussian(h: torch.Tensor, spikes: torch.Tensor, r: int = 8,
                        sigma: float = 4.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [B, T, D], spikes [B, S] -> (Z [B, S, D], valid [B, S]): each slot
    the mean of the frames within r of its spike, weighted by a Gaussian
    of width sigma; an invalid slot (-1) pools to zero."""
    T = h.shape[1]
    t = torch.arange(T, device=h.device)[None, None, :]
    c = spikes[:, :, None].float()
    w = torch.exp(-0.5 * ((t - c) / sigma) ** 2)
    w = torch.where((t - c).abs() <= r, w, 0.0)
    valid = spikes >= 0
    w = w * valid[:, :, None]
    w = w / w.sum(2, keepdim=True).clamp_min(1e-6)
    return torch.einsum("bst,btd->bsd", w.to(h.dtype), h), valid


class SparseSlotBridge(nn.Module):
    """`init_sparse_slot_params`: the slot projection and positions, the
    fusion attention and the norms. Without a generator the parameters
    are allocated for a load; with one they take the JAX init's
    distributions (uniform fan-in linears, slot positions ~ N(0, 1 /
    d_model), Xavier-uniform packed in_proj, norms at 1 / 0)."""

    def __init__(self, d_ctc: int, d_model: int, max_slots: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj_slot = nn.Linear(d_ctc, d_model)
        self.slot_pos = nn.Parameter(torch.zeros(max_slots, d_model))
        self.ln_slot = nn.LayerNorm(d_model)
        self.fuse_attn = MHA(d_model)
        self.ln_out = nn.LayerNorm(d_model)
        self.out_mlp = nn.Linear(d_model, d_model)
        if generator is not None:
            self._init(generator)

    @torch.no_grad()
    def _init(self, g: torch.Generator) -> None:
        d = self.slot_pos.shape[1]
        for lin in (self.proj_slot, self.fuse_attn.out_proj, self.out_mlp):
            bound = 1.0 / math.sqrt(lin.in_features)
            for t in (lin.weight, lin.bias):
                t.uniform_(-bound, bound, generator=g)
        self.slot_pos.normal_(generator=g).mul_(d ** -0.5)
        bound = math.sqrt(3.0 / d)
        self.fuse_attn.in_proj_weight.uniform_(-bound, bound, generator=g)
        self.fuse_attn.in_proj_bias.zero_()


def sparse_slot_bridge(p: SparseSlotBridge, x_m: torch.Tensor,
                       h_ctc: torch.Tensor, A: torch.Tensor, *,
                       n_heads: int = 8, thresh: float = 0.6,
                       min_dist: int = 4, top_k: int = 32, radius: int = 8,
                       sigma: float = 4.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_m [B, Tm, d_model] mixed features, h_ctc [B, T, d_ctc] CTC-rate
    features, A [B, T] their non-blank posterior -> (fused [B, Tm,
    d_model], slot_valid [B, min(top_k, max_slots)]): the mixed features
    attend to the pooled slots (the valid ones), LayerNorm, then a
    residual linear."""
    max_slots = p.slot_pos.shape[0]
    spikes, _ = find_spikes(A, thresh, min_dist, max_spikes=max_slots)
    spikes = prune_spikes_topk(A, spikes, k=min(top_k, max_slots), r=radius)
    Z, valid = spike_pool_gaussian(h_ctc, spikes, r=radius, sigma=sigma)
    slots = linear(p.proj_slot, Z)
    slots = slots + p.slot_pos[:slots.shape[1]][None].to(slots.dtype)
    slots = layer_norm(p.ln_slot, slots)
    y = mha(p.fuse_attn, x_m, slots, n_heads, valid[:, None, None, :])
    out = layer_norm(p.ln_out, x_m + y)
    return out + linear(p.out_mlp, out), valid
