"""Training losses (counterpart of `mtasr_tpu/models/losses.py`): the
cross-entropy of the teacher-forced decoder, the serialized CTC of the K
separated streams (fixed assignment or PIT), and the hybrid
alpha * CE + (1 - alpha) * CTC.

Within a data-parallel step (`parallel/collectives.py::dp_reduction`)
every denominator is the global batch's: the valid tokens of all ranks,
the rows of all ranks. One process divides by its own.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mtasr_tpu_torch.models.ctc_head import CTCHead, ctc_head_loss
from mtasr_tpu_torch.parallel.collectives import (
    batch_mean, dp_active, global_batch, global_count,
)


def build_perm(n: int, mode: Optional[str], step: int = 0,
               rotate_every: int = 100) -> List[int]:
    """Fixed-permutation policy of heads onto label streams."""
    if mode is None:
        return list(range(n))
    if mode == "swap01":
        p = list(range(n))
        p[0], p[1] = p[1], p[0]
        return p
    if mode == "reverse":
        return list(reversed(range(n)))
    if mode == "rotate":
        k = (step // max(1, rotate_every)) % n
        base = list(range(n))
        return base[k:] + base[:k]
    raise ValueError(f"Unknown perm_mode: {mode}")


def batch_swap_stats(best_perm: torch.Tensor):
    """PIT diagnostics: (samples with a non-identity assignment, batch
    size, their share). best_perm [B, K]."""
    B, K = best_perm.shape
    ident = torch.arange(K, device=best_perm.device)[None]
    cnt = (~(best_perm == ident).all(1)).sum()
    return cnt, B, cnt / max(global_batch(B), 1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -100) -> torch.Tensor:
    """Mean cross-entropy over the labels that are not `ignore_id`, the
    log-softmax in float32 (`losses.py:58-68`); 0 when every label is
    ignored."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / global_count(valid.sum()).clamp_min(1)


def serialized_ctc_loss(heads: Sequence[CTCHead],
                        sep_hidden: Sequence[torch.Tensor],
                        hlens: torch.Tensor, label_spks: torch.Tensor,
                        label_spk_lens: torch.Tensor, blank_id: int,
                        perm: Optional[Sequence[int]] = None,
                        detach_heads: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head i against label stream perm[i], on sep_hidden[i] in float32.
    Returns (mean loss, per-head [K, B])."""
    K = len(heads)
    perm = list(range(K)) if perm is None else perm
    per_head = torch.stack([
        ctc_head_loss(heads[i], sep_hidden[i].float(), hlens,
                      label_spks[perm[i]], label_spk_lens[perm[i]], blank_id,
                      detach_head=detach_heads)
        for i in range(K)])
    return batch_mean(per_head, 1).mean(), per_head


def pit_ctc_loss(heads: Sequence[CTCHead],
                 sep_hidden: Sequence[torch.Tensor], hlens: torch.Tensor,
                 label_spks: torch.Tensor, label_spk_lens: torch.Tensor,
                 blank_id: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Permutation-invariant CTC: every head against every stream, each
    sample takes the assignment of least total loss. Returns (mean loss,
    assigned per-head [K, B], best_perm [B, K])."""
    K = len(heads)
    pair = torch.stack([torch.stack([
        ctc_head_loss(heads[i], sep_hidden[i].float(), hlens, label_spks[j],
                      label_spk_lens[j], blank_id) for j in range(K)])
        for i in range(K)])                                   # [K, K, B]
    perms = torch.tensor(list(itertools.permutations(range(K))),
                         device=pair.device)                  # [P, K]
    head_idx = torch.arange(K, device=pair.device)[None]
    perm_losses = pair[head_idx, perms, :].sum(1)             # [P, B]
    best_perm = perms[perm_losses.argmin(0)]                  # [B, K]
    assigned = pair.permute(2, 0, 1).gather(
        2, best_perm[:, :, None])[..., 0].t()                 # [K, B]
    loss = batch_mean(assigned, 1).mean() if dp_active() \
        else assigned.mean()
    return loss, assigned, best_perm


def hybrid_loss(mode: str, alpha: float, *,
                logits: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, ignore_id: int = -100,
                heads: Optional[Sequence[CTCHead]] = None,
                sep_hidden: Optional[Sequence[torch.Tensor]] = None,
                hlens: Optional[torch.Tensor] = None,
                label_spks: Optional[torch.Tensor] = None,
                label_spk_lens: Optional[torch.Tensor] = None,
                blank_id: Optional[int] = None, use_pit: bool = False,
                perm: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, aux). "attention": the cross-entropy; "ctc": the
    serialized (or PIT) CTC; "hybrid": alpha * CE + (1 - alpha) * CTC.
    aux holds loss_attn, loss_ctc, ctc_per_head [K, B] and with PIT
    best_perm and pit_swap_ratio."""
    aux: Dict[str, torch.Tensor] = {}
    loss_attn = loss_ctc = None
    if mode in ("attention", "hybrid"):
        loss_attn = cross_entropy_loss(logits, labels, ignore_id)
        aux["loss_attn"] = loss_attn
    if mode in ("ctc", "hybrid"):
        if use_pit:
            loss_ctc, per_head, best_perm = pit_ctc_loss(
                heads, sep_hidden, hlens, label_spks, label_spk_lens,
                blank_id)
            aux["best_perm"] = best_perm
            aux["pit_swap_ratio"] = batch_swap_stats(best_perm)[2]
        else:
            loss_ctc, per_head = serialized_ctc_loss(
                heads, sep_hidden, hlens, label_spks, label_spk_lens,
                blank_id, perm)
        aux["loss_ctc"] = loss_ctc
        aux["ctc_per_head"] = per_head
    if mode == "attention":
        return loss_attn, aux
    if mode == "ctc":
        return loss_ctc, aux
    if mode != "hybrid":
        raise ValueError(f"train_mode={mode!r} not in ctc/attention/hybrid")
    return alpha * loss_attn + (1.0 - alpha) * loss_ctc, aux
