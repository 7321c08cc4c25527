"""Per-speaker CTC head (counterpart of `mtasr_tpu/models/ctc_head.py`): a
projection `ctc_lo` to the decoder vocabulary plus the blank
(`odim = vocab + 1`, `blank = odim - 1`) and its loss and inference
helpers. Float32 log-softmax, reduction 'none', zero_infinity; the caller
averages over the batch.

Under tensor parallelism `ctc_lo` may be vocab-parallel (`parallel/mesh.py`:
only when vocab + 1 divides by tp; LLaMA-3's 128265 does not): its logits
are gathered after the product, and the fused loss, which takes the
weight itself, gets the gathered weight and bias, so #11 / #12, the
separator, PIT and the bridges read full widths as in one process.
"""
from __future__ import annotations

import torch
from torch import nn

from mtasr_tpu_torch.models.layers import linear
from mtasr_tpu_torch.ops.ctc_fused import ctc_loss_from_hidden
from mtasr_tpu_torch.parallel.collectives import copy_to_tp, gather_from_tp


class CTCHead(nn.Module):
    def __init__(self, encoder_output_size: int, odim: int):
        super().__init__()
        self.ctc_lo = nn.Linear(encoder_output_size, odim)


def ctc_logits(head: CTCHead, hs: torch.Tensor) -> torch.Tensor:
    tp = getattr(head.ctc_lo, "tp", None)
    if tp is None:
        return linear(head.ctc_lo, hs)
    return gather_from_tp(linear(head.ctc_lo, copy_to_tp(hs, tp)), tp)


def ctc_log_softmax(head: CTCHead, hs: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(ctc_logits(head, hs).float(), dim=-1)


def ctc_argmax(head: CTCHead, hs: torch.Tensor) -> torch.Tensor:
    return ctc_logits(head, hs).argmax(-1)


def ctc_head_loss(head: CTCHead, hs: torch.Tensor, hlens: torch.Tensor,
                  ys: torch.Tensor, ylens: torch.Tensor, blank_id: int,
                  detach_head: bool = False) -> torch.Tensor:
    """Per-sample loss [B] of hs [B, T, D] against ys [B, L] (lengths
    hlens, ylens), through the time-chunked path that never builds
    [B, T, V] (`ops/ctc_fused.py`; the JAX default `fused=True`);
    `detach_head` holds the head's parameters constant (no gradient is
    computed for them)."""
    w, b = head.ctc_lo.weight, head.ctc_lo.bias
    tp = getattr(head.ctc_lo, "tp", None)
    if tp is not None:
        w, b = gather_from_tp(w, tp, 0), gather_from_tp(b, tp, 0)
    if detach_head:
        w, b = w.detach(), b.detach()
    return ctc_loss_from_hidden(hs, w, b, hlens, ys, ylens, blank_id)
