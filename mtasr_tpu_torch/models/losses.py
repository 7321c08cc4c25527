"""Training losses (counterpart of `mtasr_tpu/models/losses.py`), attention
mode: the cross-entropy of the teacher-forced decoder. The serialized CTC
of the ctc and hybrid modes comes with the separator and the CTC heads
(ROADMAP.md queue 1, item 11b).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

HYBRID_TODO = ("train_mode ctc / hybrid (serialized CTC, PIT, the separator "
               "and the CTC heads) is not ported yet (ROADMAP.md queue 1, "
               "item 11b: hybrid training)")


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
    return nll.sum() / valid.sum().clamp_min(1)


def hybrid_loss(mode: str, alpha: float, *,
                logits: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, ignore_id: int = -100
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, aux). Mode "attention": the cross-entropy, also as
    aux["loss_attn"]."""
    if mode != "attention":
        raise NotImplementedError(HYBRID_TODO)
    loss = cross_entropy_loss(logits, labels, ignore_id)
    return loss, {"loss_attn": loss}
