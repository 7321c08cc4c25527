"""CTC loss and greedy collapse (counterpart of `mtasr_tpu/ops/ctc.py`).

* `ctc_loss` — per-sample negative log-likelihood [B] of log_probs
  [B, T, V] (torch.nn.CTCLoss reduction 'none', zero_infinity). The JAX
  package differentiates its alpha scan; the port computes the same
  function and its gradient through kernels #11 / #12
  (`ops/kernels/ctc.py::CTCLossFunction`), whose plain versions are the
  step-by-step scans.
* `ctc_greedy_collapse` — duplicate collapse and blank / pad removal of
  argmax paths into a right-padded [B, max_out_len].
"""
from __future__ import annotations

from typing import Tuple

import torch

from mtasr_tpu_torch.ops.kernels.ctc import ctc_loss


def ctc_loss_with_logits(logits: torch.Tensor, input_lengths: torch.Tensor,
                         labels: torch.Tensor, label_lengths: torch.Tensor,
                         blank_id: int) -> torch.Tensor:
    """float32 log-softmax, then `ctc_loss` (`ctc.py:121-128`)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return ctc_loss(log_probs, input_lengths, labels, label_lengths,
                    blank_id)


def _prev_marked(path: torch.Tensor, marker: torch.Tensor) -> torch.Tensor:
    """The token at the last marked position strictly before t (-1 where
    there is none); marker [B, T] holds t where marked, else -1."""
    last_incl = torch.cummax(marker, dim=1).values
    last_excl = torch.cat([torch.full_like(last_incl[:, :1], -1),
                           last_incl[:, :-1]], dim=1)
    prev = path.gather(1, last_excl.clamp_min(0))
    return torch.where(last_excl >= 0, prev, torch.full_like(prev, -1))


def ctc_greedy_collapse(path: torch.Tensor, valid_mask: torch.Tensor,
                        blank_id: int, pad_id: int, max_out_len: int,
                        collapse_across_blanks: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """path [B, T] argmax ids, valid_mask [B, T] bool -> (collapsed
    [B, max_out_len] padded with pad_id, lengths [B]) (`ctc.py:131-185`):
    blanks and pads dropped; a token equal to the previous kept one
    (across blanks) or, with `collapse_across_blanks=False`, to the
    previous valid non-pad frame's token, dropped; the rest truncated at
    max_out_len."""
    B, T = path.shape
    t_idx = torch.arange(T, device=path.device)[None].expand(B, T)
    keepable = valid_mask & (path != blank_id) & (path != pad_id)
    if collapse_across_blanks:
        marked = keepable
    else:
        marked = valid_mask & (path != pad_id)
    prev_tok = _prev_marked(path, torch.where(marked, t_idx, -1))
    keep = keepable & (path != prev_tok)
    pos = keep.long().cumsum(1) - 1
    slot = torch.where(keep & (pos < max_out_len), pos, max_out_len)
    out = torch.full((B, max_out_len + 1), pad_id, dtype=path.dtype,
                     device=path.device)
    out.scatter_(1, slot, path)
    # unkept frames all land in the spare column; its value is dropped
    lengths = keep.sum(1).clamp(max=max_out_len)
    return out[:, :max_out_len], lengths
