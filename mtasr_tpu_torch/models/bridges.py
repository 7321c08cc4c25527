"""CTC-guided bridges between the separated streams and the decoder
(counterpart of `mtasr_tpu/models/bridges.py`):

* `frame_refiner_forward` (`talker_ctc_refine`): each separated stream
  pulled toward the mixed features by a gate that follows its CTC head's
  non-blank posterior, plus a learned delta, on valid frames;
* `ctc_token_builder` (the `ctctoken` adapter memory): the mean of each
  stream's frames over each run of one non-blank CTC argmax token, with a
  confidence of 1 - the mean blank posterior; at most `max_tokens_per_spk`
  runs a speaker, the rest padding (True = PADDING in the mask); the
  runs' sums are JAX's `segment_sum` into `max_tokens_per_spk` + 1
  buckets, the last (the overflow) dropped, computed deterministically;
* `build_multi_ctc_prefix` (the `ctcprompt` bridge): the heads' collapsed
  transcripts concatenated per row, left-compacted, embedded.

The CTC heads' posteriors are held constant (`.detach()`, JAX's
`stop_gradient`): a head's gradient comes from its own loss alone, which
PCGrad's split relies on.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtasr_tpu_torch.models.ctc_head import CTCHead, ctc_log_softmax
from mtasr_tpu_torch.models.layers import layer_norm, linear

# tokens a speaker in the CTC prompt and in the CTC-token memory (JAX's
# `ctc_prompt_max_len`, which no caller changes)
CTC_PROMPT_MAX_LEN = 64


class FrameRefiner(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        h = 2 * d_model
        self.mlp = nn.ModuleDict({"0": nn.Linear(2 * d_model + 1, h),
                                  "2": nn.Linear(h, d_model + 1)})
        self.ln_sep = nn.LayerNorm(d_model)
        self.ln_mixed = nn.LayerNorm(d_model)


def _log_posteriors(head: CTCHead, hs: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return ctc_log_softmax(head, hs)


def frame_refiner_forward(p: FrameRefiner,
                          sep_hidden_list: Sequence[torch.Tensor],
                          mixed_hidden: torch.Tensor,
                          enc_mask: Optional[torch.Tensor],
                          heads: Sequence[CTCHead],
                          blank_id: int) -> List[torch.Tensor]:
    """K x [B, T, D] separated streams, [B, T, D] mixed features, enc_mask
    [B, T] True = valid -> K refined streams (padding frames unchanged)."""
    D = mixed_hidden.shape[-1]
    mixed_norm = layer_norm(p.ln_mixed, mixed_hidden)
    refined = []
    for head, sep in zip(heads, sep_hidden_list):
        sep_norm = layer_norm(p.ln_sep, sep)
        log_probs = _log_posteriors(head, sep)
        p_nonblank = (1.0 - torch.exp(log_probs[..., blank_id]))[..., None]
        p_nonblank = p_nonblank.to(sep.dtype)
        feat = torch.cat([sep_norm, mixed_norm, p_nonblank], dim=-1)
        out = linear(p.mlp["2"], torch.relu(linear(p.mlp["0"], feat)))
        delta, gate_logit = out[..., :D], out[..., D:]
        gate = torch.sigmoid(gate_logit)
        gate = gate * p_nonblank + 0.1 * (1.0 - p_nonblank)
        fused = sep + gate * (mixed_hidden - sep) + delta
        if enc_mask is not None:
            fused = torch.where(enc_mask[:, :, None], fused, sep)
        refined.append(fused)
    return refined


def segment_ids(path: torch.Tensor, valid: torch.Tensor,
                blank_id: int) -> torch.Tensor:
    """[B, T] run ids over the non-blank runs of a CTC argmax path (blank
    or invalid frames -1). A run starts at a non-blank frame whose
    predecessor is blank, invalid or another token."""
    nonblank = valid & (path != blank_id)
    prev_path = F.pad(path, (1, 0))[:, :-1]
    prev_nonblank = F.pad(nonblank, (1, 0))[:, :-1]
    boundary = nonblank & (~prev_nonblank | (path != prev_path))
    seg = torch.cumsum(boundary.long(), dim=1) - 1
    return torch.where(nonblank, seg, -1)


def _pool(data: torch.Tensor, seg_cap: torch.Tensor, n: int) -> torch.Tensor:
    """data [B, T, C], buckets seg_cap [B, T] in [0, n] -> the sums of
    buckets 0..n-1 [B, n, C] (bucket n, the overflow, dropped), as the
    product with the buckets' one-hot rows: on the card a scatter_add sums
    through atomics in an order that changes from run to run, and so would
    the memory's last bits."""
    buckets = torch.arange(n, device=seg_cap.device)
    one_hot = (seg_cap[:, None, :] == buckets[None, :, None]).to(data.dtype)
    return one_hot @ data


def ctc_token_builder(sep_hidden_list: Sequence[torch.Tensor],
                      enc_mask: torch.Tensor, heads: Sequence[CTCHead],
                      blank_id: int, max_tokens_per_spk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mem [B, K * Lmax, D], mask [B, K * Lmax] True = PADDING, conf
    [B, K * Lmax]) over the K streams (enc_mask [B, T] True = valid)."""
    Lmax = max_tokens_per_spk
    mems, masks, confs = [], [], []
    for head, sep in zip(heads, sep_hidden_list):
        B, T, _ = sep.shape
        log_probs = _log_posteriors(head, sep)
        path = log_probs.argmax(-1)
        p_blank = torch.exp(log_probs[..., blank_id])
        seg = segment_ids(path, enc_mask, blank_id)
        seg_cap = torch.where((seg >= 0) & (seg < Lmax), seg, Lmax)
        feat_sum = _pool(sep, seg_cap, Lmax)
        cnt = _pool(sep.new_ones((B, T, 1)), seg_cap, Lmax)
        blank_sum = _pool(p_blank[..., None].to(sep.dtype), seg_cap, Lmax)
        feats = feat_sum / cnt.clamp_min(1.0)
        conf = (1.0 - blank_sum[..., 0] / cnt[..., 0].clamp_min(1.0)
                ).clamp(0.0, 1.0)
        n_seg = torch.where(seg >= 0, seg + 1, 0).amax(dim=1)
        pad_mask = torch.arange(Lmax, device=sep.device)[None, :] >= \
            n_seg.clamp_max(Lmax)[:, None]
        mems.append(torch.where(pad_mask[..., None], 0.0, feats))
        masks.append(pad_mask)
        confs.append(torch.where(pad_mask, 0.0, conf))
    return torch.cat(mems, 1), torch.cat(masks, 1), torch.cat(confs, 1)


def build_multi_ctc_prefix(ctc_transcriptions: Sequence[torch.Tensor],
                           embed_table: torch.Tensor, pad_id: int,
                           max_prefix_len_per_head: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """K x [B, Lk] collapsed transcripts (pad-filled) -> (embeds [B, L, d],
    mask [B, L] True = valid, ids [B, L]): each row's valid ids of every
    head, in order, moved to the front by a stable sort, pad after them."""
    ids = torch.cat([t[:, :max_prefix_len_per_head]
                     for t in ctc_transcriptions], dim=1)
    L = ids.shape[1]
    valid = ids != pad_id
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    ids = ids.gather(1, order)
    mask = torch.arange(L, device=ids.device)[None, :] < \
        valid.sum(1)[:, None]
    ids = torch.where(mask, ids, pad_id)
    return embed_table[ids], mask, ids
