"""SpecAugment time-mask indices, drawn on the host in numpy (counterpart
of `mtasr_tpu/data/specaugment.py`, HF's `_compute_mask_indices`). The
collator draws a boolean [B, T] mask per batch and the encoder replaces
the masked frames with `masked_spec_embed`. With the same
`np.random.Generator` state the masks equal the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def compute_mask_indices(shape, mask_prob: float, mask_length: int,
                         attention_mask: Optional[np.ndarray] = None,
                         min_masks: int = 0,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
    batch_size, sequence_length = shape
    if mask_length < 1:
        raise ValueError("`mask_length` has to be bigger than 0.")
    if mask_length > sequence_length:
        raise ValueError(f"`mask_length` ({mask_length}) > sequence_length "
                         f"({sequence_length})")
    rng = rng or np.random.default_rng()
    epsilon = rng.random()

    def num_spans(input_length):
        n = int(mask_prob * input_length / mask_length + epsilon)
        n = max(n, min_masks)
        if n * mask_length > sequence_length:
            n = sequence_length // mask_length
        if input_length - (mask_length - 1) < n:
            n = max(input_length - (mask_length - 1), 0)
        return n

    input_lengths = (attention_mask.sum(-1).astype(int).tolist()
                     if attention_mask is not None
                     else [sequence_length] * batch_size)
    mask = np.zeros((batch_size, sequence_length), dtype=bool)
    max_spans = num_spans(sequence_length)
    if max_spans == 0:
        return mask
    all_idxs = []
    for input_length in input_lengths:
        n = num_spans(input_length)
        idx = rng.choice(np.arange(max(input_length - (mask_length - 1), 1)),
                         size=n, replace=False)
        dummy = idx[0] if len(idx) else sequence_length - 1
        all_idxs.append(np.concatenate(
            [idx, np.full(max_spans - n, dummy, dtype=np.int64)]))
    spans = (np.asarray(all_idxs)[:, :, None]
             + np.arange(mask_length)[None, None, :]).reshape(batch_size, -1)
    np.put_along_axis(mask, np.minimum(spans, sequence_length - 1), True,
                      axis=-1)
    return mask
