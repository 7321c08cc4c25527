"""Host-side label surgery in numpy (counterpart of
`mtasr_tpu/data/labels.py`): the decoder inputs shifted right, eos put at
the first padding slot of the labels, the SOT labels split at `<sc>` into
one stream per talker (for the CTC heads of a later slice), and the splice
index of the instruct layout. `tests/test_torch_host.py` holds it equal to
the JAX package's module.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def shift_tokens_right(labels: np.ndarray, pad_token_id: int,
                       decoder_start_token_id: int) -> np.ndarray:
    shifted = np.zeros_like(labels)
    shifted[:, 1:] = labels[:, :-1]
    shifted[:, 0] = decoder_start_token_id
    shifted[shifted == -100] = pad_token_id
    return shifted


def insert_eos(labels: np.ndarray, eos_token_id: int,
               ignore_id: int = -100) -> np.ndarray:
    """Append one ignore column, then put eos in the first ignore slot of
    each row (a row without padding gets it in the appended slot)."""
    B = labels.shape[0]
    out = np.concatenate(
        [labels, np.full((B, 1), ignore_id, labels.dtype)], axis=1)
    first_pad = np.argmax(out == ignore_id, axis=1)
    out[np.arange(B), first_pad] = eos_token_id
    return out


def split_k_speakers_and_lengths(
    labels: np.ndarray, k_speakers: int, sep_id: int, pad_token_id: int,
    ignore_id: Optional[int] = -100, end_token_id: Optional[int] = -100,
    allow_empty_segment: bool = True, pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split SOT label rows at <sc> into exactly K per-talker streams:
    (label_spks [K, B, Lmax], lengths [K, B]). A row must hold exactly K - 1
    separators."""
    B = labels.shape[0]
    segs: List[List[np.ndarray]] = [[] for _ in range(k_speakers)]
    for b in range(B):
        row = labels[b]
        if end_token_id is not None:
            pos = np.nonzero(row == end_token_id)[0]
            if pos.size:
                row = row[: pos[0]]
        seps = np.nonzero(row == sep_id)[0].tolist()
        if len(seps) != k_speakers - 1:
            raise ValueError(
                f"[split_k_speakers_and_lengths] sample {b}: found "
                f"{len(seps)} separators (id={sep_id}) but expected "
                f"{k_speakers - 1}; row len={row.size}")
        starts = [0] + [i + 1 for i in seps]
        ends = seps + [row.size]
        for i, (s, e) in enumerate(zip(starts, ends)):
            seg = row[s:e]
            if ignore_id is not None:
                seg = seg[seg != ignore_id]
            if pad_token_id is not None and seg.size:
                keep = seg != pad_token_id
                seg = (seg[: np.nonzero(keep)[0][-1] + 1] if keep.any()
                       else seg[:0])
            if seg.size == 0 and not allow_empty_segment:
                raise ValueError(
                    f"[split_k_speakers_and_lengths] sample {b}, slot {i}: "
                    "empty segment with allow_empty_segment=False")
            segs[i].append(seg.astype(np.int64))
    lengths = np.array([[s.size for s in segs[i]] for i in range(k_speakers)],
                       np.int64)
    lmax = pad_to if pad_to is not None else max(1, int(lengths.max()))
    out = np.full((k_speakers, B, lmax), pad_token_id, np.int64)
    for i in range(k_speakers):
        for b, seg in enumerate(segs[i]):
            out[i, b, : seg.size] = seg[:lmax]
    return out, np.minimum(lengths, lmax)


def locate_prompt_region(labels_row: np.ndarray, bosp_id: int, eosp_id: int,
                         bosr_id: int) -> Tuple[int, int]:
    """(prompt length P, index of <bosr>) of an instruct label row laid out
    as [<bosp> prompt <eosp> <boss> <eoss> <bosr> ...]."""
    bosp = int(np.nonzero(labels_row == bosp_id)[0][0])
    eosp = int(np.nonzero(labels_row == eosp_id)[0][0])
    bosr = int(np.nonzero(labels_row == bosr_id)[0][0])
    return eosp - bosp - 1, bosr


def build_training_arrays(
    raw_labels: np.ndarray, *, pad_token_id: int, decoder_start_token_id: int,
    eos_token_id: int, sc_token_id: int, talker_numbers: int,
    instruct: bool = False, eosr_token_id: Optional[int] = None,
    bosp_token_id: Optional[int] = None, eosp_token_id: Optional[int] = None,
    bosr_token_id: Optional[int] = None, ignore_id: int = -100,
    label_spk_pad_to: Optional[int] = None, split_speakers: bool = True,
):
    """One batch's label surgery: decoder_input_ids [B, L+1], ce_labels
    [B, L+1], the splice index and, with `split_speakers`, label_spks
    [K, B, Lk] and label_spk_lens [K, B]."""
    B = raw_labels.shape[0]
    decoder_input_ids = shift_tokens_right(raw_labels, pad_token_id,
                                           decoder_start_token_id)
    if instruct:
        skip_eosr = decoder_input_ids.copy()
        skip_eosr[skip_eosr == eosr_token_id] = pad_token_id
        bosr_pos = int(np.nonzero(skip_eosr[0] == bosr_token_id)[0][0])
        splited = skip_eosr[:, bosr_pos + 1:]
        prompt_len, _ = locate_prompt_region(
            raw_labels[0], bosp_token_id, eosp_token_id, bosr_token_id)
        splice_index = prompt_len + 4
    else:
        splited = decoder_input_ids[:, 1:]
        splice_index = 1

    label_spks = label_spk_lens = None
    if split_speakers:
        label_spks, label_spk_lens = split_k_speakers_and_lengths(
            splited, talker_numbers, sc_token_id, pad_token_id,
            ignore_id=ignore_id, end_token_id=pad_token_id,
            allow_empty_segment=False, pad_to=label_spk_pad_to)

    decoder_input_ids = np.concatenate(
        [decoder_input_ids, np.full((B, 1), pad_token_id, np.int64)], axis=1)
    out = {"decoder_input_ids": decoder_input_ids,
           "ce_labels": insert_eos(raw_labels, eos_token_id, ignore_id),
           "splice_index": splice_index}
    if label_spks is not None:
        out["label_spks"] = label_spks
        out["label_spk_lens"] = label_spk_lens
    return out
