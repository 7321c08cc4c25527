"""Batches from waveforms (counterpart of `mtasr_tpu/data/pipeline.py`).

Each input is padded to the first duration bucket that holds it, and a
batch holds inputs of one bucket and one prompt length only: the batched
decode splices the speech at one prompt position for the whole batch.

Serving: `decode_batches` gives every input once, bucket by bucket, in
input order within a bucket; the caller puts the results back in order.
Training: `collate(..., training=True)` adds the label surgery
(`data/labels.py`: decoder_input_ids, ce_labels, the splice index) and the
SpecAugment time mask (`data/specaugment.py`), and `batches_from_examples`
shuffles full batches from a seeded numpy generator, as the JAX package's
does, so that the two give the same batches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from mtasr_tpu_torch.config import DataConfig, SpeechEncoderDecoderConfig
from mtasr_tpu_torch.data.labels import build_training_arrays
from mtasr_tpu_torch.data.specaugment import compute_mask_indices


@dataclass
class PreparedExample:
    utt_id: str
    input_values: np.ndarray      # normalised waveform
    prompt_ids: List[int]         # instruct prompt ids (no BOS), may be []
    labels: List[int] = field(default_factory=list)  # target, no BOS / EOS

    @property
    def n_samples(self) -> int:
        return len(self.input_values)


@dataclass
class Batch:
    utt_ids: List[str]
    arrays: Dict[str, np.ndarray]   # input_values, audio_mask[, prompt_ids,
    splice_index: int = 1           # labels, mask_time_indices]


def bucket_length(n_samples: int, dc: DataConfig) -> int:
    """Samples of the first bucket that holds `n_samples` (the last
    bucket's, if none does)."""
    for b in dc.bucket_boundaries_seconds:
        cap = int(b * dc.sampling_rate)
        if n_samples <= cap:
            return cap
    return int(dc.bucket_boundaries_seconds[-1] * dc.sampling_rate)


def collate(examples: Sequence[PreparedExample],
            cfg: SpeechEncoderDecoderConfig, dc: DataConfig, *,
            training: bool = False, label_pad_to: Optional[int] = None,
            spec_augment_rng: Optional[np.random.Generator] = None) -> Batch:
    B = len(examples)
    S = bucket_length(max(e.n_samples for e in examples), dc)
    wav = np.zeros((B, S), np.float32)
    amask = np.zeros((B, S), np.int32)
    for i, e in enumerate(examples):
        n = min(e.n_samples, S)
        wav[i, :n] = e.input_values[:n]
        amask[i, :n] = 1
    arrays = {"input_values": wav, "audio_mask": amask}
    splice_index = 1
    # label surgery for training and for labelled eval batches; a
    # decode-only batch carries no label arrays
    if training or any(len(e.labels) > 0 for e in examples):
        L = label_pad_to or max(len(e.labels) for e in examples)
        raw = np.full((B, L), -100, np.int64)
        for i, e in enumerate(examples):
            raw[i, :min(len(e.labels), L)] = e.labels[:L]
        surgery = build_training_arrays(
            raw, pad_token_id=cfg.pad_token_id,
            decoder_start_token_id=cfg.decoder_start_token_id,
            eos_token_id=cfg.eos_token_id, sc_token_id=cfg.sc_token_id,
            talker_numbers=cfg.talker_numbers, instruct=cfg.instruct,
            eosr_token_id=cfg.eosr_token_id, bosp_token_id=cfg.bosp_token_id,
            eosp_token_id=cfg.eosp_token_id, bosr_token_id=cfg.bosr_token_id,
            label_spk_pad_to=label_pad_to, split_speakers=cfg.talker_ctc)
        splice_index = surgery.pop("splice_index")
        arrays.update({k: np.asarray(v) for k, v in surgery.items()})
    if cfg.instruct:
        P = max(len(e.prompt_ids) for e in examples)
        prompt_ids = np.full((B, P), cfg.pad_token_id, np.int64)
        for i, e in enumerate(examples):
            prompt_ids[i, :len(e.prompt_ids)] = e.prompt_ids
        arrays["prompt_ids"] = prompt_ids
    enc = cfg.encoder
    if training and enc.apply_spec_augment and enc.mask_time_prob > 0:
        T0 = enc.conv_output_length(S)
        feat_lens = np.asarray([enc.conv_output_length(min(e.n_samples, S))
                                for e in examples])
        feat_mask = (np.arange(T0)[None, :] < feat_lens[:, None]).astype(int)
        arrays["mask_time_indices"] = compute_mask_indices(
            (B, T0), enc.mask_time_prob, enc.mask_time_length,
            attention_mask=feat_mask, min_masks=enc.mask_time_min_masks,
            rng=spec_augment_rng)
    return Batch(utt_ids=[e.utt_id for e in examples], arrays=arrays,
                 splice_index=splice_index)


def decode_batches(examples: List[PreparedExample],
                   cfg: SpeechEncoderDecoderConfig, dc: DataConfig,
                   batch_size: int) -> Iterator[Batch]:
    """Every example once, grouped by (bucket, prompt length); the last
    batch of a group may be short."""
    groups: Dict[tuple, List[PreparedExample]] = {}
    for e in examples:
        key = (bucket_length(e.n_samples, dc), len(e.prompt_ids))
        groups.setdefault(key, []).append(e)
    for _, group in sorted(groups.items()):
        for i in range(0, len(group), batch_size):
            yield collate(group[i:i + batch_size], cfg, dc)


def batches_from_examples(
    examples: List[PreparedExample], cfg: SpeechEncoderDecoderConfig,
    dc: DataConfig, batch_size: int, *, training: bool = True,
    shuffle: bool = True, seed: int = 0, drop_last: bool = True,
    pad_partial: bool = False,
) -> Iterator[Batch]:
    """Length-bucketed training batches, grouped by (bucket, prompt
    length), shuffled within and across groups from `seed`; labels padded
    to `dc.max_label_length`. `pad_partial` tops a short last batch up by
    cycling its group (DistributedSampler's drop_last=False)."""
    rng = np.random.default_rng(seed)
    by_bucket: Dict[tuple, List[PreparedExample]] = {}
    for e in examples:
        key = (bucket_length(e.n_samples, dc), len(e.prompt_ids))
        by_bucket.setdefault(key, []).append(e)
    order = []
    for _, group in sorted(by_bucket.items()):
        idx = np.arange(len(group))
        if shuffle:
            rng.shuffle(idx)
        lo_stop = (len(group) if (not drop_last or pad_partial)
                   else len(group) - (batch_size - 1))
        for i in range(0, max(lo_stop, 0), batch_size):
            chunk = [group[j] for j in idx[i:i + batch_size]]
            if len(chunk) < batch_size:
                if drop_last and not pad_partial:
                    continue
                k = 0
                while pad_partial and len(chunk) < batch_size:
                    chunk.append(group[idx[k % len(group)]])
                    k += 1
            order.append(chunk)
    if shuffle:
        rng.shuffle(order)
    for chunk in order:
        yield collate(chunk, cfg, dc, training=training,
                      label_pad_to=dc.max_label_length,
                      spec_augment_rng=rng)
