"""Batches from waveforms (counterpart of `mtasr_tpu/data/pipeline.py`).

Each input is padded to the first duration bucket that holds it, and a
batch holds inputs of one bucket and one prompt length only: the batched
decode splices the speech at one prompt position for the whole batch.

Serving: `decode_batches` gives every input once, bucket by bucket, in
input order within a bucket; the caller puts the results back in order.
From a Kaldi directory (`data/audio.py::load_kaldi_dir`), `prepare_examples`
tokenizes each utterance and filters it by duration (min < n < max); a
lazy example reads only the WAV header and loads its samples when it is
collated (a batch's rows decoded in parallel by the native loader,
`utils/native.py`, which the JAX package's `collate` uses too), so memory
follows the batch, not the dataset. It can run in a
worker pool and keep a JSONL cache stamped with the settings that made
it.
Training: `collate(..., training=True)` adds the label surgery
(`data/labels.py`: decoder_input_ids, ce_labels, the splice index) and the
SpecAugment time mask (`data/specaugment.py`), and `batches_from_examples`
shuffles full batches from a seeded numpy generator, as the JAX package's
does, so that the two give the same batches.
"""
from __future__ import annotations

import json
import logging
import os
import wave
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from mtasr_tpu_torch.config import DataConfig, SpeechEncoderDecoderConfig
from mtasr_tpu_torch.data.audio import (
    Utterance, normalize_waveform, read_wav, resample,
)
from mtasr_tpu_torch.data.labels import build_training_arrays
from mtasr_tpu_torch.data.specaugment import compute_mask_indices
from mtasr_tpu_torch.data.tokenizer import build_prompt_and_input
from mtasr_tpu_torch.utils.native import (
    wav_header_native, wav_load_batch_native,
)
from mtasr_tpu_torch.utils.profiling import annotated


@dataclass
class PreparedExample:
    utt_id: str
    input_values: Optional[np.ndarray]  # normalised waveform; None: lazy
    prompt_ids: List[int]         # instruct prompt ids (no BOS), may be []
    labels: List[int] = field(default_factory=list)  # target, no BOS / EOS
    n_samples: int = -1           # at the model's rate (-1: the waveform's)
    wav_path: Optional[str] = None  # where a lazy example loads from

    def __post_init__(self):
        if self.n_samples < 0:
            self.n_samples = len(self.input_values)

    def waveform(self, dc: DataConfig) -> np.ndarray:
        """The normalised waveform, read from disk for a lazy example."""
        if self.input_values is not None:
            return self.input_values
        wav_data, sr = read_wav(self.wav_path)
        return normalize_waveform(resample(wav_data, sr, dc.sampling_rate))


def _wav_duration_samples(path: str, target_sr: int) -> int:
    """Samples at `target_sr` from the WAV header alone, read by the
    native loader (`utils/native.py`) or, without it, `wave` (scipy
    `resample_poly`'s output length, ceil(n * up / down))."""
    hdr = wav_header_native(path)
    if hdr is not None:
        n, sr = hdr[0], hdr[1]
    else:
        with wave.open(path, "rb") as w:
            n, sr = w.getnframes(), w.getframerate()
    if sr == target_sr:
        return n
    from math import gcd
    g = gcd(sr, target_sr)
    return -(-n * (target_sr // g) // (sr // g))


def prepare_example(utt: Utterance, tokenizer, dc: DataConfig,
                    instruct: bool = False,
                    lazy: bool = False) -> Optional[PreparedExample]:
    """Tokenize one utterance (labels without BOS; in instruct mode the
    prompt template, labels = prompt + response) and read or, `lazy`, only
    measure its waveform; None if its duration is out of bounds."""
    if lazy:
        n, wav_norm = _wav_duration_samples(utt.wav_path,
                                            dc.sampling_rate), None
    else:
        wav_data, sr = read_wav(utt.wav_path)
        wav_data = resample(wav_data, sr, dc.sampling_rate)
        n, wav_norm = len(wav_data), normalize_waveform(wav_data)
    if not (dc.min_duration_in_seconds * dc.sampling_rate < n
            < dc.max_duration_in_seconds * dc.sampling_rate):
        return None
    text = utt.text.lower() if dc.do_lower_case else utt.text
    if instruct:
        prompt = utt.prompt.lower() if dc.do_lower_case else utt.prompt
        prompt_str, input_str = build_prompt_and_input(prompt, text)
        labels = tokenizer.encode(prompt_str + input_str, add_bos=False)
        prompt_ids = tokenizer.encode(prompt_str, add_bos=False)
    else:
        labels, prompt_ids = tokenizer.encode(text, add_bos=False), []
    return PreparedExample(utt.utt_id, wav_norm, prompt_ids, labels, n,
                           wav_path=utt.wav_path if lazy else None)


# the worker pool's state, set in each worker by the pool's initializer
_PREP_CTX: dict = {}


def _prep_init(tokenizer, dc, instruct, lazy):
    _PREP_CTX.update(tokenizer=tokenizer, dc=dc, instruct=instruct,
                     lazy=lazy)


def _prep_worker(utt):
    return prepare_example(utt, _PREP_CTX["tokenizer"], _PREP_CTX["dc"],
                           _PREP_CTX["instruct"], lazy=_PREP_CTX["lazy"])


def _cache_fingerprint(tokenizer, dc: DataConfig, instruct: bool) -> dict:
    """The settings that change prepared labels and durations: a cache
    written under others is rebuilt."""
    tok_id = (getattr(tokenizer, "name_or_path", None)
              or type(tokenizer).__name__)
    return {
        "tokenizer": str(tok_id),
        "vocab_size": int(getattr(tokenizer, "vocab_size", 0) or 0),
        "sampling_rate": dc.sampling_rate,
        "min_duration_in_seconds": dc.min_duration_in_seconds,
        "max_duration_in_seconds": dc.max_duration_in_seconds,
        "do_lower_case": dc.do_lower_case,
        "instruct": bool(instruct),
    }


def prepare_examples(
    utts: Sequence[Utterance], tokenizer, dc: DataConfig,
    instruct: bool = False, *, lazy: bool = True, num_proc: int = 1,
    cache_path: Optional[str] = None,
) -> List[PreparedExample]:
    """`prepare_example` over `utts`, in `num_proc` spawned workers when
    more than one, dropping the out-of-bounds ones. With `cache_path` (lazy
    only), the examples are read from, or written to, a JSONL cache whose
    first line is the settings' fingerprint."""
    fp = _cache_fingerprint(tokenizer, dc, instruct)
    if cache_path and os.path.exists(cache_path):
        with open(cache_path) as f:
            if json.loads(f.readline() or "{}").get("__fingerprint__") == fp:
                return [PreparedExample(
                    d["utt_id"], None, d["prompt_ids"], d["labels"],
                    d["n_samples"], wav_path=d["wav_path"])
                    for d in map(json.loads, f)]
        logging.getLogger("mtasr_tpu_torch.data").warning(
            "preprocessing cache %s was written under a different "
            "tokenizer/data config; rebuilding", cache_path)
    if num_proc > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(
                num_proc, initializer=_prep_init,
                initargs=(tokenizer, dc, instruct, lazy)) as pool:
            prepared = pool.map(_prep_worker, list(utts), chunksize=64)
    else:
        prepared = [prepare_example(u, tokenizer, dc, instruct, lazy=lazy)
                    for u in utts]
    out = [e for e in prepared if e is not None]
    if cache_path and lazy:
        tmp = cache_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"__fingerprint__": fp}) + "\n")
            for e in out:
                f.write(json.dumps({
                    "utt_id": e.utt_id, "labels": list(map(int, e.labels)),
                    "prompt_ids": list(map(int, e.prompt_ids)),
                    "n_samples": int(e.n_samples),
                    "wav_path": e.wav_path}) + "\n")
        os.replace(tmp, cache_path)
    return out


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


@annotated("mtasr.pipeline.collate")
def collate(examples: Sequence[PreparedExample],
            cfg: SpeechEncoderDecoderConfig, dc: DataConfig, *,
            training: bool = False, label_pad_to: Optional[int] = None,
            spec_augment_rng: Optional[np.random.Generator] = None) -> Batch:
    B = len(examples)
    S = bucket_length(max(e.n_samples for e in examples), dc)
    wav = np.zeros((B, S), np.float32)
    amask = np.zeros((B, S), np.int32)
    # the lazy rows that fit the bucket are decoded and normalised by the
    # native loader, in parallel, straight into the batch; a row it cannot
    # serve exactly (another sample rate, another encoding, no library)
    # takes the Python reader below, which normalises over the whole
    # waveform (so a row longer than the bucket goes there too)
    native_rows = [i for i, e in enumerate(examples)
                   if e.input_values is None and e.wav_path is not None
                   and e.n_samples <= S]
    loaded = set()
    if native_rows:
        sub = wav[native_rows] if len(native_rows) < B else wav
        res = wav_load_batch_native(
            [examples[i].wav_path for i in native_rows], sub,
            dc.sampling_rate)
        if res is not None:
            lens, status = res
            for j, i in enumerate(native_rows):
                if status[j] == 0:
                    amask[i, :lens[j]] = 1
                    loaded.add(i)
            if len(native_rows) < B and loaded:
                wav[native_rows] = sub
    for i, e in enumerate(examples):
        if i in loaded:
            continue
        w = e.waveform(dc)            # a lazy example loads from disk here
        n = min(len(w), S)
        wav[i, :n] = w[:n]
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
    pad_partial: bool = False, shard_index: int = 0, num_shards: int = 1,
) -> Iterator[Batch]:
    """Length-bucketed training batches, grouped by (bucket, prompt
    length), shuffled within and across groups from `seed`; labels padded
    to `dc.max_label_length`. `pad_partial` tops a short last batch up by
    cycling its group (DistributedSampler's drop_last=False). With
    `num_shards`, the examples `shard_index::num_shards` only."""
    rng = np.random.default_rng(seed)
    examples = examples[shard_index::num_shards]
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
