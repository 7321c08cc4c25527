"""One-call batched transcription (counterpart of `mtasr_tpu/api.py`).

    from mtasr_tpu_torch.api import Transcriber
    t = Transcriber(cfg, model, tokenizer)
    texts = t.transcribe([wav_a, wav_b])     # greedy SOT decode
    streams = t.transcribe_ctc([wav_a])      # K per-speaker CTC transcripts

int8 serving: quantize the model in place
(`utils.quantize.quantize_for_serving(model, "w8a8")`) and give the
Transcriber `gen=GenerationConfig(kv_quant=True)` for the int8 KV cache.

Inputs are normalised and batched on the host (`data/`), decoded on the
model's device, and come back in input order whatever the batching.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mtasr_tpu_torch.config import (
    DataConfig, GenerationConfig, SpeechEncoderDecoderConfig,
)
from mtasr_tpu_torch.data.audio import normalize_waveform, read_wav, resample
from mtasr_tpu_torch.data.pipeline import PreparedExample, decode_batches
from mtasr_tpu_torch.data.tokenizer import build_prompt_and_input
from mtasr_tpu_torch.generate.engine import generate, generate_ctc
from mtasr_tpu_torch.utils.wer import clean_decoded_text

AudioInput = Union[str, np.ndarray]


class Transcriber:
    """Batched multi-talker transcription over a loaded port model."""

    def __init__(self, cfg: SpeechEncoderDecoderConfig,
                 model: torch.nn.Module, tokenizer, *,
                 gen: Optional[GenerationConfig] = None,
                 dc: Optional[DataConfig] = None):
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.gen = gen or GenerationConfig(do_sample=False)
        # permissive bounds: a call never drops an input for its length
        self.dc = dc or DataConfig(min_duration_in_seconds=0.0,
                                   max_duration_in_seconds=1e9)

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw) -> "Transcriber":
        raise NotImplementedError(
            "loading a saved model directory into the port waits for the "
            "checkpoint files (ROADMAP.md queue 1, item 8: serving "
            "surface); build the model with utils.convert.load_flat or "
            "init_random")

    # -- input prep ----------------------------------------------------------
    def _prompt_ids(self, prompt: str) -> List[int]:
        if not self.cfg.instruct:
            return []
        prompt_str, _ = build_prompt_and_input(prompt, "")
        return self.tokenizer.encode(prompt_str, add_bos=False)

    def _examples(self, audio: Sequence[AudioInput],
                  prompt: str) -> List[PreparedExample]:
        dc, out = self.dc, []
        for i, a in enumerate(audio):
            p = prompt
            if isinstance(a, str):
                wav, sr = read_wav(a)
                wav = resample(wav, sr, dc.sampling_rate)
                p = prompt.lower() if dc.do_lower_case else prompt
                if not (dc.min_duration_in_seconds * dc.sampling_rate
                        < len(wav)
                        < dc.max_duration_in_seconds * dc.sampling_rate):
                    wav = np.zeros(1, np.float32)   # out of bounds: empty
                    p = prompt
                else:
                    wav = normalize_waveform(wav)
            else:
                wav = normalize_waveform(np.asarray(a, np.float32))
            out.append(PreparedExample(f"@{i}", wav, self._prompt_ids(p)))
        return out

    def _batches(self, examples: List[PreparedExample], batch_size: int):
        # an input longer than the last bucket gets a bucket of its own
        # length for this call, so that nothing is clipped
        dc = self.dc
        max_secs = max(e.n_samples for e in examples) / dc.sampling_rate
        if max_secs > dc.bucket_boundaries_seconds[-1]:
            dc = dataclasses.replace(
                dc, bucket_boundaries_seconds=(
                    tuple(dc.bucket_boundaries_seconds) + (max_secs,)))
        return decode_batches(examples, self.cfg, dc, batch_size)

    # -- decoding ------------------------------------------------------------
    def transcribe(self, audio: Sequence[AudioInput], *, prompt: str = "",
                   batch_size: int = 8,
                   max_new_tokens: Optional[int] = None,
                   num_beams: int = 1, clean: bool = True) -> List[str]:
        """Greedy (or self.gen-configured) SOT decode. audio: wav paths or
        1-D float waveforms at DataConfig.sampling_rate. Returns one
        `<sc>`-separated transcript per input, in input order."""
        if num_beams > 1:
            raise NotImplementedError("beam search is not ported yet "
                                      "(ROADMAP.md queue 1, item 13: "
                                      "decoding variants)")
        device = next(self.model.parameters()).device
        results: Dict[str, str] = {}
        for batch in self._batches(self._examples(audio, prompt),
                                   batch_size):
            wav = torch.from_numpy(batch.arrays["input_values"]).to(device)
            amask = torch.from_numpy(batch.arrays["audio_mask"]).to(device)
            pr = batch.arrays.get("prompt_ids")
            out = generate(self.model, self.cfg, wav, amask,
                           prompt_ids=(torch.from_numpy(pr)
                                       if pr is not None else None),
                           gen=self.gen, max_new_tokens=max_new_tokens)
            seqs = out.sequences.cpu().numpy()
            for i, uid in enumerate(batch.utt_ids):
                text = self.tokenizer.decode(seqs[i],
                                             skip_special_tokens=False)
                results[uid] = clean_decoded_text(text) if clean else text
        return [results[f"@{i}"] for i in range(len(audio))]

    def transcribe_ctc(self, audio: Sequence[AudioInput], *,
                       batch_size: int = 8, max_out_len: int = 150,
                       clean: bool = True) -> List[List[str]]:
        """One-shot CTC decode (`api.py:204-237`): K per-speaker
        transcripts per input, in input order, from the separator and the
        CTC heads (no decoder)."""
        if not self.cfg.talker_ctc:
            raise ValueError("transcribe_ctc needs talker_ctc CTC heads")
        device = next(self.model.parameters()).device
        K = self.cfg.talker_numbers
        results: Dict[str, List[str]] = {}
        for batch in self._batches(self._examples(audio, prompt=""),
                                   batch_size):
            wav = torch.from_numpy(batch.arrays["input_values"]).to(device)
            amask = torch.from_numpy(batch.arrays["audio_mask"]).to(device)
            trans, lens = generate_ctc(self.model, self.cfg, wav, amask,
                                       max_out_len=max_out_len)
            trans = trans.cpu().numpy().reshape(len(batch.utt_ids), K, -1)
            lens = lens.cpu().numpy().T
            for i, uid in enumerate(batch.utt_ids):
                streams = []
                for k in range(K):
                    text = self.tokenizer.decode(trans[i, k, :lens[i, k]],
                                                 skip_special_tokens=False)
                    streams.append(clean_decoded_text(text) if clean
                                   else text)
                results[uid] = streams
        return [results[f"@{i}"] for i in range(len(audio))]
