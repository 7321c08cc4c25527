"""One-call batched transcription (counterpart of `mtasr_tpu/api.py`).

    from mtasr_tpu_torch.api import Transcriber
    t = Transcriber.from_pretrained("exp/model", quantize="w8a8",
                                    kv_quant=True)
    texts = t.transcribe([wav_a, wav_b])     # greedy SOT decode
    best = t.transcribe([wav_a], num_beams=4)   # beam search, best beam
    streams = t.transcribe_ctc([wav_a])      # K per-speaker CTC transcripts

`from_pretrained` loads a model directory (`utils/model_io.py`) onto the
card unless the caller passes `device="cpu"`. A model built in the process
is served by `Transcriber(cfg, model, tokenizer)`; for int8 serving,
quantize it in place (`utils.quantize.quantize_for_serving(model,
"w8a8")`) and give it `gen=GenerationConfig(kv_quant=True)`.

Inputs are normalised and batched on the host (`data/`), decoded on the
model's device, and come back in input order whatever the batching.

Under `torch.distributed.run` every rank calls `from_pretrained(...,
dp_size, tp_size)` and the same `transcribe` with the same inputs: the
model is loaded whole, sharded over the dp x tp grid
(`parallel/mesh.py`), each dp index decodes its rows of every batch and
every rank returns the whole result list, as JAX's one SPMD result.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mtasr_tpu_torch.config import (
    DataConfig, GenerationConfig, SpeechEncoderDecoderConfig,
)
from mtasr_tpu_torch.data.audio import normalize_waveform, read_wav, resample
from mtasr_tpu_torch.data.pipeline import PreparedExample, decode_batches
from mtasr_tpu_torch.data.tokenizer import (
    CharTokenizer, HFTokenizer, build_prompt_and_input,
)
from mtasr_tpu_torch.generate.beam import beam_generate
from mtasr_tpu_torch.generate.engine import generate, generate_ctc
from mtasr_tpu_torch.parallel.mesh import make_mesh, shard_model
from mtasr_tpu_torch.utils.profiling import annotate, annotated
from mtasr_tpu_torch.utils.wer import clean_decoded_text

AudioInput = Union[str, np.ndarray]


def resolve_tokenizer(model_dir: Optional[str],
                      tokenizer_name: Optional[str],
                      cfg: SpeechEncoderDecoderConfig):
    """The CLIs' tokenizer: an HF tokenizer by name or path, else the
    `char_tokenizer.json` saved beside the model, else a fresh
    `CharTokenizer` whose special ids are written into `cfg`."""
    if tokenizer_name:
        return HFTokenizer(tokenizer_name)
    saved = (os.path.join(model_dir, "char_tokenizer.json")
             if model_dir else None)
    if saved and os.path.exists(saved):
        return CharTokenizer.load(saved)
    tokenizer = CharTokenizer()
    sp = tokenizer.add_special_tokens(instruct=cfg.instruct)
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    return tokenizer


def load_for_serving(model_dir: str, quantize: str = "none",
                     scope: str = "decoder", device="cuda"):
    """(config, model) of a model directory, ready to serve on `device`
    (bf16 on the card, as stored on the CPU): with `quantize` w8 / w8a8
    through the streamed int8 load (its other tensors in bf16), or, for a
    directory with a decoder LoRA, loaded, merged and quantized."""
    from mtasr_tpu_torch.train.lora import merge_decoder_lora
    from mtasr_tpu_torch.utils import model_io
    from mtasr_tpu_torch.utils.quantize import quantize_for_serving
    dtype = model_io.serving_dtype(device)
    if quantize == "none":
        return model_io.load_model(model_dir, device, dtype)
    if not model_io.has_lora(model_dir):
        return model_io.load_model_quantized(model_dir, quantize,
                                             scope=scope, device=device)
    cfg, model = model_io.load_model(model_dir, device, dtype)
    merge_decoder_lora(model)
    return cfg, quantize_for_serving(model, quantize, scope)


class Transcriber:
    """Batched multi-talker transcription over a loaded port model."""

    def __init__(self, cfg: SpeechEncoderDecoderConfig,
                 model: torch.nn.Module, tokenizer, *,
                 gen: Optional[GenerationConfig] = None,
                 dc: Optional[DataConfig] = None, mesh=None):
        """`mesh`: a dp x tp `parallel.mesh.Mesh` to shard the (whole)
        model over."""
        self.cfg = cfg
        if mesh is not None:
            shard_model(model, cfg, mesh)
        self.model = model
        self.tokenizer = tokenizer
        self.gen = gen or GenerationConfig(do_sample=False)
        # permissive bounds: a call never drops an input for its length
        self.dc = dc or DataConfig(min_duration_in_seconds=0.0,
                                   max_duration_in_seconds=1e9)

    @classmethod
    def from_pretrained(cls, model_dir: str, *,
                        tokenizer_name: Optional[str] = None,
                        quantize: str = "none", kv_quant: bool = False,
                        dp_size: int = -1, tp_size: int = 1,
                        instruct: Optional[bool] = None,
                        gen: Optional[GenerationConfig] = None,
                        device="cuda") -> "Transcriber":
        """Load a model directory for serving (`api.py:40-110` of the JAX
        package): quantize none / w8 / w8a8 (the decoder, streamed),
        kv_quant for the int8 KV cache, `instruct` to override the saved
        config's, the tokenizer by `resolve_tokenizer`. On `device`: the
        card unless the caller asks for the CPU. dp_size x tp_size must
        cover the process group's ranks (dp_size -1: world // tp_size); the
        model is loaded whole and sharded over them."""
        mesh = make_mesh(dp_size, tp_size)
        cfg, model = load_for_serving(model_dir, quantize, device=device)
        if instruct is not None:
            cfg.instruct = instruct
        g = gen or GenerationConfig(do_sample=False, kv_quant=kv_quant)
        return cls(cfg, model, resolve_tokenizer(model_dir, tokenizer_name,
                                                 cfg), gen=g, mesh=mesh)

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
    @annotated("mtasr.api.transcribe")
    def transcribe(self, audio: Sequence[AudioInput], *, prompt: str = "",
                   batch_size: int = 8,
                   max_new_tokens: Optional[int] = None,
                   num_beams: int = 1, clean: bool = True) -> List[str]:
        """Greedy (or self.gen-configured) SOT decode; with num_beams > 1,
        beam search (`generate/beam.py`, with self.gen's `kv_quant` and
        `encode_chunk`), each input's best beam. audio: wav paths or 1-D
        float waveforms at DataConfig.sampling_rate. Returns one
        `<sc>`-separated transcript per input, in input order."""
        device = next(self.model.parameters()).device
        results: Dict[str, str] = {}
        with annotate("mtasr.api.prepare"):
            examples = self._examples(audio, prompt)
        for batch in self._batches(examples, batch_size):
            with annotate("mtasr.api.to_device"):
                wav = torch.from_numpy(batch.arrays["input_values"]).to(device)
                amask = torch.from_numpy(batch.arrays["audio_mask"]).to(device)
            pr = batch.arrays.get("prompt_ids")
            pr = torch.from_numpy(pr) if pr is not None else None
            if num_beams > 1:
                gen = self.gen
                seqs = beam_generate(
                    self.model, self.cfg, wav, amask, prompt_ids=pr,
                    num_beams=num_beams,
                    max_new_tokens=max_new_tokens or (gen.max_new_tokens
                                                      or gen.max_length),
                    kv_quant=gen.kv_quant, encode_chunk=gen.encode_chunk
                ).sequences[:, 0]
            else:
                seqs = generate(self.model, self.cfg, wav, amask,
                                prompt_ids=pr, gen=self.gen,
                                max_new_tokens=max_new_tokens).sequences
            with annotate("mtasr.api.to_host"):
                seqs = seqs.cpu().numpy()
            with annotate("mtasr.api.detokenize"):
                for i, uid in enumerate(batch.utt_ids):
                    text = self.tokenizer.decode(seqs[i],
                                                 skip_special_tokens=False)
                    results[uid] = clean_decoded_text(text) if clean else text
        return [results[f"@{i}"] for i in range(len(audio))]

    @annotated("mtasr.api.transcribe_ctc")
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
        with annotate("mtasr.api.prepare"):
            examples = self._examples(audio, prompt="")
        for batch in self._batches(examples, batch_size):
            with annotate("mtasr.api.to_device"):
                wav = torch.from_numpy(batch.arrays["input_values"]).to(device)
                amask = torch.from_numpy(batch.arrays["audio_mask"]).to(device)
            trans, lens = generate_ctc(self.model, self.cfg, wav, amask,
                                       max_out_len=max_out_len)
            with annotate("mtasr.api.to_host"):
                trans = trans.cpu().numpy().reshape(len(batch.utt_ids), K,
                                                    -1)
                lens = lens.cpu().numpy().T
            with annotate("mtasr.api.detokenize"):
                for i, uid in enumerate(batch.utt_ids):
                    streams = []
                    for k in range(K):
                        text = self.tokenizer.decode(
                            trans[i, k, :lens[i, k]],
                            skip_special_tokens=False)
                        streams.append(clean_decoded_text(text) if clean
                                       else text)
                    results[uid] = streams
        return [results[f"@{i}"] for i in range(len(audio))]
