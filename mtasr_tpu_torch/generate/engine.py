"""Batched autoregressive generation over a preallocated KV cache
(counterpart of `mtasr_tpu/generate/engine.py`).

`generate` encodes the batch once, splices `[prefix | speech | suffix]`
embeddings into one prefill pass, then runs single-token decode steps with
greedy (or temperature / top-k / top-p) sampling until every row has
emitted eos or the token budget is spent.

The JAX package runs the step loop as one compiled `lax.while_loop` that
tests for eos every step. Here it is a Python loop that asks the device
whether every row is done only every `EOS_CHECK_EVERY` steps, so the host
does not wait on the device each step; rows that are done emit `pad`, so
the extra steps change no output. The step's inputs all live on the
device (the token, the step index, the done rows, the output), and the
step advances them itself. On a card, with the greedy pick of one
process or one dp index and no tp group in the model (`_replayable`),
step 1 runs eagerly, step 2 captures the step in a CUDA graph and every
later step replays it: one launch a step, the same kernels (#4 / #6
among them) on the same values. The CPU, sampling (its generator's
state), a dp group's gathered pick and tp's collectives run the same
step eagerly. The eos check, the spans and the pipelined stream's
`after_step` stay outside the graph.

`generate_ctc` is the one-shot CTC decode: each CTC head's collapsed argmax
path on its separated stream, no decoder.

A model sharded over a dp x tp mesh (`parallel/mesh.py::shard_model`)
takes the whole batch on every rank: each dp index decodes its own
contiguous rows (all of them when the batch does not divide by dp), the
ranks of a tp group decode the same rows in step (their full logits are
the same, so they pick the same tokens), and the outputs are gathered
back in input order, every rank holding all of them. With sampling the
dp indices step together: each step's logits are gathered over dp and
the tokens drawn once for the whole batch from `generator`, then sliced,
so dp = 2 draws what one process draws.
"""
from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mtasr_tpu_torch.config import GenerationConfig, SpeechEncoderDecoderConfig
from mtasr_tpu_torch.models import moe
from mtasr_tpu_torch.models.llama import (
    KVCache, embed_tokens, llama_forward, lm_head, local_kv_heads,
)
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    EncodedSpeech, SpeechEncoderDecoderModel, adapter_callback,
    encode_speech, forward_ctc,
)
from mtasr_tpu_torch.parallel.collectives import all_gather, all_reduce
from mtasr_tpu_torch.parallel.mesh import dp_rows, gather_rows, take_rows
from mtasr_tpu_torch.train.lora import merged
from mtasr_tpu_torch.utils.profiling import (
    annotate, annotated, count, tracing,
)

EOS_CHECK_EVERY = 8


@dataclass
class GenerateOutput:
    sequences: torch.Tensor   # [B, max_new_tokens] int64, pad-filled
    lengths: torch.Tensor     # [B] generated tokens incl. eos
    steps: int = 0            # decode steps run after the prefill


def prompt_layout(cfg: SpeechEncoderDecoderConfig, B: int,
                  prompt_ids: Optional[torch.Tensor],
                  device) -> Tuple[torch.Tensor, int]:
    """Prefill ids ([BOS] + prompt in instruct mode, else [BOS]) and the
    splice index. One batch decodes with one prompt layout; a batch whose
    rows do not all end with <boss><eoss><bosr> is refused."""
    bos = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long,
                     device=device)
    if not cfg.instruct:
        return bos, 1
    if prompt_ids is None:
        raise ValueError("instruct mode requires prompt_ids")
    tail = np.asarray(torch.as_tensor(prompt_ids)[:, -3:].cpu())
    expected = np.asarray([cfg.boss_token_id, cfg.eoss_token_id,
                           cfg.bosr_token_id])
    ok = (tail == expected[None, :]).all(axis=1)
    if not ok.all():
        raise ValueError(
            "heterogeneous prompt layouts in one batch: rows "
            f"{np.nonzero(~ok)[0].tolist()} do not end with "
            "<boss><eoss><bosr> — group the batch by prompt length (the "
            "data pipeline's batches_from_examples does this) or decode "
            "them separately")
    prefill_ids = torch.cat(
        [bos, torch.as_tensor(prompt_ids).to(device=device,
                                             dtype=torch.long)], dim=1)
    # [BOS bosp prompt(P) eosp boss | eoss bosr]: splice after <boss>
    return prefill_ids, prefill_ids.shape[1] - 2


def encode_maybe_chunked(model: SpeechEncoderDecoderModel,
                         cfg: SpeechEncoderDecoderConfig,
                         input_values: torch.Tensor, audio_mask,
                         chunk: Optional[int]) -> EncodedSpeech:
    """Encode the batch, optionally `chunk` rows at a time (bounds the
    encoder's peak memory; the encoder couples no rows). Every field of
    the chunks is concatenated along the batch, as the JAX `tree_map`
    does: the memories, the separated streams and their masks too."""
    B = input_values.shape[0]
    if chunk is None or not 0 < chunk < B:
        return encode_speech(model, cfg, input_values, audio_mask)
    encs = [encode_speech(model, cfg, input_values[i:i + chunk],
                          audio_mask[i:i + chunk]
                          if audio_mask is not None else None)
            for i in range(0, B, chunk)]

    def cat(parts):
        if parts[0] is None:
            return None
        if isinstance(parts[0], list):
            return [torch.cat(p, dim=0) for p in zip(*parts)]
        return torch.cat(parts, dim=0)
    return EncodedSpeech(**{
        f.name: cat([getattr(e, f.name) for e in encs])
        for f in dataclasses.fields(EncodedSpeech)})


def filter_logits(logits: torch.Tensor,
                  gen: GenerationConfig) -> torch.Tensor:
    """Temperature, then top-k and top-p: the tokens filtered out get
    -1e30. Runs in the logits' own dtype (bf16 when serving), as the JAX
    engine's filter does, with its softmax in the same steps (exp, sum,
    divide, each rounded to the dtype). When the cumulative probability
    never reaches `top_p` (it can stall below it in the dtype's rounding)
    every token is kept."""
    logits = logits / max(gen.temperature, 1e-6)
    if gen.top_k and gen.top_k > 0:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        e = torch.exp(sorted_logits - sorted_logits[:, :1])
        cum = (e / e.sum(-1, keepdim=True)).cumsum(-1)
        cutoff = (cum < gen.top_p).sum(-1, keepdim=True)
        kth = sorted_logits.gather(-1, cutoff.clamp_max(logits.shape[-1] - 1))
        logits = logits.masked_fill(logits < kth, -1e30)
    return logits


def _sample_token(logits: torch.Tensor, gen: GenerationConfig,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits [B, V] -> token [B]: argmax, or a draw from the filtered
    distribution."""
    if not gen.do_sample:
        return logits.argmax(dim=-1)
    probs = torch.softmax(filter_logits(logits, gen).float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class _Picker:
    """The decode loop's token choice and its all-done test. In one
    process (or greedy, or one dp index) `_sample_token` and
    `done.all()`; sampling over several dp indices draws once for the
    gathered batch and slices this index's rows, and every dp index stops
    together."""

    def __init__(self, gen: GenerationConfig,
                 generator: Optional[torch.Generator], mesh=None,
                 rows: Optional[slice] = None):
        self.gen, self.generator = gen, generator
        self.group = mesh.dp_group if (gen.do_sample and rows is not None) \
            else None
        self.rows = rows

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return _sample_token(logits, self.gen, self.generator)
        full = all_gather(logits, self.group, 0)
        return _sample_token(full, self.gen, self.generator)[self.rows]

    def all_done(self, done: torch.Tensor) -> bool:
        if self.group is None:
            return bool(done.all())
        return int(all_reduce((~done).sum(), self.group)) == 0


@annotated("mtasr.engine.prefill")
def _prefill(model: SpeechEncoderDecoderModel,
             cfg: SpeechEncoderDecoderConfig, enc: EncodedSpeech,
             prefill_ids: torch.Tensor, splice_index: int, S_max: int,
             kv_quant: bool = False, layer_callback=None):
    """Splice the embeddings, run the prefill into a fresh KV cache (int8
    with `kv_quant`) with the decoder's layer hook `layer_callback` (the
    adapters: `speech_encoder_decoder.adapter_callback`). Returns (cache,
    last_logits [B, V], n_valid [B], total_prefill). A CTC prompt prefix
    is part of the speech block: its valid ids count in n_valid, its
    padding sits inside the block, as in the JAX engine."""
    dec, dec_cfg = model.decoder, cfg.decoder
    speech = enc.encoder_hidden_states
    B, Ts = speech.shape[:2]
    Lp = prefill_ids.shape[1]
    total_prefill = Lp + Ts
    device = speech.device

    emb = embed_tokens(dec, dec_cfg, prefill_ids, dtype=speech.dtype)
    inputs_embeds = torch.cat(
        [emb[:, :splice_index], speech, emb[:, splice_index:]], dim=1)
    key_valid = torch.cat([
        torch.ones((B, splice_index), dtype=torch.bool, device=device),
        enc.encoder_attention_mask,
        torch.ones((B, Lp - splice_index), dtype=torch.bool, device=device),
    ], dim=1)
    # Per-row position compaction: a row's suffix and generated tokens sit
    # right after its TRUE speech length, as when each utterance is decoded
    # alone (the reference); masking hides padded frames' content but not
    # the position shift.
    n_valid = enc.encoder_attention_mask.long().sum(1)
    idx = torch.arange(total_prefill, device=device)[None, :]
    position_ids = torch.where(idx < splice_index + Ts, idx,
                               idx - Ts + n_valid[:, None])

    cache = KVCache.init(dec_cfg, B, S_max, dtype=speech.dtype, device=device,
                         quantized=kv_quant,
                         kv_heads=local_kv_heads(dec, dec_cfg))
    if Lp > splice_index:
        # the last suffix token is the last real element of every row
        logits, cache = llama_forward(
            dec, dec_cfg, inputs_embeds, position_ids,
            key_valid_mask=key_valid, kv_cache=cache, cache_offset=0,
            logits_to_keep=1, layer_callback=layer_callback)
        last_logits = logits[:, -1]
    else:
        # [BOS | speech]: the last real element is each row's last valid
        # speech frame; gather it, then lm_head on those rows only
        hidden, cache = llama_forward(
            dec, dec_cfg, inputs_embeds, position_ids,
            key_valid_mask=key_valid, kv_cache=cache, cache_offset=0,
            compute_logits=False, layer_callback=layer_callback)
        last_idx = splice_index + n_valid - 1
        h_last = hidden[torch.arange(B, device=device), last_idx]
        last_logits = lm_head(dec, dec_cfg, h_last)
    return cache, last_logits, n_valid, total_prefill


REPLAYS = "mtasr.engine.decode.graph_replays"
_capture_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _replayable(model: SpeechEncoderDecoderModel, pick: _Picker,
                device: torch.device) -> bool:
    """Whether the decode step replays from a CUDA graph: on a card, with
    the greedy pick of one process or one dp index, and no module of the
    model in a tp group. Sampling (its generator's state), a dp group's
    gathered pick and tp's collectives would each sit in the graph, so
    those steps, like the CPU's, run eagerly."""
    return (device.type == "cuda" and not pick.gen.do_sample
            and pick.group is None
            and all(getattr(m, "tp", None) is None for m in model.modules()))


class _StepGraph:
    """A decode step replayed from a CUDA graph. The first call runs the
    step eagerly on a side stream, the warm-up a capture needs (the
    stream's cuBLAS workspaces); the second captures it there, which runs
    nothing, then replays it, as every later call does: one graph launch
    on the current stream, the step reading and advancing its own static
    tensors. The graph and its memory pool go with the object. The kernel
    wrappers' launch counts see the eager step and the capture, not the
    replays: what the card ran is read from its trace."""

    def __init__(self, step: Callable[[], None], device: torch.device):
        self.step, self.graph, self.warm = step, None, False
        if device not in _capture_streams:
            _capture_streams[device] = torch.cuda.Stream(device)
        self.side = _capture_streams[device]

    def __call__(self) -> None:
        if self.graph is None:
            main = torch.cuda.current_stream(self.side.device)
            self.side.wait_stream(main)
            with torch.cuda.stream(self.side):
                if self.warm:
                    self._capture()
                else:
                    self.step()
            main.wait_stream(self.side)
            if not self.warm:
                self.warm = True
                return
        self.graph.replay()
        count(REPLAYS)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        # thread_local: the CUDA calls of the process's other threads do
        # not void this thread's capture
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            self.step()
        finally:
            graph.capture_end()
        self.graph = graph


def _decode(model: SpeechEncoderDecoderModel,
            cfg: SpeechEncoderDecoderConfig, cache: KVCache,
            last_logits: torch.Tensor, n_valid: torch.Tensor, Lp: int,
            total_prefill: int, dtype: torch.dtype, gen: GenerationConfig,
            max_new_tokens: int,
            generator: Optional[torch.Generator],
            layer_callback=None, pick: Optional[_Picker] = None,
            after_step: Optional[Callable[[int], None]] = None
            ) -> GenerateOutput:
    """The step loop after the prefill; `layer_callback` the prefill's
    (the adapters, with the memory keys and values it kept); `pick` the
    token choice (`_Picker`; by default this batch's own); `after_step`
    is called with the count of steps run after each step (the pipelined
    stream's encoder layers go there).

    The step reads its inputs from tensors it advances in place (the
    token, the step index `t`, the done rows, the output), so that the
    host passes it nothing: where `_replayable`, step 1 runs eagerly and
    every later step replays it from a CUDA graph (`_StepGraph`), with
    the eos check, the spans and `after_step` outside the graph."""
    dec, dec_cfg = model.decoder, cfg.decoder
    B = last_logits.shape[0]
    eos_id, pad_id = cfg.eos_token_id, cfg.pad_token_id
    pick = pick or _Picker(gen, generator)
    with annotate("mtasr.engine.decode"):
        device = last_logits.device
        out = torch.full((B, max_new_tokens), pad_id, dtype=torch.long,
                         device=device)
        with annotate("mtasr.engine.pick"):
            out[:, 0] = pick(last_logits)
        cur = out[:, 0].clone()
        done = cur == eos_id
        # the token generated at step t-1 sits at position
        # Lp + n_valid + t - 1 of its row, its K/V at slot
        # total_prefill + t - 1
        t = torch.ones((), dtype=torch.long, device=device)
        pos0 = (Lp + n_valid)[:, None] - 1

        def step() -> None:
            emb_t = embed_tokens(dec, dec_cfg, cur[:, None], dtype=dtype)
            logits_t, _ = llama_forward(
                dec, dec_cfg, emb_t, pos0 + t, kv_cache=cache,
                cache_offset=t + (total_prefill - 1), logits_to_keep=1,
                layer_callback=layer_callback)
            with annotate("mtasr.engine.pick"):
                nxt = torch.where(done, pad_id, pick(logits_t[:, -1]))
            out.index_copy_(1, t.reshape(1), nxt[:, None])
            done.logical_or_(nxt == eos_id)
            cur.copy_(nxt)
            t.add_(1)

        run = _StepGraph(step, device) if _replayable(model, pick, device) \
            else step
        # declared, so that a loop that replays nothing reads 0
        count(REPLAYS, 0)
        steps = 0
        for i in range(1, max_new_tokens):
            # a step span a loop iteration; the iteration that finds every
            # row done holds its eos check alone
            with annotate("mtasr.engine.decode.step"):
                if (i - 1) % EOS_CHECK_EVERY == 0:
                    with annotate("mtasr.engine.eos_check"):
                        finished = pick.all_done(done)
                    if finished:
                        break
                run()
                steps += 1
                count("mtasr.engine.decode.steps")
                if after_step is not None:
                    after_step(steps)
    return GenerateOutput(sequences=out, lengths=(out != pad_id).sum(1),
                          steps=steps)


@annotated("mtasr.engine.generate")
def generate(model: SpeechEncoderDecoderModel,
             cfg: SpeechEncoderDecoderConfig, input_values: torch.Tensor,
             audio_mask: Optional[torch.Tensor],
             prompt_ids: Optional[torch.Tensor] = None,
             gen: Optional[GenerationConfig] = None,
             generator: Optional[torch.Generator] = None,
             max_new_tokens: Optional[int] = None) -> GenerateOutput:
    """Batched decode. prompt_ids [B, P] are the instruct prompt ids
    without BOS (they must end with <boss><eoss><bosr>); all rows share one
    prompt layout. `generator` drives sampling (do_sample=True). A model
    with a decoder LoRA decodes with it folded into the weights for the
    call (`train.lora.merged`), as the JAX engine merges it per call.

    With `gen.speculative` the decode is `speculative.generate_speculative`
    (greedy, the same tokens), whose verify and fallback steps and accepted
    drafts are logged. Like the JAX `generate`, it reads neither
    `num_beams` (beam search is `beam.beam_generate`) nor `use_cache`
    (every route decodes over the KV cache). On a dp x tp mesh each dp
    index decodes its rows and every rank returns the whole batch."""
    gen = gen or GenerationConfig()
    mesh = getattr(model, "mesh", None)
    rows = dp_rows(mesh, input_values.shape[0])
    input_values, audio_mask, prompt_ids = (
        take_rows(x, rows) for x in (input_values, audio_mask, prompt_ids))
    if gen.speculative:
        from mtasr_tpu_torch.generate.speculative import generate_speculative
        out, st = generate_speculative(
            model, cfg, input_values, audio_mask, prompt_ids=prompt_ids,
            gen=gen, max_new_tokens=max_new_tokens)
        out = gather_output(out, mesh, rows, cfg.pad_token_id)
        emitted = max(int(st.emitted.sum()), 1)
        logging.getLogger("mtasr_tpu_torch.generate").info(
            "speculative: %d verify + %d fallback steps, %d/%d tokens from "
            "accepted drafts (%.0f%%)", st.spec_steps, st.fallback_steps,
            st.accepted_drafts, emitted, 100.0 * st.accepted_drafts / emitted)
        return out
    with merged(model), torch.inference_mode():
        out = _generate(model, cfg, input_values, audio_mask, prompt_ids,
                        gen, _Picker(gen, generator, mesh, rows),
                        max_new_tokens)
    return gather_output(out, mesh, rows, cfg.pad_token_id)


def gather_output(out: GenerateOutput, mesh, rows: Optional[slice],
                  pad_id: int) -> GenerateOutput:
    """The dp indices' outputs in input order (as is without a dp
    split); `steps` is this index's own."""
    if rows is None:
        return out
    return GenerateOutput(
        sequences=gather_rows(out.sequences, mesh, rows, pad_value=pad_id),
        lengths=gather_rows(out.lengths, mesh, rows), steps=out.steps)


def _generate(model, cfg, input_values, audio_mask, prompt_ids, gen,
              pick, max_new_tokens) -> GenerateOutput:
    if max_new_tokens is None:
        max_new_tokens = gen.max_new_tokens or gen.max_length
    B = input_values.shape[0]
    with annotate("mtasr.engine.encode"):
        enc = encode_maybe_chunked(model, cfg, input_values, audio_mask,
                                   gen.encode_chunk)
    prefill_ids, splice_index = prompt_layout(cfg, B, prompt_ids,
                                              input_values.device)
    return decode_encoded(model, cfg, enc, prefill_ids, splice_index, gen,
                          int(max_new_tokens), pick)


def decode_encoded(model, cfg, enc: EncodedSpeech, prefill_ids: torch.Tensor,
                   splice_index: int, gen: GenerationConfig,
                   max_new_tokens: int, pick: _Picker,
                   after_step: Optional[Callable[[int], None]] = None
                   ) -> GenerateOutput:
    """Prefill and decode an encoded batch (`_prefill`, `_decode`)."""
    Lp = prefill_ids.shape[1]
    S_max = Lp + enc.encoder_hidden_states.shape[1] + max_new_tokens
    # the adapters' memory keys and values, computed once a request and a
    # layer (the JAX loop leaves them loop-invariant, which XLA hoists)
    cb = adapter_callback(model, cfg, enc, keep_kv=True)
    # a traced call counts its own routed pairs (`moe.read_tally`)
    traced = tracing() and cfg.decoder.n_routed_experts is not None
    if traced:
        moe.reset_tally(model.decoder)
    cache, last_logits, n_valid, total_prefill = _prefill(
        model, cfg, enc, prefill_ids, splice_index, S_max, gen.kv_quant, cb)
    out = _decode(model, cfg, cache, last_logits, n_valid, Lp,
                  total_prefill, enc.encoder_hidden_states.dtype, gen,
                  max_new_tokens, pick.generator, cb, pick, after_step)
    if traced:
        moe.read_tally(model.decoder)
    return out


@annotated("mtasr.engine.generate_ctc")
@torch.inference_mode()
def generate_ctc(model: SpeechEncoderDecoderModel,
                 cfg: SpeechEncoderDecoderConfig, input_values: torch.Tensor,
                 audio_mask: Optional[torch.Tensor], max_out_len: int = 150
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot CTC decode (`engine.py:317-323`): (transcriptions
    [B, K * max_out_len] in head-major blocks, lengths [K, B]); on a
    mesh each dp index decodes its rows, gathered back in order."""
    mesh = getattr(model, "mesh", None)
    rows = dp_rows(mesh, input_values.shape[0])
    trans, lens = forward_ctc(model, cfg, take_rows(input_values, rows),
                              take_rows(audio_mask, rows), max_out_len)
    return (gather_rows(trans, mesh, rows, pad_value=cfg.pad_token_id),
            gather_rows(lens, mesh, rows, dim=1))
