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
the extra steps change no output.

`generate_ctc` is the one-shot CTC decode: each CTC head's collapsed argmax
path on its separated stream, no decoder.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mtasr_tpu_torch.config import GenerationConfig, SpeechEncoderDecoderConfig
from mtasr_tpu_torch.models.llama import (
    KVCache, embed_tokens, llama_forward, lm_head,
)
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    EncodedSpeech, SpeechEncoderDecoderModel, adapter_callback,
    encode_speech, forward_ctc,
)
from mtasr_tpu_torch.train.lora import merged

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
                         quantized=kv_quant)
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


def _decode(model: SpeechEncoderDecoderModel,
            cfg: SpeechEncoderDecoderConfig, cache: KVCache,
            last_logits: torch.Tensor, n_valid: torch.Tensor, Lp: int,
            total_prefill: int, dtype: torch.dtype, gen: GenerationConfig,
            max_new_tokens: int,
            generator: Optional[torch.Generator],
            layer_callback=None) -> GenerateOutput:
    """The step loop after the prefill; `layer_callback` the prefill's
    (the adapters, with the memory keys and values it kept)."""
    dec, dec_cfg = model.decoder, cfg.decoder
    B = last_logits.shape[0]
    eos_id, pad_id = cfg.eos_token_id, cfg.pad_token_id
    cur = _sample_token(last_logits, gen, generator)
    out = torch.full((B, max_new_tokens), pad_id, dtype=torch.long,
                     device=cur.device)
    out[:, 0] = cur
    done = cur == eos_id
    steps = 0
    for t in range(1, max_new_tokens):
        if (t - 1) % EOS_CHECK_EVERY == 0 and bool(done.all()):
            break
        emb_t = embed_tokens(dec, dec_cfg, cur[:, None], dtype=dtype)
        # the token generated at step t-1 sits at position
        # Lp + n_valid + t - 1 of its row
        pos_t = (Lp + n_valid)[:, None] - 1 + t
        logits_t, cache = llama_forward(
            dec, dec_cfg, emb_t, pos_t, kv_cache=cache,
            cache_offset=total_prefill + t - 1, logits_to_keep=1,
            layer_callback=layer_callback)
        nxt = _sample_token(logits_t[:, -1], gen, generator)
        nxt = torch.where(done, pad_id, nxt)
        out[:, t] = nxt
        done = done | (nxt == eos_id)
        cur = nxt
        steps += 1
    return GenerateOutput(sequences=out, lengths=(out != pad_id).sum(1),
                          steps=steps)


def _check_gen(gen: GenerationConfig) -> None:
    if gen.num_beams > 1:
        raise NotImplementedError("beam search is not ported yet (ROADMAP.md "
                                  "queue 1, item 7: decoding variants)")
    if gen.speculative:
        raise NotImplementedError("speculative decoding is not ported yet "
                                  "(ROADMAP.md queue 1, item 7: decoding "
                                  "variants)")
    if not gen.use_cache:
        raise NotImplementedError("decoding without the KV cache is not "
                                  "ported (ROADMAP.md queue 1, item 7: "
                                  "decoding variants)")


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
    call (`train.lora.merged`), as the JAX engine merges it per call."""
    gen = gen or GenerationConfig()
    _check_gen(gen)
    with merged(model), torch.inference_mode():
        return _generate(model, cfg, input_values, audio_mask, prompt_ids,
                         gen, generator, max_new_tokens)


def _generate(model, cfg, input_values, audio_mask, prompt_ids, gen,
              generator, max_new_tokens) -> GenerateOutput:
    if max_new_tokens is None:
        max_new_tokens = gen.max_new_tokens or gen.max_length
    B = input_values.shape[0]
    enc = encode_maybe_chunked(model, cfg, input_values, audio_mask,
                               gen.encode_chunk)
    prefill_ids, splice_index = prompt_layout(cfg, B, prompt_ids,
                                              input_values.device)
    Lp = prefill_ids.shape[1]
    S_max = Lp + enc.encoder_hidden_states.shape[1] + max_new_tokens
    # the adapters' memory keys and values, computed once a request and a
    # layer (the JAX loop leaves them loop-invariant, which XLA hoists)
    cb = adapter_callback(model, cfg, enc, keep_kv=True)
    cache, last_logits, n_valid, total_prefill = _prefill(
        model, cfg, enc, prefill_ids, splice_index, S_max, gen.kv_quant, cb)
    return _decode(model, cfg, cache, last_logits, n_valid, Lp,
                   total_prefill, enc.encoder_hidden_states.dtype, gen,
                   int(max_new_tokens), generator, cb)


@torch.inference_mode()
def generate_ctc(model: SpeechEncoderDecoderModel,
                 cfg: SpeechEncoderDecoderConfig, input_values: torch.Tensor,
                 audio_mask: Optional[torch.Tensor], max_out_len: int = 150
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot CTC decode (`engine.py:317-323`): (transcriptions
    [B, K * max_out_len] in head-major blocks, lengths [K, B])."""
    return forward_ctc(model, cfg, input_values, audio_mask, max_out_len)
