"""Batched KV-cached beam search (counterpart of
`mtasr_tpu/generate/beam.py`).

Beams are folded into the batch: row b * W + w is beam w of input b. The
prefill runs on the B inputs; its cache is then repeated W times, and
after every step each cache leaf is gathered by beam parent. The scores
follow HF's `BeamSearchScorer` (default `early_stopping=False`), as the
JAX module's docstring sets out:

- the step's candidates are the top 2W of the W * V joint scores;
- an eos candidate enters the finished pool only if its rank is below W,
  normalized by the generated length including the eos;
- the first step draws from beam 0 alone, and a rank < W eos there is the
  empty hypothesis of length 1;
- a batch is done once its pool holds W hypotheses whose worst is at least
  the best candidate's sum / (t + 1) ** length_penalty: it admits nothing
  more, and its alive beams are skipped at the end;
- alive beams of batches not done join the pool at the end, normalized by
  the full length.

The JAX package runs the steps as one `lax.while_loop` that exits as soon
as every batch is done. Here the host asks the device whether every batch
is done only every `EOS_CHECK_EVERY` steps, as `engine._decode` does; the
extra steps change no output (a done batch admits nothing, and its alive
beams are skipped at the end).

Top-k follows `lax.top_k`: values descending, ties to the lower index. Over
a wide axis (more than 4096 entries) it is k passes of argmax and mask, as
the JAX module's `_top_k_wide` does, with chosen entries masked by -inf
where the JAX module writes -1e7, which repeats an index in a row whose
values are all at or below -1e7; above that the two agree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig
from mtasr_tpu_torch.generate.engine import (
    EOS_CHECK_EVERY, _prefill, encode_maybe_chunked, prompt_layout,
)
from mtasr_tpu_torch.models.llama import KVCache, embed_tokens, llama_forward
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    EncodedSpeech, SpeechEncoderDecoderModel, adapter_callback,
)
from mtasr_tpu_torch.parallel.mesh import dp_rows, gather_rows, take_rows
from mtasr_tpu_torch.train.lora import merged

NEG_INF = -1.0e7     # the pool's "no hypothesis" score, as in the JAX module
WIDE = 4096          # past this many entries, top-k by argmax passes

BeamState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor]


@dataclass
class BeamOutput:
    sequences: torch.Tensor   # [B, W, max_new] int64, best first
    scores: torch.Tensor      # [B, W] length-normalized
    lengths: torch.Tensor     # [B, W]
    steps: int = 0            # decode steps run after the prefill


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_wide(flat: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of [B, N]. Past `WIDE` entries: k passes of argmax
    (the first maximal index) and a -inf mask of the chosen entry."""
    N = flat.shape[-1]
    if N <= WIDE or k >= N:
        return _top_k(flat, k)
    rows = torch.arange(flat.shape[0], device=flat.device)
    cur = flat.clone()
    vals, idxs = [], []
    for j in range(k):
        i = cur.argmax(-1)
        vals.append(cur[rows, i])
        idxs.append(i)
        if j + 1 < k:
            cur[rows, i] = float("-inf")
    return torch.stack(vals, 1), torch.stack(idxs, 1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] at idx [B, K] along axis 1."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                    .expand(idx.shape + x.shape[2:]))


# -- the pure bookkeeping (state: alive_seq [B, W, T], alive_scores [B, W],
# fin_seq [B, W, T], fin_scores [B, W], fin_lens [B, W], done [B]) ---------
def beam_state_init(logp0: torch.Tensor, W: int, eos_id: int, pad_id: int,
                    max_new_tokens: int) -> BeamState:
    """The first step, from logp0 [B, V]: candidates from beam 0 alone; a
    rank < W eos is the empty hypothesis, stored as [eos], length 1."""
    B, dev = logp0.shape[0], logp0.device
    top0_scores, top0_toks = _top_k_wide(logp0, 2 * W)
    is_eos0 = top0_toks == eos_id
    alive_scores, idx0 = _top_k(
        torch.where(is_eos0, NEG_INF, top0_scores), W)
    alive_seq = torch.full((B, W, max_new_tokens), pad_id, dtype=torch.long,
                           device=dev)
    alive_seq[:, :, 0] = top0_toks.gather(1, idx0)
    rank_ok0 = torch.arange(2 * W, device=dev)[None] < W
    fin_scores, _ = _top_k(
        torch.where(is_eos0 & rank_ok0, top0_scores, NEG_INF), W)
    has0 = fin_scores > NEG_INF / 2
    fin_seq = torch.full_like(alive_seq, pad_id)
    fin_seq[:, :, 0] = torch.where(has0, eos_id, pad_id)
    fin_lens = has0.long()
    done = (fin_scores[:, -1] > NEG_INF / 2) & (
        fin_scores[:, -1] >= top0_scores[:, 0])
    return alive_seq, alive_scores, fin_seq, fin_scores, fin_lens, done


def beam_state_step(t: int, logp: torch.Tensor, state: BeamState, W: int,
                    eos_id: int, length_penalty: float
                    ) -> Tuple[BeamState, torch.Tensor]:
    """One step writing generated position t, from logp [B, W, V]. Returns
    (the new state, alive_parent [B, W]): the caller gathers its cache by
    parent."""
    alive_seq, alive_scores, fin_seq, fin_scores, fin_lens, done = state
    B, _, V = logp.shape
    dev = logp.device
    cand = (alive_scores[:, :, None] + logp).reshape(B, W * V)
    top_scores, top_idx = _top_k_wide(cand, 2 * W)
    parent, token = top_idx // V, top_idx % V
    is_eos = token == eos_id

    grown = _take(alive_seq, parent)
    grown[:, :, t] = token

    # eos candidates of rank < W join the pool, normalized by the length
    # including the eos; a done batch admits nothing
    denom = torch.tensor(t + 1, dtype=torch.float32, device=dev) \
        ** length_penalty
    rank_ok = torch.arange(2 * W, device=dev)[None] < W
    cand_fin = torch.where(is_eos & rank_ok & ~done[:, None],
                           top_scores / denom, NEG_INF)
    best_fin, fin_idx = _top_k(torch.cat([fin_scores, cand_fin], 1), W)
    fin_seq = _take(torch.cat([fin_seq, grown], 1), fin_idx)
    fin_lens = torch.cat([fin_lens, torch.full_like(cand_fin, t + 1,
                                                    dtype=torch.long)],
                         1).gather(1, fin_idx)

    # alive: the best W candidates that are not eos
    new_alive, alive_idx = _top_k(torch.where(is_eos, NEG_INF, top_scores),
                                  W)
    alive_seq = _take(grown, alive_idx)
    alive_parent = parent.gather(1, alive_idx)

    pool_full = best_fin[:, -1] > NEG_INF / 2
    done = done | (pool_full & (best_fin[:, -1] >= top_scores[:, 0] / denom))
    return ((alive_seq, new_alive, fin_seq, best_fin, fin_lens, done),
            alive_parent)


def beam_state_finalize(state: BeamState, W: int, max_new_tokens: int,
                        length_penalty: float) -> BeamOutput:
    """Alive beams of batches not done join the pool at the full length;
    the best W overall, best first."""
    alive_seq, alive_scores, fin_seq, fin_scores, fin_lens, done = state
    alive_norm = torch.where(
        done[:, None], NEG_INF,
        alive_scores / (float(max_new_tokens) ** length_penalty))
    best, idx = _top_k(torch.cat([fin_scores, alive_norm], 1), W)
    lens = torch.cat([fin_lens, torch.full_like(fin_lens, max_new_tokens)],
                     1)
    return BeamOutput(sequences=_take(torch.cat([fin_seq, alive_seq], 1),
                                      idx),
                      scores=best, lengths=lens.gather(1, idx))


# -- the model loop ----------------------------------------------------------
def _expand_beams(enc: EncodedSpeech, W: int) -> EncodedSpeech:
    """Every batch-leading field repeated W times: row b * W + w."""
    def rep(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [a.repeat_interleave(W, 0) for a in x]
        return x.repeat_interleave(W, 0)
    return EncodedSpeech(**{f.name: rep(getattr(enc, f.name))
                            for f in dataclasses.fields(EncodedSpeech)})


def _cache_leaves(cache: KVCache):
    """(tensor, slot axis) of every cache leaf: K, V, the int8 scales and
    the slot-validity mask, all batch-leading."""
    yield from ((x, 1) for x in cache.k + cache.v)
    yield from ((s, 2) for s in cache.kv_scale or ())
    yield cache.valid, 1


def expand_cache(cache: KVCache, W: int) -> KVCache:
    return KVCache(
        k=[x.repeat_interleave(W, 0) for x in cache.k],
        v=[x.repeat_interleave(W, 0) for x in cache.v],
        valid=cache.valid.repeat_interleave(W, 0),
        kv_scale=None if cache.kv_scale is None else
        [s.repeat_interleave(W, 0) for s in cache.kv_scale])


def gather_cache(cache: KVCache, parent: torch.Tensor, n_slots: int) -> None:
    """Rows of every cache leaf replaced, in place, by their beam parent's
    (`parent` [B * W], global rows), over the first `n_slots` slots: the
    slots past them are empty in every row."""
    for x, axis in _cache_leaves(cache):
        idx = (slice(None),) * axis + (slice(0, n_slots),)
        x[idx] = x[(parent,) + idx[1:]]


def _beam(model: SpeechEncoderDecoderModel, cfg: SpeechEncoderDecoderConfig,
          enc: EncodedSpeech, prefill_ids: torch.Tensor, splice_index: int,
          W: int, max_new_tokens: int, length_penalty: float,
          kv_quant: bool) -> BeamOutput:
    dec, dec_cfg = model.decoder, cfg.decoder
    speech = enc.encoder_hidden_states
    B, Ts = speech.shape[:2]
    Lp = prefill_ids.shape[1]
    total_prefill = Lp + Ts
    eos_id, pad_id = cfg.eos_token_id, cfg.pad_token_id
    V = dec_cfg.vocab_size

    cache, last_logits, n_valid, _ = _prefill(
        model, cfg, enc, prefill_ids, splice_index,
        total_prefill + max_new_tokens, kv_quant,
        adapter_callback(model, cfg, enc, keep_kv=True))
    state = beam_state_init(torch.log_softmax(last_logits.float(), -1), W,
                            eos_id, pad_id, max_new_tokens)
    cache = expand_cache(cache, W)
    # the adapters read B * W rows of memory in the steps
    cb = adapter_callback(model, cfg, _expand_beams(enc, W), keep_kv=True)
    pos_base = (Lp + n_valid).repeat_interleave(W)[:, None] - 1
    rows = torch.arange(B, device=speech.device)[:, None] * W
    steps = 0
    for t in range(1, max_new_tokens):
        if (t - 1) % EOS_CHECK_EVERY == 0 and bool(state[5].all()):
            break
        cur = state[0][:, :, t - 1].reshape(B * W, 1)
        emb = embed_tokens(dec, dec_cfg, cur, dtype=speech.dtype)
        logits, cache = llama_forward(
            dec, dec_cfg, emb, pos_base + t, kv_cache=cache,
            cache_offset=total_prefill + t - 1, logits_to_keep=1,
            layer_callback=cb)
        logp = torch.log_softmax(logits[:, -1].float(), -1).reshape(B, W, V)
        state, parent = beam_state_step(t, logp, state, W, eos_id,
                                        length_penalty)
        gather_cache(cache, (rows + parent).reshape(-1), total_prefill + t)
        steps += 1
    out = beam_state_finalize(state, W, max_new_tokens, length_penalty)
    out.steps = steps
    return out


def beam_generate(model: SpeechEncoderDecoderModel,
                  cfg: SpeechEncoderDecoderConfig,
                  input_values: torch.Tensor,
                  audio_mask: Optional[torch.Tensor],
                  prompt_ids: Optional[torch.Tensor] = None,
                  num_beams: int = 4, max_new_tokens: int = 150,
                  length_penalty: float = 1.0, kv_quant: bool = False,
                  encode_chunk: Optional[int] = None) -> BeamOutput:
    """Beam search over `num_beams` beams an input; `kv_quant` an int8 KV
    cache, `encode_chunk` the encode in chunks of rows (the JAX
    `Transcriber` drops it on this route; the port passes it). A decoder
    LoRA decodes folded into the weights (`train.lora.merged`). On a dp x
    tp mesh each dp index searches its rows (`engine.generate`'s split)
    and every rank returns the whole batch."""
    mesh = getattr(model, "mesh", None)
    rows = dp_rows(mesh, input_values.shape[0])
    input_values, audio_mask, prompt_ids = (
        take_rows(x, rows) for x in (input_values, audio_mask, prompt_ids))
    B = input_values.shape[0]
    with merged(model), torch.inference_mode():
        enc = encode_maybe_chunked(model, cfg, input_values, audio_mask,
                                   encode_chunk)
        prefill_ids, splice_index = prompt_layout(cfg, B, prompt_ids,
                                                  input_values.device)
        out = _beam(model, cfg, enc, prefill_ids, splice_index,
                    int(num_beams), int(max_new_tokens),
                    float(length_penalty), bool(kv_quant))
    if rows is None:
        return out
    return BeamOutput(
        sequences=gather_rows(out.sequences, mesh, rows,
                              pad_value=cfg.pad_token_id),
        scores=gather_rows(out.scores, mesh, rows),
        lengths=gather_rows(out.lengths, mesh, rows), steps=out.steps)
