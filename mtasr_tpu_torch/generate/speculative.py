"""Speculative greedy decoding drafted by the model's own CTC heads
(counterpart of `mtasr_tpu/generate/speculative.py`).

The per-speaker CTC heads already transcribe each separated stream; joined
as `spk0 <sc> spk1 ... <eos>` they are a draft of the decoder's SOT output
(`ctc_sot_draft`). A verify step feeds the current token and `spec_k`
draft tokens to the decoder as one chunk over the KV cache, accepts the
longest draft prefix that equals the decoder's own argmax, and emits it
and the model's next token. Under the same arithmetic the output is the
greedy decode, token for token, at any acceptance. On the card the chunk
and the one-token step sum in other orders, so a near tie of the top two
logits may flip.

The chunk has the fixed length spec_k + 1. Rejected drafts leave slots
that are marked invalid in the cache's validity mask, and the slot counter
advances by the longest accepted run of the batch, so rows that accepted
fewer leave holes. Once the slots left cannot take one more chunk and then
one slot for each token still owed, an exact one-token loop finishes.

The JAX package runs both loops on the device. Here they are Python loops:
the slot counter is a host integer, and each verify step reads back one
small tensor (the longest accepted run, the accepted count, and the budget
test), each fallback step whether every row is done.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from mtasr_tpu_torch.config import GenerationConfig, SpeechEncoderDecoderConfig
from mtasr_tpu_torch.generate.engine import (
    GenerateOutput, _prefill, encode_maybe_chunked, prompt_layout,
)
from mtasr_tpu_torch.models.ctc_head import ctc_argmax
from mtasr_tpu_torch.models.llama import embed_tokens, llama_forward
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    EncodedSpeech, SpeechEncoderDecoderModel, adapter_callback, ctc_heads,
)
from mtasr_tpu_torch.ops.ctc import ctc_greedy_collapse
from mtasr_tpu_torch.train.lora import merged


@dataclass
class SpecStats:
    spec_steps: int          # verify steps run
    accepted_drafts: int     # draft tokens accepted, all rows
    fallback_steps: int      # exact one-token steps
    emitted: torch.Tensor    # [B] tokens emitted a row


def ctc_sot_draft(model: SpeechEncoderDecoderModel,
                  cfg: SpeechEncoderDecoderConfig, enc: EncodedSpeech,
                  max_out_len: int = 150) -> torch.Tensor:
    """The SOT draft `spk0 <sc> spk1 ... spk{K-1} <eos>` of the heads'
    collapsed argmax paths, [B, K * max_out_len + K] int64, pad past each
    row's <eos>."""
    K = cfg.talker_numbers
    cols, lens = [], []
    for head, hs in zip(ctc_heads(model, cfg), enc.sep_hidden):
        col, n = ctc_greedy_collapse(ctc_argmax(head, hs), enc.mask_x0,
                                     cfg.ctc_blank_id, cfg.pad_token_id,
                                     max_out_len)
        cols.append(col)
        lens.append(n)
    trans = torch.stack(cols, 1)                       # [B, K, max_out_len]
    lens = torch.stack(lens, 1).long()                 # [B, K]
    B, dev = trans.shape[0], trans.device
    # speaker i starts at sum_{m<i} (len_m + 1): each segment is followed by
    # one boundary token (<sc> between speakers, <eos> after the last)
    starts = torch.cumsum(torch.nn.functional.pad(lens[:, :-1] + 1, (1, 0)),
                          1)
    total = starts[:, -1] + lens[:, -1] + 1
    dpos = torch.arange(K * max_out_len + K, device=dev)[None]
    s = ((dpos[:, :, None] >= starts[:, None, :]).long().sum(2) - 1) \
        .clamp(0, K - 1)
    r = dpos - starts.gather(1, s)
    tok = trans.reshape(B, K * max_out_len).gather(
        1, (s * max_out_len + r).clamp(0, K * max_out_len - 1))
    boundary = torch.where(s < K - 1, cfg.sc_token_id, cfg.eos_token_id)
    tok = torch.where(r < lens.gather(1, s), tok, boundary)
    return torch.where(dpos < total[:, None], tok, cfg.pad_token_id)


def _spec(model: SpeechEncoderDecoderModel, cfg: SpeechEncoderDecoderConfig,
          enc: EncodedSpeech, prefill_ids: torch.Tensor, draft: torch.Tensor,
          splice_index: int, kv_quant: bool, max_new_tokens: int,
          spec_k: int, s_max: int) -> Tuple[GenerateOutput, SpecStats]:
    dec, dec_cfg = model.decoder, cfg.decoder
    dtype = enc.encoder_hidden_states.dtype
    B = draft.shape[0]
    Lp = prefill_ids.shape[1]
    K1 = spec_k + 1
    Dmax = draft.shape[1]
    eos_id, pad_id = cfg.eos_token_id, cfg.pad_token_id
    mn = max_new_tokens

    cb = adapter_callback(model, cfg, enc, keep_kv=True)
    cache, last_logits, n_valid, total_prefill = _prefill(
        model, cfg, enc, prefill_ids, splice_index, s_max, kv_quant, cb)
    dev = last_logits.device
    cur = last_logits.argmax(-1)
    # K1 spare columns: a verify step writes a K1 window at each row's t
    out = torch.full((B, mn + K1), pad_id, dtype=torch.long, device=dev)
    out[:, 0] = cur
    done = (cur == eos_id) | (mn <= 1)
    t = torch.ones(B, dtype=torch.long, device=dev)   # cur is out[:, t-1]
    j_idx = torch.arange(K1, device=dev)[None]
    # the token at output index j sits at position Lp + n_valid + j
    pos_base = Lp + n_valid - 1
    c = total_prefill                                 # the next free slot

    def budget(t, done):
        """[all done, the fewest tokens a row has left to emit]."""
        m = torch.where(done, mn, t).min()
        return torch.stack([done.all().long(), mn - m])

    spec_steps = accepted = 0
    all_done, owed = budget(t, done).tolist()
    while not all_done and c + K1 + owed <= s_max:
        didx = t[:, None] + j_idx[:, :spec_k]
        d = draft.gather(1, didx.clamp(0, Dmax - 1))
        d = torch.where(didx < Dmax, d, pad_id)
        chunk = torch.cat([cur[:, None], d], 1)                 # [B, K1]
        logits, cache = llama_forward(
            dec, dec_cfg, embed_tokens(dec, dec_cfg, chunk, dtype=dtype),
            pos_base[:, None] + t[:, None] + j_idx, kv_cache=cache,
            cache_offset=c, layer_callback=cb)
        greedy = logits.argmax(-1)                              # [B, K1]
        # greedy[:, j] follows chunk[:, :j+1]: accept the longest draft
        # prefix that reproduces it, then the model's own next token
        acc = torch.cumprod((d == greedy[:, :spec_k]).long(), 1).sum(1)
        within = j_idx <= acc[:, None]
        is_eos = (within & (greedy == eos_id)).long()
        keep = (within & (is_eos.cumsum(1) - is_eos == 0) & ~done[:, None]
                & (t[:, None] + j_idx < mn))
        n_emit = keep.sum(1)
        toks = torch.where(keep, greedy, pad_id)
        out.scatter_(1, t[:, None] + j_idx, toks)
        # slot c holds cur (in the stream iff the row was active), slot
        # c+1+j draft j (iff accepted and kept)
        acc_kept = keep[:, :spec_k] & (j_idx[:, :spec_k] < acc[:, None])
        cache.valid[:, c:c + K1] = torch.cat([~done[:, None], acc_kept], 1)
        last_kept = toks.gather(1, (n_emit - 1).clamp_min(0)[:, None])[:, 0]
        cur = torch.where(n_emit > 0, last_kept, cur)
        done = (done | (keep & (greedy == eos_id)).any(1)
                | (t + n_emit >= mn))
        t = t + n_emit
        n_acc = acc_kept.sum(1)
        longest, n_accepted, all_done, owed = torch.cat(
            [torch.stack([n_acc.max(), n_acc.sum()]), budget(t, done)]
        ).tolist()
        # past the longest accepted run; shorter rows leave invalid holes
        c += 1 + longest
        spec_steps += 1
        accepted += n_accepted
    c_spec_end = c

    # the exact one-token loop finishes rows the slot budget cut short
    while not all_done and c < s_max:
        logits, cache = llama_forward(
            dec, dec_cfg, embed_tokens(dec, dec_cfg, cur[:, None],
                                       dtype=dtype),
            (pos_base + t)[:, None], kv_cache=cache, cache_offset=c,
            logits_to_keep=1, layer_callback=cb)
        nxt = torch.where(done, pad_id, logits[:, -1].argmax(-1))
        out.scatter_(1, t[:, None], nxt[:, None])
        t = t + (~done).long()
        cur = torch.where(done, cur, nxt)
        done = done | (nxt == eos_id) | (t >= mn)
        c += 1
        all_done = bool(done.all())

    out = out[:, :mn]
    return (GenerateOutput(sequences=out, lengths=(out != pad_id).sum(1),
                           steps=spec_steps + c - c_spec_end),
            SpecStats(spec_steps=spec_steps, accepted_drafts=accepted,
                      fallback_steps=c - c_spec_end, emitted=t))


def generate_speculative(
        model: SpeechEncoderDecoderModel, cfg: SpeechEncoderDecoderConfig,
        input_values: torch.Tensor, audio_mask: Optional[torch.Tensor],
        prompt_ids: Optional[torch.Tensor] = None,
        gen: Optional[GenerationConfig] = None,
        max_new_tokens: Optional[int] = None,
        draft_tokens: Optional[torch.Tensor] = None,
) -> Tuple[GenerateOutput, SpecStats]:
    """Greedy speculative decode, token for token the greedy `generate`
    under the same arithmetic. `draft_tokens` [B, D] replaces the CTC
    drafter (tests, an external draft model)."""
    gen = gen or GenerationConfig(speculative="ctc")
    if gen.do_sample:
        raise ValueError("speculative decoding is greedy-only "
                         "(verification assumes argmax sampling)")
    if max_new_tokens is None:
        max_new_tokens = gen.max_new_tokens or gen.max_length
    mn = int(max_new_tokens)
    if draft_tokens is None:
        mode = gen.speculative or "ctc"
        if mode != "ctc":
            raise ValueError(f"unknown speculative draft source: {mode!r}")
        if not (cfg.talker_ctc and cfg.talker_numbers >= 1):
            raise ValueError("speculative='ctc' needs talker_ctc CTC heads "
                             "(cfg.talker_ctc=True)")
    B, dev = input_values.shape[0], input_values.device
    with merged(model), torch.inference_mode():
        enc = encode_maybe_chunked(model, cfg, input_values, audio_mask,
                                   gen.encode_chunk)
        prefill_ids, splice_index = prompt_layout(cfg, B, prompt_ids, dev)
        if draft_tokens is None:
            draft = ctc_sot_draft(model, cfg, enc, max_out_len=mn)
        else:
            draft = torch.as_tensor(draft_tokens).to(
                device=dev, dtype=torch.long).reshape(B, -1)
        total_prefill = prefill_ids.shape[1] + \
            enc.encoder_hidden_states.shape[1]
        spec_k = int(gen.spec_k)
        s_max = total_prefill + max(int(gen.spec_cache_factor * mn), mn) \
            + spec_k + 1
        return _spec(model, cfg, enc, prefill_ids, draft, splice_index,
                     gen.kv_quant, mn, spec_k, s_max)
