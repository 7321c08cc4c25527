"""The program's own lower-precision path as a cell's control, teacher
forced: the served model quantized in place (`quantize_for_serving`, w8a8,
with an int8 KV cache), run once over each judged recording with the
tokens the program served, as the engine's prefill runs (the speech
spliced after BOS, padded frames masked, positions compacted past them,
keys and values through the int8 cache). Its logits at every served
position are what the judge reads: the gap, in the reference, of the token
they rank first."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


@torch.inference_mode()
def forced_logits(tr, wavs: List[np.ndarray], tokens: List[np.ndarray],
                  kv_int8: bool) -> List[torch.Tensor]:
    from mtasr_tpu_torch.models.llama import (
        KVCache, embed_tokens, llama_forward,
    )
    from mtasr_tpu_torch.models.speech_encoder_decoder import encode_speech
    cfg, model = tr.cfg, tr.model
    device = next(model.parameters()).device
    batch = next(iter(tr._batches(tr._examples(wavs, ""), len(wavs))))
    wav = torch.from_numpy(batch.arrays["input_values"]).to(device)
    amask = torch.from_numpy(batch.arrays["audio_mask"]).to(device)
    enc = encode_speech(model, cfg, wav, amask)
    speech = enc.encoder_hidden_states
    R, Ts = speech.shape[:2]
    m = max(len(t) for t in tokens)
    toks = torch.full((R, m), cfg.pad_token_id, dtype=torch.long,
                      device=device)
    for i, t in enumerate(tokens):
        toks[i, :len(t)] = torch.as_tensor(t, device=device)
    dec, dcfg = model.decoder, cfg.decoder
    bos = torch.full((R, 1), cfg.decoder_start_token_id, device=device)
    x = torch.cat([embed_tokens(dec, dcfg, bos, dtype=speech.dtype), speech,
                   embed_tokens(dec, dcfg, toks[:, :-1], dtype=speech.dtype)],
                  dim=1)
    L = x.shape[1]
    n_valid = enc.encoder_attention_mask.long().sum(1)
    valid = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=device),
                       enc.encoder_attention_mask,
                       torch.ones((R, m - 1), dtype=torch.bool,
                                  device=device)], dim=1)
    idx = torch.arange(L, device=device)[None]
    pos = torch.where(idx < 1 + Ts, idx, idx - Ts + n_valid[:, None])
    cache = KVCache.init(dcfg, R, L, dtype=speech.dtype, device=device,
                         quantized=kv_int8)
    logits, _ = llama_forward(dec, dcfg, x, pos, key_valid_mask=valid,
                              kv_cache=cache, cache_offset=0)
    out = []
    for i, t in enumerate(tokens):
        rows = torch.cat([n_valid[i:i + 1],
                          1 + Ts + torch.arange(len(t) - 1, device=device)])
        out.append(logits[i, rows].float())
    return out
