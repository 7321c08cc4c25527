"""Composite speech encoder-decoder (counterpart of
`mtasr_tpu/models/speech_encoder_decoder.py`): WavLM -> adapter ->
`enc_to_dec_proj` -> LLaMA with the speech spliced into the prompt, and with
`talker_ctc` the speaker separator on WavLM's 50 Hz output feeding K
serialized-CTC heads (`serialized_ctc.{k}.ctc_lo`).

`encode_feats` is stage A (encoder and separator, the parameters PCGrad
treats as shared), `bridge_features` stage B, `model_forward_from_enc` the
decoder and the losses; `model_forward` runs all three. `forward_ctc` is the
one-shot CTC decode.

The bridge and adapter family rides on the same stages: stage B refines
the separated streams (`talker_ctc_refine`), builds the decoder memory of a
CTC bridge (raw: the separated streams through the encoder's adapter;
softmax: the per-speaker extractor; ctcprompt: the heads' transcripts
embedded as a prefix) and the cross-attention adapters' acoustic memory
(mix / raw: the 50 Hz features; sep: the separated streams; ctctoken: CTC
token segments), and `adapter_callback` runs each decoder layer's adapter
on that memory.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig
from mtasr_tpu_torch.models.adapters import (
    CrossAttentionAdapter, adapter_forward, memory_kv,
)
from mtasr_tpu_torch.models.bridges import (
    CTC_PROMPT_MAX_LEN, FrameRefiner, build_multi_ctc_prefix,
    ctc_token_builder, frame_refiner_forward,
)
from mtasr_tpu_torch.models.ctc_head import CTCHead, ctc_argmax, ctc_logits
from mtasr_tpu_torch.models.layers import linear
from mtasr_tpu_torch.models.llama import (
    Llama, embed_table, embed_tokens, llama_forward,
)
from mtasr_tpu_torch.models.losses import hybrid_loss
from mtasr_tpu_torch.models.refiners import (
    ExtractorConcat, extractor_concat_softmax,
)
from mtasr_tpu_torch.models.separator import Separator, separator_forward
from mtasr_tpu_torch.models.wavlm import (
    WavLM, feature_vector_attention_mask, wavlm_adapter, wavlm_forward,
)
from mtasr_tpu_torch.ops.ctc import ctc_greedy_collapse
from mtasr_tpu_torch.utils.profiling import annotate


class SpeechEncoderDecoderModel(nn.Module):
    """Parameter container of the composite model: `encoder.*`,
    `decoder.*`, when the widths differ `enc_to_dec_proj`, with
    `talker_ctc` `separator.*` and `serialized_ctc.{k}.ctc_lo`, and as the
    family's switches ask: `serilized_refine` (the reference's spelling),
    `ctc_extractor_concat` (softmax bridge), `cross_att_adap.{i}` (one
    adapter a decoder layer, over a memory of the 50 Hz width)."""

    def __init__(self, cfg: SpeechEncoderDecoderConfig):
        super().__init__()
        cfg.validate()
        max_special = max(cfg.pad_token_id, cfg.sc_token_id,
                          cfg.eosr_token_id if cfg.instruct else 0)
        if max_special >= cfg.decoder.vocab_size:
            raise ValueError(f"special token id {max_special} >= decoder "
                             f"vocab_size {cfg.decoder.vocab_size}")
        self.encoder = WavLM(cfg.encoder)
        self.decoder = Llama(cfg.decoder)
        if cfg.encoder.out_hidden != cfg.decoder.hidden_size:
            self.enc_to_dec_proj = nn.Linear(cfg.encoder.out_hidden,
                                             cfg.decoder.hidden_size)
        # the 50 Hz features, before the adapter: hidden_size wide
        d50 = cfg.encoder.hidden_size
        if cfg.talker_ctc:
            self.separator = Separator(d50, cfg.separator_hidden,
                                       cfg.talker_numbers)
            self.serialized_ctc = nn.ModuleDict({
                str(k): CTCHead(d50, cfg.ctc_odim)
                for k in range(cfg.talker_numbers)})
        if cfg.talker_ctc_refine:
            self.serilized_refine = FrameRefiner(d50)
        if cfg.ctc_bridge and cfg.ctc_bridge_type == "softmax":
            self.ctc_extractor_concat = ExtractorConcat(
                d50, cfg.encoder.out_hidden, cfg.talker_numbers)
        if cfg.decoder_cross_attention:
            self.cross_att_adap = nn.ModuleDict({
                str(i): CrossAttentionAdapter(
                    cfg.decoder_cross_attention_type,
                    cfg.decoder.hidden_size, d50, cfg.cross_attn_dim,
                    r_max=cfg.r_max, lora_alpha=cfg.lora_alpha)
                for i in range(cfg.decoder.num_hidden_layers)})


def ctc_heads(model: SpeechEncoderDecoderModel,
              cfg: SpeechEncoderDecoderConfig) -> List[CTCHead]:
    return [model.serialized_ctc[str(k)] for k in range(cfg.talker_numbers)]


def align_mask_len(mask: torch.Tensor, t_target: int) -> torch.Tensor:
    """A [B, T] mask made t_target long as the reference does
    (`speech_encoder_decoder.py:150-161`): cut when longer, the last
    column repeated when shorter."""
    t = mask.shape[1]
    if t >= t_target:
        return mask[:, :t_target]
    return torch.cat([mask, mask[:, -1:].expand(-1, t_target - t)], dim=1)


@dataclass
class EncodedSpeech:
    """What the decoder and the losses need, computed once per batch."""
    encoder_hidden_states: torch.Tensor   # [B, Ts, H_dec]
    encoder_attention_mask: torch.Tensor  # [B, Ts] True = valid
    sep_hidden: Optional[List[torch.Tensor]] = None  # K x [B, T0, D50]
    mask_x0: Optional[torch.Tensor] = None           # [B, T0] True = valid
    acoustic_mem: Optional[torch.Tensor] = None      # [B, Tm, D50]
    acoustic_pad_mask: Optional[torch.Tensor] = None  # [B, Tm] True = PAD
    acoustic_conf: Optional[torch.Tensor] = None     # [B, Tm]


@dataclass
class SpeechFeats:
    """Stage A's output: everything the shared parameters (encoder and
    separator) produce, before the bridge."""
    mixed: torch.Tensor                 # [B, T0, D50] 50 Hz features
    speech: torch.Tensor                # [B, T8, D] adapter output
    sep_hidden: Optional[List[torch.Tensor]]  # K x [B, T0, D50]
    enc_mask: torch.Tensor              # [B, T8] True = valid
    mask_x0: torch.Tensor               # [B, T0] True = valid (conv only)


def _proj_to_decoder(model: SpeechEncoderDecoderModel,
                     x: torch.Tensor) -> torch.Tensor:
    if hasattr(model, "enc_to_dec_proj"):
        return linear(model.enc_to_dec_proj, x)
    return x


def encode_feats(model: SpeechEncoderDecoderModel,
                 cfg: SpeechEncoderDecoderConfig, input_values: torch.Tensor,
                 audio_mask, *,
                 mask_time_indices: Optional[torch.Tensor] = None,
                 deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> SpeechFeats:
    """Stage A: the encoder and, with `talker_ctc`, the separator."""
    with annotate("mtasr.encoder.wavlm"):
        out = wavlm_forward(model.encoder, cfg.encoder, input_values,
                            audio_mask, mask_time_indices=mask_time_indices,
                            deterministic=deterministic, generator=generator)
    return speech_feats(model, cfg, out.encoder_hidden_state,
                        out.last_hidden_state, audio_mask,
                        deterministic=deterministic, generator=generator)


def speech_feats(model: SpeechEncoderDecoderModel,
                 cfg: SpeechEncoderDecoderConfig, mixed: torch.Tensor,
                 speech: torch.Tensor, audio_mask, *,
                 deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> SpeechFeats:
    """Stage A from the encoder's outputs (the 50 Hz features `mixed`, the
    adapter's `speech`): the masks and, with `talker_ctc`, the
    separator."""
    B, T8 = speech.shape[:2]
    T0 = mixed.shape[1]
    if audio_mask is not None:
        enc_mask = feature_vector_attention_mask(cfg.encoder, T8, audio_mask)
        mask_x0 = feature_vector_attention_mask(cfg.encoder, T0, audio_mask,
                                                num_adapter_layers=0)
    else:
        enc_mask = torch.ones((B, T8), dtype=torch.bool, device=speech.device)
        mask_x0 = torch.ones((B, T0), dtype=torch.bool, device=speech.device)
    sep_hidden = None
    if cfg.talker_ctc:
        with annotate("mtasr.encoder.separator"):
            sep_hidden = separator_forward(
                model.separator, mixed, cfg.talker_numbers,
                lstm_dropout=cfg.separator_dropout,
                deterministic=deterministic, generator=generator)
    return SpeechFeats(mixed=mixed, speech=speech, sep_hidden=sep_hidden,
                       enc_mask=enc_mask, mask_x0=mask_x0)


def bridge_features(model: SpeechEncoderDecoderModel,
                    cfg: SpeechEncoderDecoderConfig,
                    feats: SpeechFeats) -> EncodedSpeech:
    """Stage B (`speech_encoder_decoder.py:223-310`): the refiner, the
    decoder memory (the projected adapter output, or a CTC bridge's) and
    the adapters' acoustic memory. The raw bridge also reads the encoder's
    adapter, a shared parameter: no head reads it, so PCGrad gives it no
    gradient from here."""
    mixed, speech = feats.mixed, feats.speech
    enc_mask, mask_x0 = feats.enc_mask, feats.mask_x0
    sep_hidden = feats.sep_hidden
    K = cfg.talker_numbers
    heads = ctc_heads(model, cfg) if cfg.talker_ctc else None
    if cfg.talker_ctc and cfg.talker_ctc_refine:
        sep_hidden = frame_refiner_forward(
            model.serilized_refine, sep_hidden, mixed, mask_x0, heads,
            cfg.ctc_blank_id)

    encoder_hidden_states = _proj_to_decoder(model, speech)
    encoder_attention_mask = enc_mask
    bridge = cfg.ctc_bridge_type if cfg.ctc_bridge else None
    if bridge == "raw":
        # the separated 50 Hz streams, concatenated along time, through the
        # encoder's adapter and the projection
        x_ref, _ = wavlm_adapter(model.encoder.adapter, cfg.encoder,
                                 torch.cat(sep_hidden, dim=1))
        encoder_hidden_states = _proj_to_decoder(model, x_ref)
        encoder_attention_mask = align_mask_len(
            enc_mask.repeat(1, K), encoder_hidden_states.shape[1])
    elif bridge == "softmax":
        logits = [ctc_logits(h, s) for h, s in zip(heads, sep_hidden)]
        x_cat = extractor_concat_softmax(
            model.ctc_extractor_concat, mixed, cfg.ctc_blank_id, logits, K)
        encoder_hidden_states = _proj_to_decoder(model, x_cat)
        encoder_attention_mask = mask_x0.repeat(1, K)
    elif bridge == "ctcprompt":
        # the heads' collapsed transcripts, embedded, as a prefix
        transcripts = [
            ctc_greedy_collapse(ctc_argmax(h, s), mask_x0, cfg.ctc_blank_id,
                                cfg.pad_token_id, CTC_PROMPT_MAX_LEN)[0]
            for h, s in zip(heads, sep_hidden)]
        table = embed_table(model.decoder).to(encoder_hidden_states.dtype)
        pre_emb, pre_mask, _ = build_multi_ctc_prefix(
            transcripts, table, cfg.pad_token_id, CTC_PROMPT_MAX_LEN)
        encoder_hidden_states = torch.cat([pre_emb, encoder_hidden_states],
                                          dim=1)
        encoder_attention_mask = torch.cat([pre_mask, encoder_attention_mask],
                                           dim=1)

    mem = pad = conf = None
    if cfg.decoder_cross_attention:
        feat = cfg.decoder_cross_attention_feature
        if feat in ("mix", "raw"):
            mem, pad = mixed, ~mask_x0
        elif feat == "sep":
            mem = torch.cat(sep_hidden, dim=1)
            pad = ~align_mask_len(mask_x0.repeat(1, K), mem.shape[1])
        elif feat == "ctctoken":
            mem, pad, conf = ctc_token_builder(
                sep_hidden, mask_x0, heads, cfg.ctc_blank_id,
                max_tokens_per_spk=CTC_PROMPT_MAX_LEN)
    return EncodedSpeech(
        encoder_hidden_states=encoder_hidden_states,
        encoder_attention_mask=encoder_attention_mask,
        sep_hidden=sep_hidden, mask_x0=mask_x0, acoustic_mem=mem,
        acoustic_pad_mask=pad, acoustic_conf=conf)


def encode_speech(model: SpeechEncoderDecoderModel,
                  cfg: SpeechEncoderDecoderConfig,
                  input_values: torch.Tensor, audio_mask,
                  **kw) -> EncodedSpeech:
    return bridge_features(
        model, cfg, encode_feats(model, cfg, input_values, audio_mask, **kw))


def adapter_callback(model: SpeechEncoderDecoderModel,
                     cfg: SpeechEncoderDecoderConfig, enc: EncodedSpeech,
                     keep_kv: bool = False):
    """The decoder's layer hook: decoder layer i's adapter over
    `enc`'s acoustic memory, or None without adapters. With `keep_kv` each
    layer's memory keys and values are computed at its first call and kept
    for the later ones (a decode loop: the same values, computed once)."""
    if not cfg.decoder_cross_attention or \
            not hasattr(model, "cross_att_adap"):
        return None
    kept = {}

    def cb(layer_idx: int, hidden: torch.Tensor) -> torch.Tensor:
        ad = model.cross_att_adap[str(layer_idx)]
        kv = None
        if keep_kv and enc.acoustic_mem is not None:
            if layer_idx not in kept:
                kept[layer_idx] = memory_kv(ad, enc.acoustic_mem,
                                            hidden.dtype)
            kv = kept[layer_idx]
        return adapter_forward(ad, hidden, enc.acoustic_mem,
                               enc.acoustic_pad_mask, enc.acoustic_conf, kv)
    return cb


@dataclass
class ForwardOutput:
    loss: Optional[torch.Tensor]
    logits: torch.Tensor
    aux: Dict[str, torch.Tensor] = field(default_factory=dict)


def model_forward(model: SpeechEncoderDecoderModel,
                  cfg: SpeechEncoderDecoderConfig,
                  input_values: torch.Tensor,
                  audio_mask: Optional[torch.Tensor],
                  decoder_input_ids: torch.Tensor, *, splice_index: int = 1,
                  ce_labels: Optional[torch.Tensor] = None,
                  label_spks: Optional[torch.Tensor] = None,
                  label_spk_lens: Optional[torch.Tensor] = None,
                  mask_time_indices: Optional[torch.Tensor] = None,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None,
                  use_pit: bool = False) -> ForwardOutput:
    """Teacher-forced forward (`speech_encoder_decoder.py:345-367`):
    input_values [B, S], audio_mask [B, S], decoder_input_ids [B, L]
    (shifted, pad-appended), ce_labels [B, L] (eos inserted); with CTC
    heads label_spks [K, B, Lk] and label_spk_lens [K, B]. Dropout,
    SpecAugment and the LoRA's input dropout run unless `deterministic`,
    from `generator`."""
    enc = encode_speech(model, cfg, input_values, audio_mask,
                        mask_time_indices=mask_time_indices,
                        deterministic=deterministic, generator=generator)
    return model_forward_from_enc(
        model, cfg, enc, decoder_input_ids, splice_index=splice_index,
        ce_labels=ce_labels, label_spks=label_spks,
        label_spk_lens=label_spk_lens,
        generator=None if deterministic else generator, use_pit=use_pit)


def model_forward_from_enc(model: SpeechEncoderDecoderModel,
                           cfg: SpeechEncoderDecoderConfig,
                           enc: EncodedSpeech,
                           decoder_input_ids: torch.Tensor, *,
                           splice_index: int = 1,
                           ce_labels: Optional[torch.Tensor] = None,
                           label_spks: Optional[torch.Tensor] = None,
                           label_spk_lens: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           use_pit: bool = False) -> ForwardOutput:
    """The decoder over [prefix | speech | suffix] and the losses
    (`speech_encoder_decoder.py:370-444`). As in the JAX package the
    decoder sees no padding mask in training, only causality; `generator`
    (training only) drives the LoRA's input dropout. The CTC losses take
    `enc.sep_hidden` with the 50 Hz lengths of `enc.mask_x0`; the
    adapters, where the config has them, run in every decoder layer."""
    speech = enc.encoder_hidden_states
    B, Ts = speech.shape[:2]
    L = decoder_input_ids.shape[1]
    emb = embed_tokens(model.decoder, cfg.decoder, decoder_input_ids,
                       dtype=speech.dtype)
    inputs_embeds = torch.cat(
        [emb[:, :splice_index], speech, emb[:, splice_index:]], dim=1)
    position_ids = torch.arange(Ts + L, device=speech.device)[None].expand(
        B, Ts + L)
    lora = getattr(model, "decoder_lora", None)
    logits, _ = llama_forward(
        model.decoder, cfg.decoder, inputs_embeds, position_ids, lora=lora,
        lora_dropout=cfg.lora_dropout if lora is not None else 0.0,
        generator=generator,
        layer_callback=adapter_callback(model, cfg, enc))
    loss, aux = None, {}
    if ce_labels is not None or cfg.train_mode == "ctc":
        labels_full = None
        if ce_labels is not None:
            # the speech span (and in instruct mode the prompt up to
            # <bosr>) is ignored: labels_full = [ignore * prefix | tail]
            if cfg.instruct:
                prefix_len, tail = Ts + splice_index + 1, \
                    ce_labels[:, splice_index + 1:]
            else:
                prefix_len, tail = Ts, ce_labels
            ignore = torch.full((B, prefix_len), cfg.ignore_token_id,
                                dtype=ce_labels.dtype,
                                device=ce_labels.device)
            labels_full = torch.cat([ignore, tail], dim=1)
        hlens = (enc.mask_x0.sum(1, dtype=torch.int32)
                 if enc.mask_x0 is not None else None)
        loss, aux = hybrid_loss(
            cfg.train_mode, cfg.ctc_alpha, logits=logits, labels=labels_full,
            ignore_id=cfg.ignore_token_id,
            heads=ctc_heads(model, cfg) if cfg.talker_ctc else None,
            sep_hidden=enc.sep_hidden, hlens=hlens, label_spks=label_spks,
            label_spk_lens=label_spk_lens, blank_id=cfg.ctc_blank_id,
            use_pit=use_pit)
    return ForwardOutput(loss=loss, logits=logits, aux=aux)


def forward_ctc(model: SpeechEncoderDecoderModel,
                cfg: SpeechEncoderDecoderConfig, input_values: torch.Tensor,
                audio_mask: Optional[torch.Tensor], max_out_len: int = 150
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot CTC decode (`speech_encoder_decoder.py:450-473`): each
    head's argmax path on its separated stream, collapsed. Returns
    (transcriptions [B, K * max_out_len], head-major blocks; lengths
    [K, B])."""
    if not cfg.talker_ctc:
        raise ValueError("forward_ctc needs talker_ctc CTC heads")
    feats = encode_feats(model, cfg, input_values, audio_mask)
    outs, lens = [], []
    for head, hs in zip(ctc_heads(model, cfg), feats.sep_hidden):
        with annotate("mtasr.ctc.heads"):
            path = ctc_argmax(head, hs)
        with annotate("mtasr.ctc.collapse"):
            col, n = ctc_greedy_collapse(path, feats.mask_x0,
                                         cfg.ctc_blank_id, cfg.pad_token_id,
                                         max_out_len)
        outs.append(col)
        lens.append(n)
    return torch.cat(outs, dim=1), torch.stack(lens)
