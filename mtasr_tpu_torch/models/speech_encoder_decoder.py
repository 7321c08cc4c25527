"""Composite speech encoder-decoder, attention mode (counterpart of
`mtasr_tpu/models/speech_encoder_decoder.py`): WavLM -> adapter ->
`enc_to_dec_proj` -> LLaMA with the speech spliced into the prompt.

The port serves and trains `train_mode="attention"` with no separator,
serialized-CTC heads, CTC bridges or cross-attention adapters; a config
that asks for one of those is refused with the `ROADMAP.md` item that
ports it. `model_forward` is the teacher-forced training forward: the
speech spliced into the decoder inputs, the labels laid out behind it, and
the cross-entropy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig
from mtasr_tpu_torch.models.layers import linear
from mtasr_tpu_torch.models.llama import Llama, embed_tokens, llama_forward
from mtasr_tpu_torch.models.losses import HYBRID_TODO, hybrid_loss
from mtasr_tpu_torch.models.wavlm import (
    WavLM, feature_vector_attention_mask, wavlm_forward,
)


def check_supported(cfg: SpeechEncoderDecoderConfig) -> None:
    """Raise NotImplementedError for the parts of the JAX model this slice
    of the port does not have yet."""
    if cfg.talker_ctc or cfg.train_mode != "attention":
        raise NotImplementedError(
            "talker_ctc / " + HYBRID_TODO + "; the one-shot CTC decode "
            "comes with it")
    if cfg.ctc_bridge or cfg.talker_ctc_refine or cfg.decoder_cross_attention:
        raise NotImplementedError(
            "CTC bridges, refiners and cross-attention adapters are not "
            "ported yet (ROADMAP.md queue 1, item 12: bridge and adapter "
            "family)")


class SpeechEncoderDecoderModel(nn.Module):
    """Parameter container of the composite model: `encoder.*`,
    `decoder.*` and, when the widths differ, `enc_to_dec_proj`."""

    def __init__(self, cfg: SpeechEncoderDecoderConfig):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
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


@dataclass
class EncodedSpeech:
    """What the decoder needs, computed once per batch."""
    encoder_hidden_states: torch.Tensor   # [B, Ts, H_dec]
    encoder_attention_mask: torch.Tensor  # [B, Ts] True = valid


@dataclass
class SpeechFeats:
    """The encoder's output, before the bridge (attention mode: the
    adapter features and their mask; the 50 Hz features and their mask
    join when the CTC path is ported)."""
    speech: torch.Tensor    # [B, T8, D] adapter output
    enc_mask: torch.Tensor  # [B, T8] True = valid


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
    check_supported(cfg)
    speech = wavlm_forward(model.encoder, cfg.encoder, input_values,
                           audio_mask, mask_time_indices=mask_time_indices,
                           deterministic=deterministic,
                           generator=generator).last_hidden_state
    B, T8 = speech.shape[:2]
    if audio_mask is not None:
        enc_mask = feature_vector_attention_mask(cfg.encoder, T8, audio_mask)
    else:
        enc_mask = torch.ones((B, T8), dtype=torch.bool, device=speech.device)
    return SpeechFeats(speech=speech, enc_mask=enc_mask)


def bridge_features(model: SpeechEncoderDecoderModel,
                    cfg: SpeechEncoderDecoderConfig,
                    feats: SpeechFeats) -> EncodedSpeech:
    return EncodedSpeech(
        encoder_hidden_states=_proj_to_decoder(model, feats.speech),
        encoder_attention_mask=feats.enc_mask)


def encode_speech(model: SpeechEncoderDecoderModel,
                  cfg: SpeechEncoderDecoderConfig,
                  input_values: torch.Tensor, audio_mask,
                  **kw) -> EncodedSpeech:
    return bridge_features(
        model, cfg, encode_feats(model, cfg, input_values, audio_mask, **kw))


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
                  mask_time_indices: Optional[torch.Tensor] = None,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> ForwardOutput:
    """Teacher-forced forward (`speech_encoder_decoder.py:345-367`):
    input_values [B, S], audio_mask [B, S], decoder_input_ids [B, L]
    (shifted, pad-appended), ce_labels [B, L] (eos inserted). Dropout,
    SpecAugment and the LoRA's input dropout run unless `deterministic`,
    from `generator`."""
    enc = encode_speech(model, cfg, input_values, audio_mask,
                        mask_time_indices=mask_time_indices,
                        deterministic=deterministic, generator=generator)
    return model_forward_from_enc(
        model, cfg, enc, decoder_input_ids, splice_index=splice_index,
        ce_labels=ce_labels,
        generator=None if deterministic else generator)


def model_forward_from_enc(model: SpeechEncoderDecoderModel,
                           cfg: SpeechEncoderDecoderConfig,
                           enc: EncodedSpeech,
                           decoder_input_ids: torch.Tensor, *,
                           splice_index: int = 1,
                           ce_labels: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> ForwardOutput:
    """The decoder over [prefix | speech | suffix] and the loss
    (`speech_encoder_decoder.py:370-444`). As in the JAX package the
    decoder sees no padding mask in training, only causality; `generator`
    (training only) drives the LoRA's input dropout."""
    check_supported(cfg)
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
        generator=generator)
    loss, aux = None, {}
    if ce_labels is not None:
        # the speech span (and in instruct mode the prompt up to <bosr>)
        # is ignored: labels_full = [ignore * prefix | tail]
        if cfg.instruct:
            prefix_len, tail = Ts + splice_index + 1, \
                ce_labels[:, splice_index + 1:]
        else:
            prefix_len, tail = Ts, ce_labels
        ignore = torch.full((B, prefix_len), cfg.ignore_token_id,
                            dtype=ce_labels.dtype, device=ce_labels.device)
        loss, aux = hybrid_loss(cfg.train_mode, cfg.ctc_alpha, logits=logits,
                                labels=torch.cat([ignore, tail], dim=1),
                                ignore_id=cfg.ignore_token_id)
    return ForwardOutput(loss=loss, logits=logits, aux=aux)
