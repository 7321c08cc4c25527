"""Train and eval steps (counterpart of `mtasr_tpu/train/train_step.py`,
without PCGrad): one teacher-forced forward, the loss's backward, the
optimizer update. PCGrad applies only with CTC heads (`talker_ctc`), which
come with hybrid training (ROADMAP.md queue 1, item 11b).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig, TrainingConfig
from mtasr_tpu_torch.models.losses import HYBRID_TODO
from mtasr_tpu_torch.models.speech_encoder_decoder import model_forward
from mtasr_tpu_torch.train.optimizer import AdamW


def _forward(model, cfg, batch, splice_index, deterministic, generator):
    return model_forward(
        model, cfg, batch["input_values"], batch.get("audio_mask"),
        batch["decoder_input_ids"], splice_index=splice_index,
        ce_labels=batch.get("ce_labels"),
        mask_time_indices=batch.get("mask_time_indices"),
        deterministic=deterministic, generator=generator)


def make_train_step(cfg: SpeechEncoderDecoderConfig, tc: TrainingConfig,
                    optimizer: AdamW, *, splice_index: int = 1) -> Callable:
    """step(model, batch, generator) -> metrics: updates `model` in place.
    batch: tensors on the model's device, keys input_values, audio_mask,
    decoder_input_ids, ce_labels[, mask_time_indices]. Dropout runs from
    `generator`. Metrics (0-d tensors, not synchronised): loss, grad_norm
    (of the trainable gradients, before clipping) and loss_attn."""
    if (tc.pcgrad and cfg.talker_ctc and cfg.talker_numbers >= 2
            and cfg.train_mode in ("ctc", "hybrid")):
        raise NotImplementedError("PCGrad: " + HYBRID_TODO)

    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        out = _forward(model, cfg, batch, splice_index, False, generator)
        out.loss.backward()
        metrics = {"loss": out.loss.detach(),
                   "grad_norm": optimizer.grad_norm(),
                   "loss_attn": out.aux["loss_attn"].detach()}
        optimizer.step()
        optimizer.zero_grad()
        return metrics
    return step


def make_eval_step(cfg: SpeechEncoderDecoderConfig, *,
                   splice_index: int = 1) -> Callable:
    """eval_step(model, batch) -> {"loss", "loss_attn"}, deterministic."""
    @torch.no_grad()
    def eval_step(model, batch):
        out = _forward(model, cfg, batch, splice_index, True, None)
        return {"loss": out.loss, "loss_attn": out.aux["loss_attn"]}
    return eval_step
