"""Train and eval steps with PCGrad multi-head gradient surgery (counterpart
of `mtasr_tpu/train/train_step.py`).

Without PCGrad a step is one forward, the loss's backward and the optimizer
update. With it (`tc.pcgrad`, CTC heads, K >= 2 talkers, train_mode ctc or
hybrid), the shared parameters (`encoder`, `separator`) take the PCGrad
projection of the K per-head CTC gradients, and everything else the total
loss's gradient. Kept exactly as the JAX package keeps the reference's:

* the sweep is sequential and in place: for i, then j != i, g_i -= (g_i.g_j
  / (||g_j||^2 + 1e-12)) g_j where the dot is negative; the SUM of the
  projected g_i replaces the total loss's gradient on the shared
  parameters, which is discarded, cross-entropy part included (so the
  encoder adapter, which no head reads, gets a zero gradient);
* only trainable shared parameters take part (frozen ones have none).

Three stages, as the JAX step linearizes them: A (encoder + separator),
B (the bridge) and the decoder with the losses. Stage A's outputs enter the
rest detached, so the total loss's backward stops there and never runs the
encoder; each head's gradient is the per-head CTC (heads held constant)
pulled back onto its separated stream, then through stage A with
`torch.autograd.grad`, the graph retained for the next head: K encoder
backwards a step. PIT picks a per-sample assignment inside the loss, so it
keeps the joint graph: the total loss's backward to the other parameters,
then each head's mean through the whole graph to the shared ones.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig, TrainingConfig
from mtasr_tpu_torch.models.bridges import frame_refiner_forward
from mtasr_tpu_torch.models.losses import serialized_ctc_loss
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    bridge_features, ctc_heads, encode_feats, model_forward,
    model_forward_from_enc,
)
from mtasr_tpu_torch.train.optimizer import AdamW, _global_norm

SHARED_TOPS = ("encoder", "separator")
METRIC_KEYS = ("loss_attn", "loss_ctc", "ctc_head_grad_norms",
               "pit_swap_ratio")


def _dot(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    return sum((x.float() * y.float()).sum() for x, y in zip(a, b))


def pcgrad_project(head_grads: List[List[torch.Tensor]]
                   ) -> List[torch.Tensor]:
    """head_grads: K lists of the shared gradients, one per head. Their
    PCGrad-projected sum, by the reference's sequential sweep
    (`train_step.py:62-78`). Stays on the device: no host sync."""
    grads = [list(g) for g in head_grads]
    K = len(grads)
    for i in range(K):
        for j in range(K):
            if i == j:
                continue
            dot = _dot(grads[i], grads[j])
            norm2 = _dot(grads[j], grads[j]) + 1e-12
            alpha = torch.where(dot < 0, dot / norm2, torch.zeros_like(dot))
            grads[i] = [x - alpha.to(x.dtype) * y
                        for x, y in zip(grads[i], grads[j])]
    out = grads[0]
    for i in range(1, K):
        out = [x + y for x, y in zip(out, grads[i])]
    return out


def _split_params(model: torch.nn.Module):
    """(shared, rest): the trainable parameters under `encoder` /
    `separator`, and the other trainable ones."""
    shared, rest = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (shared if name.split(".")[0] in SHARED_TOPS else rest).append(p)
    return shared, rest


def _grads(out, inputs, grad_outputs=None, retain_graph=True):
    """torch.autograd.grad with zeros for the inputs it does not reach."""
    gs = torch.autograd.grad(out, inputs, grad_outputs=grad_outputs,
                             retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(gs, inputs)]


def _batch_kw(batch):
    return dict(ce_labels=batch.get("ce_labels"),
                label_spks=batch.get("label_spks"),
                label_spk_lens=batch.get("label_spk_lens"))


def _forward(model, cfg, batch, splice_index, deterministic, generator,
             use_pit=False):
    # SpecAugment is a training-time mask: the eval step takes none, as the
    # JAX eval step passes none
    return model_forward(
        model, cfg, batch["input_values"], batch.get("audio_mask"),
        batch["decoder_input_ids"], splice_index=splice_index,
        mask_time_indices=(None if deterministic
                           else batch.get("mask_time_indices")),
        deterministic=deterministic, generator=generator, use_pit=use_pit,
        **_batch_kw(batch))


def _three_stage(model, cfg, batch, splice_index, generator, shared, rest):
    """(out, shared head gradients [K lists], rest gradients) of the
    three-stage split (`train_step.py:155-241`). The family's parameters
    (refiner, extractor, adapters) belong to the rest: the total loss
    reaches them through stage B. A head's CTC is taken on its stream as
    stage B left it; with the refiner its cotangent goes back through the
    refiner (recomputed on stage A's outputs, the refiner's parameters
    held), onto the separated stream and the mixed features, then through
    stage A. No other output of stage B feeds a head, so the raw bridge's
    read of the encoder's adapter gives the shared group nothing."""
    feats = encode_feats(model, cfg, batch["input_values"],
                         batch.get("audio_mask"),
                         mask_time_indices=batch.get("mask_time_indices"),
                         deterministic=False, generator=generator)
    # stage A's outputs enter the rest as constants: the total loss's
    # pullback onto them is what PCGrad discards
    feats_c = type(feats)(
        mixed=feats.mixed.detach(), speech=feats.speech.detach(),
        sep_hidden=[h.detach() for h in feats.sep_hidden],
        enc_mask=feats.enc_mask, mask_x0=feats.mask_x0)
    enc = bridge_features(model, cfg, feats_c)
    out = model_forward_from_enc(
        model, cfg, enc, batch["decoder_input_ids"],
        splice_index=splice_index, generator=generator, **_batch_kw(batch))
    g_rest = _grads(out.loss, rest, retain_graph=False)
    # each head's mean CTC as a function of its stream, the heads
    # constant: pulled back onto the stream, then through stage A
    hlens = feats.mask_x0.sum(1, dtype=torch.int32)
    leaves = [h.detach().requires_grad_(True) for h in enc.sep_hidden]
    _, per_head = serialized_ctc_loss(
        ctc_heads(model, cfg), leaves, hlens, batch["label_spks"],
        batch["label_spk_lens"], cfg.ctc_blank_id, detach_heads=True)
    heads = per_head.mean(1)
    K = heads.shape[0]
    refined = None
    if cfg.talker_ctc_refine:
        mixed_l = feats.mixed.detach().requires_grad_(True)
        sep_l = [h.detach().requires_grad_(True) for h in feats.sep_hidden]
        refined = frame_refiner_forward(
            model.serilized_refine, sep_l, mixed_l, feats.mask_x0,
            ctc_heads(model, cfg), cfg.ctc_blank_id)
    head_grads = []
    for i in range(K):
        last = i == K - 1
        (cot,) = torch.autograd.grad(heads[i], [leaves[i]])
        outs, cots = [feats.sep_hidden[i]], [cot]
        if refined is not None:
            cots = list(torch.autograd.grad(refined[i], [sep_l[i], mixed_l],
                                            [cot], retain_graph=not last))
            outs = [feats.sep_hidden[i], feats.mixed]
        head_grads.append(_grads(outs, shared, cots, retain_graph=not last))
    return out, head_grads, g_rest


def _joint_pit(model, cfg, batch, splice_index, generator, shared, rest):
    """The PIT branch (`train_step.py:124-153`): one graph, the total loss
    pulled back to the rest, each head's mean to the shared parameters."""
    out = _forward(model, cfg, batch, splice_index, False, generator,
                   use_pit=True)
    heads = out.aux["ctc_per_head"].mean(1)
    g_rest = _grads(out.loss, rest)
    K = heads.shape[0]
    head_grads = [_grads(heads[i], shared, retain_graph=i < K - 1)
                  for i in range(K)]
    return out, head_grads, g_rest


def make_train_step(cfg: SpeechEncoderDecoderConfig, tc: TrainingConfig,
                    optimizer: AdamW, *, splice_index: int = 1,
                    use_pit: bool = False) -> Callable:
    """step(model, batch, generator) -> metrics: updates `model` in place.
    batch: tensors on the model's device, keys input_values, audio_mask,
    decoder_input_ids, ce_labels[, label_spks, label_spk_lens,
    mask_time_indices]. Dropout runs from `generator`. Metrics (tensors,
    not synchronised): loss, grad_norm (of the trainable gradients, before
    clipping), and as the mode has them loss_attn, loss_ctc,
    ctc_head_grad_norms [K] (of each head's unprojected shared gradient)
    and pit_swap_ratio."""
    pcgrad = (tc.pcgrad and cfg.talker_ctc and cfg.talker_numbers >= 2
              and cfg.train_mode in ("ctc", "hybrid"))

    def step(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        metrics = {}
        if not pcgrad:
            out = _forward(model, cfg, batch, splice_index, False, generator,
                           use_pit)
            out.loss.backward()
        else:
            shared, rest = _split_params(model)
            branch = _joint_pit if use_pit else _three_stage
            out, head_grads, g_rest = branch(model, cfg, batch, splice_index,
                                             generator, shared, rest)
            for p, g in zip(shared, pcgrad_project(head_grads)):
                p.grad = g
            for p, g in zip(rest, g_rest):
                p.grad = g
            metrics["ctc_head_grad_norms"] = torch.stack(
                [_global_norm(g) for g in head_grads])
        metrics["loss"] = out.loss.detach()
        metrics["grad_norm"] = optimizer.grad_norm()
        for k in METRIC_KEYS:
            if k in out.aux:
                metrics[k] = out.aux[k].detach()
        optimizer.step()
        optimizer.zero_grad()
        return metrics
    return step


def make_eval_step(cfg: SpeechEncoderDecoderConfig, *,
                   splice_index: int = 1) -> Callable:
    """eval_step(model, batch) -> {"loss", "loss_attn", "loss_ctc"} as the
    mode has them, deterministic."""
    @torch.no_grad()
    def eval_step(model, batch):
        out = _forward(model, cfg, batch, splice_index, True, None)
        metrics = {"loss": out.loss}
        for k in ("loss_attn", "loss_ctc"):
            if k in out.aux:
                metrics[k] = out.aux[k]
        return metrics
    return eval_step
