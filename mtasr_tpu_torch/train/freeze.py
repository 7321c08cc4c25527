"""Which parameters train (counterpart of `mtasr_tpu/train/freeze.py`, the
reference's freeze-all-then-unfreeze policy). The decision is the JAX
package's, on the same names: the port's parameter names are the JAX
tree's flat keys, read here with "/" for ".".

`trainable_mask` gives name -> bool; `apply_trainable_mask` sets
`requires_grad` from it, so a frozen parameter gets no gradient, and the
optimizer (`train/optimizer.py`) holds no state for it and never touches
it: no update and no weight decay.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def trainable_mask(model: torch.nn.Module, *, train_mode: str = "attention",
                   freeze_feature_encoder: bool = True,
                   freeze_encoder: bool = False,
                   freeze_decoder: bool = False,
                   partial_encoder_unfreeze: Sequence[str] = (
                       "masked_spec_embed",),
                   partial_decoder_unfreeze: Sequence[str] = (),
                   partial_others_unfreeze: Sequence[str] = (
                       "enc_to_dec_proj", "ctc"),
                   train_all: bool = False) -> Dict[str, bool]:
    """{parameter name: True if it trains}."""
    def decide(name: str) -> bool:
        if train_all:
            return True
        s = name.replace(".", "/")
        top = s.split("/")[0]
        if top == "encoder":
            frozen_fe = freeze_feature_encoder and "/feature_extractor/" in s
            if frozen_fe:
                return False
            if train_mode != "ctc" and ("adapter" in s
                                        or "masked_spec_embed" in s):
                return True
            if not freeze_encoder:
                return True
            return any(sub and sub in s for sub in partial_encoder_unfreeze)
        if top == "decoder":
            if not freeze_decoder:
                return True
            return any(sub and sub in s for sub in partial_decoder_unfreeze)
        if top == "decoder_lora":
            return "lora_A" in s or "lora_B" in s
        return ("enc_to_dec_proj" in s
                or any(sub and sub in s for sub in partial_others_unfreeze)
                or top in ("separator", "serialized_ctc", "cross_att_adap",
                           "serilized_refine", "ctc_extractor_concat"))

    return {name: decide(name) for name, _ in model.named_parameters()}


def apply_trainable_mask(model: torch.nn.Module,
                         mask: Dict[str, bool]) -> None:
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])


def freeze_summary(model: torch.nn.Module,
                   mask: Dict[str, bool]) -> Dict[str, int]:
    """Parameter counts: total, trainable, frozen."""
    total = trainable = 0
    for name, p in model.named_parameters():
        total += p.numel()
        trainable += p.numel() if mask[name] else 0
    return {"total": total, "trainable": trainable,
            "frozen": total - trainable}
