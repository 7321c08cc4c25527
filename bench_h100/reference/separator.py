"""The speaker separator and the serialized-CTC heads, plain float32:
Linear + ReLU + LayerNorm, a two-layer LSTM (gates i, f, g, o from one
linear over [x_t, h_t]; zero initial state), LayerNorm, then per talker
Linear + ReLU, Linear + ReLU, LayerNorm and its head's projection to the
vocabulary and the blank."""
from __future__ import annotations

from typing import List, Optional

import torch

from bench_h100.reference.common import (
    Weights, fake_quant, layer_norm, linear, weight,
)


def lstm(w: Weights, name: str, x: torch.Tensor,
         quant: Optional[int] = None) -> torch.Tensor:
    R, T, In = x.shape
    W = fake_quant(weight(w, name), quant)                   # [4H, In + H]
    H = W.shape[0] // 4
    xp = fake_quant(x, quant) @ W[:, :In].t() + w[f"{name}.bias"].float()
    Wh = W[:, In:].t()
    h = torch.zeros((R, H), device=x.device)
    c = torch.zeros((R, H), device=x.device)
    ys = []
    for t in range(T):
        i, f, g, o = (xp[:, t] + fake_quant(h, quant) @ Wh).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, 1)


def head_logits(w: Weights, talkers: int, mixed: torch.Tensor,
                quant: Optional[int] = None) -> List[torch.Tensor]:
    """mixed [R, T0, E] (the 50 Hz features) -> per talker the CTC logits
    [R, T0, vocab + 1]."""
    y = layer_norm(w, "separator.pre_ln",
                   torch.relu(linear(w, "separator.pre_proj", mixed, quant)))
    li = 0
    while f"separator.lstm.cells.{li}.weight" in w:
        y = lstm(w, f"separator.lstm.cells.{li}", y, quant)
        li += 1
    y = layer_norm(w, "separator.post_ln", y)
    out = []
    for k in range(talkers):
        b = f"separator.sep_branches.{k}"
        h = torch.relu(linear(w, f"{b}.0", y, quant))
        h = layer_norm(w, f"{b}.ln", torch.relu(linear(w, f"{b}.2", h, quant)))
        out.append(linear(w, f"serialized_ctc.{k}.ctc_lo", h, quant))
    return out
