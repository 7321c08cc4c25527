"""Speaker separator (counterpart of `mtasr_tpu/models/separator.py`):
Linear(in -> hidden) + ReLU + LayerNorm -> a 2-layer LSTM with dropout after
each layer -> LayerNorm -> K branches of [Linear + ReLU, Linear + ReLU +
LayerNorm], each branch's last bias offset by `1e-3 * k` to break the
symmetry. Its input is the encoder's 50 Hz output, `encoder.hidden_size`
wide (not the adapter's `output_hidden_size`).

Parameter names are the JAX tree's: `pre_proj`, `pre_ln`, `lstm.cells.{l}`
(one `[4H, In+H]` cell weight, torch Linear layout), `post_ln`,
`sep_branches.{k}.{0,2,ln}`.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from mtasr_tpu_torch.models.layers import dropout, layer_norm, linear
from mtasr_tpu_torch.ops.lstm import lstm


class Separator(nn.Module):
    def __init__(self, in_dim: int, hidden_size: int, talker_numbers: int,
                 num_layers: int = 2):
        super().__init__()
        self.pre_proj = nn.Linear(in_dim, hidden_size)
        self.pre_ln = nn.LayerNorm(hidden_size)
        self.post_ln = nn.LayerNorm(hidden_size)
        self.lstm = nn.Module()
        self.lstm.cells = nn.ModuleDict({
            str(i): nn.Linear(2 * hidden_size, 4 * hidden_size)
            for i in range(num_layers)})
        self.sep_branches = nn.ModuleDict()
        for k in range(talker_numbers):
            branch = nn.ModuleDict()
            branch["0"] = nn.Linear(hidden_size, hidden_size)
            branch["2"] = nn.Linear(hidden_size, in_dim)
            branch["ln"] = nn.LayerNorm(in_dim)
            self.sep_branches[str(k)] = branch


@torch.no_grad()
def init_separator(sep: Separator, generator: torch.Generator,
                   break_symmetry_eps: float = 1e-3) -> None:
    """The JAX init's distributions (`separator.py:24-57`), drawn from
    `generator`: Xavier-uniform projections with zero biases (branch k's
    last bias `eps * k`), LayerNorms 1 / 0, LSTM cells torch Linear's
    default (uniform within 1 / sqrt(fan_in), weight and bias)."""
    def xavier(m: nn.Linear, bias: float = 0.0) -> None:
        out_dim, in_dim = m.weight.shape
        bound = math.sqrt(6.0 / (in_dim + out_dim))
        m.weight.uniform_(-bound, bound, generator=generator)
        m.bias.fill_(bias)

    xavier(sep.pre_proj)
    for ln in (sep.pre_ln, sep.post_ln):
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    for cell in sep.lstm.cells.values():
        bound = 1.0 / math.sqrt(cell.weight.shape[1])
        cell.weight.uniform_(-bound, bound, generator=generator)
        cell.bias.uniform_(-bound, bound, generator=generator)
    for k, branch in enumerate(sep.sep_branches.values()):
        xavier(branch["0"])
        xavier(branch["2"], break_symmetry_eps * k)
        branch["ln"].weight.fill_(1.0)
        branch["ln"].bias.zero_()


def separator_forward(sep: Separator, x: torch.Tensor, talker_numbers: int,
                      lstm_dropout: float = 0.2, deterministic: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> List[torch.Tensor]:
    """x [B, T, in_dim] (the mixed 50 Hz encoding) -> K x [B, T, in_dim].
    Dropout after each LSTM layer unless `deterministic`, from
    `generator`."""
    y = layer_norm(sep.pre_ln, torch.relu(linear(sep.pre_proj, x)))
    for cell in sep.lstm.cells.values():
        y = lstm(y, cell.weight.t(), cell.bias)
        y = dropout(y, lstm_dropout, generator, deterministic)
    y = layer_norm(sep.post_ln, y)
    outs = []
    for k in range(talker_numbers):
        branch = sep.sep_branches[str(k)]
        h = torch.relu(linear(branch["0"], y))
        h = torch.relu(linear(branch["2"], h))
        outs.append(layer_norm(branch["ln"], h))
    return outs
