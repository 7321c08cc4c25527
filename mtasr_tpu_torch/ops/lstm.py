"""The separator's LSTM (counterpart of `mtasr_tpu/ops/lstm.py`).

Gate math of the reference cell: one linear over [x_t, h_t] into 4H gates
split (i, f, g, o); i, f, o sigmoid, g tanh; c = f*c + i*g; h = o*tanh(c).
The cell weight is kept as the JAX tree keeps it, one `[In+H, 4H]` matrix
(input-major: torch `Linear.weight.T`) and a `[4H]` bias.

* `lstm_scan` is the JAX function step by step: the input projection is
  hoisted out of the time loop, and h and c stay in the input's dtype. It
  is the plain version, for tests and references.
* `lstm` computes the same function with PyTorch's own LSTM op
  (`torch.lstm`: cuDNN on the card), the cell weight split into
  `weight_ih = w[:In].T` and `weight_hh = w[In:].T`, the bias as `bias_ih`
  and a zero `bias_hh`. The separator runs it: a Python loop of 499 steps
  a layer would launch some 10^4 small kernels a step in forward and in each
  backward. The recurrence is XLA in the JAX package (a `lax.scan`), not a
  TPU kernel, so a library op is the port's counterpart.
"""
from __future__ import annotations

import warnings
from typing import List, Optional

import torch


def lstm_scan(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None,
              c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, In]; w [In+H, 4H]; b [4H]. Returns [B, T, H]."""
    B, T, _ = x.shape
    H = w.shape[1] // 4
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device) if h0 is None \
        else h0
    c = torch.zeros((B, H), dtype=x.dtype, device=x.device) if c0 is None \
        else c0
    w = w.to(x.dtype)
    w_x, w_h = w[:-H], w[-H:]
    x_proj = torch.einsum("bti,ih->bth", x, w_x) + b.to(x.dtype)
    ys = []
    for t in range(T):
        gates = x_proj[:, t] + h @ w_h
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1)


def lstm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The function of `lstm_scan` (zero initial state) through
    `torch.lstm`: x [B, T, In]; w [In+H, 4H]; b [4H] -> [B, T, H]."""
    B, _, In = x.shape
    H = w.shape[1] // 4
    w = w.to(x.dtype)
    b = b.to(x.dtype)
    weights = [w[:In].t().contiguous(), w[In:].t().contiguous(), b,
               torch.zeros_like(b)]
    zeros = torch.zeros((1, B, H), dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        # cuDNN packs the four weights into its buffer on every call (a few
        # MB), and says so once; the weights stay the model's parameters
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, _, _ = torch.lstm(x, (zeros, zeros), weights, True, 1, 0.0,
                               torch.is_grad_enabled(), False, True)
    return out


def stacked_lstm(x: torch.Tensor, weights: List[torch.Tensor],
                 biases: List[torch.Tensor],
                 ln_scales: Optional[List[torch.Tensor]] = None,
                 ln_biases: Optional[List[torch.Tensor]] = None,
                 dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True) -> torch.Tensor:
    """Layers of `lstm` run one after the other over the whole sequence
    (`lstm.py:60-88`), with an optional LayerNorm (eps 1e-5, over the
    features) and inverted dropout from `generator` after each layer."""
    y = x
    for layer, (w, b) in enumerate(zip(weights, biases)):
        y = lstm(y, w, b)
        if ln_scales is not None:
            mean = y.mean(-1, keepdim=True)
            var = ((y - mean) ** 2).mean(-1, keepdim=True)
            y = (y - mean) * torch.rsqrt(var + 1e-5)
            y = y * ln_scales[layer] + ln_biases[layer]
        if dropout_rate > 0.0 and not deterministic:
            keep = torch.rand(y.shape, generator=generator,
                              device=y.device) < 1.0 - dropout_rate
            y = torch.where(keep, y / (1.0 - dropout_rate),
                            torch.zeros((), dtype=y.dtype, device=y.device))
    return y
