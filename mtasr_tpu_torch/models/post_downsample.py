"""The WavLM post-downsampler (counterpart of
`mtasr_tpu/models/post_downsample.py`): two rounds of a stride-2 Conv1d
and a GLU, 4x fewer frames, with the lengths carried through the conv's
length formula. No config wires it, in the JAX package or here: the
reference builds it but its one call site is commented out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mtasr_tpu_torch.models.layers import conv1d, dropout


class PostDownsample(nn.Module):
    """`init_post_downsample_params`: two Conv1d of dim -> 2 * dim (torch
    layout [out, in, k], the JAX init's uniform fan-in distribution)."""

    def __init__(self, dim: int, kernel: int = 3):
        super().__init__()
        self.conv1 = nn.Conv1d(dim, 2 * dim, kernel)
        self.conv2 = nn.Conv1d(dim, 2 * dim, kernel)


def post_downsample(p: PostDownsample, x: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    kernel: int = 3, stride: int = 2,
                    drop_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x [B, T, D] -> [B, about T / 4, D]; each round's dropout from
    `generator` unless deterministic; lengths become floor((L + 2 pad -
    k) / s) + 1 twice."""
    pad = kernel // 2
    for conv in (p.conv1, p.conv2):
        a, b = conv1d(conv, x, stride=stride, padding=pad).chunk(2, dim=-1)
        x = dropout(a * torch.sigmoid(b), drop_rate, generator,
                    deterministic)
        if lengths is not None:
            lengths = (lengths + 2 * pad - kernel) // stride + 1
    return x, lengths
