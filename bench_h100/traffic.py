"""The one generator of the benchmark's traffic, driven by a mix file's
parameters and the seed.

Serving (`entry` transcribe / transcribe_ctc): `distinct_calls` calls of
`batch` recordings each, replayed in turn through the window. A call's
lengths are the same for every seed: `batch` values evenly spaced over
`lengths_s` (the centres of `batch` equal bins), in an order drawn from
the seed, so every seed offers the same work; the samples are noise
(N(0, 0.1^2)) drawn from the seed on the run's device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

SAMPLING_RATE = 16000


@dataclass
class Call:
    wavs: List[np.ndarray]
    audio_s: float          # seconds of unpadded audio


def stratified_lengths(lo_s: float, hi_s: float, n: int) -> np.ndarray:
    """`n` lengths in samples, the centres of n equal bins of [lo, hi]."""
    secs = lo_s + (hi_s - lo_s) * (np.arange(n) + 0.5) / n
    return np.round(secs * SAMPLING_RATE).astype(np.int64)


def serve_calls(mix: dict, seed: int, device) -> List[Call]:
    B = mix["batch"]
    lengths = stratified_lengths(*mix["lengths_s"], B)
    rng = np.random.default_rng(int(seed))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    calls = []
    for _ in range(mix["distinct_calls"]):
        order = lengths[rng.permutation(B)]
        noise = (torch.randn((B, int(order.max())), generator=g,
                             device=device) * 0.1).cpu().numpy()
        wavs = [np.ascontiguousarray(noise[i, :n]) for i, n in
                enumerate(order)]
        calls.append(Call(wavs, float(order.sum()) / SAMPLING_RATE))
    return calls
