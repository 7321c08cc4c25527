"""WavLM-Large with the system's conv adapter, plain float32: the
published equations (HF `WavLMModel` with `do_stable_layer_norm`), the
waveform normalised per recording over its own samples and zero-padded to
the batch's bucket, as a batch of them is served."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference.common import Weights, layer_norm, linear


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def normalized_batch(wavs: Sequence[np.ndarray], n_samples: int,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(waveforms [R, n_samples] float32, lengths [R]): each recording
    normalised to zero mean and unit variance (eps 1e-7) over its own
    samples, in float64, then zero-padded."""
    x = torch.zeros((len(wavs), n_samples), dtype=torch.float32)
    lengths = []
    for i, w in enumerate(wavs):
        w = torch.as_tensor(np.asarray(w), dtype=torch.float64)
        w = (w - w.mean()) / torch.sqrt(w.var(unbiased=False) + 1e-7)
        x[i, :len(w)] = w.float()
        lengths.append(len(w))
    return x.to(device), torch.tensor(lengths, device=device)


def conv_lengths(enc: dict, n: torch.Tensor) -> torch.Tensor:
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
    return n


def adapter_lengths(enc: dict, n: torch.Tensor) -> torch.Tensor:
    for _ in range(enc["num_adapter_layers"]):
        n = (n - 1) // enc["adapter_stride"] + 1
    return n


def relative_buckets(T: int, num_buckets: int, max_distance: int,
                     device) -> torch.Tensor:
    """WavLM's bidirectional log-spaced buckets of (key - query)."""
    rel = (torch.arange(T, device=device)[None, :]
           - torch.arange(T, device=device)[:, None])
    half = num_buckets // 2
    out = (rel > 0).long() * half
    dist = rel.abs()
    exact = half // 2
    far = exact + (torch.log(dist.clamp(min=1).double() / exact)
                   / math.log(max_distance / exact)
                   * (half - exact)).long()
    return out + torch.where(dist < exact, dist, far.clamp(max=half - 1))


def _conv(w: Weights, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
    b = w.get(f"{name}.bias")
    return F.conv1d(x, w[f"{name}.weight"].float(),
                    None if b is None else b.float(), **kw)


def encode(w: Weights, enc: dict, x: torch.Tensor, lengths: torch.Tensor,
           quant=None, prefix: str = "encoder."):
    """x [R, S] normalised, padded waveforms; lengths [R] samples. Returns
    (50 Hz features [R, T0, E], their mask [R, T0], adapter output
    [R, T8, E], its mask [R, T8])."""
    p = prefix
    h = x[:, None, :]
    for i, (k, s) in enumerate(zip(enc["conv_kernel"], enc["conv_stride"])):
        name = f"{p}feature_extractor.conv_layers.{i}"
        h = _conv(w, f"{name}.conv", h, stride=s)
        h = gelu(layer_norm(w, f"{name}.layer_norm", h.transpose(1, 2))
                 ).transpose(1, 2)
    h = h.transpose(1, 2)                                    # [R, T0, C]
    T0 = h.shape[1]
    mask0 = (torch.arange(T0, device=x.device)[None]
             < conv_lengths(enc, lengths)[:, None])
    h = layer_norm(w, f"{p}feature_projection.layer_norm", h,
                   enc["layer_norm_eps"])
    h = linear(w, f"{p}feature_projection.projection", h, quant)
    h = h * mask0[..., None]
    K = enc["num_conv_pos_embeddings"]
    pos = _conv(w, f"{p}encoder.pos_conv_embed.conv", h.transpose(1, 2),
                padding=K // 2, groups=enc["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[..., :-1]
    h = h + gelu(pos.transpose(1, 2))
    E, H = enc["hidden_size"], enc["num_attention_heads"]
    D = E // H
    table = w[f"{p}encoder.layers.0.attention.rel_attn_embed.weight"].float()
    bias = table[relative_buckets(T0, enc["num_buckets"],
                                  enc["max_bucket_distance"], x.device)]
    bias = bias.permute(2, 0, 1)                              # [H, T, T]
    key_ok = mask0[:, None, None, :]
    R = h.shape[0]
    eps = enc["layer_norm_eps"]
    for i in range(enc["num_hidden_layers"]):
        lp = f"{p}encoder.layers.{i}"
        a = layer_norm(w, f"{lp}.layer_norm", h, eps)
        q = linear(w, f"{lp}.attention.q_proj", a, quant)
        k = linear(w, f"{lp}.attention.k_proj", a, quant)
        v = linear(w, f"{lp}.attention.v_proj", a, quant)
        q, k, v = (t.reshape(R, T0, H, D).transpose(1, 2) for t in (q, k, v))
        g = linear(w, f"{lp}.attention.gru_rel_pos_linear",
                   a.reshape(R, T0, H, D))
        g = torch.sigmoid(g.reshape(R, T0, H, 2, 4).sum(-1))
        const = w[f"{lp}.attention.gru_rel_pos_const"].float()
        gate = g[..., 0] * (g[..., 1] * const - 1.0) + 2.0     # [R, T, H]
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
        scores = scores + gate.transpose(1, 2)[..., None] * bias[None]
        scores = scores.masked_fill(~key_ok, float("-inf"))
        att = torch.softmax(scores, -1) @ v
        att = att.transpose(1, 2).reshape(R, T0, E)
        h = h + linear(w, f"{lp}.attention.out_proj", att, quant)
        f = layer_norm(w, f"{lp}.final_layer_norm", h, eps)
        f = gelu(linear(w, f"{lp}.feed_forward.intermediate_dense", f, quant))
        h = h + linear(w, f"{lp}.feed_forward.output_dense", f, quant)
    mixed = layer_norm(w, f"{p}encoder.layer_norm", h, eps)
    s = mixed.transpose(1, 2)
    for i in range(enc["num_adapter_layers"]):
        s = _conv(w, f"{p}adapter.layers.{i}.conv", s,
                  stride=enc["adapter_stride"],
                  padding=enc["adapter_kernel_size"] // 2)
        a, b = s.chunk(2, dim=1)
        s = a * torch.sigmoid(b)
    speech = s.transpose(1, 2)
    T8 = speech.shape[1]
    mask8 = (torch.arange(T8, device=x.device)[None]
             < adapter_lengths(enc, conv_lengths(enc, lengths))[:, None])
    return mixed, mask0, speech, mask8


def encode_rows(w: Weights, enc: dict, wavs: List[np.ndarray],
                n_samples: int, device, quant=None, block: int = 4):
    """`encode` over `wavs` in blocks of `block` recordings (so that the
    conv stack's activations fit), concatenated."""
    outs = []
    for i in range(0, len(wavs), block):
        x, n = normalized_batch(wavs[i:i + block], n_samples, device)
        outs.append(encode(w, enc, x, n, quant))
    return tuple(torch.cat(parts) for parts in zip(*outs))
