"""WavLM speech encoder (counterpart of `mtasr_tpu/models/wavlm.py`).

Conv feature encoder (layer 0 through the fused `conv0_fused` kernel),
feature projection, positional conv, the transformer with WavLM's gated
relative-position bias (attention through the `flash_attention` kernels,
which compose the bias inside, forward and backward), and the conv adapter
with its 4x tap. Training adds what the JAX forward adds: SpecAugment's
`masked_spec_embed` at the host-drawn `mask_time_indices`, dropout at the
JAX sites from an explicit `torch.Generator` (none in attention: the JAX
package reads `attention_dropout` nowhere), the positional conv's weight
norm composed from (g, v) in float32 when the model carries them, and
per-layer recomputation (`torch.utils.checkpoint`) with `cfg.remat`.

Under tensor parallelism (`parallel/mesh.py::shard_model`) a layer's
q/k/v and `intermediate_dense` are column-parallel and `out_proj` and
`output_dense` row-parallel: a rank runs #2 / #3 and #8-#10 at H / tp
heads. The position bias is built from the replicated `rel_attn_embed`
and sliced to the local heads, and the gate reads the local heads'
slices of the input with the replicated `gru_rel_pos_linear` and
`gru_rel_pos_const`; all three enter through `copy_to_tp`, so their
gradients (#10's table gradient among them) are summed over the heads of
every rank. The conv frontend (#1) is replicated.

Parameter names are the JAX tree's flat keys under `encoder.`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtasr_tpu_torch.config import WavLMConfig
from mtasr_tpu_torch.models.layers import (
    conv1d, dropout, gelu, group_norm, layer_norm, linear, remat_layer,
    resolve_act, row_linear,
)
from mtasr_tpu_torch.ops.kernels.conv_frontend import conv0_fused
from mtasr_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, padded_bias,
)
from mtasr_tpu_torch.ops.relpos import relative_position_bucket
from mtasr_tpu_torch.parallel.collectives import (
    copy_to_tp, group_rank, group_size,
)


@dataclass
class WavLMOutput:
    last_hidden_state: torch.Tensor         # [B, T/8, out_hidden]
    encoder_hidden_state: torch.Tensor      # [B, T, hidden] (50 Hz)
    wavlm_down_hidden_states: torch.Tensor  # [B, T/4, out_hidden]
    extract_features: torch.Tensor          # [B, T, conv_dim[-1]]


# ---------------------------------------------------------------------------
# parameter containers (names follow the HF / JAX keys)
# ---------------------------------------------------------------------------
class _ConvLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, kernel: int, bias: bool,
                 norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, bias=bias)
        if norm:
            self.layer_norm = nn.LayerNorm(out_dim)


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        layers, in_dim = {}, 1
        for i, (out_dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
            norm = (cfg.feat_extract_norm == "layer"
                    or (cfg.feat_extract_norm == "group" and i == 0))
            layers[str(i)] = _ConvLayer(in_dim, out_dim, k, cfg.conv_bias,
                                        norm)
            in_dim = out_dim
        self.conv_layers = nn.ModuleDict(layers)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1])
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class _Attention(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_rel_embed: bool):
        super().__init__()
        E, H = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(E, E)
        self.k_proj = nn.Linear(E, E)
        self.v_proj = nn.Linear(E, E)
        self.out_proj = nn.Linear(E, E)
        self.gru_rel_pos_linear = nn.Linear(E // H, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(H))
        if has_rel_embed:
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H)


class _FeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, index: int):
        super().__init__()
        self.attention = _Attention(cfg, has_rel_embed=index == 0)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)


class WeightNormConv1d(nn.Module):
    """The positional conv as torch's weight_norm(dim=2) trains it:
    `weight_g` [1, 1, K] (a magnitude per kernel position), `weight_v`
    [O, I / groups, K] and `bias` [O]; the weight is g * v / ||v|| with the
    norm over (out, in), composed in float32 (`wavlm.py:387-393`)."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(torch.empty(channels, channels // groups,
                                                 kernel))
        self.bias = nn.Parameter(torch.zeros(channels))

    @property
    def weight(self) -> torch.Tensor:
        v = self.weight_v.float()
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
        return (self.weight_g.float() * v / norm).to(self.weight_v.dtype)


def pos_conv_module(cfg: WavLMConfig, weight_norm: bool) -> nn.Module:
    E, K = cfg.hidden_size, cfg.num_conv_pos_embeddings
    G = cfg.num_conv_pos_embedding_groups
    return (WeightNormConv1d(E, K, G) if weight_norm
            else nn.Conv1d(E, E, K, groups=G))


class _PosConvEmbed(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.conv = pos_conv_module(cfg, cfg.pos_conv_weight_norm)


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.layers = nn.ModuleDict({str(i): _EncoderLayer(cfg, i)
                                     for i in range(cfg.num_hidden_layers)})


class _AdapterLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        out_h = cfg.out_hidden
        self.conv = nn.Conv1d(out_h, 2 * out_h, cfg.adapter_kernel_size)


class _Adapter(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        if cfg.out_hidden != cfg.hidden_size:
            self.proj = nn.Linear(cfg.hidden_size, cfg.out_hidden)
            self.proj_layer_norm = nn.LayerNorm(cfg.out_hidden)
        self.layers = nn.ModuleDict({str(i): _AdapterLayer(cfg)
                                     for i in range(cfg.num_adapter_layers)})


class WavLM(nn.Module):
    """Parameter container of the encoder (run it with `wavlm_forward`)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        if cfg.mask_time_prob > 0 or cfg.mask_feature_prob > 0:
            self.masked_spec_embed = nn.Parameter(
                torch.zeros(cfg.hidden_size))
        self.encoder = _Encoder(cfg)
        if cfg.add_adapter:
            self.adapter = _Adapter(cfg)


# ---------------------------------------------------------------------------
# length / mask arithmetic
# ---------------------------------------------------------------------------
def conv_output_lengths(cfg: WavLMConfig,
                        lengths: torch.Tensor) -> torch.Tensor:
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


def feat_extract_output_lengths(cfg: WavLMConfig, lengths: torch.Tensor,
                                num_adapter_layers: int) -> torch.Tensor:
    lengths = conv_output_lengths(cfg, lengths)
    for _ in range(num_adapter_layers):
        lengths = (lengths - 1) // cfg.adapter_stride + 1
    return lengths


def _lengths_to_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    j = torch.arange(T, device=lengths.device)
    return j[None, :] < lengths.clamp(0, T)[:, None]


def feature_vector_attention_mask(cfg: WavLMConfig, T: int,
                                  attention_mask: torch.Tensor,
                                  num_adapter_layers: Optional[int] = None
                                  ) -> torch.Tensor:
    """Boolean [B, T] mask on the feature axis. `num_adapter_layers`:
    None -> full adapter, 0 -> conv only, n -> after n adapter convs."""
    if num_adapter_layers is None:
        num_adapter_layers = cfg.num_adapter_layers if cfg.add_adapter else 0
    lengths = feat_extract_output_lengths(
        cfg, attention_mask.long().sum(-1), num_adapter_layers)
    return _lengths_to_mask(lengths, T)


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------
def feature_encoder(fe: _FeatureExtractor, cfg: WavLMConfig,
                    input_values: torch.Tensor) -> torch.Tensor:
    """[B, S] waveform -> [B, T, conv_dim[-1]] at 50 Hz. Layer 0 always runs
    through `conv0_fused`: with the LayerNorm and gelu fused when the config
    has them with the exact erf (WavLM-Large), else the conv alone, the
    norm and `cfg.feat_extract_activation` following here, as the JAX
    package composes them after its kernel (`wavlm.py:213-220`)."""
    act = resolve_act(cfg.feat_extract_activation, cfg.gelu_impl)
    lp = fe.conv_layers["0"]
    fuse = (cfg.feat_extract_norm == "layer"
            and cfg.feat_extract_activation == "gelu"
            and cfg.gelu_impl != "fast")
    x = conv0_fused(input_values, lp.conv.weight, lp.conv.bias,
                    lp.layer_norm.weight if fuse else None,
                    lp.layer_norm.bias if fuse else None,
                    stride=cfg.conv_stride[0], fuse_ln=fuse, fuse_act=fuse)
    if not fuse:
        if cfg.feat_extract_norm == "layer":
            x = layer_norm(lp.layer_norm, x)
        elif cfg.feat_extract_norm == "group":
            x = group_norm(lp.layer_norm, x.transpose(1, 2),
                           num_groups=cfg.conv_dim[0]).transpose(1, 2)
        x = act(x)
    for i in range(1, len(cfg.conv_kernel)):
        lp = fe.conv_layers[str(i)]
        x = conv1d(lp.conv, x, stride=cfg.conv_stride[i])
        if cfg.feat_extract_norm == "layer":
            x = layer_norm(lp.layer_norm, x)
        x = act(x)
    return x


def _local_heads(n_heads: int, tp) -> slice:
    n = n_heads // group_size(tp)
    return slice(group_rank(tp) * n, (group_rank(tp) + 1) * n)


def _attention_gate(att: _Attention, x: torch.Tensor,
                    n_heads: int) -> torch.Tensor:
    """Per-(batch, head, query) gate of the shared rel-pos bias, [B, H, T]
    (this rank's heads under tp: `n_heads` are all of them)."""
    B, T, E = x.shape
    gh = x.reshape(B, T, n_heads, E // n_heads)
    const = att.gru_rel_pos_const
    tp = getattr(att, "tp", None)
    if tp is None:
        proj = linear(att.gru_rel_pos_linear, gh)
    else:
        heads = _local_heads(n_heads, tp)
        gh, const = gh[:, :, heads], copy_to_tp(const, tp)[heads]
        lin = att.gru_rel_pos_linear
        proj = F.linear(gh, copy_to_tp(lin.weight, tp).to(x.dtype),
                        copy_to_tp(lin.bias, tp).to(x.dtype))
        n_heads = gh.shape[2]
    proj = proj.reshape(B, T, n_heads, 2, 4).sum(-1)
    gates = torch.sigmoid(proj)
    gate_a, gate_b = gates[..., 0], gates[..., 1]
    const = const.to(x.dtype)
    gate_out = gate_a * (gate_b * const[None, None, :] - 1.0) + 2.0
    return gate_out.transpose(1, 2).contiguous()


def _wavlm_attention(att: _Attention, cfg: WavLMConfig, x: torch.Tensor,
                     position_bias: torch.Tensor,
                     key_valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
    B, T, E = x.shape
    H = cfg.num_attention_heads
    D = E // H
    tp = getattr(att, "tp", None)
    x = copy_to_tp(x, tp)
    Hl = H // group_size(tp)
    q = linear(att.q_proj, x).reshape(B, T, Hl, D)
    k = linear(att.k_proj, x).reshape(B, T, Hl, D)
    v = linear(att.v_proj, x).reshape(B, T, Hl, D)
    kv_lens = (key_valid_mask.sum(-1, dtype=torch.int32)
               if key_valid_mask is not None else None)
    out = flash_attention(q, k, v, kv_lens=kv_lens,
                          pos_bias=position_bias.to(x.dtype),
                          gate=_attention_gate(att, x, H))
    return row_linear(att.out_proj, out.reshape(B, T, Hl * D), tp)


def _feed_forward(ff: _FeedForward, cfg: WavLMConfig, x: torch.Tensor,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    tp = getattr(ff, "tp", None)
    x = copy_to_tp(x, tp)
    act = resolve_act(cfg.hidden_act, cfg.gelu_impl)
    h = act(linear(ff.intermediate_dense, x))
    h = dropout(h, cfg.activation_dropout, generator, deterministic)
    h = row_linear(ff.output_dense, h, tp)
    return dropout(h, cfg.hidden_dropout, generator, deterministic)


def wavlm_encoder_layer(lp: _EncoderLayer, cfg: WavLMConfig,
                        hidden: torch.Tensor, position_bias: torch.Tensor,
                        attention_mask: Optional[torch.Tensor],
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    if cfg.do_stable_layer_norm:
        h = _wavlm_attention(lp.attention, cfg,
                             layer_norm(lp.layer_norm, hidden, eps),
                             position_bias, attention_mask)
        hidden = hidden + dropout(h, cfg.hidden_dropout, generator,
                                  deterministic)
        return hidden + _feed_forward(
            lp.feed_forward, cfg,
            layer_norm(lp.final_layer_norm, hidden, eps), deterministic,
            generator)
    h = _wavlm_attention(lp.attention, cfg, hidden, position_bias,
                         attention_mask)
    h = dropout(h, cfg.hidden_dropout, generator, deterministic)
    hidden = layer_norm(lp.layer_norm, hidden + h, eps)
    hidden = hidden + _feed_forward(lp.feed_forward, cfg, hidden,
                                    deterministic, generator)
    return layer_norm(lp.final_layer_norm, hidden, eps)


def wavlm_encoder_prologue(enc: _Encoder, cfg: WavLMConfig,
                           hidden: torch.Tensor,
                           attention_mask: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input masking, positional conv embedding, the non-stable-LN pre-norm
    and the shared [H, T, T] relative-position bias, built once for the
    layers with its rows padded to 16 bytes (`padded_bias`: what the flash
    kernel's TMA reads)."""
    B, T, E = hidden.shape
    if attention_mask is not None:
        hidden = hidden * attention_mask[:, :, None].to(hidden.dtype)
    pos = conv1d(enc.pos_conv_embed.conv, hidden,
                 padding=cfg.num_conv_pos_embeddings // 2,
                 groups=cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :-1, :]
    hidden = hidden + gelu(pos)
    if not cfg.do_stable_layer_norm:
        hidden = layer_norm(enc.layer_norm, hidden, cfg.layer_norm_eps)
    buckets = relative_position_bucket(T, T, cfg.num_buckets,
                                       cfg.max_bucket_distance,
                                       device=hidden.device)
    att0 = enc.layers["0"].attention
    table = att0.rel_attn_embed.weight
    tp = getattr(att0, "tp", None)
    if tp is not None:   # this rank's heads
        table = copy_to_tp(table, tp)[:, _local_heads(table.shape[1], tp)]
    position_bias = padded_bias(table[buckets].permute(2, 0, 1))
    return hidden, position_bias


def wavlm_encoder(enc: _Encoder, cfg: WavLMConfig, hidden: torch.Tensor,
                  attention_mask: Optional[torch.Tensor],
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    hidden, position_bias = wavlm_encoder_prologue(enc, cfg, hidden,
                                                   attention_mask)
    hidden = dropout(hidden, cfg.hidden_dropout, generator, deterministic)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_hidden_layers):
        args = (enc.layers[str(i)], cfg, hidden, position_bias,
                attention_mask, deterministic, generator)
        hidden = (remat_layer(wavlm_encoder_layer, generator, *args) if remat
                  else wavlm_encoder_layer(*args))
    if cfg.do_stable_layer_norm:
        hidden = layer_norm(enc.layer_norm, hidden, cfg.layer_norm_eps)
    return hidden


def wavlm_adapter(ad: _Adapter, cfg: WavLMConfig, hidden: torch.Tensor):
    """Returns (final 8x features, 4x tap)."""
    if hasattr(ad, "proj"):
        hidden = layer_norm(ad.proj_layer_norm, linear(ad.proj, hidden))
    tap = hidden
    for i in range(cfg.num_adapter_layers):
        h = conv1d(ad.layers[str(i)].conv, hidden, stride=cfg.adapter_stride,
                   padding=cfg.adapter_kernel_size // 2)
        a, b = h.chunk(2, dim=-1)
        hidden = a * torch.sigmoid(b)
        if i == 1:
            tap = hidden
    return hidden, tap


def feature_frontend(model: WavLM, cfg: WavLMConfig,
                     input_values: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None, *,
                     mask_time_indices: Optional[torch.Tensor] = None,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None):
    """The conv feature encoder (in the model's dtype), the frames' mask,
    the feature projection, its dropout and SpecAugment's masked frames:
    (hidden [B, T, E], feat_mask [B, T] or None, the normalised conv
    features)."""
    dtype = model.feature_projection.layer_norm.weight.dtype
    extract = feature_encoder(model.feature_extractor, cfg,
                              input_values.to(dtype).contiguous())
    T = extract.shape[1]
    feat_mask = None
    if attention_mask is not None:
        feat_mask = _lengths_to_mask(
            conv_output_lengths(cfg, attention_mask.long().sum(-1)), T)
    norm_features = layer_norm(model.feature_projection.layer_norm, extract,
                               cfg.layer_norm_eps)
    hidden = linear(model.feature_projection.projection, norm_features)
    hidden = dropout(hidden, cfg.feat_proj_dropout, generator, deterministic)
    if mask_time_indices is not None and hasattr(model, "masked_spec_embed"):
        hidden = torch.where(mask_time_indices.to(torch.bool)[:, :, None],
                             model.masked_spec_embed.to(hidden.dtype), hidden)
    return hidden, feat_mask, norm_features


def wavlm_forward(model: WavLM, cfg: WavLMConfig, input_values: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None, *,
                  mask_time_indices: Optional[torch.Tensor] = None,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None
                  ) -> WavLMOutput:
    """input_values [B, S] normalised waveform; attention_mask [B, S];
    mask_time_indices [B, T] bool (SpecAugment, drawn on the host). Dropout
    runs unless `deterministic`, from `generator` (on the model's device).

    The waveform is cast to the model's dtype first, so a bf16 model runs
    bf16 end to end (the JAX package computes in the waveform's dtype)."""
    hidden, feat_mask, norm_features = feature_frontend(
        model, cfg, input_values, attention_mask,
        mask_time_indices=mask_time_indices, deterministic=deterministic,
        generator=generator)
    hidden = wavlm_encoder(model.encoder, cfg, hidden, feat_mask,
                           deterministic, generator)
    if cfg.add_adapter:
        last, tap = wavlm_adapter(model.adapter, cfg, hidden)
    else:
        last = tap = hidden
    return WavLMOutput(last_hidden_state=last, encoder_hidden_state=hidden,
                       wavlm_down_hidden_states=tap,
                       extract_features=norm_features)
