"""Parameters into the port (counterpart of
`mtasr_tpu/utils/torch_interop.py`).

`load_flat` takes the JAX parameter tree flattened to numpy arrays
(`tree_to_flat(init_model_params(...))`, or an HF `state_dict`'s arrays)
and loads it into the port's model with `load_state_dict(strict=True)`:
the port's parameter names are the flat keys. Three keys need a fix-up:
the positional conv's weight norm (`weight_g` / `weight_v`) is fused into
a plain weight for serving, and kept as the two parameters it trains as
with `training=True`; HF's [1, H, 1, 1] `gru_rel_pos_const` is squeezed;
a decoder LoRA subtree (`decoder_lora.*`) becomes `model.decoder_lora`,
its `__meta__` r and alpha plain attributes. A quantized tree
(`tree_to_flat(quantize_for_serving(params, ...))`: int8
`weight_q8a8` / `weight_q8` and f32 `scale` in a linear's slot) loads as
well: each such slot of the model becomes a `QuantLinear` first. A
`talker_ctc` tree's `separator.*` and `serialized_ctc.{k}.ctc_lo.*` keys
are the port's parameter names as they are, and so are the bridge and
adapter family's (`serilized_refine.*`, `ctc_extractor_concat.*`,
`cross_att_adap.{i}.*`, its scalars 0-d). A DeepSeek-V3 decoder's
per-expert weights (`mlp.experts.{e}.*_proj.weight`) are stacked into
the port's two expert tensors a layer (`stack_experts`).

The values may also be torch tensors (`utils/model_io.py` hands over the
memory-mapped tensors of a model directory, already on their device).
A model built on the meta device is filled by assignment: it takes the
given tensors as they are, device and dtype, and no parameter is
allocated twice.

`init_random` builds a model at full width with random weights from a
`torch.Generator`, straight on the target device, for runs that have no
checkpoint; its decoder optionally in int8 serving form from the start.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig
from mtasr_tpu_torch.models.adapters import init_scalars
from mtasr_tpu_torch.models.layers import QuantLinear
from mtasr_tpu_torch.models.separator import init_separator
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.models.wavlm import WavLM, pos_conv_module
from mtasr_tpu_torch.train.lora import DecoderLoRA, LoRAPair
from mtasr_tpu_torch.utils.quantize import init_quantized_llama
from mtasr_tpu_torch.utils.safetensors_io import convert_state_dict


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a, copy=True, order="C")   # writable, owned by torch
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_QUANT_KEYS = {".weight_q8a8": "w8a8", ".weight_q8": "w8"}


def _quantized_slots(model: torch.nn.Module,
                     flat: Mapping[str, np.ndarray]) -> None:
    """Make each linear slot that `flat` holds quantized a `QuantLinear` of
    the same geometry (a tied head's `lm_head` slot is new)."""
    device = next(model.parameters()).device
    for key, value in flat.items():
        for suffix, mode in _QUANT_KEYS.items():
            if not key.endswith(suffix):
                continue
            path = key[:-len(suffix)]
            parent_path, _, name = path.rpartition(".")
            parent = model.get_submodule(parent_path)
            old = getattr(parent, name, None)
            if old is not None and not isinstance(
                    old, (torch.nn.Linear, QuantLinear)):
                raise ValueError(f"{key}: {path} is not a linear layer")
            bias = flat.get(path + ".bias")
            out_dim, in_dim = np.shape(value)
            setattr(parent, name, QuantLinear(
                in_dim, out_dim, mode, device=device,
                bias_dtype=None if bias is None else _to_tensor(bias).dtype))


def _pos_conv_slots(model: torch.nn.Module, flat: Mapping[str, np.ndarray],
                    training: bool) -> bool:
    """Give each WavLM's positional conv the (g, v) container when a
    training load keeps them, else a plain conv. True if any is kept."""
    kept = False
    for name, mod in list(model.named_modules()):
        if not isinstance(mod, WavLM):
            continue
        prefix = f"{name}." if name else ""
        keep = training and \
            f"{prefix}encoder.pos_conv_embed.conv.weight_g" in flat
        holder = mod.encoder.pos_conv_embed
        if hasattr(holder.conv, "weight_v") != keep:
            device = next(model.parameters()).device
            holder.conv = pos_conv_module(mod.cfg, keep).to(device)
        kept |= keep
    return kept


def _lora_slot(model: torch.nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Build `model.decoder_lora` for the `decoder_lora.*` keys of `flat`
    (which are popped from the meta keys: r and alpha are attributes)."""
    keys = [k for k in flat if k.startswith("decoder_lora.")]
    if not keys:
        return
    r = float(flat.pop("decoder_lora.__meta__.r"))
    alpha = float(flat.pop("decoder_lora.__meta__.alpha"))
    device = next(model.parameters()).device
    pairs: Dict[str, Dict[str, LoRAPair]] = {}
    for key in keys:
        if key.endswith(".lora_A"):
            _, li, proj, _ = key.split(".")
            out_dim = np.shape(flat[key[:-1] + "B"])[0]
            in_dim = np.shape(flat[key])[1]
            pairs.setdefault(li, {})[proj] = LoRAPair(
                in_dim, out_dim, int(r), device=device)
    model.decoder_lora = DecoderLoRA(pairs, r, alpha)


_EXPERT = re.compile(r"^(.*\.mlp\.experts)\.(\d+)\.(gate|up|down)_proj"
                     r"\.weight$")


def stack_experts(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A DeepSeek-V3-named flat dict (`transformers`' state dict names:
    `...mlp.experts.{e}.{gate,up,down}_proj.weight`) in the port's stacked
    layout: a layer's `...mlp.experts.gate_up_proj` [E * 2I, H] (expert
    e's gate rows, then its up rows) and `...mlp.experts.down_proj`
    [E * H, I]. Every other key (the router `mlp.gate.weight` and
    `mlp.gate.e_score_correction_bias`, `mlp.shared_experts.*`, the
    latent attention's `self_attn.kv_a_proj_with_mqa.*`, ...) is the
    port's name as it is. A layer whose experts are not numbered 0..E-1,
    each with its three weights, is refused."""
    groups: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    out = {}
    for key, value in flat.items():
        m = _EXPERT.match(key)
        if m is None:
            out[key] = value
            continue
        groups.setdefault(m.group(1), {}).setdefault(
            int(m.group(2)), {})[m.group(3)] = value
    for stem, experts in groups.items():
        E = len(experts)
        if sorted(experts) != list(range(E)) or any(
                sorted(e) != ["down", "gate", "up"] for e in experts.values()):
            raise KeyError(f"{stem}: experts must be numbered 0..{E - 1}, "
                           "each with gate_proj, up_proj and down_proj")
        out[f"{stem}.gate_up_proj"] = torch.cat(
            [t for e in range(E)
             for t in (experts[e]["gate"], experts[e]["up"])])
        out[f"{stem}.down_proj"] = torch.cat(
            [experts[e]["down"] for e in range(E)])
    return out


def load_flat(model: torch.nn.Module, flat: Mapping[str, object], *,
              training: bool = False) -> None:
    """Load flat parameters (numpy arrays or torch tensors) into `model`
    (strict: every key must match a parameter or buffer, and every one
    must be given). With `training`, a weight-normed positional conv keeps
    its (g, v). A model on the meta device takes the tensors as given."""
    flat = stack_experts({k: _to_tensor(v) for k, v in flat.items()})
    keep = _pos_conv_slots(model, flat, training)
    # weight norm fused in float32 (kept as (g, v) for training), HF's
    # [1, H, 1, 1] gru_rel_pos_const flattened
    flat = convert_state_dict(flat, fuse_weight_norm=not keep)
    _lora_slot(model, flat)
    _quantized_slots(model, flat)
    meta = next(model.parameters()).is_meta
    model.load_state_dict(flat, strict=True, assign=meta)


def init_random(cfg: SpeechEncoderDecoderConfig, generator: torch.Generator,
                device, dtype: torch.dtype, quantize: Optional[str] = None
                ) -> SpeechEncoderDecoderModel:
    """A model with random weights, allocated on `device` in `dtype` (no
    float32 copy on the host). Matrices ~ N(0, 1/fan_in), embeddings
    ~ N(0, 0.02^2), biases ~ N(0, 0.02^2), norm scales and the rel-pos gate
    constants 1; a separator gets the JAX init's distributions
    (`models/separator.py::init_separator`: Xavier projections, the
    symmetry-breaking bias offsets), the cross-attention adapters the JAX
    init's scalars, rank gates and zero LoRA B factors
    (`models/adapters.py::init_scalars`). `generator` must live on
    `device`. With `quantize` ("w8" / "w8a8") the decoder is built
    directly in int8 serving form (`utils/quantize.py::init_quantized_llama`:
    the device never holds its float weights)."""
    with torch.device("meta"):
        model = SpeechEncoderDecoderModel(cfg)
    if quantize:
        model.decoder = torch.nn.Module()   # keeps the submodules' order
    model = model.to(dtype=dtype).to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 0:
                p.zero_()               # the adapters' scalars: below
            elif p.dim() == 1:
                if name.endswith("bias"):
                    p.normal_(0.0, 0.02, generator=generator)
                else:
                    p.fill_(1.0)
            elif "embed" in name and "pos_conv" not in name:
                p.normal_(0.0, 0.02, generator=generator)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    if hasattr(model, "separator"):
        init_separator(model.separator, generator)
    for ad in getattr(model, "cross_att_adap", {}).values():
        init_scalars(ad, cfg.r_max, cfg.lora_alpha)
    if quantize:
        model.decoder = init_quantized_llama(cfg.decoder, generator, device,
                                             quantize)
    return model.eval()
