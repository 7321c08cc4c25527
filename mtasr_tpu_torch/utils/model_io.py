"""Model directories: `config.json` + `model.safetensors` (counterpart of
`mtasr_tpu/utils/model_io.py`), read and written through the port's own
safetensors I/O (`utils/safetensors_io.py`), so a directory moves between
the JAX package and the port as it is.

* `save_model` / `load_model`: a composite model directory. A load builds
  the model on the meta device and fills it tensor by tensor from the
  memory-mapped file, straight onto `device` (`utils/convert.py::load_flat`,
  with its strict key check): nothing is held twice, on the host or on the
  device.
* `load_hf_pretrained_dir` / `create_from_pretrained`: an HF WavLM and an
  HF LLaMA directory assembled into a composite one, with the JAX
  package's config surgery and embedding growth.
* `load_model_quantized`: the streamed int8 load for serving. Each decoder
  weight the serving quantizer targets is read, quantized on the host and
  moved to the device alone, so the float decoder never sits on the
  device.

A model is loaded in the dtype the caller names; `dtype=None` keeps each
tensor's stored dtype. A decoder LoRA and the quantization scales keep
theirs (float32) whatever the dtype.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from mtasr_tpu_torch.config import (
    LlamaConfig, SpeechEncoderDecoderConfig, WavLMConfig,
)
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.utils.convert import init_random, load_flat
from mtasr_tpu_torch.utils.quantize import (
    MIN_OUT_DIM, decoder_quant_key, quantize_encoder_for_serving,
    quantize_host,
)
from mtasr_tpu_torch.utils.safetensors_io import (
    SafetensorsFile, convert_state_dict, dir_files, iter_dir, save_file,
)

LORA_META = ("decoder_lora.__meta__.r", "decoder_lora.__meta__.alpha")


def serving_dtype(device) -> Optional[torch.dtype]:
    """The dtype an entry point loads a model in when its caller names
    none: bfloat16 on a CUDA device, whose kernels take bfloat16; the
    stored dtype elsewhere."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else None


def flat_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers by flat name, as the JAX tree
    flattens them: a decoder LoRA adds its r and alpha as float32 scalars
    (`decoder_lora.__meta__.*`)."""
    flat = dict(model.state_dict())
    lora = getattr(model, "decoder_lora", None)
    if lora is not None:
        flat[LORA_META[0]] = torch.tensor(lora.r, dtype=torch.float32)
        flat[LORA_META[1]] = torch.tensor(lora.alpha, dtype=torch.float32)
    return flat


def check_disk(path: str, n_bytes: int) -> None:
    """Refuse to start writing `n_bytes` under `path` if the disk has less
    free space (with 1 % and 64 MiB to spare)."""
    parent = os.path.abspath(path)
    while not os.path.exists(parent):
        parent = os.path.dirname(parent)
    free = shutil.disk_usage(parent).free
    need = int(n_bytes * 1.01) + (64 << 20)
    if free < need:
        raise OSError(f"not enough disk space under {parent} to write "
                      f"{path}: {n_bytes} bytes to write, {free} free")


def tensor_bytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def save_flat(path: str, flat: Mapping[str, torch.Tensor]) -> int:
    """`flat` as `path` (a safetensors file) after a disk-space check;
    returns the bytes written."""
    check_disk(path, tensor_bytes(flat.values()))
    return save_file(flat, path)


def save_model(path: str, cfg: SpeechEncoderDecoderConfig,
               model_or_flat) -> int:
    """Write `config.json` and `model.safetensors` (metadata format=pt) to
    the directory `path`, from a model or a flat dict of tensors; returns
    the bytes of the tensor file."""
    flat = (flat_state(model_or_flat)
            if isinstance(model_or_flat, torch.nn.Module) else model_or_flat)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return save_flat(os.path.join(path, "model.safetensors"), flat)


def read_config(path: str) -> SpeechEncoderDecoderConfig:
    with open(os.path.join(path, "config.json")) as f:
        cfg = SpeechEncoderDecoderConfig.from_json(f.read())
    cfg.validate()
    return cfg


def read_flat(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a model directory, as memory-mapped CPU views."""
    return dict(iter_dir(path))


def has_lora(path: str) -> bool:
    """Whether a model directory holds a decoder LoRA (read from the
    files' headers alone)."""
    return any(_is_lora(k) for fn in dir_files(path)
               for k in SafetensorsFile(fn).keys())


def _is_lora(name: str) -> bool:
    return name.startswith("decoder_lora.") or ".decoder_lora." in name


def _place(name: str, t: torch.Tensor, device,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One tensor onto `device`: a float one cast to `dtype` (on the host,
    so only the cast bytes cross to the device), but for the LoRA's."""
    if dtype is not None and t.dtype != dtype and t.is_floating_point() \
            and not _is_lora(name):
        return t.to(dtype).to(device)
    # a copy even on the host: no parameter keeps a view of the file
    return t.to(device, copy=True)


def _meta_model(cfg: SpeechEncoderDecoderConfig) -> SpeechEncoderDecoderModel:
    with torch.device("meta"):
        return SpeechEncoderDecoderModel(cfg)


def load_model(path: str, device="cuda", dtype: Optional[torch.dtype] = None,
               training: bool = False
               ) -> Tuple[SpeechEncoderDecoderConfig,
                          SpeechEncoderDecoderModel]:
    """(config, model) of a model directory, the model on `device` in
    `dtype` (None: as stored), in eval mode. With `training`, a
    weight-normed positional conv keeps its (g, v)."""
    cfg = read_config(path)
    flat = {name: _place(name, t, device, dtype)
            for name, t in iter_dir(path)}
    model = _meta_model(cfg)
    load_flat(model, flat, training=training)
    return cfg, model.eval()


# ---------------------------------------------------------------------------
# HF directories and the assembly of a composite model
# ---------------------------------------------------------------------------
def _hf_config_to_wavlm(d: dict) -> WavLMConfig:
    keys = {f.name for f in dataclasses.fields(WavLMConfig)}
    return WavLMConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in d.items() if k in keys})


def _hf_config_to_llama(d: dict) -> LlamaConfig:
    keys = {f.name for f in dataclasses.fields(LlamaConfig)}
    kw = {k: v for k, v in d.items() if k in keys}
    if isinstance(kw.get("eos_token_id"), list):
        kw["eos_token_id"] = kw["eos_token_id"][0]
    return LlamaConfig(**kw)


def load_hf_pretrained_dir(path: str
                           ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(config dict, flat tensors) of an HF model directory (config.json +
    *.safetensors), the weight norm fused and the rel-pos constant
    flattened (`convert_state_dict`). The tensors are memory-mapped CPU
    views; the fused weight is computed."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    return cfg, convert_state_dict(read_flat(path))


def mean_row(w: torch.Tensor) -> torch.Tensor:
    """The mean of `w`'s rows as the JAX package computes it
    (`np.asarray(w).mean(axis=0)` in the stored dtype): the rows added one
    after another in that dtype, then divided by their count."""
    acc = w[0].clone()
    for row in w[1:]:
        acc = acc + row
    return acc / w.shape[0]


def grow_rows(w: torch.Tensor, n: int) -> torch.Tensor:
    """`w` with rows appended up to `n`, each the mean row."""
    if n < w.shape[0]:
        raise ValueError(f"cannot shrink a {w.shape[0]}-row table to {n} "
                         "rows: the tokenizer has fewer ids than the "
                         "decoder's vocabulary")
    mean = mean_row(w)
    return torch.cat([w, mean[None].expand(n - w.shape[0], -1)], 0)


def create_from_pretrained(
    encoder_dir: str, decoder_dir: str, *, tokenizer_len: int,
    special_ids: dict, model_overrides: Optional[dict] = None,
    seed: int = 0, device="cuda",
) -> Tuple[SpeechEncoderDecoderConfig, SpeechEncoderDecoderModel]:
    """Assemble WavLM + LLaMA from HF directories, as the JAX package does
    (`model_io.py:72-146`): the encoder's adapter on, mask_time_prob 0.1,
    layerdrop 0, max_length 200; the special ids wired; the decoder's
    embedding (and an untied lm_head) grown to `tokenizer_len` rows by the
    mean row; then every pretrained tensor grafted, in its stored dtype,
    over a fresh float32 model drawn from a `torch.Generator` seeded with
    `seed` on `device` (a tensor whose name or shape the model lacks stays
    behind, so a pretrained encoder without an adapter gets a fresh one)."""
    enc_cfg_d, enc_flat = load_hf_pretrained_dir(encoder_dir)
    dec_cfg_d, dec_flat = load_hf_pretrained_dir(decoder_dir)

    enc_cfg = _hf_config_to_wavlm(enc_cfg_d)
    enc_cfg.add_adapter = True
    enc_cfg.mask_time_prob = 0.1
    enc_cfg.layerdrop = 0.0
    dec_cfg = _hf_config_to_llama(dec_cfg_d)
    cfg = SpeechEncoderDecoderConfig(encoder=enc_cfg, decoder=dec_cfg,
                                     **dict(model_overrides or {}))
    cfg.decoder_start_token_id = dec_cfg.bos_token_id
    cfg.bos_token_id = dec_cfg.bos_token_id
    cfg.eos_token_id = dec_cfg.eos_token_id
    for k, v in special_ids.items():
        setattr(cfg, k, v)
    cfg.max_length = 200

    if tokenizer_len != dec_cfg.vocab_size:
        dec_cfg.vocab_size = tokenizer_len
        for key in ("model.embed_tokens.weight", "lm_head.weight"):
            if key in dec_flat:
                dec_flat[key] = grow_rows(dec_flat[key].to(device),
                                          tokenizer_len)

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = init_random(cfg, g, device, torch.float32)
    params = dict(model.named_parameters())
    for prefix, src in (("decoder.", dec_flat), ("encoder.", enc_flat)):
        for key, value in src.items():
            p = params.get(prefix + key)
            if p is not None and tuple(p.shape) == tuple(value.shape):
                p.data = value.to(device, copy=True)
    return cfg, model


# ---------------------------------------------------------------------------
# Streamed int8 load for serving
# ---------------------------------------------------------------------------
def load_model_quantized(
    path: str, mode: str = "w8a8", *, scope: str = "decoder",
    dtype: torch.dtype = torch.bfloat16, device="cuda",
) -> Tuple[SpeechEncoderDecoderConfig, SpeechEncoderDecoderModel]:
    """(config, int8 serving model) of a model directory, streamed: each
    tensor is read from the memory map; a decoder weight the serving
    quantizer targets (at least MIN_OUT_DIM rows) is quantized on the
    host (`utils/quantize.py::quantize_host`, bit-equal to the in-memory
    quantizer) and only its int8 codes and scales cross to the device;
    every other float tensor is cast to `dtype` on the host first. A head
    tied to the embedding gets a quantized `lm_head` of its own, as
    `quantize_for_serving` gives it. scope "all" then quantizes the
    encoder on the device. A directory with a decoder LoRA is refused:
    load it, merge the LoRA, then quantize (`api.Transcriber.from_pretrained`
    does)."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"quantize mode {mode!r} not in w8 / w8a8")
    if scope not in ("decoder", "all"):
        raise ValueError(f"quantize scope {scope!r} not in decoder / all")
    cfg = read_config(path)
    flat: Dict[str, torch.Tensor] = {}
    embed = None
    for name, t in iter_dir(path):
        if _is_lora(name):
            raise ValueError("the streamed quantized load cannot fold a "
                             "LoRA: merge it first (load_model, "
                             "train.lora.merge_decoder_lora, "
                             "quantize_for_serving)")
        if decoder_quant_key(name) and t.dim() == 2 \
                and t.shape[0] >= MIN_OUT_DIM:
            base = name[:-len(".weight")]
            for k, v in quantize_host(t, mode).items():
                flat[f"{base}.{k}"] = v.to(device)
            continue
        if name == "decoder.model.embed_tokens.weight":
            embed = t
        flat[name] = _place(name, t, device, dtype)
    # a head tied to the embedding (no lm_head in the file) gets a
    # quantized one; an untied head narrower than MIN_OUT_DIM stays float,
    # as quantize_for_serving leaves it
    if embed is not None and not any(k.startswith("decoder.lm_head.")
                                     for k in flat):
        for k, v in quantize_host(embed, mode).items():
            flat[f"decoder.lm_head.{k}"] = v.to(device)
    model = _meta_model(cfg)
    load_flat(model, flat)
    if scope == "all":
        quantize_encoder_for_serving(model, mode)
    return cfg, model.eval()
