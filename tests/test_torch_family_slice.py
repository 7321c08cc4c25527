"""The bridge and adapter family through the port's whole model, against
the JAX package on the CPU (`tiny_cfg` widths, JAX's init from a seed,
float32; the JAX side jitted once per config):

* `model_forward`: logits within rtol 1e-5, atol 1e-5 (the f32 sums of a
  few hundred terms in two libraries' orders), the loss and its parts
  within rtol 1e-5, in six configs that together take every adapter kind
  (tiny, gatetiny, ctcaware, adapgatetiny), every memory feature (mix,
  raw, sep, ctctoken), every CTC bridge (raw, softmax, ctcprompt), the
  refiner on and off, and an attention-mode model with no CTC heads;
* greedy `generate` token for token equal to JAX's: an instruct model
  with the CTC prompt (rows whose prefixes differ in length) and the
  CTC-token memory; `encode_chunk` < B with the raw bridge and the
  separated-stream memory; the adapters' memory keys and values kept
  across steps give the same logits, bit for bit, as computing them at
  every step;
* w8a8 + int8 KV serving of a family model: the family stays in float
  (the JAX `scope="decoder"`), tokens equal to JAX's int8 generate.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.config import GenerationConfig
from mtasr_tpu.generate import generate as jax_generate
from mtasr_tpu.models.speech_encoder_decoder import (
    init_model_params, model_forward as jax_model_forward,
)
from mtasr_tpu.utils.quantize import quantize_for_serving as jax_quantize
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models.layers import QuantLinear
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel, encode_feats, bridge_features, model_forward,
)
from mtasr_tpu_torch.ops import kernels
from mtasr_tpu_torch.utils.convert import load_flat
from mtasr_tpu_torch.utils.quantize import quantize_for_serving
from tests.test_composite import make_batch, tiny_cfg
from tests.test_torch_quantize import int8_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

RTOL, LOGITS_ATOL = 1e-5, 1e-5
INSTRUCT_IDS = dict(bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
                    eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)


def family(kind, feature, bridge=None, refine=False, **kw):
    """A hybrid tiny config with adapters of `kind` over `feature`, the
    CTC bridge `bridge` (None: none) and the refiner on or off."""
    base = dict(train_mode="hybrid", talker_ctc=True,
                decoder_cross_attention=True,
                decoder_cross_attention_type=kind,
                decoder_cross_attention_feature=feature,
                talker_ctc_refine=refine, cross_attn_dim=16, r_max=4,
                lora_alpha=8)
    if bridge is not None:
        base.update(ctc_bridge=True, ctc_bridge_type=bridge)
    base.update(kw)
    return tiny_cfg(**base)


FORWARD = {
    "tiny-mix-raw-refine": lambda: family("tiny", "mix", "raw", True),
    "gatetiny-sep-softmax": lambda: family("gatetiny", "sep", "softmax"),
    "ctcaware-ctctoken-ctcprompt-refine":
        lambda: family("ctcaware", "ctctoken", "ctcprompt", True),
    "adapgatetiny-sep-raw": lambda: family("adapgatetiny", "sep", "raw"),
    "adapgatetiny-ctctoken-softmax-refine":
        lambda: family("adapgatetiny", "ctctoken", "softmax", True),
    "attention-tiny-raw": lambda: family(
        "tiny", "raw", train_mode="attention", talker_ctc=False),
}


def _port(cfg):
    return tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)


def _params(cfg, seed=0, decoder_scale=1.0):
    """JAX's init; `decoder_scale` multiplies the decoder's matrices (at
    the init's 0.02 this random decoder repeats one token, and token
    identity would then prove little)."""
    params = init_model_params(jax.random.key(seed), cfg)
    params["decoder"] = jax.tree_util.tree_map(
        lambda x: x * decoder_scale if x.ndim == 2 else x, params["decoder"])
    rng = np.random.default_rng(seed)
    for ad in params.get("cross_att_adap", {}).values():
        for name in ("q_lora", "k_lora", "v_lora", "out_lora"):
            if name in ad:         # a nonzero B: the LoRA changes the output
                ad[name]["lora_B"] = jnp.asarray(rng.standard_normal(
                    ad[name]["lora_B"].shape).astype(np.float32) * 0.1)
    return params


def _model(cfg, params):
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, tree_to_flat(params))
    return model


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_model_forward_matches_jax(name):
    cfg = FORWARD[name]()
    params = _params(cfg)
    model = _model(cfg, params)
    wav, amask, arr = make_batch(cfg, B=2, S=3200, seed=1)
    keys = ["decoder_input_ids", "ce_labels"] + (
        ["label_spks", "label_spk_lens"] if cfg.talker_ctc else [])
    ref = jax.jit(lambda p, w, m, ids, **kw: jax_model_forward(
        p, cfg, w, m, ids, **kw))(
            params, jnp.asarray(wav), jnp.asarray(amask),
            *[jnp.asarray(arr[k]) for k in keys[:1]],
            **{k: jnp.asarray(arr[k]) for k in keys[1:]})
    with torch.no_grad():
        out = model_forward(
            model, _port(cfg), torch.from_numpy(wav), torch.from_numpy(amask),
            torch.from_numpy(np.array(arr["decoder_input_ids"])),
            **{k: torch.from_numpy(np.array(arr[k])) for k in keys[1:]})
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               rtol=RTOL, atol=LOGITS_ATOL)
    np.testing.assert_allclose(float(out.loss), float(ref.loss), rtol=RTOL)
    assert set(out.aux) == set(ref.aux)
    for k in out.aux:
        np.testing.assert_allclose(out.aux[k].numpy(), np.asarray(ref.aux[k]),
                                   rtol=RTOL, err_msg=k)


def _wav(B=3, S=6000, seed=0):
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((B, S)).astype(np.float32)
    amask = np.ones((B, S), np.int32)
    amask[-1, S // 2:] = 0
    return wav, amask


def _generate(model, cfg, wav, amask, prompt=None, **gen):
    return engine.generate(
        model, _port(cfg), torch.from_numpy(wav), torch.from_numpy(amask),
        prompt_ids=None if prompt is None else torch.from_numpy(prompt),
        gen=tconfig.GenerationConfig(**gen), max_new_tokens=8)


def _jax_generate(params, cfg, wav, amask, prompt=None, **gen):
    return jax_generate(params, cfg, jnp.asarray(wav), jnp.asarray(amask),
                        prompt_ids=None if prompt is None
                        else jnp.asarray(prompt),
                        gen=GenerationConfig(**gen), max_new_tokens=8)


def test_generate_instruct_ctc_prompt_matches_jax():
    """The CTC prompt's prefix is part of the speech block: its padding sits
    inside the block and its valid ids count in each row's positions. The
    rows' prefixes differ in length (short audio: the padded row has fewer
    frames than a head's 64 prompt slots)."""
    cfg = family("ctcaware", "ctctoken", "ctcprompt", True, instruct=True,
                 **INSTRUCT_IDS)
    params = _params(cfg, seed=1, decoder_scale=30.0)
    model = _model(cfg, params)
    wav, amask = _wav(S=1000, seed=1)
    prompt = np.tile([52, 20, 21, 53, 54, 55, 56], (3, 1))
    with torch.no_grad():
        enc = bridge_features(model, _port(cfg), encode_feats(
            model, _port(cfg), torch.from_numpy(wav),
            torch.from_numpy(amask)))
    n_prefix = enc.encoder_attention_mask[:, :2 * 64].sum(1)
    assert len(set(n_prefix.tolist())) > 1, n_prefix
    ref = _jax_generate(params, cfg, wav, amask, prompt)
    kernels.reset_launch_counts()
    out = _generate(model, cfg, wav, amask, prompt)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    assert len(np.unique(out.sequences.numpy())) >= 3
    assert sum(kernels.launch_counts().values()) == 0   # CPU: plain only


def test_generate_chunked_encode_matches_jax():
    """encode_chunk 2 of B 3: every field of the chunks' encodings (the
    memory, its mask, the separated streams) is concatenated."""
    cfg = family("adapgatetiny", "sep", "raw")
    params = _params(cfg, seed=6, decoder_scale=30.0)
    model = _model(cfg, params)
    wav, amask = _wav(seed=2)
    ref = _jax_generate(params, cfg, wav, amask, encode_chunk=2)
    out = _generate(model, cfg, wav, amask, encode_chunk=2)
    whole = _generate(model, cfg, wav, amask)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  whole.sequences.numpy())
    assert len(np.unique(out.sequences.numpy())) >= 3


def _step_logits(model, cfg, wav, amask):
    seen = []

    def sample(logits, gen, generator):
        seen.append(logits.clone())
        return logits.argmax(-1)
    with mock.patch.object(engine, "_sample_token", sample):
        out = _generate(model, cfg, wav, amask)
    return torch.stack(seen), out.sequences


def test_kept_memory_kv_is_bit_equal_and_matches_jax():
    cfg = family("gatetiny", "mix", "ctcprompt")
    params = _params(cfg, seed=3, decoder_scale=30.0)
    model = _model(cfg, params)
    wav, amask = _wav(seed=3)
    calls = []
    real = engine.adapter_callback

    def every_step(*a, **kw):
        calls.append(kw["keep_kv"])
        return real(*a, **{**kw, "keep_kv": False})
    kept, seq = _step_logits(model, cfg, wav, amask)
    with mock.patch.object(engine, "adapter_callback", every_step):
        every, seq2 = _step_logits(model, cfg, wav, amask)
    assert calls == [True]
    assert torch.equal(kept, every) and torch.equal(seq, seq2)
    ref = _jax_generate(params, cfg, wav, amask)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref.sequences))
    assert len(np.unique(seq.numpy())) >= 3


@functools.lru_cache(maxsize=None)
def _int8_pair():
    cfg = int8_cfg(talker_ctc=True, ctc_bridge=True,
                   decoder_cross_attention=True,
                   decoder_cross_attention_type="adapgatetiny",
                   decoder_cross_attention_feature="sep", cross_attn_dim=32,
                   r_max=4, lora_alpha=8)
    params = _params(cfg, seed=4, decoder_scale=8.0)
    model = _model(cfg, params)
    quantize_for_serving(model, "w8a8")
    return cfg, jax_quantize(params, "w8a8"), model


def test_int8_family_generate_matches_jax():
    cfg, qparams, model = _int8_pair()
    assert not any(isinstance(m, QuantLinear)
                   for m in model.cross_att_adap.modules())
    assert not any(k.startswith("cross_att_adap") and "q8" in k
                   for k in tree_to_flat(qparams))
    wav, amask = _wav(B=2, S=8000, seed=4)
    ref = _jax_generate(qparams, cfg, wav, amask, kv_quant=True)
    out = _generate(model, cfg, wav, amask, kv_quant=True)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    assert len(np.unique(out.sequences.numpy())) >= 3
