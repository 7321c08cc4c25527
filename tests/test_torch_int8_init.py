"""The direct int8 init of a LLaMA decoder (`utils/quantize.py::
init_quantized_llama`, `utils/convert.py::init_random(quantize=...)`)
against the JAX package's `init_quantized_llama_params`, on a tiny decoder
of the LLaMA-3.1-8B's kind: head dim 128, 4 q heads a kv head (8 / 2),
llama3 rope scaling, an untied head, every linear at least 256 wide (so
`quantize_for_serving` quantizes each one, as at 8B). The JAX int8 tree
itself, carried through `load_flat`, serves on the port with JAX's greedy
tokens (int8 KV, the JAX int8 kernels interpreted), f32 on the CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.config import GenerationConfig
from mtasr_tpu.generate import generate as jax_generate
from mtasr_tpu.models import llama as jllama
from mtasr_tpu.utils.quantize import init_quantized_llama_params
from mtasr_tpu.utils.torch_interop import flat_to_tree, tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models import llama as tllama
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.utils.convert import init_random, load_flat
from mtasr_tpu_torch.utils.quantize import (
    INIT_SCALE, init_quantized_llama, quantize_for_serving,
)
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


def _cfg():
    cfg = tiny_cfg(train_mode="attention")
    cfg.decoder = dataclasses.replace(
        cfg.decoder, vocab_size=256, hidden_size=256, intermediate_size=256,
        num_attention_heads=8, num_key_value_heads=2, head_dim=128,
        tie_word_embeddings=False, decode_attn_impl="pallas_interpret",
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                      "original_max_position_embeddings": 8192})
    return cfg, tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)


def _layout(flat):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat.items()}


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@torch.no_grad()
def test_direct_int8_init_has_the_serving_tree(mode):
    """Keys, shapes and dtypes equal JAX's direct init's and the port's
    `quantize_for_serving` of an `init_random` bf16 decoder (and the whole
    model's, `init_random(quantize=...)`, with the encoder); every scale
    is JAX's constant to the bit; the dequantized std is 0.02 +- 5 %."""
    cfg, tcfg = _cfg()
    g = torch.Generator().manual_seed(0)
    dec = init_quantized_llama(tcfg.decoder, g, "cpu", mode)
    got = {f"decoder.{k}": v for k, v in dec.state_dict().items()}
    ref = tree_to_flat({"decoder": init_quantized_llama_params(
        jax.random.key(0), cfg.decoder, mode)})
    assert _layout(got) == _layout(ref)
    model = quantize_for_serving(
        init_random(tcfg, g, "cpu", torch.bfloat16), mode)
    layout = _layout(model.state_dict())
    assert _layout(got) == {k: v for k, v in layout.items()
                            if k.startswith("decoder.")}
    direct = init_random(tcfg, g, "cpu", torch.bfloat16, quantize=mode)
    assert _layout(direct.state_dict()) == layout
    wkey = "weight_q8a8" if mode == "w8a8" else "weight_q8"
    deq = []
    for k, v in got.items():
        if k.endswith(".scale"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))
            assert float(v[0]) == np.float32(INIT_SCALE)
            w = got[k[:-len("scale")] + wkey]
            assert int(w.min()) >= -127 and int(w.max()) <= 127
            deq.append((w.float() * v[:, None]).flatten())
    assert abs(float(torch.cat(deq).std()) / 0.02 - 1) < 0.05


@functools.lru_cache(maxsize=None)
def _served():
    """JAX's direct int8 decoder, its scales 8x (at 0.02 a random decoder
    picks one token at every step, and token identity would say little),
    beside a port-initialised encoder; the same flat tree for both."""
    cfg, tcfg = _cfg()
    flat = {k: v.numpy() for k, v in init_random(
        tcfg, torch.Generator().manual_seed(1), "cpu",
        torch.float32).state_dict().items() if not k.startswith("decoder.")}
    dec = tree_to_flat({"decoder": init_quantized_llama_params(
        jax.random.key(2), cfg.decoder, "w8a8")})
    for k, v in dec.items():
        v = np.asarray(v)
        flat[k] = v.astype(np.float32) if v.dtype.name == "bfloat16" else (
            v * 8 if k.endswith(".scale") else v)
    model = SpeechEncoderDecoderModel(tcfg)
    load_flat(model, flat)
    return cfg, tcfg, jax.tree.map(jnp.asarray, flat_to_tree(flat)), model


@torch.inference_mode()
def test_jax_direct_int8_tree_serves_on_the_port_as_in_jax():
    """Greedy tokens equal to JAX's `generate` with `kv_quant` (a padded
    row, a prefill of at most 16 positions: #7, then #6); the decoder's
    logits of two one-token steps over its int8 cache (#6; one compile of
    the jitted JAX forward) within test_torch_quantize's atol 5e-3, the
    same argmax."""
    cfg, tcfg, params, model = _served()
    rng = np.random.default_rng(7)
    wav = rng.standard_normal((2, 1000)).astype(np.float32)
    amask = np.ones((2, 1000), np.int32)
    amask[1, 600:] = 0
    ref = jax_generate(params, cfg, jnp.asarray(wav), jnp.asarray(amask),
                       gen=GenerationConfig(kv_quant=True), max_new_tokens=6)
    out = engine.generate(model, tcfg, torch.from_numpy(wav),
                          torch.from_numpy(amask),
                          gen=tconfig.GenerationConfig(kv_quant=True),
                          max_new_tokens=6)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    assert len(np.unique(out.sequences.numpy())) >= 3
    dcfg = cfg.decoder
    x = rng.standard_normal((2, 2, 1, dcfg.hidden_size)).astype(np.float32)
    jcache = jllama.KVCache.init(dcfg, 2, 2, jnp.float32, quantized=True)
    tcache = tllama.KVCache.init(tcfg.decoder, 2, 2, torch.float32, "cpu",
                                 quantized=True)
    jf = jax.jit(jllama.llama_forward, static_argnums=1)
    for off in (0, 1):
        pos = np.full((2, 1), off)
        jl, jcache = jf(params["decoder"], dcfg, jnp.asarray(x[off]),
                        jnp.asarray(pos), kv_cache=jcache,
                        cache_offset=jnp.int32(off))
        tl, tcache = tllama.llama_forward(
            model.decoder, tcfg.decoder, torch.from_numpy(x[off]),
            torch.from_numpy(pos), kv_cache=tcache, cache_offset=off)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-3)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
