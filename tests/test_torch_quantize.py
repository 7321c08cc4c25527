"""The port's int8 serving pieces against the JAX package's, on the same
seeded numpy inputs (CPU): the weight quantizer, the KV quantizer and the
quantized `linear` (exact in float32: the same f32 steps in the same order,
integer products exact), whole-model quantization (the same keys and
values as the JAX tree's), and `load_flat` of a quantized JAX tree. The
JAX functions run jitted, as the JAX package runs them: XLA then computes
x / 127 as x * f32(1 / 127), which the port does too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.models import layers as jlayers
from mtasr_tpu.models import llama as jllama
from mtasr_tpu.models.speech_encoder_decoder import init_model_params
from mtasr_tpu.utils import quantize as jquant
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.models import layers as tlayers
from mtasr_tpu_torch.models import llama as tllama
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.utils import quantize as tquant
from mtasr_tpu_torch.utils.convert import load_flat
from tests.test_composite import tiny_cfg


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def int8_cfg(**kw):
    """tiny_cfg's encoder (its FFN widened to 256, so `scope="all"`
    quantizes a slot there) with a decoder of hidden 256 and 4 q / 2 kv
    heads of 64: Hkv * D = 128, so the JAX package's decode kernels engage,
    and widths of 256 and more, so `min_out_dim` quantizes some linears and
    not others (k_proj, v_proj: 128); the head tied to the embeddings, as
    LLaMA-3.2-1B's is."""
    cfg = tiny_cfg(train_mode="attention", **kw)
    cfg.encoder = dataclasses.replace(cfg.encoder, intermediate_size=256)
    cfg.decoder = dataclasses.replace(
        cfg.decoder, hidden_size=256, intermediate_size=512,
        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
        tie_word_embeddings=True, decode_attn_impl="pallas_interpret")
    return cfg


def _port_cfg(cfg):
    return tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_weight_quantizer_matches_jax(mode):
    """A row of zeros takes the 127e-12 floor; exact."""
    w = _rand((300, 40), 0)
    w[7] = 0.0
    ref = jax.jit(jquant.quantize_linear, static_argnums=1)(
        {"weight": jnp.asarray(w)}, mode)
    key = "weight_q8a8" if mode == "w8a8" else "weight_q8"
    q = tquant.quantize_linear(torch.from_numpy(w), None, mode)
    np.testing.assert_array_equal(q.weight_int8.numpy(),
                                  np.asarray(ref[key]))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(ref["scale"]))
    assert q.weight_key == key


def test_kv_quantizer_matches_jax():
    """int8 values and bf16 scales identical; an all-zero head takes the
    1e-8 floor."""
    x = _rand((2, 5, 3, 64), 1, 2.0)
    x[1, 2, 0] = 0.0
    q8, s = tllama._quantize_kv(torch.from_numpy(x))
    jq8, js = jax.jit(jllama._quantize_kv)(jnp.asarray(x))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    assert s.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))


@pytest.mark.parametrize("mode,bias", [("w8a8", True), ("w8a8", False),
                                       ("w8", True)])
def test_quantized_linear_matches_jax(mode, bias):
    """w8a8 without a bias is exact in float32 (int32 product, then the
    same f32 rescale); with a bias, within one f32 rounding (XLA fuses the
    rescale and the bias add into a multiply-add); w8 is a float32 matrix
    product of the same dequantized weight, equal up to the order of its
    sums (rtol 1e-6). A row of x of zeros takes the 1e-12 activation-scale
    floor."""
    w = _rand((256, 96), 2, 0.1)
    b = _rand((256,), 3, 0.1) if bias else None
    x = _rand((2, 3, 96), 4)
    x[1, 1] = 0.0
    p = {"weight": jnp.asarray(w)}
    if bias:
        p["bias"] = jnp.asarray(b)
    ref = np.asarray(jax.jit(jlayers.linear)(
        jax.jit(jquant.quantize_linear, static_argnums=1)(p, mode),
        jnp.asarray(x)))
    q = tquant.quantize_linear(torch.from_numpy(w),
                               None if b is None else torch.from_numpy(b),
                               mode)
    out = tlayers.linear(q, torch.from_numpy(x)).numpy()
    if mode == "w8a8" and not bias:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode,scope", [("w8a8", "decoder"),
                                        ("w8", "decoder"), ("w8a8", "all")])
def test_quantize_for_serving_matches_jax(mode, scope):
    """The port quantizes its own model to the JAX tree's keys and values
    (the tied head gets an `lm_head` slot of its own); some linears are
    quantized and some are not."""
    cfg = int8_cfg()
    params = init_model_params(jax.random.key(0), cfg)
    model = SpeechEncoderDecoderModel(_port_cfg(cfg))
    load_flat(model, tree_to_flat(params))
    tquant.quantize_for_serving(model, mode, scope)
    ref = tree_to_flat(jquant.quantize_for_serving(params, mode, scope))
    state = model.state_dict()
    assert set(state) == set(ref)
    key = "weight_q8a8" if mode == "w8a8" else "weight_q8"
    qkeys = {k for k in ref if k.endswith(key)}
    assert "decoder.lm_head." + key in qkeys
    assert ("encoder.encoder.layers.0.feed_forward.intermediate_dense."
            + key in qkeys) == (scope == "all")
    assert "decoder.model.layers.0.self_attn.k_proj.weight" in ref
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_load_flat_takes_a_quantized_jax_tree():
    """A quantized JAX tree loads into a plain port model (strict), and the
    loaded model's w8a8 decoder gives the JAX logits for a cached prefill
    and decode step (int8 cache; the JAX decode kernel interpreted) with
    the same caches and argmax. Tolerance atol 5e-3: each w8a8 linear
    re-quantizes its input per row, so a last-bit difference upstream (the
    f32 sums' order) can move one int8 rounding of an activation by one
    step, which moves these logits by about 2e-3. A tree missing one scale
    is refused."""
    cfg = int8_cfg()
    qparams = jquant.quantize_for_serving(
        init_model_params(jax.random.key(1), cfg), "w8a8")
    flat = tree_to_flat(qparams)
    model = SpeechEncoderDecoderModel(_port_cfg(cfg))
    load_flat(model, flat)
    assert isinstance(model.decoder.lm_head, tlayers.QuantLinear)
    assert isinstance(model.decoder.model.layers["0"].self_attn.k_proj,
                      torch.nn.Linear)
    dcfg, tdcfg = cfg.decoder, _port_cfg(cfg).decoder
    B, L = 2, 20
    emb = _rand((B, L, 256), 5)
    pos = np.tile(np.arange(L), (B, 1))
    jcache = jllama.KVCache.init(dcfg, B, L + 1, jnp.float32, quantized=True)
    jf = jax.jit(jllama.llama_forward, static_argnums=1)
    jl, jcache = jf(qparams["decoder"], dcfg, jnp.asarray(emb),
                    jnp.asarray(pos), kv_cache=jcache)
    tcache = tllama.KVCache.init(tdcfg, B, L + 1, torch.float32, "cpu",
                                 quantized=True)
    with torch.inference_mode():
        tl, tcache = tllama.llama_forward(
            model.decoder, tdcfg, torch.from_numpy(emb),
            torch.from_numpy(pos), kv_cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-3)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
        x = _rand((B, 1, 256), 6)
        p = np.full((B, 1), L)
        jl, jcache = jf(qparams["decoder"], dcfg, jnp.asarray(x),
                        jnp.asarray(p), kv_cache=jcache,
                        cache_offset=jnp.int32(L))
        tl, tcache = tllama.llama_forward(
            model.decoder, tdcfg, torch.from_numpy(x), torch.from_numpy(p),
            kv_cache=tcache, cache_offset=L)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-3)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    for layer in range(dcfg.num_hidden_layers):
        np.testing.assert_array_equal(tcache.k[layer].numpy(),
                                      np.asarray(jcache.k[layer]))
        np.testing.assert_array_equal(
            tcache.kv_scale[layer].float().numpy(),
            np.asarray(jcache.kv_scale[layer].astype(jnp.float32)))
    broken = dict(flat)
    del broken["decoder.lm_head.scale"]
    with pytest.raises(RuntimeError, match="scale"):
        load_flat(SpeechEncoderDecoderModel(_port_cfg(cfg)), broken)
