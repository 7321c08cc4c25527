"""The int8 serving slice as a whole: a w8a8 decoder with an int8 KV cache,
greedy `generate` and `Transcriber`, the port against the JAX package on
the same weights and seeded inputs (float32, CPU).

The config (`int8_cfg`) has Hkv * D = 128, so the JAX package's int8
decode kernels engage, and `decode_attn_impl="pallas_interpret"`, so that
on the CPU JAX runs those kernels interpreted instead of quietly taking its
dequantized XLA attention, which is another function (q and p are not
quantized there). Each side quantizes its own model; the quantized keys
are the same. A prefill of more than 16 positions runs dequantized
attention on both sides; one of at most 16 runs the int8 chunk kernel
(#7) on both sides, as the counting wrappers below show."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtasr_tpu_torch.models.llama as tllama
from mtasr_tpu.api import Transcriber as JaxTranscriber
from mtasr_tpu.config import DataConfig, GenerationConfig
from mtasr_tpu.data.tokenizer import CharTokenizer
from mtasr_tpu.generate import generate as jax_generate
from mtasr_tpu.models.speech_encoder_decoder import init_model_params
from mtasr_tpu.ops.pallas import decode_attention as jda
from mtasr_tpu.utils.quantize import quantize_for_serving as jax_quantize
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.data.tokenizer import CharTokenizer as TCharTokenizer
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.utils.convert import load_flat
from mtasr_tpu_torch.utils.quantize import quantize_for_serving
from tests.test_torch_quantize import int8_cfg

_ROUTES = ("decode_attention_int8", "decode_attention_int8_chunk")


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of the int8 kernels on both sides: the JAX package
    imports its kernels at call time, the port at import."""
    seen = {}

    def counting(side, mod, name):
        real = getattr(mod, name)

        def fn(*a, **kw):
            seen[(side, name)] = seen.get((side, name), 0) + 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, fn)

    jax.clear_caches()
    for name in _ROUTES:
        counting("jax", jda, name)
        counting("port", tllama, name)
    return seen


@functools.lru_cache(maxsize=None)
def _pair(seed=0):
    """The JAX parameters quantized w8a8 and the port's model, loaded in
    float32 and quantized by the port's own quantizer, made once (generate
    does not change them). The decoder's matrices are drawn at 8x the
    init's 0.02: at 0.02 this random decoder picks the same token at every
    step of every row, and token identity would then prove little."""
    cfg = int8_cfg()
    params = init_model_params(jax.random.key(seed), cfg)
    params["decoder"] = jax.tree_util.tree_map(
        lambda x: x * 8 if x.ndim == 2 else x, params["decoder"])
    model = SpeechEncoderDecoderModel(
        tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg))
    load_flat(model, tree_to_flat(params))
    quantize_for_serving(model, "w8a8")
    qparams = jax_quantize(params, "w8a8")
    jkeys = {k for k in tree_to_flat(qparams) if k.endswith("weight_q8a8")}
    tkeys = {k for k in model.state_dict() if k.endswith("weight_q8a8")}
    assert jkeys and jkeys == tkeys
    return qparams, model


@pytest.mark.parametrize("samples,prefill", [(8000, 101), (1000, 14)])
def test_int8_generate_token_identical_to_jax(samples, prefill, routes):
    """A prefill of 101 positions (dequantized attention) and of 14 (the
    int8 chunk kernel), then int8 decode steps; a padded row."""
    cfg = int8_cfg()
    qparams, model = _pair()
    rng = np.random.default_rng(7)
    wav = rng.standard_normal((2, samples)).astype(np.float32)
    amask = np.ones((2, samples), np.int32)
    amask[1, samples * 3 // 5:] = 0
    ref = jax_generate(qparams, cfg, jnp.asarray(wav), jnp.asarray(amask),
                       gen=GenerationConfig(kv_quant=True), max_new_tokens=6)
    out = engine.generate(
        model, tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg),
        torch.from_numpy(wav), torch.from_numpy(amask),
        gen=tconfig.GenerationConfig(kv_quant=True), max_new_tokens=6)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    assert len(np.unique(out.sequences.numpy())) >= 4
    short = prefill <= 16
    L_dec = cfg.decoder.num_hidden_layers
    assert routes[("port", "decode_attention_int8")] == L_dec * out.steps
    assert routes.get(("port", "decode_attention_int8_chunk"), 0) == \
        (L_dec if short else 0)
    # the JAX side traces its loop body once: each route seen at least once
    assert routes[("jax", "decode_attention_int8")] > 0
    assert (("jax", "decode_attention_int8_chunk") in routes) == short


def test_int8_transcriber_matches_jax(routes):
    """Inputs in two duration buckets: a batch of short ones (prefill of
    at most 16 positions) and a padded batch of long ones; the same
    strings as the JAX Transcriber, both with `kv_quant`."""
    cfg = int8_cfg()
    tok, ttok = CharTokenizer(), TCharTokenizer()
    sp = tok.add_special_tokens()
    ttok.add_special_tokens()
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    qparams, model = _pair()
    dc = DataConfig(min_duration_in_seconds=0.0, max_duration_in_seconds=1e9,
                    bucket_boundaries_seconds=(0.0625, 0.5))
    gen = GenerationConfig(do_sample=False, kv_quant=True)
    jt = JaxTranscriber(cfg, qparams, tok, gen=gen, dc=dc)
    tt = Transcriber(
        tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg), model,
        ttok, gen=tconfig.from_fields(tconfig.GenerationConfig, gen),
        dc=tconfig.from_fields(tconfig.DataConfig, dc))
    rng = np.random.default_rng(8)
    wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (900, 7000, 800, 5000)]
    kw = dict(max_new_tokens=5, batch_size=2, clean=False)
    texts = tt.transcribe(wavs, **kw)
    assert texts == jt.transcribe(wavs, **kw)
    assert len(set(texts)) > 1
    assert routes[("port", "decode_attention_int8_chunk")] == \
        cfg.decoder.num_hidden_layers
    assert ("jax", "decode_attention_int8_chunk") in routes
