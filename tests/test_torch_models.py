"""The port's WavLM and LLaMA against the JAX package on the same weights
(the JAX init's tree, `tree_to_flat`, loaded with `load_flat`) and the
same seeded inputs, in float32 on the CPU, with the JAX Pallas kernels run
in interpret mode where the geometry lets them engage."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.config import LlamaConfig
from mtasr_tpu.models import llama as jllama
from mtasr_tpu.models import wavlm as jwavlm
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.models import llama as tllama
from mtasr_tpu_torch.models import wavlm as twavlm
from mtasr_tpu_torch.utils.convert import load_flat
from tests.test_composite import tiny_cfg
from tests.test_torch_kernels import pallas_calls  # noqa: F401 (fixture)

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


# JAX conv0 engages only for conv_dim[0] % 128 == 0, S % 128 == 0 and
# S >= 768 (conv_frontend.py:56-73): conv_dim (128, 8) with S = 1280.
@functools.lru_cache(maxsize=None)
def _wavlm_pair(seed=0):
    """The JAX encoder's parameters and the port's WavLM loaded with them,
    made once: the `pallas_calls` fixture clears JAX's caches, and the
    eager init would compile each of its ops again for every test."""
    cfg = tiny_cfg(train_mode="attention")
    cfg.encoder = dataclasses.replace(cfg.encoder, conv_dim=(128, 8))
    params = jwavlm.init_wavlm_params(jax.random.key(seed), cfg.encoder)
    tcfg = tconfig.from_fields(tconfig.WavLMConfig, cfg.encoder)
    model = twavlm.WavLM(tcfg)
    load_flat(model, tree_to_flat(params))
    return cfg.encoder, params, model, tcfg


@pytest.mark.parametrize("conv0_impl,attention_impl,atol", [
    ("pallas", "flash_spmd", 2e-3),   # both Pallas kernels, interpreted;
                                      # the poly-erf bound of conv0
    ("auto", "auto", 1e-4),           # the XLA path (exact gelu)
])
@torch.inference_mode()
def test_wavlm_matches_jax(conv0_impl, attention_impl, atol, pallas_calls):
    enc, params, model, tcfg = _wavlm_pair()
    enc = dataclasses.replace(enc, conv0_impl=conv0_impl,
                              attention_impl=attention_impl)
    B, S = 2, 1280
    wav = np.random.default_rng(1).standard_normal((B, S)).astype(np.float32)
    amask = np.ones((B, S), np.int32)
    amask[1, 700:] = 0
    ref = jax.jit(jwavlm.wavlm_forward, static_argnums=1)(
        params, enc, jnp.asarray(wav), jnp.asarray(amask))
    assert (pallas_calls["n"] > 0) == (conv0_impl == "pallas")
    out = twavlm.wavlm_forward(model, tcfg,
                               torch.from_numpy(wav), torch.from_numpy(amask))
    for name in ("last_hidden_state", "encoder_hidden_state",
                 "wavlm_down_hidden_states", "extract_features"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=1e-3, err_msg=name)


@torch.inference_mode()
def test_llama_prefill_and_decode_match_jax(pallas_calls):
    """Prefill over a padded slot, then two cached decode steps; JAX's
    decode attention runs its Pallas kernel interpreted (it engages for
    (Hkv * D) % 128 == 0: Hkv = 2, D = 64). f32, atol 2e-5."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=48, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, rope_theta=10000.0,
                      tie_word_embeddings=True,
                      decode_attn_impl="pallas_interpret")
    params = jllama.init_llama_params(jax.random.key(3), cfg)
    tcfg = tconfig.from_fields(tconfig.LlamaConfig, cfg)
    dec = tllama.Llama(tcfg)
    load_flat(dec, tree_to_flat(params))
    B, L, S_max = 2, 7, 10
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((B, L, 48)).astype(np.float32)
    pos = np.tile(np.arange(L), (B, 1))
    valid = np.ones((B, L), bool)
    valid[1, 4] = False

    # one compiled program per shape, not an eager compile per op
    jforward = jax.jit(jllama.llama_forward, static_argnums=1)
    jcache = jllama.KVCache.init(cfg, B, S_max, dtype=jnp.float32)
    jl, jcache = jforward(
        params, cfg, jnp.asarray(emb), jnp.asarray(pos),
        key_valid_mask=jnp.asarray(valid), kv_cache=jcache)
    tcache = tllama.KVCache.init(tcfg, B, S_max, torch.float32, "cpu")
    tl, tcache = tllama.llama_forward(
        dec, tcfg, torch.from_numpy(emb), torch.from_numpy(pos),
        key_valid_mask=torch.from_numpy(valid), kv_cache=tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-4)
    for t in range(2):
        x = rng.standard_normal((B, 1, 48)).astype(np.float32)
        p = np.full((B, 1), L + t)
        jl, jcache = jforward(
            params, cfg, jnp.asarray(x), jnp.asarray(p), kv_cache=jcache,
            cache_offset=jnp.int32(L + t))
        tl, tcache = tllama.llama_forward(
            dec, tcfg, torch.from_numpy(x), torch.from_numpy(p),
            kv_cache=tcache, cache_offset=L + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=1e-4, err_msg=f"step {t}")
    assert pallas_calls["n"] > 0
    for layer in range(2):
        np.testing.assert_allclose(tcache.k[layer].numpy(),
                                   np.asarray(jcache.k[layer]), atol=2e-5)
