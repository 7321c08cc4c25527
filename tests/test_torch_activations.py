"""WavLM's activation table (`models/layers.py::ACT`, `resolve_act`)
against the JAX package's: every activation in both of WavLM's slots
through the port's `wavlm_forward` and JAX's on the same weights and
waveform, f32 on the CPU, and the polynomial erf against JAX's on a grid.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.models import layers as jlayers
from mtasr_tpu.models import wavlm as jwavlm
from mtasr_tpu.utils.torch_interop import flat_to_tree
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.models import layers as tlayers
from mtasr_tpu_torch.models import wavlm as twavlm
from mtasr_tpu_torch.utils.convert import load_flat
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

ACTS = ("gelu", "gelu_fast", "gelu_new", "relu", "silu", "tanh")
SLOTS = ("hidden_act", "feat_extract_activation")


@functools.lru_cache(maxsize=None)
def _pair():
    """The tiny encoder (hidden 32, one layer, LayerNorm conv stack): the
    port's WavLM with seeded normal weights, the same tree for JAX
    (`flat_to_tree`: no JAX init to compile), and a padded waveform."""
    enc = tiny_cfg(train_mode="attention").encoder
    model = twavlm.WavLM(tconfig.from_fields(tconfig.WavLMConfig, enc))
    rng = np.random.default_rng(0)
    flat = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
            for k, v in model.state_dict().items()}
    load_flat(model, flat)
    params = jax.tree.map(jnp.asarray, flat_to_tree(flat))
    wav = rng.standard_normal((2, 1600)).astype(np.float32)
    amask = np.ones((2, 1600), np.int32)
    amask[1, 1000:] = 0
    return enc, params, model, wav, amask


@torch.inference_mode()
def _check(**changes):
    enc, params, model, wav, amask = _pair()
    enc = dataclasses.replace(enc, **changes)
    ref = jwavlm.wavlm_forward(params, enc, jnp.asarray(wav),
                               jnp.asarray(amask))
    out = twavlm.wavlm_forward(model,
                               tconfig.from_fields(tconfig.WavLMConfig, enc),
                               torch.from_numpy(wav), torch.from_numpy(amask))
    for name in ("extract_features", "last_hidden_state"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("slot", SLOTS)
@pytest.mark.parametrize("act", ACTS)
def test_wavlm_activation_matches_jax(act, slot):
    """Each activation of the table in one slot, gelu in the other: the
    feature extractor's runs after the conv-only kernel route unless it is
    exact gelu (then #1's fused route)."""
    _check(**{slot: act})


def test_wavlm_fast_gelu_impl_matches_jax():
    """gelu_impl "fast": the polynomial erf in both slots (never the fused
    route, whose erf is exact)."""
    _check(gelu_impl="fast")


def test_polynomial_erf_and_fast_gelu_match_jax():
    """Against JAX run op by op, as the WavLM A/B above runs it: jitted,
    XLA:CPU contracts the Horner steps into fused multiply-adds, which
    moves erf_approx(3.9) by 6.8e-5 (the polynomial's terms cancel there)."""
    x = np.linspace(-6.0, 6.0, 4801, dtype=np.float32)
    for jfn, tfn in ((jlayers.erf_approx, tlayers.erf_approx),
                     (jlayers.fast_gelu, tlayers.fast_gelu)):
        ref = np.asarray(jfn(jnp.asarray(x)))
        np.testing.assert_allclose(tfn(torch.from_numpy(x)).numpy(), ref,
                                   rtol=0, atol=1e-6)
    assert tlayers.resolve_act("gelu", "fast") is tlayers.fast_gelu
    assert tlayers.resolve_act("gelu", "auto") is tlayers.gelu
    assert tlayers.resolve_act("gelu", "exact") is tlayers.gelu
