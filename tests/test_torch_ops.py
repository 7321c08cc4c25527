"""The port's plain ops and layers (mtasr_tpu_torch/ops, models/layers.py,
utils/convert.py) against their JAX counterparts on the same seeded numpy
inputs, in float32. Tolerance 1e-5 absolute unless a test says otherwise:
both sides compute in float32 and differ only in summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mtasr_tpu.models import layers as jl
from mtasr_tpu.ops import attention as ja
from mtasr_tpu.ops import norms as jn
from mtasr_tpu.ops import relpos as jr
from mtasr_tpu.ops import rope as jrope
from mtasr_tpu_torch.models import layers as tl
from mtasr_tpu_torch.ops import attention as ta
from mtasr_tpu_torch.ops import norms as tn
from mtasr_tpu_torch.ops import relpos as tr
from mtasr_tpu_torch.ops import rope as trope

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

ATOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


def _module_from(mod: nn.Module, **arrays):
    with torch.no_grad():
        for name, a in arrays.items():
            getattr(mod, name).copy_(torch.from_numpy(a))
    return mod


def test_rms_norm():
    x, w = _rand((3, 5, 16), 0), _rand((16,), 1)
    _close(tn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 32.0, "high_freq_factor": 4.0,
     "low_freq_factor": 1.0, "original_max_position_embeddings": 8192},
    {"rope_type": "linear", "factor": 4.0},
])
def test_rope_freqs_cos_sin_and_rotation(scaling):
    inv_t, sc_t = trope.compute_rope_freqs(64, 500000.0, scaling)
    inv_j, sc_j = jrope.compute_rope_freqs(64, 500000.0, scaling)
    np.testing.assert_array_equal(inv_t, inv_j)
    assert sc_t == sc_j
    pos = np.random.default_rng(2).integers(0, 300, (2, 7))
    cos_t, sin_t = trope.rope_cos_sin(torch.from_numpy(inv_t),
                                      torch.from_numpy(pos), sc_t)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(inv_j), jnp.asarray(pos),
                                      sc_j)
    _close(cos_t, cos_j, atol=1e-4)   # f32 cos of arguments up to ~300
    _close(sin_t, sin_j, atol=1e-4)
    q, k = _rand((2, 7, 4, 64), 3), _rand((2, 7, 2, 64), 4)
    qt, kt = trope.apply_rotary_emb(torch.from_numpy(q), torch.from_numpy(k),
                                    cos_t, sin_t)
    qj, kj = jrope.apply_rotary_emb(jnp.asarray(q), jnp.asarray(k),
                                    cos_j, sin_j)
    _close(qt, qj, atol=1e-4)
    _close(kt, kj, atol=1e-4)


@pytest.mark.parametrize("T,S,nb,md", [(499, 499, 320, 800), (37, 50, 16, 20)])
def test_relative_position_bucket(T, S, nb, md):
    np.testing.assert_array_equal(
        tr.relative_position_bucket(T, S, nb, md).numpy(),
        jr.relative_position_bucket(T, S, nb, md))


def test_gated_position_bias():
    B, T, H, hd = 2, 9, 4, 8
    pb, x = _rand((H, T, T), 5), _rand((B, T, H * hd), 6)
    w, b, c = _rand((hd, 8), 7), _rand((8,), 8), _rand((H,), 9)
    _close(tr.gated_position_bias(*map(torch.from_numpy, (pb, x, w, b, c)),
                                  H),
           jr.gated_position_bias(*map(jnp.asarray, (pb, x, w, b, c)), H))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_dot_product_attention_gqa_bias_mask(hq, hkv):
    B, T, S, D = 2, 6, 11, 16
    q, k, v = _rand((B, T, hq, D), 10), _rand((B, S, hkv, D), 11), \
        _rand((B, S, hkv, D), 12)
    bias = _rand((B, hq, T, S), 13, 0.5)
    mask = np.ones((B, 1, T, S), bool)
    mask[1, :, :, 7:] = False
    out_t = ta.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), bias=torch.from_numpy(bias),
        mask=torch.from_numpy(mask))
    out_j = ja.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias),
        mask=jnp.asarray(mask))
    _close(out_t, out_j)


def test_linear_embed_layer_norm_gelu():
    x = _rand((3, 4, 12), 14)
    w, b = _rand((5, 12), 15), _rand((5,), 16)
    lin = _module_from(nn.Linear(12, 5), weight=w, bias=b)
    _close(tl.linear(lin, torch.from_numpy(x)),
           jl.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x)))
    g, bt = _rand((12,), 17), _rand((12,), 18)
    ln = _module_from(nn.LayerNorm(12), weight=g, bias=bt)
    _close(tl.layer_norm(ln, torch.from_numpy(x), 1e-5),
           jl.layer_norm({"weight": jnp.asarray(g), "bias": jnp.asarray(bt)},
                         jnp.asarray(x), 1e-5))
    _close(tl.gelu(torch.from_numpy(x)), jl.gelu(jnp.asarray(x)))


def test_embed_clips_out_of_range_ids():
    """Out-of-range ids read the last row, as the JAX decoder's
    `jnp.take(mode="clip")` does (torch indexing would raise)."""
    from mtasr_tpu.config import LlamaConfig
    from mtasr_tpu.models.llama import embed_tokens

    table = _rand((10, 6), 19)
    ids = np.array([[0, 3, 9, 10, 57]])
    emb = _module_from(nn.Embedding(10, 6), weight=table)
    _close(tl.embed(emb, torch.from_numpy(ids)),
           embed_tokens({"model": {"embed_tokens":
                                   {"weight": jnp.asarray(table)}}},
                        LlamaConfig(), jnp.asarray(ids)))


def test_group_norm():
    x = _rand((2, 8, 30), 20)
    g, b = _rand((8,), 21), _rand((8,), 22)
    m = _module_from(nn.LayerNorm(8), weight=g, bias=b)
    _close(tl.group_norm(m, torch.from_numpy(x), num_groups=8),
           jl.group_norm({"weight": jnp.asarray(g), "bias": jnp.asarray(b)},
                         jnp.asarray(x), num_groups=8))


@pytest.mark.parametrize("stride,padding,groups", [(5, 0, 1), (2, 1, 1),
                                                   (1, 4, 2)])
def test_conv1d(stride, padding, groups):
    C, O, K = 8, 6, 3 if groups == 1 else 8
    x = _rand((2, 40, C), 23)
    w, b = _rand((O, C // groups, K), 24), _rand((O,), 25)
    m = _module_from(nn.Conv1d(C, O, K, groups=groups), weight=w, bias=b)
    _close(tl.conv1d(m, torch.from_numpy(x), stride=stride, padding=padding,
                     groups=groups),
           jl.conv1d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride, padding=padding,
                     groups=groups))


def _tiny_flat(**kw):
    """The JAX tree's flat keys and shapes for tiny_cfg (jax.eval_shape:
    traced, never run), filled with seeded random values."""
    from mtasr_tpu.models.speech_encoder_decoder import init_model_params
    from mtasr_tpu.utils.torch_interop import tree_to_flat
    from tests.test_composite import tiny_cfg
    cfg = tiny_cfg(train_mode="attention")
    for k, v in kw.items():
        setattr(cfg.encoder, k, v)
    shapes = jax.eval_shape(lambda key: init_model_params(key, cfg),
                            jax.random.key(0))
    flat = {}
    for n, (k, v) in enumerate(sorted(tree_to_flat(
            jax.tree_util.tree_map(lambda s: np.empty(s.shape, s.dtype),
                                   shapes)).items())):
        flat[k] = _rand(v.shape, 100 + n)
    return cfg, flat


def test_load_flat_is_strict_and_complete():
    from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig, from_fields
    from mtasr_tpu_torch.models.speech_encoder_decoder import (
        SpeechEncoderDecoderModel,
    )
    from mtasr_tpu_torch.utils.convert import load_flat
    cfg, flat = _tiny_flat()
    model = SpeechEncoderDecoderModel(
        from_fields(SpeechEncoderDecoderConfig, cfg))
    load_flat(model, flat)
    state = model.state_dict()
    assert set(state) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)
    with pytest.raises(RuntimeError):
        load_flat(model, {k: v for k, v in flat.items()
                          if not k.endswith("norm.weight")})


def test_load_flat_fuses_weight_norm_and_hf_gate_constant():
    """A weight-normed pos conv (g, v) is fused as the JAX forward fuses
    it (`wavlm.py:388-393`), and HF's [1, H, 1, 1] gru_rel_pos_const is
    squeezed to [H]."""
    from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig, from_fields
    from mtasr_tpu_torch.models.speech_encoder_decoder import (
        SpeechEncoderDecoderModel,
    )
    from mtasr_tpu_torch.utils.convert import load_flat
    cfg, flat = _tiny_flat(pos_conv_weight_norm=True)
    key = "encoder.encoder.pos_conv_embed.conv"
    g, v = flat[key + ".weight_g"], flat[key + ".weight_v"]
    const = "encoder.encoder.layers.0.attention.gru_rel_pos_const"
    flat[const] = flat[const].reshape(1, -1, 1, 1)
    model = SpeechEncoderDecoderModel(
        from_fields(SpeechEncoderDecoderConfig, cfg))
    load_flat(model, flat)
    norm = jnp.sqrt(jnp.sum(jnp.asarray(v) ** 2, axis=(0, 1), keepdims=True))
    want = jnp.asarray(g) * jnp.asarray(v) / norm
    np.testing.assert_allclose(model.state_dict()[key + ".weight"].numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-7)
    H = cfg.encoder.num_attention_heads
    np.testing.assert_array_equal(model.state_dict()[const].numpy(),
                                  flat[const].reshape(H))
