"""The cross-attention adapters of the port (`mtasr_tpu_torch/models/
adapters.py`) against the JAX package's (`mtasr_tpu/models/adapters.py`) on
the CPU, the same parameters (JAX's init, LoRA B factors made nonzero) and
the same inputs from a numpy seed:

* `adapter_forward` of the four kinds, without a mask, and with a padding
  mask (one row all padding) and CTC confidences: float32 within rtol
  1e-5, atol 1e-6; a bfloat16 run against JAX's bfloat16 run within the
  rounding of bf16 activations (atol 0.05 on outputs of unit scale);
* the keys and values of the memory computed once (`memory_kv`) give the
  same bits as computing them in the call;
* `rank_usage` and `prune_lora_ranks` (the kept ranks, the factors and
  the new `lora_scale` equal to JAX's);
* `init_scalars` gives the JAX init's scalars, rank gates and zero B.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.models import adapters as jad
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch.models import adapters as tad
from mtasr_tpu_torch.utils.convert import load_flat

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

H, D_MEM, A, R = 24, 32, 16, 4
B, LQ, TM = 3, 5, 7
RTOL, ATOL = 1e-5, 1e-6


def _jax_params(kind, seed=0):
    p = jad.init_adapter_params(jax.random.key(seed), kind, H, D_MEM, A,
                                r_max=R, lora_alpha=8.0)
    rng = np.random.default_rng(seed)
    for name in ("q_lora", "k_lora", "v_lora", "out_lora"):
        if name in p:      # nonzero B and spread gates: the LoRA matters
            lp = dict(p[name])
            lp["lora_B"] = jnp.asarray(rng.standard_normal(
                lp["lora_B"].shape).astype(np.float32) * 0.2)
            lp["rank_logits"] = jnp.asarray(rng.uniform(
                -4, 4, R).astype(np.float32))
            p[name] = lp
    return p


def _port(kind, p):
    ad = tad.CrossAttentionAdapter(kind, H, D_MEM, A, r_max=R,
                                   lora_alpha=8.0)
    load_flat(ad, tree_to_flat(p))
    return ad


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, LQ, H)).astype(np.float32)
    mem = rng.standard_normal((B, TM, D_MEM)).astype(np.float32)
    mask = np.zeros((B, TM), bool)
    mask[1, 4:] = True          # a padded row
    mask[2, :] = True           # a row that is all padding
    conf = rng.uniform(0, 1, (B, TM)).astype(np.float32)
    conf[0, 2] = 0.0            # clipped to 1e-6
    return hidden, mem, mask, conf


@pytest.fixture(scope="module", params=tad.KINDS)
def pair(request):
    kind = request.param
    p = _jax_params(kind, seed=tad.KINDS.index(kind))
    return kind, p, _port(kind, p)


@pytest.mark.parametrize("masked", [False, True])
def test_adapter_forward_matches_jax(pair, masked):
    kind, p, ad = pair
    hidden, mem, mask, conf = _inputs()
    m, c = (mask, conf) if masked else (None, None)
    ref = jad.adapter_forward(
        p, kind, jnp.asarray(hidden), jnp.asarray(mem),
        None if m is None else jnp.asarray(m),
        None if c is None else jnp.asarray(c))
    with torch.no_grad():
        got = tad.adapter_forward(
            ad, torch.from_numpy(hidden), torch.from_numpy(mem),
            None if m is None else torch.from_numpy(m),
            None if c is None else torch.from_numpy(c))
    assert bool(torch.isfinite(got).all())     # the all-padding row too
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_adapter_bf16_matches_jax_bf16(pair):
    """Both sides in bfloat16 (parameters and activations): the scores in
    float32, the memory cast to the hidden dtype, the padding and the
    confidences as in float32."""
    kind, p, _ = pair
    pb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), p)
    ad = _port(kind, pb)
    hidden, mem, mask, conf = _inputs(seed=2)
    ref = jad.adapter_forward(
        pb, kind, jnp.asarray(hidden, jnp.bfloat16),
        jnp.asarray(mem, jnp.bfloat16), jnp.asarray(mask),
        jnp.asarray(conf, jnp.bfloat16))
    with torch.no_grad():
        got = tad.adapter_forward(
            ad, torch.from_numpy(hidden).bfloat16(),
            torch.from_numpy(mem).bfloat16(), torch.from_numpy(mask),
            torch.from_numpy(conf).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=0.05)


def test_memory_kv_kept_is_bit_equal(pair):
    kind, _, ad = pair
    hidden, mem, mask, conf = [torch.from_numpy(x) for x in _inputs(seed=3)]
    with torch.no_grad():
        kv = tad.memory_kv(ad, mem, hidden.dtype)
        a = tad.adapter_forward(ad, hidden, mem, mask, conf)
        b = tad.adapter_forward(ad, hidden, mem, mask, conf, kv)
    assert torch.equal(a, b)


def test_rank_usage_and_pruning_match_jax():
    p = _jax_params("adapgatetiny", seed=5)
    ad = _port("adapgatetiny", p)
    np.testing.assert_allclose(float(tad.rank_usage(ad).detach()),
                               float(jad.rank_usage(p)), rtol=1e-6)
    assert float(tad.rank_usage(_port("tiny", _jax_params("tiny")))) == 0.0
    for thr, keep in ((0.5, 1), (0.999, 2)):
        ad = _port("adapgatetiny", p)
        ref, r_ref = jad.prune_lora_ranks(p, gate_threshold=thr,
                                          keep_at_least=keep)
        r = tad.prune_lora_ranks(ad, gate_threshold=thr, keep_at_least=keep)
        assert r == r_ref and r >= keep
        flat, ref_flat = dict(ad.state_dict()), tree_to_flat(ref)
        assert set(flat) == set(ref_flat)
        for k, v in ref_flat.items():
            np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)


def test_init_scalars_are_the_jax_init():
    for kind in tad.KINDS:
        ref = tree_to_flat(jad.init_adapter_params(
            jax.random.key(0), kind, H, D_MEM, A, r_max=R, lora_alpha=8.0))
        ad = tad.CrossAttentionAdapter(kind, H, D_MEM, A, r_max=R,
                                       lora_alpha=8.0)
        with torch.no_grad():
            for q in ad.parameters():
                q.fill_(7.0)
        tad.init_scalars(ad, R, 8.0)
        flat = dict(ad.state_dict())
        assert set(flat) == set(ref)
        for k, v in ref.items():
            if v.ndim == 0 or k.endswith(("rank_logits", "lora_B")):
                np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)
