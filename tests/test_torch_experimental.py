"""The experimental modules of the port (`mtasr_tpu_torch/models/
sparse_slot.py`, `post_downsample.py`, the rest of `refiners.py`, the
shared core of `adapters.py`) against the JAX package's on the CPU: JAX's
init from a key, its parameters carried across with `load_flat`, the same
inputs from a numpy seed; float32 within rtol 1e-5 and atol 1e-5 (the
sums of a few hundred terms in two libraries' orders), integer and boolean
outputs equal:

* `find_spikes` against JAX and against the reference's Python loop
  (`tests/test_experimental_modules.py:22-33`), exactly; the top-k prune
  (with ties between equal scores), the Gaussian pool and
  `sparse_slot_bridge`;
* `post_downsample`: outputs and lengths;
* the guidance signals (nearest and linear resampling, max and mean),
  `dynamic_lpf`, `local_self_attn`, `soft_router`, `continuous_refiner`
  (and its gradients against `jax.grad`), `ctc_guided_refiner`,
  `extractor_concat_nng` (with and without the repair and the stream
  LayerNorm) and the frame-guided extractor in its gate variants;
* `shared_core_forward` with pre and post MLPs, and a missing memory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.models import adapters as jad
from mtasr_tpu.models import post_downsample as jpd
from mtasr_tpu.models import refiners as jrf
from mtasr_tpu.models import sparse_slot as jss
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch.models import adapters as tad
from mtasr_tpu_torch.models import post_downsample as tpd
from mtasr_tpu_torch.models import refiners as trf
from mtasr_tpu_torch.models import sparse_slot as tss
from mtasr_tpu_torch.utils.convert import load_flat
from tests.test_experimental_modules import _py_find_spikes

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _load(module, p):
    load_flat(module, tree_to_flat(p))
    return module


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=atol)


def _rand(shape, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) if kind == "normal" else rng.random(shape)
    return x.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# sparse slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_spikes_matches_jax_and_the_reference_loop(seed):
    A = _rand((3, 60), seed, "uniform")
    spikes, count = tss.find_spikes(_t(A), thresh=0.6, min_dist=4,
                                    max_spikes=32)
    ref_s, ref_c = jss.find_spikes(jnp.asarray(A), 0.6, 4, 32)
    np.testing.assert_array_equal(spikes.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_c))
    for b in range(3):
        loop = _py_find_spikes(A[b], 0.6, 4)[:32]
        assert count[b] == len(loop)
        np.testing.assert_array_equal(spikes[b, :len(loop)].numpy(), loop)
        assert bool((spikes[b, len(loop):] == -1).all())


def test_find_spikes_caps_at_max_spikes():
    A = _rand((2, 80), 7, "uniform")
    spikes, count = tss.find_spikes(_t(A), 0.3, 2, max_spikes=5)
    ref_s, ref_c = jss.find_spikes(jnp.asarray(A), 0.3, 2, 5)
    assert spikes.shape == (2, 5)
    np.testing.assert_array_equal(spikes.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_c))


def test_prune_and_pool_match_jax():
    A = _rand((2, 50), 3, "uniform")
    A[1, 20:30] = 0.9              # a plateau: equal local means, ties
    h = _rand((2, 50, 8), 4)
    spikes, _ = tss.find_spikes(_t(A), 0.5, 3, max_spikes=16)
    ref_spikes, _ = jss.find_spikes(jnp.asarray(A), 0.5, 3, max_spikes=16)
    for k in (4, 20):              # k past the spikes: padded with -1
        pruned = tss.prune_spikes_topk(_t(A), spikes, k=k)
        ref = jss.prune_spikes_topk(jnp.asarray(A), ref_spikes, k=k)
        np.testing.assert_array_equal(pruned.numpy(), np.asarray(ref))
    pruned = tss.prune_spikes_topk(_t(A), spikes, k=4)
    Z, valid = tss.spike_pool_gaussian(_t(h), pruned)
    Zr, vr = jss.spike_pool_gaussian(jnp.asarray(h),
                                     jss.prune_spikes_topk(
                                         jnp.asarray(A), ref_spikes, k=4))
    _close(Z, Zr)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vr))


def test_sparse_slot_bridge_matches_jax():
    B, Tm, Thi, Dc, Dm = 2, 20, 40, 8, 16
    p = jss.init_sparse_slot_params(jax.random.key(0), Dc, Dm, max_slots=16,
                                    n_heads=4)
    x, h = _rand((B, Tm, Dm), 5), _rand((B, Thi, Dc), 6)
    A = _rand((B, Thi), 7, "uniform")
    A[1] *= 0.5                    # the second row: no spike, no slot
    ref_out, ref_valid = jax.jit(lambda *a: jss.sparse_slot_bridge(
        *a, n_heads=4, top_k=8))(p, jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(A))
    m = _load(tss.SparseSlotBridge(Dc, Dm, max_slots=16), p)
    with torch.no_grad():
        out, valid = tss.sparse_slot_bridge(m, _t(x), _t(h), _t(A),
                                            n_heads=4, top_k=8)
    _close(out, ref_out)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert not bool(valid[1].any()) and bool(valid[0].any())


def test_sparse_slot_init_follows_the_jax_distributions():
    g = torch.Generator().manual_seed(0)
    m = tss.SparseSlotBridge(8, 64, max_slots=16, generator=g)
    assert set(m.state_dict()) == set(tree_to_flat(
        jss.init_sparse_slot_params(jax.random.key(0), 8, 64, 16)))
    m.requires_grad_(False)
    assert float(m.proj_slot.weight.abs().max()) <= 8 ** -0.5
    assert float(m.fuse_attn.in_proj_weight.abs().max()) <= (3 / 64) ** 0.5
    assert float(m.fuse_attn.in_proj_bias.abs().max()) == 0.0
    assert abs(float(m.slot_pos.std()) - 64 ** -0.5) < 0.02
    with torch.no_grad():
        out, _ = tss.sparse_slot_bridge(
            m, torch.randn(2, 10, 64, generator=g),
            torch.randn(2, 30, 8, generator=g),
            torch.rand(2, 30, generator=g), n_heads=4)
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# post-downsampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [3, 4])
def test_post_downsample_matches_jax(kernel):
    D = 8
    p = jpd.init_post_downsample_params(jax.random.key(1), D, kernel)
    x = _rand((2, 37, D), 8)
    lengths = np.array([37, 21], np.int32)
    ref, ref_len = jpd.post_downsample(p, jnp.asarray(x),
                                       jnp.asarray(lengths), kernel=kernel)
    m = _load(tpd.PostDownsample(D, kernel), p)
    with torch.no_grad():
        out, out_len = tpd.post_downsample(m, _t(x), _t(lengths),
                                           kernel=kernel)
    _close(out, ref)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    assert out.shape[1] == ref.shape[1]


# ---------------------------------------------------------------------------
# refiners
# ---------------------------------------------------------------------------
BLANK, V = 7, 8


def _logits(K, B, T, seed):
    return [_rand((B, T, V), seed + k) * 3 for k in range(K)]


@pytest.mark.parametrize("mode,aggregate,t_target", [
    ("nearest", "max", 11), ("nearest", "mean", 37), ("linear", "max", 37),
    ("linear", "mean", 11), ("linear", "max", 20)])
def test_guidance_matches_jax(mode, aggregate, t_target):
    logits = _logits(2, 2, 20, 10)
    ref = jrf.build_guidance_from_ctc_logits(
        [jnp.asarray(lg) for lg in logits], BLANK, t_target, mode, aggregate)
    got = trf.build_guidance_from_ctc_logits(
        [_t(lg) for lg in logits], BLANK, t_target, mode, aggregate)
    for g, r in zip(got[0] + got[1] + [got[2], got[3]],
                    list(ref[0]) + list(ref[1]) + [ref[2], ref[3]]):
        _close(g, r)
    _close(trf.entropy_from_logits(_t(logits[0])),
           jrf.entropy_from_logits(jnp.asarray(logits[0])))


def test_refiner_blocks_match_jax():
    D, B, T, K = 16, 2, 12, 2
    x = _rand((B, T, D), 20)
    A, H = _rand((B, T), 21, "uniform"), _rand((B, T), 22, "uniform")
    p = jrf.init_dynamic_lpf(jax.random.key(3), D)
    # a non-dirac depthwise kernel, so that the conv shows
    p["dw"]["weight"] = jnp.asarray(_rand((D, 1, 9), 23))
    ref = jax.jit(jrf.dynamic_lpf)(p, jnp.asarray(x), jnp.asarray(A),
                                   jnp.asarray(H))
    with torch.no_grad():
        _close(trf.dynamic_lpf(_load(trf.DynamicLPF(D), p), _t(x), _t(A),
                               _t(H)), ref)
    p = jrf.init_local_self_attn(jax.random.key(4), D)
    ref = jax.jit(lambda p, x: jrf.local_self_attn(p, x, 4, 3))(
        p, jnp.asarray(x))
    with torch.no_grad():
        _close(trf.local_self_attn(_load(trf.LocalSelfAttn(D), p), _t(x), 4,
                                   3), ref)
    p = jrf.init_soft_router(jax.random.key(5), D, K)
    A_list = [_rand((B, T), 24 + k, "uniform") for k in range(K)]
    ref = jax.jit(jrf.soft_router)(p, jnp.asarray(x),
                                   [jnp.asarray(a) for a in A_list])
    m = _load(trf.SoftRouter(D, K), p)
    with torch.no_grad():
        _close(trf.soft_router(m, _t(x), [_t(a) for a in A_list]), ref)
        assert trf.soft_router(m, _t(x), None) is not None
        np.testing.assert_array_equal(trf.soft_router(m, _t(x), []).numpy(),
                                      x)


def _refiner(K):
    p = jrf.init_continuous_refiner(jax.random.key(6), 12, 16, n_layers=2,
                                    K_spk=K)
    for i in p["blocks"]:           # non-dirac low-pass kernels
        p["blocks"][i]["lpf"]["dw"]["weight"] = jnp.asarray(
            _rand((16, 1, 9), 30 + int(i)))
    return p, _load(trf.ContinuousRefiner(12, 16, 2, K), p)


def test_continuous_refiner_and_its_gradients_match_jax():
    K, B, T = 2, 2, 14
    p, m = _refiner(K)
    x = _rand((B, T, 12), 31)
    A, H = _rand((B, T), 32, "uniform"), _rand((B, T), 33, "uniform")
    A_list = [_rand((B, T), 34 + k, "uniform") for k in range(K)]
    w = _rand((B, T, 16), 36)

    def jloss(p, x):
        y = jrf.continuous_refiner(p, x, jnp.asarray(A), jnp.asarray(H),
                                   [jnp.asarray(a) for a in A_list],
                                   n_heads=4, band_local=3, band_repair=5)
        return jnp.sum(y * jnp.asarray(w)), y
    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = trf.continuous_refiner(m, xt, _t(A), _t(H), [_t(a) for a in A_list],
                               n_heads=4, band_local=3, band_repair=5)
    (y * _t(w)).sum().backward()
    _close(y, ref)
    _close(xt.grad, gx, atol=1e-4)
    ref_g = tree_to_flat(gp)
    for name, prm in m.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), ref_g[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # no guidance: zeros, H = A
    with torch.no_grad():
        _close(trf.continuous_refiner(m, _t(x), None, None, n_heads=4),
               jax.jit(lambda p, x: jrf.continuous_refiner(
                   p, x, None, None, n_heads=4))(p, jnp.asarray(x)))


def test_ctc_guided_refiner_matches_jax():
    p, m = _refiner(2)
    x = _rand((2, 14, 12), 40)
    logits = _logits(2, 2, 9, 41)
    ref = jax.jit(lambda p, x, lg: jrf.ctc_guided_refiner(
        p, x, BLANK, lg, aggregate="mean", resample_mode="linear",
        n_heads=4))(p, jnp.asarray(x), [jnp.asarray(lg) for lg in logits])
    with torch.no_grad():
        _close(trf.ctc_guided_refiner(m, _t(x), BLANK,
                                      [_t(lg) for lg in logits],
                                      aggregate="mean",
                                      resample_mode="linear", n_heads=4),
               ref)


@pytest.mark.parametrize("repair,stream_ln", [(True, False), (False, True),
                                              (True, True)])
def test_extractor_concat_nng_matches_jax(repair, stream_ln):
    K, D = 2, 16
    p = jrf.init_extractor_concat(jax.random.key(7), 12, D, K,
                                  use_repair=repair,
                                  use_stream_ln=stream_ln)
    x = _rand((2, 10, 12), 50)
    logits = _logits(K, 2, 10, 51)
    ref = jax.jit(lambda p, x, lg: jrf.extractor_concat_nng(
        p, x, BLANK, lg, K, n_heads=4, band_repair=3))(
            p, jnp.asarray(x), [jnp.asarray(lg) for lg in logits])
    m = _load(trf.ExtractorConcat(12, D, K, use_repair=repair,
                                  use_stream_ln=stream_ln), p)
    with torch.no_grad():
        got = trf.extractor_concat_nng(m, _t(x), BLANK,
                                       [_t(lg) for lg in logits], K,
                                       n_heads=4, band_repair=3)
    _close(got, ref)


FRAME_GUIDED = {
    "pow": dict(),
    "sigmoid-entropy-floor": dict(entropy_lambda=0.5, gate_mode="sigmoid",
                                  prob_floor=0.1),
    "even-window": dict(smooth_win=4, gate_gamma=2.0),
    "no-smoothing": dict(smooth_win=1, tag_scale=0.5),
}


@pytest.mark.parametrize("fuse_hidden", [0, 24])
@pytest.mark.parametrize("variant", sorted(FRAME_GUIDED))
def test_frame_guided_extractor_matches_jax(variant, fuse_hidden):
    B, Tm, Tk, Dm_in, Ds, D, K = 2, 20, 30, 8, 6, 16, 2
    p = jrf.init_extractor_frame_guided(jax.random.key(8), Dm_in, Ds, D, K,
                                        fuse_hidden=fuse_hidden)
    x = _rand((B, Tm, Dm_in), 60)
    seps = [_rand((B, Tk, Ds), 61 + k) for k in range(K)]
    logits = _logits(K, B, Tk, 63)
    kw = FRAME_GUIDED[variant]
    ref, ref_mask = jax.jit(lambda p, x, s, lg: jrf.
                            extractor_concat_frame_guided(p, x, BLANK, s, lg,
                                                          **kw))(
        p, jnp.asarray(x), [jnp.asarray(s) for s in seps],
        [jnp.asarray(lg) for lg in logits])
    m = _load(trf.ExtractorFrameGuided(Dm_in, Ds, D, K, fuse_hidden), p)
    with torch.no_grad():
        got, mask = trf.extractor_concat_frame_guided(
            m, _t(x), BLANK, [_t(s) for s in seps],
            [_t(lg) for lg in logits], **kw)
    _close(got, ref)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


# ---------------------------------------------------------------------------
# the shared adapter core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pre,post", [(True, False), (True, True),
                                      (False, True)])
def test_shared_core_forward_matches_jax(pre, post):
    B, L, H, Dm = 2, 7, 16, 8
    p = jad.init_shared_core_params(jax.random.key(2), H, Dm, attn_dim=8,
                                    n_layers=3, mlp_rank=4,
                                    use_pre_mlp=pre, use_post_mlp=post)
    hidden, mem = _rand((B, L, H), 70), _rand((B, 11, Dm), 71)
    mask = np.zeros((B, 11), bool)
    mask[1, 6:] = True             # True = padding
    m = _load(tad.SharedCore(H, Dm, attn_dim=8, n_layers=3, mlp_rank=4,
                             use_pre_mlp=pre, use_post_mlp=post), p)
    with torch.no_grad():
        for i in range(3):
            ref = jax.jit(lambda *a, i=i: jad.shared_core_forward(
                a[0], i, *a[1:]))(p, jnp.asarray(hidden), jnp.asarray(mem),
                                  jnp.asarray(mask))
            _close(tad.shared_core_forward(m, i, _t(hidden), _t(mem),
                                           _t(mask)), ref)
        np.testing.assert_array_equal(
            tad.shared_core_forward(m, 0, _t(hidden), None).numpy(), hidden)
