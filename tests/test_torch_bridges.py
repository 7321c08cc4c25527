"""The CTC bridges and the softmax extractor of the port
(`mtasr_tpu_torch/models/bridges.py`, `refiners.py`) against the JAX
package's (`mtasr_tpu/models/bridges.py`, `refiners.py`) on the CPU, the
same parameters and the same inputs from a numpy seed; float32 within
rtol 1e-5, atol 1e-6, integer and boolean outputs equal:

* `frame_refiner_forward` on padded rows;
* `segment_ids` and `ctc_token_builder` on crafted CTC paths (the head
  reads a one-hot feature, so its argmax is the path): repeats split by a
  blank, a row all blank (every memory slot padding), a row with more
  runs than `Lmax` (the overflow dropped), invalid frames;
* `build_multi_ctc_prefix` on transcripts with ids and pads interleaved,
  cut to 4 a head and at the composite's 64;
* `mha` (self-attention with the band mask, cross-attention with a band
  mask of another length), `band_mask`, `cross_repair`,
  `extractor_concat_softmax`, `resample_to_len_1d` (nearest, at the
  extractor's own length and at others), `nonblank_from_logits`;
* `align_mask_len` shorter, longer and equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.models import bridges as jbr
from mtasr_tpu.models import refiners as jrf
from mtasr_tpu.models.ctc_head import init_ctc_params
from mtasr_tpu.models.speech_encoder_decoder import (
    align_mask_len as jax_align_mask_len,
)
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch.models import bridges as tbr
from mtasr_tpu_torch.models import refiners as trf
from mtasr_tpu_torch.models.ctc_head import CTCHead
from mtasr_tpu_torch.models.speech_encoder_decoder import align_mask_len
from mtasr_tpu_torch.utils.convert import load_flat

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
BLANK = 7          # vocab 7, odim 8


def _load(module, p):
    load_flat(module, tree_to_flat(p))
    return module


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# frame refiner
# ---------------------------------------------------------------------------
def test_frame_refiner_matches_jax():
    D, B, T, K = 16, 2, 9, 2
    key = jax.random.key(0)
    p = jbr.init_frame_refiner_params(key, D)
    heads = [init_ctc_params(k, D, BLANK + 1)
             for k in jax.random.split(jax.random.key(1), K)]
    rng = np.random.default_rng(0)
    sep = [rng.standard_normal((B, T, D)).astype(np.float32)
           for _ in range(K)]
    mixed = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 6:] = False
    ref = jax.jit(lambda *a: jbr.frame_refiner_forward(*a, BLANK))(
        p, [jnp.asarray(s) for s in sep], jnp.asarray(mixed),
        jnp.asarray(mask), heads)
    th = [_load(CTCHead(D, BLANK + 1), h) for h in heads]
    with torch.no_grad():
        got = tbr.frame_refiner_forward(
            _load(tbr.FrameRefiner(D), p), [_t(s) for s in sep], _t(mixed),
            _t(mask), th, BLANK)
    for g, r, s in zip(got, ref, sep):
        _close(g, r)
        np.testing.assert_array_equal(g[1, 6:].numpy(), s[1, 6:])


# ---------------------------------------------------------------------------
# CTC token memory
# ---------------------------------------------------------------------------
PATHS = np.array([
    [[1, 1, 7, 1, 2, 2, 7, 3],     # 4 runs: a repeat split by a blank
     [7, 7, 7, 7, 7, 7, 7, 7],     # all blank: no run, all padding
     [1, 2, 3, 4, 5, 6, 1, 2],     # 8 runs, past Lmax = 4
     [2, 2, 7, 4, 4, 4, 5, 5]],    # runs past the valid frames dropped
    [[3, 7, 3, 3, 7, 7, 6, 6],
     [5, 5, 5, 5, 5, 5, 5, 5],
     [7, 1, 7, 1, 7, 1, 7, 1],
     [6, 5, 4, 3, 2, 1, 0, 0]]])
VALID_LEN = [8, 8, 8, 4]
LMAX = 4


def _one_hot_heads():
    """A head per speaker whose logits are 10 x its one-hot input."""
    p = {"ctc_lo": {"weight": jnp.eye(BLANK + 1) * 10.0,
                    "bias": jnp.zeros(BLANK + 1)}}
    return [p, p], [_load(CTCHead(BLANK + 1, BLANK + 1), p)
                    for _ in range(2)]


def _streams(seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(BLANK + 1, dtype=np.float32)
    return [eye[PATHS[k]] + 0.05 * rng.standard_normal(
        eye[PATHS[k]].shape).astype(np.float32) for k in range(2)]


def _valid():
    return np.arange(PATHS.shape[2])[None, :] < np.array(VALID_LEN)[:, None]


def test_segment_ids_match_jax():
    valid = _valid()
    for k in range(2):
        ref = jbr._segment_ids(jnp.asarray(PATHS[k]), jnp.asarray(valid),
                               BLANK)
        got = tbr.segment_ids(_t(PATHS[k]), _t(valid), BLANK)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tbr.segment_ids(_t(PATHS[0]), _t(valid), BLANK)[0].numpy(),
        [0, 0, -1, 1, 2, 2, -1, 3])


def test_ctc_token_builder_matches_jax_on_crafted_paths():
    jheads, theads = _one_hot_heads()
    sep, valid = _streams(), _valid()
    ref = jbr.ctc_token_builder([jnp.asarray(s) for s in sep],
                                jnp.asarray(valid), jheads, BLANK, LMAX)
    with torch.no_grad():
        got = tbr.ctc_token_builder([_t(s) for s in sep], _t(valid), theads,
                                    BLANK, LMAX)
    mem, pad, conf = got
    _close(mem, ref[0])
    np.testing.assert_array_equal(pad.numpy(), np.asarray(ref[1]))
    _close(conf, ref[2])
    # speaker 0: 4 runs fill Lmax; all blank is all padding; 8 runs keep
    # the first 4; the cut row keeps its 2 runs in the valid frames
    np.testing.assert_array_equal((~pad[:, :LMAX]).sum(1).numpy(),
                                  [4, 0, 4, 2])
    assert float(mem[1, :LMAX].abs().sum()) == 0.0
    assert float(conf[1, :LMAX].abs().sum()) == 0.0
    # run 1 of row 0 is frame 3 alone (token 1 after a blank)
    np.testing.assert_allclose(mem[0, 1].numpy(), sep[0][0, 3], rtol=1e-6)


def test_build_multi_ctc_prefix_matches_jax():
    pad = 0
    rng = np.random.default_rng(3)
    trans = [rng.integers(1, 9, (3, 6)) for _ in range(2)]
    trans[0][0, [1, 4]] = pad
    trans[1][0, :] = pad
    trans[0][2, :] = pad
    trans[1][2, 3:] = pad
    table = rng.standard_normal((9, 5)).astype(np.float32)
    for max_len in (4, tbr.CTC_PROMPT_MAX_LEN):
        ref = jbr.build_multi_ctc_prefix([jnp.asarray(t) for t in trans],
                                         jnp.asarray(table), pad, max_len)
        got = tbr.build_multi_ctc_prefix([_t(t) for t in trans], _t(table),
                                         pad, max_len)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# refiners
# ---------------------------------------------------------------------------
E, NH = 16, 4


def test_mha_and_band_mask_match_jax():
    p = jrf.init_mha_params(jax.random.key(2), E)
    p["in_proj_bias"] = jnp.asarray(
        np.random.default_rng(2).standard_normal(3 * E).astype(np.float32))
    tp = _load(trf.MHA(E), p)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, E)).astype(np.float32)
    mem = rng.standard_normal((2, 7, E)).astype(np.float32)
    for T, S, band in ((11, 11, 3), (11, 7, 0), (4, 9, 20)):
        np.testing.assert_array_equal(trf.band_mask(T, S, band).numpy(),
                                      np.asarray(jrf.band_mask(T, S, band)))
    m = jrf.band_mask(11, 11, 3)[None, None]
    ref = jrf.mha(p, jnp.asarray(x), jnp.asarray(x), NH, m)
    with torch.no_grad():
        got = trf.mha(tp, _t(x), _t(x), NH, _t(m))
    _close(got, ref)
    m = jrf.band_mask(11, 7, 2)[None, None]
    ref = jrf.mha(p, jnp.asarray(x), jnp.asarray(mem), NH, m)
    with torch.no_grad():
        got = trf.mha(tp, _t(x), _t(mem), NH, _t(m))
    _close(got, ref)


def test_cross_repair_and_extractor_match_jax():
    d_in, K, B, T = 12, 2, 2, 30
    p = jrf.init_extractor_concat(jax.random.key(5), d_in, E, K)
    tp = _load(trf.ExtractorConcat(d_in, E, K), p)
    rng = np.random.default_rng(5)
    xr = rng.standard_normal((B, T, E)).astype(np.float32)
    xm = rng.standard_normal((B, T + 3, E)).astype(np.float32)
    ref = jax.jit(jrf.cross_repair, static_argnums=(3, 4))(
        p["repair"], jnp.asarray(xr), jnp.asarray(xm), 8, 24)
    with torch.no_grad():
        got = trf.cross_repair(tp.repair, _t(xr), _t(xm), 8, 24)
    _close(got, ref)
    x_m = rng.standard_normal((B, T, d_in)).astype(np.float32)
    logits = [rng.standard_normal((B, T, BLANK + 1)).astype(np.float32) * 3
              for _ in range(K)]
    ref = jax.jit(lambda p, x, lg: jrf.extractor_concat_softmax(
        p, x, BLANK, lg, K, n_heads=4, band_repair=5))(
            p, jnp.asarray(x_m), [jnp.asarray(lg) for lg in logits])
    with torch.no_grad():
        got = trf.extractor_concat_softmax(
            tp, _t(x_m), BLANK, [_t(lg) for lg in logits], K, n_heads=4,
            band_repair=5)
    assert got.shape == (B, K * T, E)
    _close(got, ref)


@pytest.mark.parametrize("t", [13, 5, 29])
def test_resample_and_nonblank_match_jax(t):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 13)).astype(np.float32)
    _close(trf.resample_to_len_1d(_t(x), t),
           jrf.resample_to_len_1d(jnp.asarray(x), t))
    lg = rng.standard_normal((2, 13, BLANK + 1)).astype(np.float32)
    _close(trf.nonblank_from_logits(_t(lg), BLANK),
           jrf.nonblank_from_logits(jnp.asarray(lg), BLANK))


def test_align_mask_len_matches_jax():
    m = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    for t in (3, 5, 9):
        got = align_mask_len(_t(m), t)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_align_mask_len(jnp.asarray(m), t)))
        assert got.shape == (2, t)
