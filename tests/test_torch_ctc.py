"""The port's CTC against the JAX package on the CPU, in float32:

* kernel #11's plain version (`ctc_alpha_plain`) against the interpreted
  Pallas kernel `ctc_loss_pallas_fwd`: alpha, the final row and the loss;
* kernel #12's plain version, through the port's `ctc_loss` backward,
  against `jax.grad` of the interpreted `ctc_loss_pallas`;
* the port's `ctc_loss` and its gradient against `ops/ctc.py::ctc_loss`
  (the XLA scan) and `jax.grad` of it;
* `ctc_greedy_collapse` in both collapse modes;
* `ctc_loss_from_hidden`'s loss and (dhs, dW, db) against `jax.vjp` of the
  JAX function, with a T that the time chunk does not divide.

Cases: ragged input lengths (one of 1), a label length 0, repeated labels
(the skip refused), an impossible alignment (loss 0 and gradient 0 under
zero_infinity). Tolerances: losses rtol 1e-5; alpha and the final row
atol 1e-4 on values of magnitude up to ~60 (f32 rounding of the same
operations, the exp / log of XLA and ATen differ in the last bit);
gradients atol 1e-4 * max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.ops.ctc import ctc_greedy_collapse as jax_collapse
from mtasr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from mtasr_tpu.ops.ctc_fused import ctc_loss_from_hidden as jax_fused
from mtasr_tpu.ops.pallas.ctc_kernel import (
    ctc_loss_pallas, ctc_loss_pallas_fwd,
)
from mtasr_tpu_torch.ops import kernels
from mtasr_tpu_torch.ops.ctc import (
    ctc_greedy_collapse, ctc_loss, ctc_loss_with_logits,
)
from mtasr_tpu_torch.ops.ctc_fused import ctc_loss_from_hidden
from mtasr_tpu_torch.ops.kernels import ctc as kctc

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def _case(seed=0, B=5, T=14, V=9, L=4):
    """log_probs, input lengths, labels, label lengths, blank: row 1 has
    ilen 1, row 2 label length 0, row 3 repeated labels, row 4 an
    impossible alignment (4 labels with repeats in 4 frames)."""
    rng = np.random.default_rng(seed)
    blank = V - 1
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = rng.integers(0, V - 1, (B, L)).astype(np.int32)
    labels[3] = [2, 2, 5, 5]
    labels[4] = [1, 1, 1, 1]
    ilen = np.array([T, 1, T - 3, T - 1, 4], np.int32)
    llen = np.array([L, 1, 0, 4, 4], np.int32)
    return lp, ilen, labels, llen, blank


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_REL * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_alpha_plain_matches_interpreted_pallas(seed):
    lp, ilen, labels, llen, blank = _case(seed)
    loss_j, alpha_j, ll_j = ctc_loss_pallas_fwd(
        jnp.asarray(lp), jnp.asarray(ilen), jnp.asarray(labels),
        jnp.asarray(llen), blank_id=blank, interpret=True)
    lpt, ilt, lat, llt = _t(lp, ilen, labels, llen)
    ext, allow = kctc.lattice(lat, blank, lp.shape[2])
    S = ext.shape[1]
    emit = lpt.gather(2, ext[:, None].expand(-1, lp.shape[1], -1))
    kernels.reset_launch_counts()
    alpha, final = kctc.ctc_alpha(emit.contiguous(), ilt, llt, allow)
    assert kernels.launch_counts()["ctc_alpha"] == 0       # CPU: plain
    alpha_j = np.asarray(alpha_j)[:, :, :S]
    np.testing.assert_allclose(alpha.numpy(), alpha_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), alpha_j[:, -1], rtol=0,
                               atol=1e-4)
    ll = kctc.final_ll(final, llt)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=LOSS_RTOL)
    loss = kctc.zero_infinity_loss(ll)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j),
                               rtol=LOSS_RTOL)
    assert float(loss[4]) == 0.0 and float(loss[0]) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_grad_match_pallas_and_scan(seed):
    """The port's ctc_loss (#11 forward, #12 backward, plain on the CPU)
    against the interpreted Pallas kernels and the XLA scan; a per-row
    cotangent weights the rows differently."""
    lp, ilen, labels, llen, blank = _case(seed)
    w = np.linspace(0.5, 2.0, lp.shape[0]).astype(np.float32)
    args = (jnp.asarray(ilen), jnp.asarray(labels), jnp.asarray(llen))

    def pallas(x):
        return jnp.sum(ctc_loss_pallas(x, *args, blank, True) * w)

    def scan(x):
        return jnp.sum(jax_ctc_loss(x, *args, blank) * w)

    x = jnp.asarray(lp)
    ref_p = ctc_loss_pallas(x, *args, blank, True)
    ref_s = jax_ctc_loss(x, *args, blank)
    g_p, g_s = jax.grad(pallas)(x), jax.grad(scan)(x)
    lpt, ilt, lat, llt = _t(lp, ilen, labels, llen)
    lpt.requires_grad_(True)
    loss = ctc_loss(lpt, ilt, lat, llt, blank)
    (loss * torch.from_numpy(w)).sum().backward()
    for ref in (ref_p, ref_s):
        np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref),
                                   rtol=LOSS_RTOL)
    _assert_grad(lpt.grad.numpy(), g_p)
    _assert_grad(lpt.grad.numpy(), g_s)
    assert not lpt.grad[4].any()            # impossible: zero gradient
    assert not lpt.grad[1, 1:].any()        # past ilen: zero gradient


def test_ctc_loss_with_logits_matches_jax():
    from mtasr_tpu.ops.ctc import ctc_loss_with_logits as jax_with_logits
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 7)).astype(np.float32)
    labels = np.array([[1, 2, 3], [4, 4, 0]], np.int32)
    ilen, llen = np.array([9, 6], np.int32), np.array([3, 2], np.int32)
    ref = jax_with_logits(jnp.asarray(logits), jnp.asarray(ilen),
                          jnp.asarray(labels), jnp.asarray(llen), 6)
    got = ctc_loss_with_logits(*_t(logits, ilen, labels, llen), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=LOSS_RTOL)


@pytest.mark.parametrize("across", [True, False])
def test_greedy_collapse_matches_jax(across):
    rng = np.random.default_rng(7)
    B, T, blank, pad = 4, 30, 9, 8
    path = rng.integers(0, 10, (B, T)).astype(np.int32)
    path[0, :6] = [3, 3, blank, 3, 4, 4]
    valid = np.ones((B, T), bool)
    valid[2, 17:] = False
    for max_out in (5, 40):
        ref, ref_len = jax_collapse(jnp.asarray(path), jnp.asarray(valid),
                                    blank, pad, max_out,
                                    collapse_across_blanks=across)
        got, got_len = ctc_greedy_collapse(*_t(path, valid), blank, pad,
                                           max_out,
                                           collapse_across_blanks=across)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))


@pytest.mark.parametrize("chunk", [4, 128])
def test_ctc_from_hidden_matches_jax_vjp(chunk):
    rng = np.random.default_rng(11)
    B, T, D, V, L = 5, 13, 6, 11, 4
    hs = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((V, D)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    _, ilen, labels, llen, blank = _case(5, B=B, T=T, V=V, L=L)
    ct = np.linspace(0.5, 1.5, B).astype(np.float32)
    loss_j, vjp = jax.vjp(
        lambda h, ww, bb: jax_fused(h, ww, bb, jnp.asarray(ilen),
                                    jnp.asarray(labels), jnp.asarray(llen),
                                    blank, chunk),
        jnp.asarray(hs), jnp.asarray(w), jnp.asarray(b))
    dh_j, dw_j, db_j = vjp(jnp.asarray(ct))
    hst, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                   for a in (hs, w, b))
    loss = ctc_loss_from_hidden(hst, wt, bt, *_t(ilen, labels, llen), blank,
                                time_chunk=chunk)
    (loss * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j),
                               rtol=LOSS_RTOL)
    for got, want in ((hst.grad, dh_j), (wt.grad, dw_j), (bt.grad, db_j)):
        _assert_grad(got.numpy(), want)
    # the same function as the gather path on materialised logits
    logits = hst.detach() @ wt.detach().t() + bt.detach()
    plain = ctc_loss_with_logits(logits, *_t(ilen, labels, llen), blank)
    np.testing.assert_allclose(loss.detach().numpy(), plain.numpy(),
                               rtol=LOSS_RTOL)


def test_ctc_from_hidden_skips_unneeded_gradients():
    """With the head's parameters constant only dhs is computed, with
    the hidden states constant only dW and db; each equals the full
    backward's."""
    rng = np.random.default_rng(2)
    B, T, D, V = 2, 9, 4, 7
    hs = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    b = torch.zeros(V)
    labels = torch.tensor([[1, 2], [3, 3]])
    ilen, llen = torch.tensor([9, 7]), torch.tensor([2, 2])

    def grads(need):
        leaves = [t.clone().requires_grad_(n) for t, n in zip((hs, w, b),
                                                              need)]
        ctc_loss_from_hidden(*leaves, ilen, labels, llen, V - 1).sum() \
            .backward()
        return [t.grad for t in leaves]
    full = grads((True, True, True))
    only_h = grads((True, False, False))
    only_wb = grads((False, True, True))
    torch.testing.assert_close(only_h[0], full[0])
    assert only_h[1] is None and only_wb[0] is None
    torch.testing.assert_close(only_wb[1], full[1])
    torch.testing.assert_close(only_wb[2], full[2])


def test_wrappers_refuse_bad_inputs():
    emit = torch.zeros(2, 5, 3)
    allow = torch.zeros(2, 3, dtype=torch.bool)
    lens = torch.tensor([5, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="allow"):
        kctc.ctc_alpha(emit, lens, lens, allow.int())
    with pytest.raises(ValueError, match="alpha"):
        kctc.ctc_beta_post(emit, emit[:, :4], lens, lens, allow)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kctc.ctc_alpha(emit.to("meta"), lens, lens, allow)
