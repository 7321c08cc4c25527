"""The flash attention backward of the port (kernels #8-#10's plain
versions and the autograd `Function` around them, on CPU tensors) against
the JAX package's Pallas backward run in interpret mode, on the same
seeded inputs in float32:

* `flash_attention_bwd_plain` against the interpreted `_flash_backward`
  fed JAX's own forward output and lse;
* the forward's lse (`flash_attention_lse_plain`) against JAX's;
* `flash_attention` under autograd against `jax.vjp` of the interpreted
  `flash_attention`, and against autograd of `flash_attention_plain`.

Cases: with and without the gated bias, GQA, a kv_len-0 row, T and S not
multiples of the block, the one-block (S <= block_k, MHA) and the tiled
JAX forward. Tolerance: atol 2e-5 + rtol 1e-4 (f32 sums in another order;
the observed differences are about 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.ops.pallas.flash_attention import (
    _flash_backward, _flash_forward, flash_attention as jax_flash,
)
from mtasr_tpu_torch.ops.kernels import flash_attention as fa

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)

CASES = {   # B, T, S, Hq, Hkv, D, bias, kv_lens, block
    "tiled_bias_gqa_len0": (2, 50, 70, 4, 2, 16, True, (70, 0), 32),
    "tiled_nobias_gqa": (2, 40, 33, 4, 1, 16, False, (33, 17), 32),
    "one_block_bias_len0": (3, 37, 37, 2, 2, 16, True, (37, 0, 20), 128),
    "one_block_nobias": (2, 45, 45, 2, 2, 32, False, None, 128),
    "tiled_bias_mha": (2, 65, 65, 2, 2, 16, True, (65, 30), 32),
}


def _inputs(B, T, S, Hq, Hkv, D, bias, kv_lens, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = {"q": rng.standard_normal((B, T, Hq, D)).astype(f),
         "k": rng.standard_normal((B, S, Hkv, D)).astype(f),
         "v": rng.standard_normal((B, S, Hkv, D)).astype(f),
         "dout": rng.standard_normal((B, T, Hq, D)).astype(f),
         "pos_bias": (rng.standard_normal((Hq, T, S)) * 0.3).astype(f)
         if bias else None,
         "gate": np.abs(rng.standard_normal((B, Hq, T))).astype(f)
         if bias else None,
         "kv_lens": None if kv_lens is None
         else np.asarray(kv_lens, np.int32)}
    return x


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(name, got, want):
    if want is None:
        assert got is None, name
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=name, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_interpreted_pallas(case):
    B, T, S, Hq, Hkv, D, bias, kv_lens, blk = CASES[case]
    x = _inputs(B, T, S, Hq, Hkv, D, bias, kv_lens)
    scale = D ** -0.5
    args = [_j(x[n]) for n in ("q", "k", "v", "kv_lens", "pos_bias",
                               "gate")]
    out, lse = _flash_forward(*args, scale, False, 0, blk, blk, True)
    want = _flash_backward(*args, out, lse, _j(x["dout"]), scale, False, 0,
                           blk, blk, True)
    got = fa.flash_attention_bwd_plain(
        _t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["kv_lens"]),
        _t(x["pos_bias"]), _t(x["gate"]), _t(out),
        _t(np.asarray(lse).reshape(B * Hq, T)), _t(x["dout"]))
    for name, g, w in zip(("dq", "dk", "dv", "dpb", "dg"), got, want):
        _close(name, g, w)
    if kv_lens is not None and 0 in kv_lens:     # a kv_len-0 row: zeros
        b = kv_lens.index(0)
        assert not got[0][b].any() and not got[1][b].any()
    # each kernel's wrapper on CPU tensors gives its part of the plain
    targs = (_t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["kv_lens"]),
             _t(x["pos_bias"]), _t(x["gate"]), _t(out),
             _t(np.asarray(lse).reshape(B * Hq, T)), _t(x["dout"]))
    dq, dg = fa.flash_attention_bwd_dq(*targs)
    dk, dv = fa.flash_attention_bwd_dkv(*targs)
    assert torch.equal(dq, got[0]) and torch.equal(dk, got[1])
    assert torch.equal(dv, got[2])
    if bias:
        assert torch.equal(dg, got[4])
        assert torch.equal(fa.flash_attention_bwd_dpb(*targs), got[3])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_lse_matches_jax(case):
    B, T, S, Hq, Hkv, D, bias, kv_lens, blk = CASES[case]
    x = _inputs(B, T, S, Hq, Hkv, D, bias, kv_lens, seed=1)
    args = [_j(x[n]) for n in ("q", "k", "v", "kv_lens", "pos_bias",
                               "gate")]
    _, lse = _flash_forward(*args, D ** -0.5, False, 0, blk, blk, True)
    got = fa.flash_attention_lse_plain(_t(x["q"]), _t(x["k"]),
                                       _t(x["kv_lens"]), _t(x["pos_bias"]),
                                       _t(x["gate"]))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(lse).reshape(B * Hq, T), **TOL)


def _port_grads(x, fn):
    names = ["q", "k", "v"] + (["pos_bias", "gate"]
                               if x["pos_bias"] is not None else [])
    ts = {n: _t(x[n]).requires_grad_(True) for n in names}
    out = fn(ts["q"], ts["k"], ts["v"], kv_lens=_t(x["kv_lens"]),
             pos_bias=ts.get("pos_bias"), gate=ts.get("gate"))
    out.backward(_t(x["dout"]))
    return out, [ts[n].grad for n in names]


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_jax_vjp(case):
    """The autograd Function (plain forward with lse, plain backward on
    CPU tensors) against jax.vjp of the interpreted Pallas flash."""
    B, T, S, Hq, Hkv, D, bias, kv_lens, blk = CASES[case]
    x = _inputs(B, T, S, Hq, Hkv, D, bias, kv_lens, seed=2)
    names = ["q", "k", "v"] + (["pos_bias", "gate"] if bias else [])

    def f(*a):
        kw = dict(zip(names[3:], a[3:]))
        return jax_flash(a[0], a[1], a[2], kv_lens=_j(x["kv_lens"]),
                         block_q=blk, block_k=blk, interpret=True, **kw)
    want_out, vjp = jax.vjp(f, *[_j(x[n]) for n in names])
    want = vjp(_j(x["dout"]))
    out, got = _port_grads(x, fa.flash_attention)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for name, g, w in zip(names, got, want):
        _close(name, g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_autograd_of_plain(case):
    B, T, S, Hq, Hkv, D, bias, kv_lens, _ = CASES[case]
    x = _inputs(B, T, S, Hq, Hkv, D, bias, kv_lens, seed=3)
    out, got = _port_grads(x, fa.flash_attention)
    ref_out, want = _port_grads(x, fa.flash_attention_plain)
    torch.testing.assert_close(out, ref_out, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_function_reads_the_padded_table():
    """WavLM passes `padded_bias`'s row-padded view of the table, which the
    backward reads through its strides, uncopied: autograd through
    `flash_attention` with that view equals autograd with the contiguous
    table, and jax.vjp of the interpreted Pallas flash; the table's
    gradient reaches the leaf through the view."""
    B, T, S, Hq, Hkv, D, bias, kv_lens, blk = CASES["one_block_bias_len0"]
    x = _inputs(B, T, S, Hq, Hkv, D, bias, kv_lens, seed=4)
    names = ["q", "k", "v", "pos_bias", "gate"]

    def f(*a):
        return jax_flash(*a[:3], kv_lens=_j(x["kv_lens"]), pos_bias=a[3],
                         gate=a[4], block_q=blk, block_k=blk, interpret=True)
    _, vjp = jax.vjp(f, *[_j(x[n]) for n in names])
    want = vjp(_j(x["dout"]))
    out_c, got_c = _port_grads(x, fa.flash_attention)
    ts = {n: _t(x[n]).requires_grad_(True) for n in names}
    table = fa.padded_bias(ts["pos_bias"])
    assert table.stride(1) == 40 and not table.is_contiguous()
    out = fa.flash_attention(ts["q"], ts["k"], ts["v"],
                             kv_lens=_t(x["kv_lens"]), pos_bias=table,
                             gate=ts["gate"])
    out.backward(_t(x["dout"]))
    assert torch.equal(out, out_c)
    for name, c, w in zip(names, got_c, want):
        assert torch.equal(ts[name].grad, c), name
        _close(name, ts[name].grad, w)


def test_no_grad_takes_the_forward_alone():
    x = _inputs(1, 8, 8, 2, 2, 16, True, None)
    q = _t(x["q"]).requires_grad_(True)
    with torch.no_grad():
        out = fa.flash_attention(q, _t(x["k"]), _t(x["v"]),
                                 pos_bias=_t(x["pos_bias"]),
                                 gate=_t(x["gate"]))
    assert out.grad_fn is None
    out = fa.flash_attention(q, _t(x["k"]), _t(x["v"]))
    assert type(out.grad_fn).__name__.startswith("FlashAttentionFunction")
