"""The separator in the port against the JAX package, on the CPU in float32:
`lstm_scan` (the step-by-step plain version) and `lstm` (the route the
separator takes, `torch.lstm`) against the JAX `lstm_scan`, forward and
gradients; `stacked_lstm` with its inter-layer LayerNorm; the separator's
init distributions and `separator_forward` on the JAX parameters.
Tolerances: f32 sums in another order, 1e-5 absolute on outputs of
magnitude <= 1, gradients 1e-4 of max|ref|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.models.separator import (
    init_separator_params, separator_forward as jax_separator_forward,
)
from mtasr_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from mtasr_tpu.ops.lstm import stacked_lstm as jax_stacked_lstm
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch.models.separator import (
    Separator, init_separator, separator_forward,
)
from mtasr_tpu_torch.ops.lstm import lstm, lstm_scan, stacked_lstm

ATOL = 1e-5
GRAD_REL = 1e-4


def _lstm_inputs(seed=0, B=3, T=11, In=5, H=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, In)).astype(np.float32)
    w = (rng.standard_normal((In + H, 4 * H)) * 0.4).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("fn", [lstm_scan, lstm], ids=["scan", "torch_lstm"])
def test_lstm_matches_jax(fn):
    x, w, b = _lstm_inputs()
    cot = np.random.default_rng(1).standard_normal((3, 11, 4)).astype(
        np.float32)
    ref, vjp = jax.vjp(jax_lstm_scan, jnp.asarray(x), jnp.asarray(w),
                       jnp.asarray(b))
    grads = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    out = fn(*leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=ATOL)
    for leaf, want in zip(leaves, grads):
        want = np.asarray(want)
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                                   atol=GRAD_REL * np.abs(want).max())


def test_stacked_lstm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4)).astype(np.float32)
    ws = [(rng.standard_normal((8, 16)) * 0.4).astype(np.float32)
          for _ in range(2)]
    bs = [(rng.standard_normal(16) * 0.1).astype(np.float32)
          for _ in range(2)]
    sc = [(1 + rng.standard_normal(4) * 0.1).astype(np.float32)
          for _ in range(2)]
    bi = [(rng.standard_normal(4) * 0.1).astype(np.float32)
          for _ in range(2)]
    ref = jax_stacked_lstm(jnp.asarray(x), [jnp.asarray(a) for a in ws],
                           [jnp.asarray(a) for a in bs],
                           [jnp.asarray(a) for a in sc],
                           [jnp.asarray(a) for a in bi])
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]  # noqa: E731
    got = stacked_lstm(torch.from_numpy(x), t(ws), t(bs), t(sc), t(bi))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    g = torch.Generator().manual_seed(0)
    dropped = stacked_lstm(torch.from_numpy(x), t(ws), t(bs),
                           dropout_rate=0.5, generator=g,
                           deterministic=False)
    assert float((dropped == 0).float().mean()) > 0.3


def _separator_pair(seed=0, in_dim=12, hidden=8, K=2):
    params = init_separator_params(jax.random.key(seed), in_dim, hidden, K)
    sep = Separator(in_dim, hidden, K)
    sep.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         tree_to_flat(params).items()}, strict=True)
    return params, sep


def test_separator_forward_matches_jax():
    params, sep = _separator_pair()
    x = np.random.default_rng(3).standard_normal((2, 10, 12)).astype(
        np.float32)
    ref = jax_separator_forward(params, jnp.asarray(x), 2)
    with torch.no_grad():
        got = separator_forward(sep, torch.from_numpy(x), 2)
    assert len(got) == 2
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    assert not torch.allclose(got[0], got[1])    # the branches differ
    # dropout after each LSTM layer, only when not deterministic
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        train = separator_forward(sep, torch.from_numpy(x), 2,
                                  lstm_dropout=0.2, deterministic=False,
                                  generator=g)
        evald = separator_forward(sep, torch.from_numpy(x), 2,
                                  lstm_dropout=0.2, deterministic=True,
                                  generator=g)
    assert not torch.allclose(train[0], got[0])
    torch.testing.assert_close(evald[0], got[0])


def test_separator_init_matches_jax_distributions():
    params, _ = _separator_pair(in_dim=64, hidden=32, K=3)
    sep = Separator(64, 32, 3)
    init_separator(sep, torch.Generator().manual_seed(0))
    flat = tree_to_flat(params)
    state = sep.state_dict()
    assert set(state) == set(flat)
    for name, p in state.items():
        ref = np.asarray(flat[name])
        assert tuple(p.shape) == ref.shape, name
        if name.endswith("bias") and "cells" not in name:
            np.testing.assert_allclose(p.numpy(), ref, atol=1e-7,
                                       err_msg=name)   # zero + k * 1e-3
        else:   # same bound: the largest |value| near it on both sides
            bound = np.abs(ref).max()
            assert float(p.abs().max()) <= bound * 1.05 + 1e-6, name
            assert float(p.abs().max()) >= bound * 0.8, name
    assert float(sep.sep_branches["2"]["2"].bias[0].detach()) == \
        pytest.approx(2e-3)
