"""The plain versions of the port's kernels against the JAX Pallas kernels
they replace, run in interpret mode on the CPU, and the wrappers'
dispatch: a CPU tensor takes the plain version (no launch is counted), any
other non-CUDA device raises. The CUDA kernels themselves are checked on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.ops.pallas import conv_frontend as jcf
from mtasr_tpu.ops.pallas import decode_attention as jda
from mtasr_tpu.ops.pallas import flash_attention as jfa
from mtasr_tpu_torch.ops import kernels
from mtasr_tpu_torch.ops.kernels import conv_frontend as cf
from mtasr_tpu_torch.ops.kernels import ctc as kctc
from mtasr_tpu_torch.ops.kernels import decode_attention as da
from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
from mtasr_tpu_torch.ops.kernels import flash_attention as fa
from mtasr_tpu_torch.ops.kernels import moe_experts as me
from mtasr_tpu_torch.ops.kernels import w8a8_rows as wr

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


@pytest.fixture
def pallas_calls(monkeypatch):
    """Counts pallas_call entries, so an A/B can assert the JAX kernel ran
    (and not its silent XLA fallback)."""
    from jax.experimental import pallas as pl
    jax.clear_caches()
    seen = {"n": 0}
    real = pl.pallas_call

    def counting(*a, **kw):
        seen["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", counting)
    return seen


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _conv0_inputs(B, S, O=512, K=10, seed=0):
    return (_rand((B, S), seed), _rand((O, 1, K), seed + 1, 0.2),
            _rand((O,), seed + 2, 0.05), 1.0 + _rand((O,), seed + 3, 0.1),
            _rand((O,), seed + 4, 0.05))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("S,fuse", [(1280, True), (1280, False),
                                    (1337, True)])
def test_conv0_plain_matches_xla_golden(S, fuse):
    """Plain vs the JAX golden `_conv0_xla` (exact gelu) at 1e-5; S = 1337
    is not a multiple of 128, which the port takes without a fallback."""
    wave, w, b, g, bt = _conv0_inputs(3, S)
    out = cf.conv0_fused(*_torch(wave, w, b, g, bt), stride=5,
                         fuse_ln=fuse, fuse_act=fuse)
    ref = jcf._conv0_xla(*map(jnp.asarray, (wave, w, b, g, bt)), 5, 1e-5,
                         fuse, fuse)
    assert out.shape == (3, (S - 10) // 5 + 1, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_conv0_plain_matches_pallas_kernel(pallas_calls):
    """Plain vs the TPU kernel in interpret mode at atol 2e-3, the bound of
    its polynomial erf (tests/test_conv_frontend_kernel.py)."""
    wave, w, b, g, bt = _conv0_inputs(4, 1280)
    assert jcf.supported(10, 5, 1, 512, 4, 1280)
    ref = jcf.conv0_fused(*map(jnp.asarray, (wave, w, b, g, bt)), stride=5,
                          interpret=True)
    assert pallas_calls["n"] > 0
    out = cf.conv0_fused(*_torch(wave, w, b, g, bt), stride=5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3)


@pytest.mark.parametrize("T,S,hq,hkv,block_k,bias", [
    (80, 80, 4, 4, 512, True),     # S <= block_k: the one-key-block kernel
    (80, 80, 4, 4, 32, True),      # S > block_k: the tiled kernel
    (50, 70, 4, 2, 32, False),     # tiled, GQA, ragged lengths
])
def test_flash_plain_matches_pallas_kernel(T, S, hq, hkv, block_k, bias,
                                           pallas_calls):
    """Gate, rel-pos table, a padded kv_lens row and a row with kv_len 0
    (all zeros, as the TPU kernels write it): f32, atol 3e-5 / rtol 3e-4
    (the JAX flash tests' own bound)."""
    B, D = 3, 32
    q, k, v = _rand((B, T, hq, D), 6), _rand((B, S, hkv, D), 7), \
        _rand((B, S, hkv, D), 8)
    kv_lens = np.array([S, S - 25, 0], np.int32)
    pb = _rand((hq, T, S), 9, 0.3) if bias else None
    gate = np.abs(_rand((B, hq, T), 10)) if bias else None
    ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_lens=jnp.asarray(kv_lens),
        pos_bias=None if pb is None else jnp.asarray(pb),
        gate=None if gate is None else jnp.asarray(gate),
        block_q=32, block_k=block_k, interpret=True)
    assert pallas_calls["n"] > 0
    out = fa.flash_attention(
        *_torch(q, k, v), kv_lens=torch.from_numpy(kv_lens),
        pos_bias=None if pb is None else torch.from_numpy(pb),
        gate=None if gate is None else torch.from_numpy(gate))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=3e-4)
    assert not out[2].any()


@pytest.mark.parametrize("B,S,hq,hkv,D", [(2, 37, 8, 2, 64),
                                          (3, 214, 32, 8, 64)])
def test_decode_plain_matches_pallas_kernel(B, S, hq, hkv, D, pallas_calls):
    """GQA with a masked tail (a row attending to its first slots only):
    f32, atol 1e-5."""
    q = _rand((B, hq, D), 11)
    kc, vc = _rand((B, S, hkv * D), 12), _rand((B, S, hkv * D), 13)
    mask = np.ones((B, S), bool)
    mask[-1, S // 2:] = False
    mask[0, 3] = False
    ref = jda.decode_attention(*map(jnp.asarray, (q, kc, vc, mask)),
                               interpret=True)
    assert pallas_calls["n"] > 0
    out = da.decode_attention(*_torch(q, kc, vc, mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def _int8_cache(B, S, hkv, D, seed):
    """Random int8 K / V and bf16 scales, the k and v rows of every head
    different, so that reading them in the wrong layout shows."""
    rng = np.random.default_rng(seed)
    k8 = rng.integers(-127, 128, (B, S, hkv * D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, S, hkv * D)).astype(np.int8)
    kvs = rng.uniform(0.002, 0.03, (B, 2 * hkv, S)).astype(np.float32)
    kvs = np.asarray(jnp.asarray(kvs, jnp.bfloat16).astype(jnp.float32))
    return k8, v8, kvs


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16)   # exact: a is bf16-valued


def _assert_int8_close(out, ref, q, k8, v8, kvs, mask):
    """Within 2e-6 + 1e-5 |ref| (the f32 softmax's order of sums), except
    where the two sides rounded one p of a query row to neighbouring int8
    steps: that moves the row's elements by up to 127 * sp (sp the row's p
    scale), and may happen in at most 1 row in 8."""
    _, sp = di.int8_cache_attention(*_torch(q, k8, v8), _bf16(kvs),
                                    torch.from_numpy(mask))
    B, L, Hq, _ = q.shape
    step = (127 * sp).permute(0, 2, 1, 3, 4).reshape(B, L, Hq, 1).numpy()
    out, ref = out.reshape(q.shape), np.asarray(ref).reshape(q.shape)
    err = np.abs(out - ref) - 1e-5 * np.abs(ref)
    assert (err <= 2e-6 + step).all()
    flipped = (err > 2e-6).any(-1)
    assert flipped.mean() <= 1 / 8, flipped.mean()


@pytest.mark.parametrize("B,S,hq,hkv,D", [(2, 37, 8, 2, 64),
                                          (3, 214, 32, 8, 64),
                                          (2, 50, 4, 4, 32)])
def test_decode_int8_plain_matches_pallas_kernel(B, S, hq, hkv, D,
                                                 pallas_calls):
    """#6 over an int8 cache with interleaved k / v scale rows, GQA and a
    masked tail (f32; tolerance `_assert_int8_close`)."""
    q = _rand((B, hq, D), 21)
    k8, v8, kvs = _int8_cache(B, S, hkv, D, 22)
    mask = np.ones((B, S), bool)
    mask[-1, S // 2:] = False
    mask[0, 3] = False
    ref = jda.decode_attention_int8(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(kvs, jnp.bfloat16), jnp.asarray(mask), interpret=True)
    assert pallas_calls["n"] > 0
    out = di.decode_attention_int8(*_torch(q, k8, v8), _bf16(kvs),
                                   torch.from_numpy(mask))
    _assert_int8_close(out.numpy(), ref, q[:, None], k8, v8, kvs,
                       mask[:, None])


def _chunk_mask(B, L, S):
    """Position l sees the slots up to S - L + l (a chunk written at the
    cache's end), and row 1 has a padded slot."""
    mask = np.zeros((B, L, S), bool)
    for pos in range(L):
        mask[:, pos, :S - L + pos + 1] = True
    mask[1, :, 7] = False
    return mask


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("L,hq,hkv", [(2, 8, 2), (5, 4, 4), (16, 8, 2)])
def test_chunk_plain_matches_pallas_kernel(L, hq, hkv, int8, pallas_calls):
    """#5 (bf16 cache) and #7 (int8 cache) over an L-token chunk with a
    [B, L, S] mask, GQA or not: f32, atol 2e-6 / rtol 1e-5 (the f32
    softmax's order of sums), for #7 as `_assert_int8_close` says."""
    B, S, D = 2, 40, 64
    q = _rand((B, L, hq, D), 23)
    mask = _chunk_mask(B, L, S)
    if int8:
        k8, v8, kvs = _int8_cache(B, S, hkv, D, 24)
        ref = jda.decode_attention_int8_chunk(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
            jnp.asarray(kvs, jnp.bfloat16), jnp.asarray(mask),
            interpret=True)
        out = dc.decode_attention_int8_chunk(*_torch(q, k8, v8), _bf16(kvs),
                                             torch.from_numpy(mask))
        assert pallas_calls["n"] > 0
        _assert_int8_close(out.numpy(), ref, q, k8, v8, kvs, mask)
    else:
        kc, vc = _rand((B, S, hkv * D), 25), _rand((B, S, hkv * D), 26)
        ref = jda.decode_attention_chunk(*map(jnp.asarray, (q, kc, vc, mask)),
                                         interpret=True)
        out = dc.decode_attention_chunk(*_torch(q, kc, vc, mask))
        assert pallas_calls["n"] > 0
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("L,S,hq,hkv,D,chunks,resident", [
    (8, 158, 32, 8, 64, 1, 1),       # the served short prefill
    (16, 800, 32, 8, 64, 1, 4),
    (16, 1000, 32, 8, 64, 1, 4),     # the old kernel's scratch began here
    (16, 20000, 64, 8, 256, 63, 0),  # streamed, scores recomputed
    (1, 20000, 32, 8, 64, 18, 0),
])
def test_chunk_int8_plan_needs_no_scratch(L, S, hq, hkv, D, chunks,
                                          resident):
    """The int8 kernel's plan: 16 query rows a block, the cache staged at
    once or in chunks of whole 32-key tiles within the shared memory, the
    scores in registers only when all S are staged and a warp has at most
    4 tiles; the launch takes no buffer but q, the caches, the scales, the
    mask and the output."""
    p = dc.chunk_int8_plan(L, S, D, hq // hkv)
    assert p.row_blocks == -(-hq // hkv * L // 16)
    assert p.keys_staged % 32 == 0 and -(-S // p.keys_staged) == chunks
    assert p.scores_resident == resident
    assert p.warps == min(8, p.keys_staged // 32)
    assert p.smem_bytes == dc.int8_smem_bytes(L, p.keys_staged, D, p.warps)
    assert p.smem_bytes <= dc.MAX_SMEM
    assert not hasattr(dc, "scores_scratch") and \
        "scratch" not in dc.launch.__code__.co_varnames


@pytest.mark.parametrize("L", [1, 2, 8, 16])
def test_chunk_int8_plan_fits_every_shape(L):
    """Every S up to 4096 and a long cache, G <= 8, D <= 256 (multiples of
    4): the block's shared memory fits 227 KB, one chunk holds S whenever
    S fits, and a resident plan covers every tile of S with its warps."""
    for D in (4, 36, 40, 64, 128, 200, 256):
        most = dc.chunk_int8_plan(L, 10 ** 6, D, 8).keys_staged
        for S in list(range(1, 4097, 7)) + [20000, 10 ** 6]:
            for G in (1, 8):
                p = dc.chunk_int8_plan(L, S, D, G)
                assert p.smem_bytes <= dc.MAX_SMEM, (L, S, D)
                assert 1 <= p.warps <= 8 and p.keys_staged >= 32
                assert p.keys_staged == min(-(-S // 32) * 32, most)
                if p.scores_resident:
                    assert p.keys_staged >= S
                    assert p.warps * p.scores_resident * 32 >= S
                assert bool(p.scores_resident) == (S <= min(most, 1024))
            assert dc.chunk_int8_plan(L, S, D, 3).row_blocks == \
                -(-3 * L // 16)


@pytest.mark.parametrize("S,permuted", [(499, False), (64, False), (7, True),
                                        (16, True)])
def test_padded_bias_has_rows_16_bytes_apart(S, permuted):
    """The forward kernel's TMA reads the rel-pos table with rows (and
    heads) a multiple of 8 elements apart: `padded_bias` gives a view of
    the same values and gradient with such strides, and passes a table
    already so laid out through as it is (WavLM builds it once a forward)."""
    t = torch.from_numpy(_rand((3, 5, S), 7))
    if permuted:
        t = torch.from_numpy(_rand((5, S, 3), 7)).permute(2, 0, 1)
    t.requires_grad_(True)
    p = fa.padded_bias(t)
    assert p.shape == t.shape and torch.equal(p, t)
    assert p.stride(2) == 1 and p.stride(1) % 8 == 0 and p.stride(0) % 8 == 0
    assert fa.padded_bias(p) is p
    (p * torch.arange(S, dtype=p.dtype)).sum().backward()
    assert torch.equal(t.grad, torch.arange(S, dtype=p.dtype).expand(t.shape))
    q = torch.from_numpy(_rand((2, 5, 3, 8), 8))
    k = torch.from_numpy(_rand((2, S, 3, 8), 9))
    gate = torch.ones((2, 3, 5))
    np.testing.assert_array_equal(
        fa.flash_attention(q, k, k, pos_bias=p.detach(), gate=gate).numpy(),
        fa.flash_attention(q, k, k, pos_bias=t.detach().contiguous(),
                           gate=gate).numpy())


def test_cpu_tensors_take_the_plain_versions_without_counting():
    kernels.reset_launch_counts()
    wave, w, b, g, bt = _torch(*_conv0_inputs(1, 200, O=64))
    np.testing.assert_array_equal(
        cf.conv0_fused(wave, w, b, g, bt, stride=5).numpy(),
        cf.conv0_plain(wave, w, b, g, bt, stride=5).numpy())
    q = torch.from_numpy(_rand((1, 9, 2, 8), 1))
    np.testing.assert_array_equal(fa.flash_attention(q, q, q).numpy(),
                                  fa.flash_attention_plain(q, q, q).numpy())
    qd = torch.from_numpy(_rand((1, 4, 8), 2))
    kc = torch.from_numpy(_rand((1, 5, 16), 3))
    m = torch.ones((1, 5), dtype=torch.bool)
    np.testing.assert_array_equal(
        da.decode_attention(qd, kc, kc, m).numpy(),
        da.decode_attention_plain(qd, kc, kc, m).numpy())
    k8 = torch.ones((1, 5, 16), dtype=torch.int8)
    kvs = torch.ones((1, 4, 5), dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        di.decode_attention_int8(qd, k8, k8, kvs, m).numpy(),
        di.decode_attention_int8_plain(qd, k8, k8, kvs, m).numpy())
    qc, mc = qd[:, None].expand(1, 3, 4, 8).contiguous(), m.expand(1, 3, 5)
    np.testing.assert_array_equal(
        dc.decode_attention_chunk(qc, kc, kc, mc).numpy(),
        dc.decode_attention_chunk_plain(qc, kc, kc, mc).numpy())
    np.testing.assert_array_equal(
        dc.decode_attention_int8_chunk(qc, k8, k8, kvs, mc).numpy(),
        dc.decode_attention_int8_chunk_plain(qc, k8, k8, kvs, mc).numpy())
    # the backward kernels' wrappers (#8-#10), on a forward with a bias
    pb = torch.from_numpy(_rand((2, 9, 9), 4))
    gate = torch.ones((1, 2, 9))
    out = fa.flash_attention_plain(q, q, q, pos_bias=pb, gate=gate)
    lse = fa.flash_attention_lse_plain(q, q, pos_bias=pb, gate=gate)
    args = (q, q, q, None, pb, gate, out, lse, q)
    ref = fa.flash_attention_bwd_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(
        fa.flash_attention_bwd_dq(*args) + fa.flash_attention_bwd_dkv(*args)
        + (fa.flash_attention_bwd_dpb(*args),),
        (ref[0], ref[4], ref[1], ref[2], ref[3])))
    # the CTC lattice kernels' wrappers (#11, #12)
    _, allow = kctc.lattice(torch.tensor([[3, 3]]), 0, 5)
    emit = torch.from_numpy(_rand((1, 6, 5), 5))
    lens = (torch.tensor([6], dtype=torch.int32),
            torch.tensor([2], dtype=torch.int32))
    alpha, final = kctc.ctc_alpha(emit, *lens, allow)
    ref_alpha, ref_final = kctc.ctc_alpha_plain(emit, *lens, allow)
    assert torch.equal(alpha, ref_alpha) and torch.equal(final, ref_final)
    assert torch.equal(kctc.ctc_beta_post(emit, alpha, *lens, allow),
                       kctc.ctc_beta_post_plain(emit, alpha, *lens, allow))
    # the routed experts' grouped kernel: the loop over experts
    x = torch.from_numpy(_rand((3, 128), 6))
    rows = torch.tensor([0, 2, 1, 0], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    wgu = torch.from_numpy(_rand((3 * 2 * 64, 128), 7))
    wd = torch.from_numpy(_rand((3 * 128, 64), 8))
    counts = torch.tensor([2, 0, 2], dtype=torch.int32)
    assert torch.equal(me.moe_experts(x, rows, offsets, counts, wgu, wd),
                       me.moe_experts_plain(x, rows, offsets, wgu, wd))
    # the w8a8 linear's quantize and rescale
    xq, sx = wr.w8a8_quantize(x)
    assert all(torch.equal(a, b) for a, b in zip(
        (xq, sx), wr.w8a8_quantize_plain(x)))
    acc = torch._int_mm(xq.repeat(6, 1)[:17], xq[:2].t().contiguous())
    scale = torch.from_numpy(np.abs(_rand((2,), 9)))
    assert torch.equal(
        wr.w8a8_rescale(acc, sx.repeat(6, 1)[:17], scale, None,
                        torch.bfloat16),
        wr.w8a8_rescale_plain(acc, sx.repeat(6, 1)[:17], scale, None,
                              torch.bfloat16))
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert len(kernels.WRAPPERS) == 14


def test_wrappers_refuse_other_devices_and_bad_shapes():
    """No silent route: a tensor on neither the CPU nor a CUDA device
    raises, and so do malformed shapes."""
    meta = torch.empty((2, 200), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cf.conv0_fused(meta, torch.empty((64, 1, 10), device="meta"), None,
                       stride=5)
    q = torch.empty((1, 9, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        da.decode_attention(torch.empty((1, 4, 8), device="meta"),
                            torch.empty((1, 5, 16), device="meta"),
                            torch.empty((1, 5, 16), device="meta"),
                            torch.ones((1, 5), dtype=torch.bool,
                                       device="meta"))
    with pytest.raises(ValueError):
        cf.conv0_fused(torch.zeros(2, 5), torch.zeros(8, 1, 10), None,
                       stride=5)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(1, 9, 3, 8), torch.zeros(1, 9, 2, 8),
                           torch.zeros(1, 9, 2, 8))
    with pytest.raises(ValueError):
        da.decode_attention(torch.zeros(1, 4, 8), torch.zeros(1, 5, 16),
                            torch.zeros(1, 5, 16),
                            torch.ones((1, 6), dtype=torch.bool))
    meta_k8 = torch.empty((1, 5, 16), dtype=torch.int8, device="meta")
    meta_s = torch.empty((1, 4, 5), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        di.decode_attention_int8(torch.empty((1, 4, 8), device="meta"),
                                 meta_k8, meta_k8, meta_s,
                                 torch.ones((1, 5), dtype=torch.bool,
                                            device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dc.decode_attention_chunk(
            torch.empty((1, 2, 4, 8), device="meta"),
            torch.empty((1, 5, 16), device="meta"),
            torch.empty((1, 5, 16), device="meta"),
            torch.ones((1, 2, 5), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wr.w8a8_quantize(torch.empty((4, 64), device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wr.w8a8_rescale(torch.empty((4, 8), dtype=torch.int32,
                                    device="meta"),
                        torch.empty((4, 1), device="meta"),
                        torch.empty(8, device="meta"), None, torch.bfloat16)
    k8 = torch.zeros((1, 5, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="kv_scale"):      # [B, Hkv, S]
        di.decode_attention_int8(torch.zeros(1, 4, 8), k8, k8,
                                 torch.zeros(1, 2, 5, dtype=torch.bfloat16),
                                 torch.ones((1, 5), dtype=torch.bool))
    with pytest.raises(ValueError, match="mask"):          # [B, S] for L=2
        dc.decode_attention_int8_chunk(
            torch.zeros(1, 2, 4, 8), k8, k8,
            torch.zeros(1, 4, 5, dtype=torch.bfloat16),
            torch.ones((1, 5), dtype=torch.bool))
