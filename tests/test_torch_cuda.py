"""The port's CUDA kernels against their plain PyTorch versions on the card,
at shapes beyond the main path's: ragged lengths, other head counts and
dims, long caches, and the wrappers' refusals. Marked `cuda`;
without a CUDA device every test skips. Run on the card with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax, which this file does not
need). Tolerances: one bf16 rounding of the same f32 math is 1 ulp of the
largest |ref|; attention rounds p at another point than its plain version,
so 4 ulps; the int8 kernels' products are exact, and `_check_int8` allows
the one int8 step of p that another order of the softmax's sums can
flip."""
import contextlib
import math
import warnings

import pytest
import torch

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(g, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _check(out, ref, n_ulps):
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape
    err = float((out - ref).abs().max())
    top = float(ref.abs().max())
    tol = n_ulps * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    assert math.isfinite(err) and err <= tol, (err, tol)


@pytest.mark.parametrize("S,O,fuse", [(1337, 512, True), (1337, 256, True),
                                      (4001, 512, False), (10, 64, True),
                                      (1342, 1024, True), (1342, 32, True),
                                      (1342, 128, False)])
def test_conv0_kernel(gen, S, O, fuse):
    """T_out = 266, 799, 1 and 267: none a multiple of the kernel's group
    of frames a warp at that O (4 up to O = 256, 3 at 512, 2 at 1024), so
    every group shape's ragged end is stored; O from 32 to 1024; LayerNorm
    and gelu on and off."""
    from mtasr_tpu_torch.ops.kernels import conv_frontend as cf
    wave = _randn(gen, 3, S)
    w = _randn(gen, O, 1, 10, scale=0.3)
    b, g, bt = (_randn(gen, O, scale=0.05), 1 + _randn(gen, O, scale=0.1),
                _randn(gen, O, scale=0.05))
    before = cf.conv0_fused.launches
    out = cf.conv0_fused(wave, w, b, g, bt, stride=5, fuse_ln=fuse,
                         fuse_act=fuse)
    ref = cf.conv0_plain(wave, w, b, g, bt, stride=5, fuse_ln=fuse,
                         fuse_act=fuse)
    torch.cuda.synchronize()
    assert cf.conv0_fused.launches == before + 1
    _check(out, ref, 1)


@pytest.mark.parametrize("K,stride", [(8, 4), (40, 20)])
def test_conv0_kernel_other_widths(gen, K, stride):
    """A kernel width other than WavLM's 10 (the run-time K path): a window
    of 3 s + K = 20 samples that the shuffles hand out, and one of 100 that
    the taps read from memory."""
    from mtasr_tpu_torch.ops.kernels import conv_frontend as cf
    wave = _randn(gen, 2, 1001)
    w = _randn(gen, 512, 1, K, scale=K ** -0.5)
    b, g, bt = (_randn(gen, 512, scale=0.05), 1 + _randn(gen, 512, scale=0.1),
                _randn(gen, 512, scale=0.05))
    _check(cf.conv0_fused(wave, w, b, g, bt, stride=stride),
           cf.conv0_plain(wave, w, b, g, bt, stride=stride), 1)


def _flash_inputs(g, B, T, S, hq, hkv, D, bias, lens):
    q, k, v = (_randn(g, B, T, hq, D), _randn(g, B, S, hkv, D),
               _randn(g, B, S, hkv, D))
    kw = {}
    if bias:
        kw["pos_bias"] = _randn(g, hq, T, S, scale=0.5)
        kw["gate"] = (1 + torch.rand((B, hq, T), generator=g,
                                     device="cuda")).to(torch.bfloat16)
    if lens is not None:
        kw["kv_lens"] = torch.tensor(lens, device="cuda")
    return q, k, v, kw


_SERVE_LENS = (499,) * 7 + (300,)


@pytest.mark.parametrize("B,T,S,hq,hkv,D,bias,lens", [
    (3, 700, 700, 8, 2, 128, True, (700, 1, 0)),
    (3, 65, 130, 4, 4, 40, False, None),
    (1, 513, 513, 16, 16, 64, True, (400,)),
    (8, 499, 499, 16, 16, 64, True, _SERVE_LENS),         # serving
    (16, 499, 499, 16, 16, 64, True, _SERVE_LENS * 2),    # training
    (3, 100, 200, 4, 4, 64, True, (137, 1, 0)),   # a partial last tile
    (2, 130, 150, 8, 2, 40, True, (150, 77)),      # D = 40, GQA, bias
    (2, 64, 64, 4, 1, 128, False, (64, 5)),        # D = 128, GQA
    (2, 70, 90, 8, 4, 96, True, None),             # D = 96: a half atom
])
def test_flash_kernel(gen, B, T, S, hq, hkv, D, bias, lens):
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, kw = _flash_inputs(gen, B, T, S, hq, hkv, D, bias, lens)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _check(out, fa.flash_attention_plain(q, k, v, **kw), 4)
    if lens is not None and 0 in lens:       # kv_len 0: the row is zeros
        assert not out[lens.index(0)].any()


@pytest.mark.parametrize("B,T,S,hq,hkv,D,bias,lens", [
    (16, 499, 499, 16, 16, 64, True, _SERVE_LENS * 2),
    (3, 100, 200, 8, 2, 128, True, (137, 1, 0)),
    (2, 65, 130, 4, 4, 40, False, None),
])
def test_flash_kernel_lse(gen, B, T, S, hq, hkv, D, bias, lens):
    """The training forward's lse against `flash_attention_lse_plain`
    (-1e30 exactly for a row with no key), and its output beside it."""
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, kw = _flash_inputs(gen, B, T, S, hq, hkv, D, bias, lens)
    out, lse = fa._forward(q, k, v, kw.get("kv_lens"), kw.get("pos_bias"),
                           kw.get("gate"), D ** -0.5, True)
    ref = fa.flash_attention_lse_plain(q, k, kw.get("kv_lens"),
                                       kw.get("pos_bias"), kw.get("gate"))
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, ref, rtol=1e-4, atol=1e-3)
    _check(out, fa.flash_attention_plain(q, k, v, **kw), 4)


def test_flash_kernel_reads_the_padded_table_as_the_contiguous_one(gen):
    """WavLM passes `padded_bias`'s view (rows 16 bytes apart, what TMA
    reads); a contiguous table of an odd S is padded by the wrapper: both
    give the same output, bit for bit."""
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, kw = _flash_inputs(gen, 2, 499, 499, 4, 4, 64, True, (499, 300))
    out = fa.flash_attention(q, k, v, **kw)
    kw["pos_bias"] = fa.padded_bias(kw["pos_bias"])
    assert kw["pos_bias"].stride(1) == 504
    torch.cuda.synchronize()
    assert torch.equal(fa.flash_attention(q, k, v, **kw), out)


def test_flash_kernel_ignores_what_lies_past_kv_len(gen):
    """K and V rows at or past kv_len hold NaN, inside the last partial key
    tile (150 of 192 and 37 of 64 keys) and in tiles wholly past it: the
    output is finite and equals the plain version on clean inputs."""
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    lens = (150, 37, 200, 0)
    q, k, v, kw = _flash_inputs(gen, 4, 90, 200, 4, 2, 64, True, lens)
    k_nan, v_nan = k.clone(), v.clone()
    for b, n in enumerate(lens):
        k_nan[b, n:] = float("nan")
        v_nan[b, n:] = float("nan")
    out = fa.flash_attention(q, k_nan, v_nan, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _check(out, fa.flash_attention_plain(q, k, v, **kw), 4)


def _decode_inputs(g, B, S, hq, hkv, D):
    q = _randn(g, B, hq, D)
    kc = _randn(g, B, S, hkv * D)
    vc = _randn(g, B, S, hkv * D)
    mask = torch.rand((B, S), generator=g, device="cuda") > 0.2
    mask[:, 0] = True
    mask[-1, S // 3 + 1:] = False
    return q, kc, vc, mask


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S", [1, 7, 214, 1000, 20000])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_decode_kernel(gen, B, S, G, D):
    """#4 against its plain version at 8 kv heads: batches on either side
    of the card's 132 SMs (clusters of up to 8 blocks a (b, kv head), 1 at
    B = 64), caches from one slot to 20000 (scores past the shared memory
    of a block go to the global scratch), GQA groups 1-8."""
    from mtasr_tpu_torch.ops.kernels import decode_attention as da
    q, kc, vc, mask = _decode_inputs(gen, B, S, 8 * G, 8, D)
    n = da.decode_attention.launches
    out = da.decode_attention(q, kc, vc, mask)
    assert da.decode_attention.launches == n + 1
    _check(out, da.decode_attention_plain(q, kc, vc, mask), 4)


@pytest.mark.parametrize("B,S,hq,hkv,D", [
    (64, 214, 32, 8, 64), (11, 120, 12, 6, 64), (8, 150, 32, 8, 64),
    (5, 214, 32, 8, 64), (4, 300, 32, 8, 128), (3, 214, 24, 8, 64),
    (1, 7, 32, 8, 64), (1, 1000, 8, 8, 64),
    (2, 9, 6, 2, 40), (3, 50, 4, 4, 256), (2, 33, 2, 1, 2),
    (3, 1000, 32, 8, 64), (3, 214, 24, 8, 128), (3, 77, 8, 8, 64),
])
def test_decode_kernel_covers_every_cluster_size(gen, B, S, hq, hkv, D):
    """Shapes for which the chooser returns each cluster size 1..8 on the
    132-SM card (in this order; `test_torch_decode_cluster.py` pins them),
    then head dims off the 16-byte copies (40, 2) and the widest (256),
    then the earlier shapes at B = 3, among them the compile-time D = 128
    path at an odd group (G = 3)."""
    from mtasr_tpu_torch.ops.kernels import decode_attention as da
    q, kc, vc, mask = _decode_inputs(gen, B, S, hq, hkv, D)
    _check(da.decode_attention(q, kc, vc, mask),
           da.decode_attention_plain(q, kc, vc, mask), 4)


def test_decode_kernel_with_every_slot_masked_and_the_same_bits(gen):
    """A row whose every slot is masked gives what the plain version gives
    (a softmax over -1e9 + s); two launches give the same bits (no atomics,
    a fixed order of the cluster's sums)."""
    from mtasr_tpu_torch.ops.kernels import decode_attention as da
    for B, S in ((8, 214), (64, 214), (2, 5000)):
        q, kc, vc, mask = _decode_inputs(gen, B, S, 32, 8, 64)
        mask[1] = False
        out = da.decode_attention(q, kc, vc, mask)
        _check(out, da.decode_attention_plain(q, kc, vc, mask), 4)
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, da.decode_attention(q, kc, vc, mask))


def test_decode_kernel_refused_cluster_raises(gen, monkeypatch):
    """A cluster size the C entry refuses raises; nothing falls back."""
    from mtasr_tpu_torch.ops.kernels import decode_attention as da
    q, kc, vc, mask = _decode_inputs(gen, 1, 214, 32, 8, 64)
    n = da.decode_attention.launches
    monkeypatch.setattr(da, "cluster_size", lambda *a, **k: 9)
    with pytest.raises(RuntimeError, match="decode_attention"):
        da.decode_attention(q, kc, vc, mask)
    assert da.decode_attention.launches == n


def _int8_cache(g, B, S, hkv, D):
    """K / V drawn in bf16 and quantized by the decoder's own KV quantizer,
    so the scales sit in the interleaved layout the model writes."""
    from mtasr_tpu_torch.models.llama import _quantize_kv
    k8, ks = _quantize_kv(_randn(g, B, S, hkv, D))
    v8, vs = _quantize_kv(_randn(g, B, S, hkv, D))
    kvs = torch.stack([ks, vs], -1).reshape(B, S, 2 * hkv).transpose(1, 2)
    return (k8.reshape(B, S, hkv * D), v8.reshape(B, S, hkv * D),
            kvs.contiguous())


def _check_int8(out, ref, sp, n_ulps=1):
    """n bf16 ulps at max|ref|, plus, in at most 1 query row in 8, one int8
    step of p (the two sides summed the softmax in another order and
    rounded one p / sp to neighbouring integers): 127 * sp of that row.
    sp [B, Hkv, L, G, 1] from `int8_cache_attention`."""
    out, ref = out.float(), ref.float()
    if out.dim() == 3:                      # one token: [B, Hq, D]
        out = out[:, None]
    assert out.shape == ref.shape
    B, L, Hq, D = ref.shape
    top = float(ref.abs().max())
    tol = n_ulps * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    step = (127 * sp).permute(0, 2, 1, 3, 4).reshape(B, L, Hq, 1)
    err = (out - ref).abs()
    assert bool(torch.isfinite(err).all())
    assert bool((err <= tol + step).all()), float((err - tol - step).max())
    assert float((err > tol).any(-1).float().mean()) <= 1 / 8


@pytest.mark.parametrize("B,S,hq,hkv,D", [(3, 1000, 32, 8, 64),
                                          (2, 214, 8, 8, 128),
                                          (4, 77, 12, 2, 64),
                                          (1, 5, 4, 1, 64),
                                          (1, 20000, 32, 8, 64)])
def test_decode_int8_kernel(gen, B, S, hq, hkv, D):
    """S = 5: 5 blocks of one key each; S = 20000 at B = 1: 8 slices of 2500
    keys (the scratch is reached at the longer caches of
    `test_decode_int8_kernel_covers_every_cluster_size`)."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    q = _randn(gen, B, hq, D)
    k8, v8, kvs = _int8_cache(gen, B, S, hkv, D)
    mask = torch.rand((B, S), generator=gen, device="cuda") > 0.2
    mask[-1, S // 3:] = False
    mask[:, 0] = True
    before = di.decode_attention_int8.launches
    out = di.decode_attention_int8(q, k8, v8, kvs, mask)
    ref, sp = di.int8_cache_attention(q[:, None], k8, v8, kvs, mask[:, None])
    torch.cuda.synchronize()
    assert di.decode_attention_int8.launches == before + 1
    _check_int8(out, ref.to(torch.bfloat16), sp)


def _int8_decode(gen, B, S, hq, hkv, D):
    q = _randn(gen, B, hq, D)
    k8, v8, kvs = _int8_cache(gen, B, S, hkv, D)
    mask = torch.rand((B, S), generator=gen, device="cuda") > 0.2
    mask[-1, S // 3:] = False
    mask[:, 0] = True
    return q, k8, v8, kvs, mask


def _check_int8_decode(q, k8, v8, kvs, mask):
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    out = di.decode_attention_int8(q, k8, v8, kvs, mask)
    ref, sp = di.int8_cache_attention(q[:, None], k8, v8, kvs, mask[:, None])
    _check_int8(out, ref.to(torch.bfloat16), sp)
    return out


@pytest.mark.parametrize("B,S,hq,hkv,D,C", [
    (64, 214, 32, 8, 64, 1), (11, 120, 12, 6, 64, 2), (8, 150, 32, 8, 64, 3),
    (5, 214, 32, 8, 64, 4), (4, 300, 32, 8, 128, 5), (3, 214, 24, 8, 64, 6),
    (1, 7, 32, 8, 64, 7), (1, 1000, 8, 8, 64, 8),
    (1, 5, 32, 8, 64, 5), (2, 3, 16, 2, 64, 3),
    (2, 9, 6, 2, 40, 8), (3, 50, 4, 4, 256, 8), (3, 77, 64, 8, 64, 6),
    (1, 30000, 64, 8, 64, 8), (17, 20000, 32, 8, 64, 1),
    (17, 700, 16, 8, 48, 1),
])
def test_decode_int8_kernel_covers_every_cluster_size(gen, B, S, hq, hkv, D,
                                                      C):
    """#6 at shapes for which the chooser returns each cluster size 1..8 on
    the 132-SM card (`test_torch_decode_cluster.py` pins them), C = S at
    S = 5 and 3 (a key a block), head dims off the 16-byte copies (40) and
    the widest (256), G = 8 (two rows a lane's butterfly), D = 48 in 5
    tiles of 168 keys (the general path's ring); then the long
    caches: S = 30000 at G = 8 in 8 slices of 3750 keys, past the shared
    memory's 24576 scores (the global scratch, the scales and mask staged),
    and S = 20000 at B * Hkv = 136 >= 132 SMs (C = 1: the scratch, the
    scales and mask read in place)."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    q, k8, v8, kvs, mask = _int8_decode(gen, B, S, hq, hkv, D)
    n = di.decode_attention_int8.launches
    _check_int8_decode(q, k8, v8, kvs, mask)
    assert di.decode_attention_int8.launches == n + 1
    assert di.decode_attention_int8.last_cluster == C


def test_decode_int8_kernel_with_every_slot_masked_and_the_same_bits(gen):
    """A row whose every slot is masked gives what the plain version gives;
    a second launch gives the same bits (integer atomics, a fixed order of
    the cluster's float sums)."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    for B, S in ((8, 214), (64, 214), (1, 20000), (2, 5000)):
        q, k8, v8, kvs, mask = _int8_decode(gen, B, S, 32, 8, 64)
        mask[min(1, B - 1)] = False
        out = _check_int8_decode(q, k8, v8, kvs, mask)
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, di.decode_attention_int8(q, k8, v8, kvs,
                                                         mask))


def test_decode_int8_kernel_refused_cluster_raises(gen, monkeypatch):
    """A cluster size the C entry refuses raises; nothing falls back."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    q, k8, v8, kvs, mask = _int8_decode(gen, 1, 214, 32, 8, 64)
    n = di.decode_attention_int8.launches
    monkeypatch.setattr(di, "cluster_size_int8", lambda *a, **k: 9)
    with pytest.raises(RuntimeError, match="decode_attention_int8"):
        di.decode_attention_int8(q, k8, v8, kvs, mask)
    assert di.decode_attention_int8.launches == n


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,L,S,hq,hkv,D", [(3, 2, 214, 32, 8, 64),
                                            (2, 16, 300, 8, 1, 64),
                                            (2, 16, 97, 16, 2, 128),
                                            (1, 7, 40, 6, 6, 64),
                                            (2, 16, 1000, 32, 8, 64)])
def test_chunk_kernel(gen, int8, B, L, S, hq, hkv, D):
    """S = 1000 at L = 16, G = 4: the int8 kernel stages all 1000 keys at
    once and keeps 4 tiles of scores a warp in registers (both kernels
    keep their scores in registers at any S, with no scratch)."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    q = _randn(gen, B, L, hq, D)
    mask = torch.ones((B, L, S), dtype=torch.bool, device="cuda")
    for pos in range(L):                     # causal within the chunk
        mask[:, pos, S - L + pos + 1:] = False
    mask[-1, :, S // 3:S - L] = False        # a padded row
    if int8:
        k8, v8, kvs = _int8_cache(gen, B, S, hkv, D)
        out = dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
        ref, sp = di.int8_cache_attention(q, k8, v8, kvs, mask)
        _check_int8(out, ref.to(torch.bfloat16), sp)
    else:
        kc, vc = _randn(gen, B, S, hkv * D), _randn(gen, B, S, hkv * D)
        _check(dc.decode_attention_chunk(q, kc, vc, mask),
               dc.decode_attention_chunk_plain(q, kc, vc, mask), 4)


@pytest.mark.parametrize("B,L,S,hq,hkv,D", [
    (2, 16, 300, 32, 4, 64),     # G = 8, L = 16: 128 rows a kv head
    (2, 4, 1, 8, 2, 64),         # one cache slot
    (1, 8, 20000, 32, 8, 64),    # a long cache, scores in registers
    (2, 3, 70, 4, 2, 36),        # D = 36, padded to 48 for q.k
    (1, 6, 90, 12, 3, 200),      # D = 200: two passes of 128 columns
    (1, 5, 50, 8, 8, 256),
])
def test_chunk_bf16_kernel_edges(gen, B, L, S, hq, hkv, D):
    """#5 at the edges of what it takes, under a random mask with one
    fully masked row: every score is then -1e9 and every key stays in the
    sum, so the row is the mean of V (p = bf16(1 / S)), as the TPU kernel
    and the plain version give."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    q = _randn(gen, B, L, hq, D)
    kc, vc = _randn(gen, B, S, hkv * D), _randn(gen, B, S, hkv * D)
    mask = torch.rand((B, L, S), generator=gen, device="cuda") > 0.3
    mask[:, :, 0] = True
    mask[0, -1] = False
    before = dc.decode_attention_chunk.launches
    out = dc.decode_attention_chunk(q, kc, vc, mask)
    ref = dc.decode_attention_chunk_plain(q, kc, vc, mask)
    torch.cuda.synchronize()
    assert dc.decode_attention_chunk.launches == before + 1
    _check(out, ref, 4)
    p = float(torch.tensor(1.0 / S).to(torch.bfloat16))
    mean = p * vc[0].float().reshape(S, hkv, D).sum(0)
    _check(out[0, -1], mean.repeat_interleave(hq // hkv, 0), 4)


def _chunk_int8_inputs(gen, B, L, S, hq, hkv, D):
    """q, an int8 cache and a random mask with key 0 open in every row
    and the last position of batch row 0 fully masked."""
    q = _randn(gen, B, L, hq, D)
    k8, v8, kvs = _int8_cache(gen, B, S, hkv, D)
    mask = torch.rand((B, L, S), generator=gen, device="cuda") > 0.3
    mask[:, :, 0] = True
    mask[0, -1] = False
    return q, k8, v8, kvs, mask


@pytest.mark.parametrize("B,L,S,hq,hkv,D", [
    (2, 16, 300, 32, 4, 64),     # G = 8, L = 16: 128 rows, 8 row blocks
    (2, 4, 1, 8, 2, 64),         # one cache slot
    (1, 8, 20000, 32, 8, 64),    # a long cache: streamed, recomputed
    (2, 3, 70, 4, 2, 36),        # D = 36: 4-byte copies, padded to 64
    (2, 5, 123, 16, 4, 40),      # D = 40: 8-byte copies
    (1, 6, 90, 12, 3, 200),      # D = 200: four rounds of 64 columns
    (1, 5, 50, 8, 8, 256),
    (3, 1, 214, 32, 8, 64),      # L = 1, as a caller may send it
])
def test_chunk_int8_kernel_edges(gen, B, L, S, hq, hkv, D):
    """#7 at the edges of what it takes, under a random mask with one
    fully masked row (every score -1e9, every key in the sum: the mean of
    v weighted by vs, as the TPU kernel and the plain version give; the
    keys that pad S to a tile stay out of it), and the same bits on a
    second launch."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    q, k8, v8, kvs, mask = _chunk_int8_inputs(gen, B, L, S, hq, hkv, D)
    before = dc.decode_attention_int8_chunk.launches
    out = dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
    again = dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
    ref, sp = di.int8_cache_attention(q, k8, v8, kvs, mask)
    torch.cuda.synchronize()
    assert dc.decode_attention_int8_chunk.launches == before + 2
    _check_int8(out, ref.to(torch.bfloat16), sp)
    assert torch.equal(out, again)


@pytest.mark.parametrize("keys,resident", [(None, 0), (64, 0), (32, 0),
                                           (None, 4)])
@pytest.mark.parametrize("S", [158, 300])
def test_chunk_int8_kernel_every_route(gen, S, keys, resident, monkeypatch):
    """The plan's other routes at S = 158 and 300 (L = 16, G = 4): the
    scores recomputed by each pass, the cache streamed in chunks of 2 and
    1 tiles, and more resident tiles than a warp needs; each against the
    plain version, and a route that keeps the plan's tiles and warps gives
    the plan's own bits (only the tiles' order sets the sum's)."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    q, k8, v8, kvs, mask = _chunk_int8_inputs(gen, 2, 16, S, 16, 4, 64)
    mine = dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
    plan = dc.chunk_int8_plan(16, S, 64, 4)
    forced = plan._replace(keys_staged=keys or plan.keys_staged,
                           scores_resident=resident)
    monkeypatch.setattr(dc, "chunk_int8_plan", lambda *a: forced)
    out = dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
    ref, sp = di.int8_cache_attention(q, k8, v8, kvs, mask)
    torch.cuda.synchronize()
    _check_int8(out, ref.to(torch.bfloat16), sp)
    if keys is None:
        assert torch.equal(out, mine)


def test_chunk_int8_kernel_refused_plan_raises(gen, monkeypatch):
    """A plan the kernel cannot take (scores resident over a cache staged
    in chunks) is refused by the launch and raised, not routed to the
    plain version."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    q, k8, v8, kvs, mask = _chunk_int8_inputs(gen, 1, 8, 300, 32, 8, 64)
    plan = dc.chunk_int8_plan(8, 300, 64, 4)
    monkeypatch.setattr(dc, "chunk_int8_plan", lambda *a: plan._replace(
        keys_staged=64, scores_resident=4))
    n = dc.decode_attention_int8_chunk.launches
    with pytest.raises(RuntimeError, match="decode_attention_int8_chunk"):
        dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
    assert dc.decode_attention_int8_chunk.launches == n


def test_int8_linear_small_batch_pads_to_the_int8_gemm(gen):
    """w8a8 on the card: `torch._int_mm` at M = 8 (padded to 32 rows) and
    M = 40 gives the CPU's exact int32 products."""
    from mtasr_tpu_torch.models.layers import linear
    from mtasr_tpu_torch.utils.quantize import quantize_linear
    w = _randn(gen, 512, 2048, scale=0.02)
    q = quantize_linear(w, None, "w8a8")
    qc = quantize_linear(w.cpu(), None, "w8a8")
    for M in (8, 40):
        x = _randn(gen, M, 2048)
        out = linear(q, x)
        ref = linear(qc, x.cpu())
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    from mtasr_tpu_torch.ops.kernels import conv_frontend as cf
    from mtasr_tpu_torch.ops.kernels import decode_attention as da
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    q = _randn(gen, 1, 8, 2, 64, dtype=torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = _randn(gen, 1, 8, 2, 136)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    mask = torch.ones((1, 5), dtype=torch.bool, device="cuda")
    q = _randn(gen, 1, 16, 64)
    kc = _randn(gen, 1, 5, 64)           # Hq / Hkv = 16 > 8
    with pytest.raises(ValueError):
        da.decode_attention(q, kc, kc, mask)
    q, kc = q[:, :8].float(), kc.float()
    with pytest.raises(TypeError):
        da.decode_attention(q, kc, kc, mask)
    wave = _randn(gen, 2, 400).t().contiguous().t()
    with pytest.raises(ValueError):
        cf.conv0_fused(wave, _randn(gen, 64, 1, 10), None, stride=5)
    with pytest.raises(TypeError):
        cf.conv0_fused(wave.float().contiguous(), _randn(gen, 64, 1, 10),
                       None, stride=5)
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    k8, v8, kvs = _int8_cache(gen, 1, 5, 2, 64)
    q = _randn(gen, 1, 4, 64)
    with pytest.raises(TypeError):                 # bf16 cache to #6
        di.decode_attention_int8(q, k8.bfloat16(), v8.bfloat16(), kvs, mask)
    with pytest.raises(TypeError):                 # f32 scales
        di.decode_attention_int8(q, k8, v8, kvs.float(), mask)
    with pytest.raises(ValueError):                # D = 66: not 4k
        di.decode_attention_int8(_randn(gen, 1, 4, 66),
                                 torch.zeros(1, 5, 132, dtype=torch.int8,
                                             device="cuda"),
                                 torch.zeros(1, 5, 132, dtype=torch.int8,
                                             device="cuda"),
                                 kvs, mask)
    qc = _randn(gen, 1, 17, 4, 64)                 # L = 17 > 16
    mc = torch.ones((1, 17, 5), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="positions"):
        dc.decode_attention_int8_chunk(qc, k8, v8, kvs, mc)
    kc = torch.zeros(1, 5, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="Hq/Hkv"):  # 16 q heads a kv head
        dc.decode_attention_chunk(_randn(gen, 1, 2, 16, 64), kc, kc,
                                  mc[:, :2])
    with pytest.raises(ValueError):                # not contiguous
        dc.decode_attention_chunk(qc[:, :4].transpose(1, 2).contiguous()
                                  .transpose(1, 2), k8.bfloat16(),
                                  v8.bfloat16(), mc[:, :4])


def _flash_bwd_inputs(g, B, T, S, hq, hkv, D, bias, lens, padded=False):
    """With `padded`, the table is `padded_bias`'s row-padded view, as WavLM
    passes it."""
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v = (_randn(g, B, T, hq, D), _randn(g, B, S, hkv, D),
               _randn(g, B, S, hkv, D))
    pb = _randn(g, hq, T, S, scale=0.5) if bias else None
    if padded:
        pb = fa.padded_bias(pb)
    gate = ((1 + torch.rand((B, hq, T), generator=g, device="cuda"))
            .to(torch.bfloat16) if bias else None)
    kv = torch.tensor(lens, device="cuda") if lens is not None else None
    out = fa.flash_attention_plain(q, k, v, kv_lens=kv, pos_bias=pb,
                                   gate=gate)
    lse = fa.flash_attention_lse_plain(q, k, kv, pb, gate)
    dout = _randn(g, B, T, hq, D)
    return q, k, v, kv, pb, gate, out, lse, dout


@pytest.mark.parametrize("B,T,S,hq,hkv,D,bias,lens,padded", [
    (3, 130, 130, 4, 4, 64, True, (130, 1, 0), False),
    (2, 200, 1000, 8, 2, 64, True, (1000, 555), False),
    (2, 77, 93, 4, 1, 128, False, (93, 0), False),
    (1, 499, 499, 16, 16, 64, True, None, False),
    (2, 499, 499, 16, 16, 64, True, (499, 300), True),   # WavLM's table
    (2, 100, 70, 4, 4, 40, True, (70, 33), True),        # D 40, S < T
    (2, 70, 150, 8, 4, 96, True, (150, 1), True),        # D 96, S > T
    (2, 65, 130, 4, 4, 128, True, (130, 0), True),       # D 128, bias
    (2, 90, 80, 8, 2, 64, True, (80, 17), False),        # GQA 4
    (3, 64, 64, 2, 2, 64, True, (64, 63, 1), False),     # whole tiles
    (1, 100, 77, 4, 2, 64, True, (77,), True),           # B 1, GQA 2
    (16, 130, 190, 4, 2, 64, True,                       # B 16, GQA, a 0
     (190, 0, 1, 64, 65, 128, 129, 190, 37, 190, 150, 2, 190, 100, 63, 190),
     True),
    (16, 499, 499, 16, 16, 64, True, (499,) * 14 + (300, 0), True),
])
def test_flash_bwd_kernels(gen, B, T, S, hq, hkv, D, bias, lens, padded):
    """#8, #9, #10 against `flash_attention_bwd_plain`; the forward's lse
    against the plain lse; a kv_len-0 row gives zero gradients. bf16
    outputs: 4 ulps at max|ref| (ds and p round to bf16 before the
    products on both sides, in another order of f32 sums). Head dims 40 to
    128, T and S off the 64-row tiles on either side of each other, kv_len
    0 and 1, GQA groups 1, 2 and 4, the row-padded table."""
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, kv, pb, gate, out, lse, dout = _flash_bwd_inputs(
        gen, B, T, S, hq, hkv, D, bias, lens, padded)
    o_k, lse_k = fa._forward(q, k, v, kv, pb, gate, D ** -0.5, True)
    torch.cuda.synchronize()
    assert float((lse_k - lse).abs().max()) < 2e-2
    ref = fa.flash_attention_bwd_plain(q, k, v, kv, pb, gate, out, lse, dout)
    n = (fa.flash_attention_bwd_dq.launches,
         fa.flash_attention_bwd_dkv.launches,
         fa.flash_attention_bwd_dpb.launches)
    dq, dg = fa.flash_attention_bwd_dq(q, k, v, kv, pb, gate, out, lse, dout)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, kv, pb, gate, out, lse,
                                        dout)
    torch.cuda.synchronize()
    _check(dq, ref[0], 4)
    _check(dk, ref[1], 4)
    _check(dv, ref[2], 4)
    if bias:
        _check(dg, ref[4], 4)
        _check(fa.flash_attention_bwd_dpb(q, k, v, kv, pb, gate, out, lse,
                                          dout), ref[3], 4)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dpb.launches) == \
        (n[0] + 1, n[1] + 1, n[2] + int(bias))
    if lens is not None and 0 in lens:
        b = lens.index(0)
        for t in (dq[b], dk[b], dv[b]):
            assert bool(torch.isfinite(t).all()) and not t.any()


def _nan_after(t, extra=64):
    """t's values as the prefix of a buffer that holds NaN past its end."""
    buf = torch.full((t.numel() + extra,), float("nan"), dtype=t.dtype,
                     device=t.device)
    buf[:t.numel()] = t.flatten()
    return buf[:t.numel()].view(t.shape)


def test_flash_bwd_kernels_ignore_what_lies_past_kv_len_and_t(gen):
    """NaN in the K and V rows at or past kv_len (inside the last partial
    key tile and in tiles wholly past it), in the table's padding slots
    past S and in the memory past the end of q, dO, lse, delta and the
    gate (past T of the last row): #8, #9 and #10 give finite gradients
    equal to the plain version's on clean inputs."""
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    B, T, S, H, D, lens = 4, 90, 200, 4, 64, (150, 37, 200, 0)
    q, k, v, kv, pb, gate, out, lse, dout = _flash_bwd_inputs(
        gen, B, T, S, H, H, D, True, lens)
    k_nan, v_nan = k.clone(), v.clone()
    for b, n in enumerate(lens):
        k_nan[b, n:] = float("nan")
        v_nan[b, n:] = float("nan")
    full = torch.full((H, T, 208), float("nan"), dtype=pb.dtype,
                      device="cuda")
    full[..., :S] = pb
    pb_nan = full[..., :S]                   # rows 208 apart, NaN past S
    got_args = (_nan_after(q), k_nan, v_nan, kv, pb_nan, _nan_after(gate),
                out, _nan_after(lse), _nan_after(dout))
    ref = fa.flash_attention_bwd_plain(q, k, v, kv, pb, gate, out, lse, dout)
    delta = _nan_after(fa._delta(dout, out))
    dq, dg = fa.flash_attention_bwd_dq(*got_args, delta=delta)
    dk, dv = fa.flash_attention_bwd_dkv(*got_args, delta=delta)
    dpb = fa.flash_attention_bwd_dpb(*got_args, delta=delta)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv, dpb, dg), ref):
        assert bool(torch.isfinite(got).all())
        _check(got, want, 4)


@pytest.mark.parametrize("B,T,S,hq,hkv,lens", [
    (4, 499, 499, 16, 16, (499, 300, 499, 1)),   # the training shape
    (2, 200, 300, 8, 2, (300, 111)),             # GQA: f32 per head
    (1, 100, 77, 4, 2, (77,)),
    (16, 130, 190, 4, 2, (190, 0, 1, 64, 65, 128, 129, 190, 37, 190, 150, 2,
                          190, 100, 63, 190)),
])
def test_flash_bwd_kernels_give_the_same_bits_every_run(gen, B, T, S, hq,
                                                        hkv, lens):
    """#8, #9 and #10 launched twice on the same inputs give equal bits: no
    atomics, and no race in #8's ring or #9's double buffer of lse / delta
    / gate would stay hidden under a tolerance."""
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    args = _flash_bwd_inputs(gen, B, T, S, hq, hkv, 64, True, lens, True)
    delta = fa._delta(args[8], args[6])
    runs = [(*fa.flash_attention_bwd_dq(*args, delta=delta),
             *fa.flash_attention_bwd_dkv(*args, delta=delta),
             fa.flash_attention_bwd_dpb(*args, delta=delta))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dg", "dk", "dv", "dpb"), *runs):
        assert torch.equal(a, b), name


@contextlib.contextmanager
def _deterministic():
    """ATen and cuDNN on their deterministic algorithms (their defaults may
    sum in another order from run to run: two hybrid steps then differ by
    a rel-L2 of about 6e-4); yields the warnings of ops that have none."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def _hybrid_step_grads(remat: bool, pit: bool = False, plain: bool = False):
    """(loss, {name: f32 gradient}, launch counts) of one hybrid PCGrad
    step at full width cut to 2 encoder and 2 decoder layers, batch 2 x
    2 s, dropout and SpecAugment on, weights and dropout from fixed seeds:
    the projected head gradients on the shared parameters, the total
    loss's on the rest. `pit`: the PIT branch (one graph) instead of the
    three-stage split; `plain`: the kernels' plain versions."""
    from chip_smoke import plain_versions
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.train import train_step as ts
    from mtasr_tpu_torch.train.freeze import (
        apply_trainable_mask, trainable_mask,
    )
    from mtasr_tpu_torch.train.lora import init_decoder_lora
    from mtasr_tpu_torch.utils.convert import init_random
    cfg, _ = full_width.config(hybrid=True, num_hidden_layers=2)
    cfg.decoder.num_hidden_layers = 2
    cfg.encoder.remat = remat
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    model = init_random(cfg, g, "cuda", torch.bfloat16).train()
    init_decoder_lora(model, g, r=16, alpha=32.0)
    apply_trainable_mask(model, trainable_mask(
        model, train_mode="hybrid", freeze_decoder=True))
    batch = full_width.train_batch(cfg, 2, 2, seed=0)
    t = {n: torch.from_numpy(a).cuda() for n, a in batch.arrays.items()
         if n != "prompt_ids"}
    shared, rest = ts._split_params(model)
    names = {id(p): n for n, p in model.named_parameters()}
    g.manual_seed(1)                           # the dropout stream
    kernels.reset_launch_counts()
    branch = ts._joint_pit if pit else ts._three_stage
    with plain_versions(plain):
        out, head_grads, g_rest = branch(model, cfg, t, 1, g, shared, rest)
    grads = {names[id(p)]: x.float() for p, x in
             zip(shared + rest, ts.pcgrad_project(head_grads) + g_rest)}
    torch.cuda.synchronize()
    return float(out.loss.detach()), grads, kernels.launch_counts()


def _rel(a, b):
    num = sum(float((a[n] - b[n]).pow(2).sum()) for n in b)
    return math.sqrt(num / sum(float(x.pow(2).sum()) for x in b.values()))


def test_hybrid_step_with_remat_equals_the_step_without(gen, monkeypatch):
    """With the encoder's remat each layer's forward runs again in the
    backward (the flash forward, then #8-#10 on its lse). On deterministic
    algorithms two steps without remat give the same bits, and so does the
    step with remat: the same loss and gradients."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with _deterministic() as caught:
        l0, g0, n0 = _hybrid_step_grads(False)
        l0b, g0b, _ = _hybrid_step_grads(False)
        l1, g1, n1 = _hybrid_step_grads(True)
    assert n0["flash_attention_bwd_dq"] == n1["flash_attention_bwd_dq"] > 0
    assert n1["flash_attention"] > n0["flash_attention"]   # recomputed
    noise, rel = _rel(g0b, g0), _rel(g1, g0)
    worst = sorted(((_rel({n: g1[n]}, {n: g0[n]}), n) for n in g0
                    if float(g0[n].norm()) > 0), reverse=True)[:4]
    msg = (f"loss {l0} / {l0b} / remat {l1}; rel-L2 remat {rel}, two runs "
           f"without {noise}; worst {worst}; nondeterministic ops "
           f"{sorted({str(w.message)[:120] for w in caught})}")
    print(msg)
    assert l0b == l0 and all(torch.equal(g0b[n], g0[n]) for n in g0), msg
    assert l1 == l0 and all(torch.equal(g1[n], g0[n]) for n in g0), msg


def test_hybrid_pit_step_with_kernels_equals_the_plain_step(gen):
    """The PIT branch (`train_step.py::_joint_pit`) of one hybrid step with
    the kernels against the same step on their plain versions: the loss
    and the projected gradients within the hybrid gate (rel-L2 0.03), and
    the launches of the flash forward, #8-#10 (one backward a head: 2
    heads x 2 layers) and #11 / #12 (every head against every stream: 4
    CTC losses, their backward for the rest and for each head)."""
    loss_k, gk, nk = _hybrid_step_grads(False, pit=True)
    loss_p, gp, np_ = _hybrid_step_grads(False, pit=True, plain=True)
    print(f"PIT: loss {loss_k} vs {loss_p}, rel-L2 {_rel(gk, gp)}, "
          f"launches {nk} / {np_}")
    assert math.isfinite(loss_k) and abs(loss_k - loss_p) <= 0.03 * abs(loss_p)
    assert _rel(gk, gp) <= 0.03
    want = {"conv0_fused": 1, "flash_attention": 2,
            "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4,
            "flash_attention_bwd_dpb": 4, "ctc_alpha": 4, "ctc_beta_post": 12}
    assert {n: nk[n] for n in want} == want
    assert not any(np_[n] for n in want)


def test_gradients_flow_through_the_kernel_functions(gen):
    """The flash and conv0 wrappers under autograd: the kernels run
    forward and backward, and the gradients match autograd through the
    plain versions."""
    from mtasr_tpu_torch.ops.kernels import conv_frontend as cf
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, kv, pb, gate, _, _, dout = _flash_bwd_inputs(
        gen, 2, 99, 99, 4, 4, 64, True, (99, 50))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pb, gate)]
    n_fwd = fa.flash_attention.launches
    out = fa.flash_attention(*leaves[:3], kv_lens=kv, pos_bias=leaves[3],
                             gate=leaves[4])
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pb, gate)]
    ref = torch.autograd.grad(
        fa.flash_attention_plain(*ref_leaves[:3], kv_lens=kv,
                                 pos_bias=ref_leaves[3], gate=ref_leaves[4]),
        ref_leaves, dout)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n_fwd + 1
    for a, b in zip(got, ref):
        _check(a, b, 8)
    wave = _randn(gen, 2, 1337)
    w = _randn(gen, 512, 1, 10, scale=0.3).requires_grad_(True)
    b, g2, bt = (_randn(gen, 512, scale=0.05).requires_grad_(True),
                 (1 + _randn(gen, 512, scale=0.1)).requires_grad_(True),
                 _randn(gen, 512, scale=0.05).requires_grad_(True))
    n_conv = cf.conv0_fused.launches
    y = cf.conv0_fused(wave, w, b, g2, bt, stride=5)
    dy = _randn(gen, *y.shape)
    got = torch.autograd.grad(y, (w, b, g2, bt), dy)
    ref = torch.autograd.grad(cf.conv0_plain(wave, w, b, g2, bt, stride=5),
                              (w, b, g2, bt), dy)
    torch.cuda.synchronize()
    assert cf.conv0_fused.launches == n_conv + 1
    for a, r in zip(got, ref):
        _check(a, r, 2)


def _ctc_inputs(g, B, T, V, L, device="cuda"):
    """log-probs [B, T, V] f32 and a lattice with ragged lengths: row 0
    full, row 1 ilen 1, row 2 label length 0, row 3 repeated labels, row
    4 an impossible alignment (L labels with repeats in L frames)."""
    logits = torch.randn((B, T, V), generator=g, device="cuda") * 2
    lp = torch.log_softmax(logits, -1).to(device)
    labels = torch.randint(0, V - 1, (B, L), generator=g,
                           device="cuda").to(device)
    ilen = torch.full((B,), T, dtype=torch.int32, device=device)
    llen = torch.full((B,), L, dtype=torch.int32, device=device)
    if B >= 5:
        ilen[1], llen[1] = 1, min(L, 1)
        llen[2] = 0
        labels[3, : L // 2 * 2] = labels[3, 0]
        labels[4] = 1
        ilen[4] = min(L, T)
        ilen[0] = T - 3
    return lp, ilen, labels, llen, V - 1


def _ctc_close(out, ref):
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,T,V,L", [(16, 499, 60, 10), (5, 499, 300, 100),
                                     (5, 40, 600, 511), (3, 1, 9, 4)])
def test_ctc_kernels(gen, B, T, V, L):
    """#11 and #12 against their plain versions (the path's shape, a long
    label, the largest lattice a block takes, a single frame), and the
    loss against torch's CTC on the same log-probs."""
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    lp, ilen, labels, llen, blank = _ctc_inputs(gen, B, T, V, L)
    ext, allow = kc.lattice(labels, blank, V)
    emit = lp.gather(2, ext[:, None].expand(-1, T, -1)).contiguous()
    n11, n12 = kc.ctc_alpha.launches, kc.ctc_beta_post.launches
    alpha, final = kc.ctc_alpha(emit, ilen, llen, allow)
    log_post = kc.ctc_beta_post(emit, alpha, ilen, llen, allow)
    a_ref, f_ref = kc.ctc_alpha_plain(emit, ilen, llen, allow)
    p_ref = kc.ctc_beta_post_plain(emit, alpha, ilen, llen, allow)
    torch.cuda.synchronize()
    assert (kc.ctc_alpha.launches, kc.ctc_beta_post.launches) == \
        (n11 + 1, n12 + 1)
    _ctc_close(alpha, a_ref)
    _ctc_close(final, f_ref)
    _ctc_close(log_post, p_ref)
    loss = kc.zero_infinity_loss(kc.final_ll(final, llen))
    ref = torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), labels, ilen, llen, blank=blank,
        reduction="none", zero_infinity=True)
    torch.testing.assert_close(loss, ref, rtol=1e-4, atol=1e-3)


def _ctc_lattice(g, B, T, L, V=40):
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    lp, ilen, labels, llen, blank = _ctc_inputs(g, B, T, V, L)
    ext, allow = kc.lattice(labels, blank, V)
    emit = lp.gather(2, ext[:, None].expand(-1, T, -1)).contiguous()
    return emit, ilen, llen, allow


def _ctc_run(emit, ilen, llen, allow):
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    alpha, final = kc.ctc_alpha(emit, ilen, llen, allow)
    return alpha, final, kc.ctc_beta_post(emit, alpha, ilen, llen, allow)


def _ctc_check(emit, ilen, llen, allow):
    """#11 and #12 within rtol 1e-5 + atol 1e-4 of their plain versions,
    and a second launch equal bit for bit; returns the outputs. A launch on
    other emissions goes first, so that shared memory holds other values
    and a chunk read before it has landed cannot pass."""
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    _ctc_run(emit - 1, ilen, llen, allow)
    outs = _ctc_run(emit, ilen, llen, allow)
    a_ref, f_ref = kc.ctc_alpha_plain(emit, ilen, llen, allow)
    p_ref = kc.ctc_beta_post_plain(emit, outs[0], ilen, llen, allow)
    for out, ref in zip(outs, (a_ref, f_ref, p_ref)):
        _ctc_close(out, ref)
    for x, y in zip(outs, _ctc_run(emit, ilen, llen, allow)):
        assert torch.equal(x, y)
    return outs


@pytest.mark.parametrize("T", [1, 61])
@pytest.mark.parametrize("L", [15, 16, 31, 32, 35, 100, 511])
def test_ctc_kernels_at_lane_and_warp_edges(gen, L, T):
    """S = 31, 33, 63, 65, 71, 201, 1023: one lane's positions, one warp's
    and several warps' edges; one step and a T no chunk divides."""
    _ctc_check(*_ctc_lattice(gen, 5, T, L))


@pytest.mark.parametrize("steps", ["one", "below_a_chunk", "chunks_and_some"])
@pytest.mark.parametrize("L", [10, 35, 100])
def test_ctc_kernels_over_the_chunk_ring(gen, L, steps):
    """T = 1, T one step short of a chunk, and 2 Tc + 3 (a partial last
    chunk), at the lattices the plan stages in chunks of different Tc."""
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    Tc = kc.ctc_plan(2 * L + 1, 10 ** 4).Tc
    T = {"one": 1, "below_a_chunk": max(Tc - 1, 1),
         "chunks_and_some": 2 * Tc + 3}[steps]
    _ctc_check(*_ctc_lattice(gen, 5, T, L))


@pytest.mark.parametrize("L", [10, 35, 100])
def test_ctc_kernels_end_rows_at_chunk_edges(gen, L):
    """Rows whose last step (ilen - 1) is the first or the last step of a
    chunk, the first step of all, or one past a chunk's first step."""
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    Tc = kc.ctc_plan(2 * L + 1, 10 ** 4).Tc
    T = 3 * Tc + 5
    emit, ilen, llen, allow = _ctc_lattice(gen, 8, T, L)
    ends = [Tc + 1, 2 * Tc, Tc, 1, 2 * Tc + 1, Tc + 2, T, 3 * Tc]
    ilen.copy_(torch.tensor([min(e, T) for e in ends], dtype=torch.int32))
    _ctc_check(emit, ilen, llen, allow)


@pytest.mark.parametrize("Tc", [1, 2, 3])
@pytest.mark.parametrize("L", [10, 35, 100, 511])
def test_ctc_kernels_with_a_chunk_of_few_steps(gen, L, Tc, monkeypatch):
    """The plan's route with a chunk of Tc steps, 4 times with the L2 cache
    flushed and other values left in shared memory: each step then reads a
    chunk staged one to three steps before from device memory, so a read
    of the ring before its copy has landed shows."""
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    plan = kc.ctc_plan
    monkeypatch.setattr(kc, "ctc_plan", lambda S, T: kc.plan_for(
        S, T, plan(S, T).K, plan(S, T).halo, Tc))
    emit, ilen, llen, allow = _ctc_lattice(gen, 5, 61, L)
    want = _ctc_check(emit, ilen, llen, allow)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(4):
        kc.ctc_alpha(emit - 1, ilen, llen, allow)
        flush.add_(1)
        alpha, final = kc.ctc_alpha(emit, ilen, llen, allow)
        flush.add_(1)
        log_post = kc.ctc_beta_post(emit, want[0], ilen, llen, allow)
        for x, y in zip((alpha, final, log_post), want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("L", [10, 100])
def test_ctc_kernels_with_more_rows_than_sms(gen, L):
    _ctc_check(*_ctc_lattice(gen, 200, 97, L))


@pytest.mark.parametrize("L", [15, 35, 100, 511])
def test_ctc_kernels_every_route_gives_the_same_bits(gen, L, monkeypatch):
    """Each route that covers the lattice (K positions a lane; the halo
    lanes a warp, which set the warps and the steps between exchanges),
    forced in turn, equals the plan's own route bit for bit, ilen - 1 on
    and off an exchange step."""
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    emit, ilen, llen, allow = _ctc_lattice(gen, 8, 45, L)
    ilen[5:] = torch.tensor([44, 43, 42], dtype=torch.int32)
    want = _ctc_check(emit, ilen, llen, allow)
    S = emit.shape[2]
    for K, H in kc.ctc_routes(S):
        monkeypatch.setattr(kc, "ctc_plan",
                            lambda S, T, K=K, H=H: kc.plan_for(S, T, K, H))
        for x, y in zip(_ctc_run(emit, ilen, llen, allow), want):
            assert torch.equal(x, y), (K, H)


def test_ctc_losses_on_the_card_equal_the_cpu(gen):
    """`ctc_loss` and `ctc_loss_from_hidden` (#11 forward, #12 backward on
    the card) against the same functions on the CPU (plain versions), loss
    and gradients, with a T the time chunk does not divide."""
    from mtasr_tpu_torch.ops.ctc import ctc_loss
    from mtasr_tpu_torch.ops.ctc_fused import ctc_loss_from_hidden
    B, T, D, V, L = 5, 77, 32, 500, 6
    lp, ilen, labels, llen, blank = _ctc_inputs(gen, B, T, V, L)
    hs = torch.randn((B, T, D), generator=gen, device="cuda")
    w = torch.randn((V, D), generator=gen, device="cuda") * 0.2
    b = torch.randn((V,), generator=gen, device="cuda") * 0.1
    outs = {}
    for dev in ("cuda", "cpu"):
        x = lp.detach().to(dev).requires_grad_(True)
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (hs, w, b)]
        args = [t.to(dev) for t in (ilen, labels, llen)]
        l1 = ctc_loss(x, *args, blank)
        l2 = ctc_loss_from_hidden(*leaves, *args, blank, time_chunk=32)
        (l1.sum() + l2.sum()).backward()
        outs[dev] = [l1, l2, x.grad] + [t.grad for t in leaves]
    # within 1e-4 of each tensor's largest |value|: dW's blank row sums
    # 385 frames' terms of both signs, where another order moves an element
    # by 0.2 % of itself (measured on one H100)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        want = want.detach()
        torch.testing.assert_close(got.detach().cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


def test_ctc_wrappers_refuse(gen):
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    emit = torch.zeros((2, 5, 1025), device="cuda")
    allow = torch.zeros((2, 1025), dtype=torch.bool, device="cuda")
    lens = torch.full((2,), 5, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="S = 1025"):
        kc.ctc_alpha(emit, lens, lens, allow)
    emit, allow = emit[:, :, :7], allow[:, :7]
    with pytest.raises(ValueError, match="contiguous"):
        kc.ctc_alpha(emit, lens, lens, allow)
    with pytest.raises(TypeError, match="float32"):
        kc.ctc_alpha(emit.contiguous().double(), lens, lens,
                     allow.contiguous())
    with pytest.raises(TypeError, match="int32"):
        kc.ctc_alpha(emit.contiguous(), lens.long(), lens,
                     allow.contiguous())


# ---------------------------------------------------------------------------
# model directories and checkpoints on the card (full widths, 2 + 2 layers)
# ---------------------------------------------------------------------------
def _two_layer_model(seed=0, train=False):
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.train.lora import init_decoder_lora
    from mtasr_tpu_torch.utils.convert import init_random
    cfg, tok = full_width.config(num_hidden_layers=2, mask_time_prob=0.0)
    cfg.decoder.num_hidden_layers = 2
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    model = init_random(cfg, g, "cuda", torch.bfloat16)
    if train:
        init_decoder_lora(model, g, r=16, alpha=32.0)
    return cfg, tok, model


def _wav_batch(B=4, seconds=3):
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    wav = torch.randn((B, 16000 * seconds), generator=g, device="cuda")
    amask = torch.ones_like(wav, dtype=torch.int32)
    amask[-1, 16000 * seconds // 2:] = 0
    return wav, amask


def test_from_pretrained_on_the_card_serves_the_in_memory_tokens(
        gen, tmp_path):
    """save_model -> Transcriber.from_pretrained (the card by default): the
    same bf16 parameters, the same greedy tokens, through the kernels."""
    from mtasr_tpu_torch.api import Transcriber
    from mtasr_tpu_torch.generate.engine import generate
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.utils import model_io
    cfg, tok, model = _two_layer_model()
    model_io.save_model(str(tmp_path), cfg, model)
    tr = Transcriber.from_pretrained(str(tmp_path))
    assert next(tr.model.parameters()).device.type == "cuda"
    for k, v in model.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    wav, amask = _wav_batch()
    ref = generate(model, cfg, wav, amask, max_new_tokens=24).sequences
    kernels.reset_launch_counts()
    got = generate(tr.model, tr.cfg, wav, amask, max_new_tokens=24).sequences
    counts = kernels.launch_counts()
    assert torch.equal(got, ref)
    assert counts["conv0_fused"] == 1 and counts["decode_attention"] > 0


def test_streamed_int8_load_peak_memory(gen, tmp_path):
    """The streamed w8a8 load never holds the bf16 decoder on the card:
    its peak stays inside its final footprint plus the largest tensor of
    the file; its int8 weights equal quantize_for_serving's."""
    from mtasr_tpu_torch.utils import model_io
    from mtasr_tpu_torch.utils.quantize import quantize_for_serving
    cfg, tok, model = _two_layer_model()
    model_io.save_model(str(tmp_path), cfg, model)
    largest = max(v.numel() * v.element_size()
                  for v in model.state_dict().values())
    quantize_for_serving(model, "w8a8")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, q = model_io.load_model_quantized(str(tmp_path), "w8a8")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    final = torch.cuda.memory_allocated() - base
    print(f"streamed peak {peak} final {final} largest {largest}")
    assert peak <= final + largest
    for k, v in model.state_dict().items():
        assert torch.equal(q.state_dict()[k], v), k


def test_resume_with_kernels_equals_the_uninterrupted_run(gen, tmp_path,
                                                          monkeypatch):
    """Trainer on the card through #1-#3 and #8-#10, dropout on: 2 steps,
    save, a fresh trainer resumed to 4 steps gives the bits of 4 steps
    straight, parameters and AdamW moments, on deterministic algorithms."""
    from mtasr_tpu_torch.config import DataConfig, TrainingConfig
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.train.loop import Trainer
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    batches = [full_width.train_batch(_two_layer_model()[0], 2, 2, seed=s)
               for s in range(4)]

    def trainer(out):
        cfg, _, model = _two_layer_model(train=True)
        tc = TrainingConfig(output_dir=str(out), learning_rate=1e-4,
                            warmup_steps=1, max_steps=4, save_steps=2,
                            logging_steps=1, pcgrad=False, seed=5)
        return Trainer(cfg, tc, DataConfig(), model.train(),
                       freeze_kwargs=dict(freeze_decoder=True))

    with _deterministic():
        kernels.reset_launch_counts()
        a = trainer(tmp_path / "a")
        a.train(lambda epoch: batches)
        assert kernels.launch_counts()["flash_attention_bwd_dkv"] == 2 * 4
        b = trainer(tmp_path / "b")
        b.train(lambda epoch: batches, max_steps=2)
        c = trainer(tmp_path / "b")
        assert c.maybe_resume() and c.state.step == 2
        c.train(lambda epoch: batches)
    for k, v in a.model.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k
    oa, oc = a.optimizer.state_dict(), c.optimizer.state_dict()
    for slot in ("mu", "nu"):
        for k, v in oa[slot].items():
            assert torch.equal(oc[slot][k], v), (slot, k)


# ---------------------------------------------------------------------------
# the bridge and adapter family on the card (full widths, 2 + 2 layers)
# ---------------------------------------------------------------------------
def _family_model(leg):
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.utils.convert import init_random
    cfg, _ = full_width.config(family=leg, num_hidden_layers=2,
                               mask_time_prob=0.0)
    cfg.decoder.num_hidden_layers = 2
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return cfg, init_random(cfg, g, "cuda", torch.bfloat16)


@pytest.mark.parametrize("leg", ["A", "B", "C"])
def test_family_kept_memory_kv_gives_the_same_logits(gen, leg):
    """Greedy decoding of a `full_width.FAMILY` configuration through the
    kernels, from one encoding: the adapters' memory keys and values kept
    from the prefill give the same logits, bit for bit, as computing them
    at every step; and a second encoding is bit-equal to the first (the
    memories are built deterministically)."""
    from unittest import mock

    from mtasr_tpu_torch.config import GenerationConfig
    from mtasr_tpu_torch.generate import engine
    from mtasr_tpu_torch.models.speech_encoder_decoder import (
        adapter_callback,
    )
    from mtasr_tpu_torch.ops import kernels
    cfg, model = _family_model(leg)
    wav, amask = _wav_batch()
    gcfg = GenerationConfig(do_sample=False)
    with torch.inference_mode():
        enc = engine.encode_maybe_chunked(model, cfg, wav, amask, None)
        again = engine.encode_maybe_chunked(model, cfg, wav, amask, None)
        for f in ("encoder_hidden_states", "encoder_attention_mask",
                  "acoustic_mem", "acoustic_pad_mask"):
            assert torch.equal(getattr(enc, f), getattr(again, f)), f
        ids, splice = engine.prompt_layout(cfg, wav.shape[0], None, "cuda")
        S_max = ids.shape[1] + enc.encoder_hidden_states.shape[1] + 12
        runs = []
        kernels.reset_launch_counts()
        for keep in (True, False):
            cb = adapter_callback(model, cfg, enc, keep_kv=keep)
            cache, last, n_valid, total = engine._prefill(
                model, cfg, enc, ids, splice, S_max, False, cb)
            seen = [last.clone()]

            def sample(logits, g, generator, seen=seen):
                seen.append(logits.clone())
                return logits.argmax(-1)
            with mock.patch.object(engine, "_sample_token", sample):
                engine._decode(model, cfg, cache, last, n_valid,
                               ids.shape[1], total, torch.bfloat16, gcfg, 12,
                               None, cb)
            runs.append(seen)
    assert kernels.launch_counts()["decode_attention"] > 0
    assert len(runs[0]) == len(runs[1]) > 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_family_token_memory_on_the_card_equals_the_cpu(gen):
    """`ctc_token_builder` and `build_multi_ctc_prefix` on crafted paths:
    the card's segment sums (one-hot products into the Lmax + 1 buckets)
    against the CPU's within float32 rounding, the masks and ids equal."""
    from mtasr_tpu_torch.models import bridges
    from mtasr_tpu_torch.models.ctc_head import CTCHead
    V = 8
    head = CTCHead(V, V)
    with torch.no_grad():
        head.ctc_lo.weight.copy_(torch.eye(V) * 10)
        head.ctc_lo.bias.zero_()
    paths = torch.randint(0, V, (2, 5, 300), generator=torch.Generator()
                          .manual_seed(0))
    paths[:, 1] = V - 1                      # an all-blank row
    sep = [torch.eye(V)[p] + 0.05 * torch.randn(p.shape + (V,),
           generator=torch.Generator().manual_seed(k))
           for k, p in enumerate(paths)]
    valid = torch.arange(300)[None] < torch.tensor([300, 300, 200, 9, 1])[
        :, None]
    cpu = bridges.ctc_token_builder(sep, valid, [head, head], V - 1, 64)
    hc = head.cuda()
    card = bridges.ctc_token_builder([s.cuda() for s in sep], valid.cuda(),
                                     [hc, hc], V - 1, 64)
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(card[1].cpu(), cpu[1])
    torch.testing.assert_close(card[2].cpu(), cpu[2], rtol=1e-5, atol=1e-6)
    assert bool(cpu[1][1].all()) and not bool(cpu[1][0].any())
    ids = [p[:, ::5] for p in paths]
    table = torch.randn(V, 16)
    got = bridges.build_multi_ctc_prefix([i.cuda() for i in ids],
                                         table.cuda(), V - 1, 40)
    for g, r in zip(got, bridges.build_multi_ctc_prefix(ids, table, V - 1,
                                                        40)):
        assert torch.equal(g.cpu(), r)
