"""Flash attention with the WavLM gated relative-position bias, forward and
backward (counterpart of `mtasr_tpu/ops/pallas/flash_attention.py`).

`flash_attention` is the entry point. For CUDA tensors it launches the
kernels of `csrc/flash_attention.cu` (forward) and
`csrc/flash_attention_bwd.cu` (backward); for CPU tensors it takes their
plain versions. When no input requires a gradient it runs the forward
alone. Otherwise it runs `FlashAttentionFunction`: the forward also writes
the logsumexp (lse) of every query row, and the backward recomputes the
probabilities from it and launches three kernels:

* `flash_attention_bwd_dq` (#8) replaces `_bwd_dq_kernel` (call
  `flash_attention.py:640`): dq, and dg, the gradient of the per-query gate;
* `flash_attention_bwd_dkv` (#9) replaces `_bwd_dkv_kernel` (`:664`): dk
  and dv for each q head, in bf16 without GQA, else in f32 with the group
  summed here afterwards (`:673-674`);
* `flash_attention_bwd_dpb` (#10) replaces `_bwd_dpb_kernel` (`:711`):
  dpb, the gradient of the shared [H, T, S] rel-pos table, summed over the
  batch.

Every kernel reads the table through its strides, so WavLM's row-padded
copy (`padded_bias`) reaches the backward as it is.

The forward kernel replaces `_flash_forward_1s` (`:266`) and
`_flash_forward` (`:349`). Each .cu file's note says what bounds its
kernels on the H100 and how the design answers that. Each kernel wrapper
counts its launches in `launches`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mtasr_tpu_torch.ops.attention import dot_product_attention
from mtasr_tpu_torch.ops.kernels import _build

NEG_INF = -1e30   # the lse of a row with no valid key, as in the JAX kernels

_ARGS = [_build.P] * 8 + [_build.I] * 6 + [_build.F, _build.I] + \
    [ctypes.c_longlong] * 2 + [_build.P]
_BWD_ARGS = [_build.I] + [_build.P] * 11 + [_build.I] * 6 + \
    [_build.F, _build.I] + [ctypes.c_longlong] * 2 + [_build.P]
_DQ, _DKV, _DPB = 0, 1, 2        # the backward library's kernel switch


def build():
    """The forward kernel's library, built from csrc/flash_attention.cu."""
    return _build.load("flash_attention", "flash_attention_launch", _ARGS)


def build_bwd():
    """The library of the three backward kernels, built from
    csrc/flash_attention_bwd.cu."""
    return _build.load("flash_attention_bwd", "flash_attention_bwd_launch",
                       _BWD_ARGS)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_lens: Optional[torch.Tensor] = None,
                          pos_bias: Optional[torch.Tensor] = None,
                          gate: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: the gated bias [B, H, T, S] is
    materialised, keys at or past kv_lens are masked and their V rows
    zeroed, as in the TPU kernels, so a row with kv_len 0 gives 0."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    bias = None
    if pos_bias is not None:
        if gate is None:
            gate = torch.ones((B, Hq, T), dtype=q.dtype, device=q.device)
        bias = gate[..., None].float() * pos_bias[None].float()
    mask = None
    if kv_lens is not None:
        valid = _key_valid(kv_lens, B, S, q.device)
        v = v.masked_fill(~valid[:, :, None, None], 0)
        mask = valid[:, None, None, :]
    return dot_product_attention(q, k, v, bias=bias, mask=mask, scale=scale)


def _key_valid(kv_lens, B: int, S: int, device) -> torch.Tensor:
    j = torch.arange(S, device=device)
    if kv_lens is None:
        return torch.ones((B, S), dtype=torch.bool, device=device)
    return j[None, :] < kv_lens.to(device)[:, None]                 # [B, S]


def _scores_plain(q, k, kv_lens, pos_bias, gate, scale):
    """f32 scores [B, Hq, T, S] with the gated bias, K rows past kv_len
    zeroed, GQA by head index; and the key validity [B, S]."""
    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    valid = _key_valid(kv_lens, B, S, q.device)
    kf = k.float().masked_fill(~valid[:, :, None, None], 0)
    kf = kf.repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * scale
    if pos_bias is not None:
        s = s + gate.float()[..., None] * pos_bias.float()[None]
    return s, valid


def flash_attention_lse_plain(q, k, kv_lens=None, pos_bias=None, gate=None,
                              scale=None) -> torch.Tensor:
    """The logsumexp of every query row over its valid keys, [B*Hq, T]
    f32, NEG_INF for a row with none (what the forward kernel writes)."""
    B, T, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if pos_bias is not None and gate is None:
        gate = torch.ones((B, Hq, T), dtype=q.dtype, device=q.device)
    s, valid = _scores_plain(q, k, kv_lens, pos_bias, gate, scale)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(valid.any(-1)[:, None, None], lse,
                      torch.full_like(lse, NEG_INF))
    return lse.reshape(B * Hq, T)


def flash_attention_bwd_plain(q, k, v, kv_lens, pos_bias, gate, out, lse,
                              dout, *, scale: Optional[float] = None,
                              delta: Optional[torch.Tensor] = None):
    """(dq, dk, dv, dpb, dg) in plain PyTorch, as the TPU kernels compute
    them: p = exp(s - lse) recomputed and masked (`_recompute_p`),
    ds = p * (dO V^T - delta) with delta = sum(dO * out) over D, ds and p
    rounded to the input dtype before the products, every sum in f32, each
    gradient cast to its input's dtype. dpb and dg are None without a
    bias. lse [B*Hq, T]; delta, if given, [B, Hq, T] f32."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    has_bias = pos_bias is not None
    if has_bias and gate is None:
        gate = torch.ones((B, Hq, T), dtype=q.dtype, device=q.device)
    s, valid = _scores_plain(q, k, kv_lens, pos_bias, gate, scale)
    vmask = valid[:, None, None, :]
    p = torch.where(vmask, torch.exp(s - lse.reshape(B, Hq, T, 1)),
                    torch.zeros((), device=q.device))
    vf = v.float().masked_fill(~valid[:, :, None, None], 0)
    vf = vf.repeat_interleave(G, dim=2)
    kf = k.float().masked_fill(~valid[:, :, None, None], 0)
    kf = kf.repeat_interleave(G, dim=2)
    dof = dout.float()
    if delta is None:
        delta = (dof * out.float()).sum(-1).transpose(1, 2)          # [B,Hq,T]
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None])
    dt = q.dtype
    dsr = ds.to(dt).float()
    dq = torch.einsum("bhts,bshd->bthd", dsr, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", dsr, q.float()) * scale
    dv = torch.einsum("bhts,bthd->bshd", p.to(dt).float(), dof)
    dk = dk.reshape(B, S, Hkv, G, D).sum(3)
    dv = dv.reshape(B, S, Hkv, G, D).sum(3)
    dpb = dg = None
    if has_bias:
        dpb = (gate.float()[..., None] * ds).sum(0).to(pos_bias.dtype)
        pb = torch.where(vmask, pos_bias.float()[None],
                         torch.zeros((), device=q.device))
        dg = (ds * pb).sum(-1).to(gate.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dpb, dg


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _tma_rows(pos_bias: torch.Tensor) -> bool:
    """Rows and heads of the table a multiple of 8 elements (16 bytes)
    apart, columns contiguous: what the kernels' TMA reads."""
    return (pos_bias.stride(2) == 1 and pos_bias.stride(1) % 8 == 0
            and pos_bias.stride(0) % 8 == 0)


def padded_bias(pos_bias: torch.Tensor) -> torch.Tensor:
    """The [H, T, S] rel-pos table as the kernels read it: the same values
    (and autograd graph) as a view of storage whose rows are padded to a
    multiple of 8 elements, since TMA needs 16-byte strides and a row of
    S = 499 bf16 is 998 bytes. A table already so laid out is returned as
    it is. WavLM builds its table this way once a forward, so that its 24
    layers share it, forward and backward; the wrappers pad any other table
    at each call."""
    if _tma_rows(pos_bias):
        return pos_bias
    S = pos_bias.shape[-1]
    if S % 8 == 0:
        return pos_bias.contiguous()
    return F.pad(pos_bias, (0, -S % 8))[..., :S]


def _check(q, k, v, kv_lens, pos_bias, gate):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q [B, T, Hq, D] and k, v "
                         "[B, S, Hkv, D] expected")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if pos_bias is not None and tuple(pos_bias.shape) != (Hq, T, S):
        raise ValueError(f"flash_attention: pos_bias must be {(Hq, T, S)}")
    if gate is not None and tuple(gate.shape) != (B, Hq, T):
        raise ValueError(f"flash_attention: gate must be {(B, Hq, T)}")
    if kv_lens is not None and tuple(kv_lens.shape) != (B,):
        raise ValueError(f"flash_attention: kv_lens must be [{B}]")


def _check_cuda(what, q, named, f32=(), strided=()):
    """bf16 (f32 for the names in `f32`), on q's device, contiguous (for the
    names in `strided`, rows 16 bytes apart: `_tma_rows`); q, k, v and the
    like 16-byte aligned for the kernels' vector and TMA loads."""
    _build.require_cuda(q, what)
    D = q.shape[-1]
    if D > 128 or D % 8:
        raise ValueError(f"{what}: head dim {D} (a multiple of 8, at most "
                         "128)")
    for name, t in named:
        want = torch.float32 if name in f32 else torch.bfloat16
        if t.dtype != want or t.device != q.device:
            raise TypeError(f"{what}: {name} must be {want} on {q.device}, "
                            f"got {t.dtype} on {t.device}")
        if not (_tma_rows(t) if name in strided else t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous")
        if (t.dim() == 4 or name in strided) and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _lens(kv_lens, B, S, device):
    if kv_lens is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return kv_lens.to(device=device, dtype=torch.int32).contiguous()


def _forward(q, k, v, kv_lens, pos_bias, gate, scale, with_lse
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, lse or None) from the forward kernel, or on the CPU from the
    plain versions."""
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, kv_lens=kv_lens,
                                    pos_bias=pos_bias, gate=gate, scale=scale)
        lse = (flash_attention_lse_plain(q, k, kv_lens, pos_bias, gate, scale)
               if with_lse else None)
        return out, lse
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    named = [("q", q), ("k", k), ("v", v)]
    has_bias = pos_bias is not None
    if has_bias:
        pos_bias = padded_bias(pos_bias)
        named += [("pos_bias", pos_bias), ("gate", gate)]
    _check_cuda("flash_attention", q, named, strided=("pos_bias",))
    lens = _lens(kv_lens, B, S, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((B * Hq, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = build()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pos_bias.data_ptr() if has_bias else None,
            gate.data_ptr() if has_bias else None, lens.data_ptr(),
            out.data_ptr(), lse.data_ptr() if with_lse else None,
            B, T, S, Hq, Hkv, D, float(scale), int(has_bias),
            pos_bias.stride(1) if has_bias else 0,
            pos_bias.stride(0) if has_bias else 0, _build.stream_of(q))
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _bwd_launch(which, what, q, k, v, kv_lens, pos_bias, gate, lse, delta,
                dout, out_a, out_b, scale):
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    named = [("q", q), ("k", k), ("v", v), ("dout", dout), ("lse", lse),
             ("delta", delta)]
    has_bias = pos_bias is not None
    if has_bias:
        pos_bias = padded_bias(pos_bias)
        named += [("pos_bias", pos_bias), ("gate", gate)]
    _check_cuda(what, q, named, f32=("lse", "delta"), strided=("pos_bias",))
    if tuple(lse.shape) != (B * Hq, T) or tuple(delta.shape) != (B, Hq, T):
        raise ValueError(f"{what}: lse must be {(B * Hq, T)} and delta "
                         f"{(B, Hq, T)}")
    lens = _lens(kv_lens, B, S, q.device)
    lib = build_bwd()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_launch(
            which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pos_bias.data_ptr() if has_bias else None,
            gate.data_ptr() if has_bias else None, lens.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
            out_a.data_ptr(), None if out_b is None else out_b.data_ptr(),
            B, T, S, Hq, Hkv, D, float(scale), int(has_bias),
            pos_bias.stride(1) if has_bias else 0,
            pos_bias.stride(0) if has_bias else 0, _build.stream_of(q))
    _build.check(lib, code, what)


def _delta(dout, out):
    """sum(dO * out) over D in f32, [B, Hq, T] (an XLA op in JAX too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_prologue(q, pos_bias, gate, scale):
    B, T, Hq, D = q.shape
    if pos_bias is not None and gate is None:
        gate = torch.ones((B, Hq, T), dtype=q.dtype, device=q.device)
    return gate, D ** -0.5 if scale is None else scale


def flash_attention_bwd_dq(q, k, v, kv_lens, pos_bias, gate, out, lse, dout,
                           *, scale=None, delta=None):
    """Kernel #8: (dq, dg); dg is None without a bias."""
    gate, scale = _bwd_prologue(q, pos_bias, gate, scale)
    if q.device.type == "cpu":
        dq, _, _, _, dg = flash_attention_bwd_plain(
            q, k, v, kv_lens, pos_bias, gate, out, lse, dout, scale=scale,
            delta=delta)
        return dq, dg
    delta = _delta(dout, out) if delta is None else delta
    B, T, Hq, _ = q.shape
    dq = torch.empty_like(q)
    dg = (torch.empty((B, Hq, T), dtype=q.dtype, device=q.device)
          if pos_bias is not None else None)
    _bwd_launch(_DQ, "flash_attention_bwd_dq", q, k, v, kv_lens, pos_bias,
                gate, lse, delta, dout, dq, dg, scale)
    flash_attention_bwd_dq.launches += 1
    return dq, dg


def flash_attention_bwd_dkv(q, k, v, kv_lens, pos_bias, gate, out, lse, dout,
                            *, scale=None, delta=None):
    """Kernel #9: (dk, dv). Without GQA the kernel writes them in bf16;
    with a group it writes each q head's f32 dk / dv, and the group is
    summed and cast here, as the JAX package does."""
    gate, scale = _bwd_prologue(q, pos_bias, gate, scale)
    if q.device.type == "cpu":
        _, dk, dv, _, _ = flash_attention_bwd_plain(
            q, k, v, kv_lens, pos_bias, gate, out, lse, dout, scale=scale,
            delta=delta)
        return dk, dv
    delta = _delta(dout, out) if delta is None else delta
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dt = k.dtype if Hq == Hkv else torch.float32
    dk_h = torch.empty((B, S, Hq, D), dtype=dt, device=q.device)
    dv_h = torch.empty_like(dk_h)
    _bwd_launch(_DKV, "flash_attention_bwd_dkv", q, k, v, kv_lens, pos_bias,
                gate, lse, delta, dout, dk_h, dv_h, scale)
    flash_attention_bwd_dkv.launches += 1
    if Hq == Hkv:
        return dk_h, dv_h
    dk_h = dk_h.reshape(B, S, Hkv, Hq // Hkv, D).sum(3)
    dv_h = dv_h.reshape(B, S, Hkv, Hq // Hkv, D).sum(3)
    return dk_h.to(k.dtype), dv_h.to(v.dtype)


def flash_attention_bwd_dpb(q, k, v, kv_lens, pos_bias, gate, out, lse, dout,
                            *, scale=None, delta=None):
    """Kernel #10: dpb [Hq, T, S] (contiguous), summed over the batch in
    batch order."""
    gate, scale = _bwd_prologue(q, pos_bias, gate, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, kv_lens, pos_bias, gate, out, lse, dout, scale=scale,
            delta=delta)[3]
    delta = _delta(dout, out) if delta is None else delta
    dpb = torch.empty(pos_bias.shape, dtype=pos_bias.dtype,
                      device=pos_bias.device)
    _bwd_launch(_DPB, "flash_attention_bwd_dpb", q, k, v, kv_lens, pos_bias,
                gate, lse, delta, dout, dpb, None, scale)
    flash_attention_bwd_dpb.launches += 1
    return dpb


def flash_attention_bwd(q, k, v, kv_lens, pos_bias, gate, out, lse, dout, *,
                        scale=None):
    """(dq, dk, dv, dpb, dg): #8 and #9, and #10 with a bias (the plain
    version for CPU tensors)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_lens, pos_bias, gate,
                                         out, lse, dout, scale=scale)
    delta = _delta(dout, out)
    kw = dict(scale=scale, delta=delta)
    if pos_bias is not None:       # a table of odd S padded once, not thrice
        pos_bias = padded_bias(pos_bias)
    args = (q, k, v, kv_lens, pos_bias, gate, out, lse, dout)
    dq, dg = flash_attention_bwd_dq(*args, **kw)
    dk, dv = flash_attention_bwd_dkv(*args, **kw)
    dpb = flash_attention_bwd_dpb(*args, **kw) if pos_bias is not None \
        else None
    return dq, dk, dv, dpb, dg


class FlashAttentionFunction(torch.autograd.Function):
    """Forward kernel with lse; backward kernels #8-#10 (`jax.custom_vjp`
    at `flash_attention.py:725-757`). kv_lens gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, pos_bias, gate, kv_lens, scale):
        out, lse = _forward(q, k, v, kv_lens, pos_bias, gate, scale, True)
        ctx.save_for_backward(q, k, v, pos_bias, gate, kv_lens, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pos_bias, gate, kv_lens, out, lse = ctx.saved_tensors
        dq, dk, dv, dpb, dg = flash_attention_bwd(
            q, k, v, kv_lens, pos_bias, gate, out, lse, dout.contiguous(),
            scale=ctx.scale)
        return dq, dk, dv, dpb, dg, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_lens: Optional[torch.Tensor] = None,
                    pos_bias: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, T, Hq, D], k/v [B, S, Hkv, D]; pos_bias [Hq, T, S] with
    gate [B, Hq, T] adds gate[b,h,i] * pos_bias[h,i,j] to the scores;
    kv_lens [B] masks keys at or past it. Returns [B, T, Hq, D].
    Differentiable in q, k, v, pos_bias and gate.

    On CUDA: q, k, v, pos_bias and gate bf16 and contiguous (pos_bias may
    instead be `padded_bias`'s row-padded view), D % 8 == 0, D <= 128."""
    _check(q, k, v, kv_lens, pos_bias, gate)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if pos_bias is not None and gate is None:
        gate = torch.ones((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=q.dtype, device=q.device)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, pos_bias, gate))
    if not grad:
        return _forward(q, k, v, kv_lens, pos_bias, gate, scale, False)[0]
    return FlashAttentionFunction.apply(q, k, v, pos_bias, gate, kv_lens,
                                        float(scale))


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dpb.launches = 0
