"""The CTC loss computed from hidden states through the head's projection,
never materialising [B, T, V] (counterpart of `mtasr_tpu/ops/ctc_fused.py`).

forward:  time chunks of `time_chunk` frames: logits_c = hs_c W^T + b in
          float32, their logsumexp, and only the [B, Tc, 2L+1] lattice
          emissions kept; then the alpha recursion, kernel #11.
backward: gamma = exp(alpha + beta - logZ) from kernel #12 (the beta
          recursion fused with alpha + beta), then chunk by chunk (the
          chunk's logits recomputed) dL/dlogits = softmax * sum_s gamma -
          gamma scattered onto the vocabulary, contracted at once into
          dL/dhs, dL/dW and dL/db; only one chunk's [B, Tc, V] is alive.

The products are `torch.matmul` in float32 (XLA einsums in the JAX
package). Gradients that no input needs are not computed: the trainer's
per-head pass asks for dhs alone, its total-loss pass for dW and db alone.
At the CTC head's width (V = 128265) a chunk of 128 frames at B = 16 is
about 1 GB of float32 logits.
"""
from __future__ import annotations

import torch

from mtasr_tpu_torch.ops.kernels.ctc import (
    ctc_alpha, final_ll, lattice, lattice_gamma, lengths_i32,
    zero_infinity_loss,
)


def _chunks(T: int, chunk: int):
    return [(t0, min(t0 + chunk, T)) for t0 in range(0, T, chunk)]


def _logits(hc: torch.Tensor, wf: torch.Tensor, bf: torch.Tensor):
    """[B, Tc, D] -> [B*Tc, V] float32 logits."""
    return torch.addmm(bf, hc.reshape(-1, hc.shape[-1]).float(), wf.t())


class CTCFromHiddenFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hs, w, b, input_lengths, labels, label_lengths,
                blank_id, time_chunk):
        B, T, _ = hs.shape
        V = w.shape[0]
        ext, allow = lattice(labels, blank_id, V)
        S = ext.shape[1]
        wf, bf = w.float(), b.float()
        emit = torch.empty((B, T, S), dtype=torch.float32, device=hs.device)
        for t0, t1 in _chunks(T, time_chunk):
            logits = _logits(hs[:, t0:t1], wf, bf).view(B, t1 - t0, V)
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            emit[:, t0:t1] = logits.gather(
                2, ext[:, None, :].expand(-1, t1 - t0, -1)) - lse
            del logits, lse
        alpha, final = ctc_alpha(emit, lengths_i32(input_lengths),
                                 lengths_i32(label_lengths), allow)
        # #11 carries alpha past a row's input length, so its final row is
        # alpha at ilen - 1 (`ctc_fused.py:185-188`)
        ll = final_ll(final, label_lengths)
        ctx.save_for_backward(hs, w, b, input_lengths, label_lengths, ext,
                              allow, emit, alpha, ll)
        ctx.time_chunk = time_chunk
        return zero_infinity_loss(ll)

    @staticmethod
    def backward(ctx, g):
        (hs, w, b, ilen, llen, ext, allow, emit, alpha,
         ll) = ctx.saved_tensors
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        B, T, D = hs.shape
        V = w.shape[0]
        gamma = lattice_gamma(emit, alpha, ll, ilen, llen, allow, g)
        gsum = gamma.sum(2)                                       # [B, T]
        wf, bf = w.float(), b.float()
        dhs = torch.empty((B, T, D), dtype=torch.float32,
                          device=hs.device) if need_h else None
        dw = torch.zeros((V, D), dtype=torch.float32,
                         device=hs.device) if need_w else None
        db = torch.zeros((V,), dtype=torch.float32,
                         device=hs.device) if need_b else None
        for t0, t1 in _chunks(T, ctx.time_chunk):
            n = t1 - t0
            hc = hs[:, t0:t1].reshape(B * n, D).float()
            y = torch.softmax(_logits(hs[:, t0:t1], wf, bf), dim=-1)
            y.mul_(gsum[:, t0:t1].reshape(-1, 1))
            y.view(B, n, V).scatter_add_(
                2, ext[:, None, :].expand(-1, n, -1), -gamma[:, t0:t1])
            if need_h:
                dhs[:, t0:t1] = (y @ wf).view(B, n, D)
            if need_w:
                dw.addmm_(y.t(), hc)
            if need_b:
                db += y.sum(0)
            del y
        return (None if dhs is None else dhs.to(hs.dtype),
                None if dw is None else dw.to(w.dtype),
                None if db is None else db.to(b.dtype),
                None, None, None, None, None)


def ctc_loss_from_hidden(hs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         input_lengths: torch.Tensor, labels: torch.Tensor,
                         label_lengths: torch.Tensor, blank_id: int,
                         time_chunk: int = 128) -> torch.Tensor:
    """Per-sample CTC loss [B] of hs [B, T, D] through the projection
    (w [V, D], b [V]): `ctc_loss(log_softmax(hs W^T + b))` without the
    [B, T, V] logits; differentiable in hs, w and b."""
    return CTCFromHiddenFunction.apply(hs, w, b, input_lengths, labels,
                                       label_lengths, blank_id, time_chunk)
