"""CTC forward-backward over the [T, 2L+1] lattice (counterpart of
`mtasr_tpu/ops/pallas/ctc_kernel.py`), torch.nn.CTCLoss(reduction='none',
zero_infinity=True) semantics.

* `ctc_alpha` (#11) replaces `ctc_loss_pallas_fwd` (call `ctc_kernel.py:206`,
  body `_fwd_kernel :56-84`): the alpha recursion, carried unchanged past a
  row's input length; alpha [B, T, S] and the final row [B, S].
* `ctc_beta_post` (#12) replaces `_vjp_bwd` (call `:271`, body
  `_bwd_kernel :87-148`): the beta recursion fused with alpha + beta, the
  log-posterior [B, T, S].

For CUDA tensors both launch the kernels of `csrc/ctc.cu`: a batch row a
block, a lane on K neighbouring lattice positions, warps with halo lanes
past 32 positions, the emissions staged Tc steps at a time (`ctc_plan`, a
pure function of the lattice); for CPU tensors they take their plain
versions, step-by-step loops of the same f32 arithmetic. `CTCLossFunction`
is the counterpart of the `jax.custom_vjp` at `ctc_kernel.py:229-290`:
forward is the emission gather and #11, backward #12, the combine with
logZ and the scatter back onto the vocabulary; the fused loss from hidden
states (`ops/ctc_fused.py`) runs the same two kernels. Each wrapper counts
its launches in `launches`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from mtasr_tpu_torch.ops.kernels import _build

LOG_EPS = -1e30
MAX_S = 1024          # lattice positions a block's threads can own

_ARGS = [_build.I] + [_build.P] * 7 + [_build.I] * 8 + [_build.P]
_ALPHA, _BETA_POST = 0, 1

TC_MAX = 64                  # steps a staged chunk
RING_BYTES = 200 * 1000      # #12's two chunks of emit and alpha
SMEM_MAX = 232448            # shared memory a block may have on the H100


class CTCPlan(NamedTuple):
    K: int            # neighbouring lattice positions a lane (1 or 2)
    warps: int        # warps a batch row (one block)
    halo: int         # halo lanes a warp when warps > 1 (else 0)
    Tc: int           # steps a staged chunk
    stages: int       # chunks in the ring
    smem_bytes: int   # #12's shared memory (#11 stages emit alone)


def _chunk_floats(rows: int, S: int) -> int:
    return (rows * S + 7) // 4 * 4


def smem_bytes(which: int, S: int, K: int, warps: int, halo: int, Tc: int,
               stages: int) -> int:
    """`csrc/ctc.cu` `smem_bytes`: the staged chunks (#11: Tc rows of emit;
    #12: Tc + 1 rows of emit and Tc of alpha) and, with several warps, the
    halo exchange."""
    ring = _chunk_floats(Tc, S) if which == _ALPHA else \
        _chunk_floats(Tc + 1, S) + _chunk_floats(Tc, S)
    edge = 2 * warps * halo * K + K if warps > 1 else 0
    return 4 * (stages * ring + edge)


def plan_for(S: int, T: int, K: int, halo: int, Tc: int = 0) -> CTCPlan:
    """Route (K positions a lane, `halo` lanes a warp; 0: one warp) for S
    positions: as many warps as the warps' own lanes need, and (unless Tc
    is given) the most steps a chunk, up to TC_MAX, whose two chunks of
    #12's emit and alpha fit RING_BYTES; two chunks in the ring unless T
    fits one."""
    warps = 1 if halo == 0 else -(-S // ((32 - halo) * K))
    Tc = Tc or max(1, min(TC_MAX, RING_BYTES // (2 * 2 * 4 * S)))
    stages = 1 if T <= Tc else 2
    return CTCPlan(K, warps, halo, Tc, stages,
                   smem_bytes(_BETA_POST, S, K, warps, halo, Tc, stages))


def ctc_routes(S: int) -> List[Tuple[int, int]]:
    """Every (K, halo) the kernels take for S positions: one warp of one
    position a lane up to S = 32; past that K = 1 or 2 on more than one
    warp, with an even number of halo positions and at most 32 warps."""
    if S <= 32:
        return [(1, 0)]
    return [(K, H) for K in (1, 2) for H in (2, 4, 8, 16)
            if 32 * K < S and H * K % 2 == 0
            and -(-S // ((32 - H) * K)) <= 32]


def ctc_plan(S: int, T: int) -> CTCPlan:
    """The route the kernels take for S lattice positions and T steps: one
    warp, one position a lane, up to S = 32; past that one position a lane
    up to S = 300 and two beyond (on the H100, one is faster at S = 201,
    two at 401 and past), on the halo (2, 4, 8 or 16 lanes) that needs the
    fewest warps on each of an SM's four schedulers, and of those the
    widest (the fewest exchanges)."""
    if not 1 <= S <= MAX_S:
        raise ValueError(f"S = {S} (1..{MAX_S})")
    if S <= 32:
        return plan_for(S, T, 1, 0)
    K = 1 if S <= 300 else 2

    def per_scheduler(H):
        return -(-plan_for(S, T, K, H).warps // 4)
    halo = min((H for k, H in ctc_routes(S) if k == K),
               key=lambda H: (per_scheduler(H), -H))
    return plan_for(S, T, K, halo)


def build():
    """The library of #11 and #12, built from csrc/ctc.cu if needed."""
    return _build.load("ctc", "ctc_launch", _ARGS)


# ---------------------------------------------------------------------------
# the lattice
# ---------------------------------------------------------------------------
def interleave_blanks(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, L] -> [B, 2L+1] = (blank, y1, blank, y2, ..., yL, blank)."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank_id, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def lattice(labels: torch.Tensor, blank_id: int, V: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ext [B, S] int64, allow [B, S] bool): the extended label sequence
    (labels clipped into [0, V)) and where the s-2 -> s skip is allowed
    (onto a non-blank that differs from the label two positions back)."""
    ext = interleave_blanks(labels.long().clamp(0, V - 1), blank_id)
    prev2 = torch.full_like(ext, blank_id)
    prev2[:, 2:] = ext[:, :-2]
    s = torch.arange(ext.shape[1], device=ext.device)
    allow = (ext != blank_id) & (ext != prev2) & (s >= 2)[None]
    return ext, allow


def _valid(label_lengths: torch.Tensor, S: int) -> torch.Tensor:
    s = torch.arange(S, device=label_lengths.device)
    return s[None] < (2 * label_lengths.long()[:, None] + 1)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m = m.clamp_min(LOG_EPS)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                        + torch.exp(c - m))
    return out.clamp_min(LOG_EPS)


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """Shift along the last axis by n (> 0: right, < 0: left), LOG_EPS in."""
    out = torch.full_like(x, LOG_EPS)
    if n > 0:
        out[..., n:] = x[..., :-n]
    else:
        out[..., :n] = x[..., -n:]
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def ctc_alpha_plain(emit: torch.Tensor, input_lengths: torch.Tensor,
                    label_lengths: torch.Tensor, allow: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The alpha recursion step by step in plain PyTorch, #11's arithmetic:
    (alpha [B, T, S], final row [B, S])."""
    B, T, S = emit.shape
    valid = _valid(label_lengths, S)
    ilen = input_lengths.long()[:, None]
    s = torch.arange(S, device=emit.device)[None]
    a = torch.where((s < 2) & valid, emit[:, 0], LOG_EPS).clamp_min(LOG_EPS)
    rows = [a]
    for t in range(1, T):
        from2 = torch.where(allow, _shift(a, 2), LOG_EPS)
        new = _lse3(a, _shift(a, 1), from2) + emit[:, t]
        new = torch.where(valid, new, LOG_EPS).clamp_min(LOG_EPS)
        a = torch.where(t < ilen, new, a)
        rows.append(a)
    return torch.stack(rows, 1), a


def ctc_beta_post_plain(emit: torch.Tensor, alpha: torch.Tensor,
                        input_lengths: torch.Tensor,
                        label_lengths: torch.Tensor,
                        allow: torch.Tensor) -> torch.Tensor:
    """The beta recursion fused with alpha + beta, step by step in plain
    PyTorch, #12's arithmetic: the log-posterior [B, T, S]."""
    B, T, S = emit.shape
    valid = _valid(label_lengths, S)
    ilen = input_lengths.long()[:, None]
    last = 2 * label_lengths.long()[:, None]
    s = torch.arange(S, device=emit.device)[None]
    beta_T = torch.where((s == last) | (s == (last - 1).clamp_min(0)), 0.0,
                         LOG_EPS)
    beta_T = torch.where(valid, beta_T, LOG_EPS)
    allow2 = _shift(allow.float(), -2) > 0
    beta = beta_T
    out = [None] * T
    for t in range(T - 1, -1, -1):
        active = t < ilen
        term = (beta + emit[:, min(t + 1, T - 1)]).clamp_min(LOG_EPS)
        step = _lse3(term, _shift(term, -1),
                     torch.where(allow2, _shift(term, -2), LOG_EPS))
        step = torch.where(valid, step, LOG_EPS)
        new = torch.where(active & (t < ilen - 1), step, beta)
        at_end = active & (t == ilen - 1)
        g = (alpha[:, t] + torch.where(at_end, beta_T, new)).clamp_min(
            LOG_EPS)
        out[t] = torch.where(valid & active, g, LOG_EPS)
        beta = torch.where(at_end, beta_T, new)
    return torch.stack(out, 1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(name, emit, input_lengths, label_lengths, allow, alpha=None):
    if emit.dim() != 3:
        raise ValueError(f"{name}: emit [B, T, S] expected")
    B, T, S = emit.shape
    if tuple(allow.shape) != (B, S) or allow.dtype != torch.bool:
        raise ValueError(f"{name}: allow must be bool [{B}, {S}]")
    for what, t in (("input_lengths", input_lengths),
                    ("label_lengths", label_lengths)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name}: {what} must be [{B}]")
    if alpha is not None and alpha.shape != emit.shape:
        raise ValueError(f"{name}: alpha {tuple(alpha.shape)} != emit "
                         f"{tuple(emit.shape)}")
    if emit.device.type == "cpu":
        return False
    _build.require_cuda(emit, name)
    if T < 1 or not 1 <= S <= MAX_S:
        raise ValueError(f"{name}: T = {T} (>= 1), S = {S} (1..{MAX_S})")
    tensors = (("emit", emit), ("allow", allow),
               ("input_lengths", input_lengths),
               ("label_lengths", label_lengths)) + \
        ((("alpha", alpha),) if alpha is not None else ())
    for what, t in tensors:
        if t.device != emit.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on "
                             f"{emit.device}")
    if emit.dtype != torch.float32 or (alpha is not None
                                       and alpha.dtype != torch.float32):
        raise TypeError(f"{name}: emit and alpha must be float32")
    if input_lengths.dtype != torch.int32 or \
            label_lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32")
    return True


def _launch(which, name, emit, alpha_in, allow, ilen, llen, out, final):
    B, T, S = emit.shape
    plan = ctc_plan(S, T)
    lib = build()
    with torch.cuda.device(emit.device):
        code = lib.ctc_launch(
            which, emit.data_ptr(),
            None if alpha_in is None else alpha_in.data_ptr(),
            allow.data_ptr(), ilen.data_ptr(), llen.data_ptr(),
            out.data_ptr(), None if final is None else final.data_ptr(),
            B, T, S, plan.K, plan.warps, plan.halo, plan.Tc, plan.stages,
            _build.stream_of(emit))
    _build.check(lib, code, name)


def ctc_alpha(emit: torch.Tensor, input_lengths: torch.Tensor,
              label_lengths: torch.Tensor, allow: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #11: (alpha [B, T, S], final row [B, S]) from the lattice
    emissions emit [B, T, S] (log-probs at the extended labels).

    On CUDA: emit f32, lengths int32, allow bool, all contiguous; S <= 1024."""
    if not _check("ctc_alpha", emit, input_lengths, label_lengths, allow):
        return ctc_alpha_plain(emit, input_lengths, label_lengths, allow)
    alpha = torch.empty_like(emit)
    final = torch.empty_like(emit[:, 0])
    _launch(_ALPHA, "ctc_alpha", emit, None, allow, input_lengths,
            label_lengths, alpha, final)
    ctc_alpha.launches += 1
    return alpha, final


def ctc_beta_post(emit: torch.Tensor, alpha: torch.Tensor,
                  input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                  allow: torch.Tensor) -> torch.Tensor:
    """Kernel #12: the log-posterior max(alpha + beta, LOG_EPS) [B, T, S]
    (LOG_EPS at invalid positions and at t >= input length). Takes what
    #11 takes, and #11's alpha."""
    if not _check("ctc_beta_post", emit, input_lengths, label_lengths,
                  allow, alpha):
        return ctc_beta_post_plain(emit, alpha, input_lengths, label_lengths,
                                   allow)
    log_post = torch.empty_like(emit)
    _launch(_BETA_POST, "ctc_beta_post", emit, alpha, allow, input_lengths,
            label_lengths, log_post, None)
    ctc_beta_post.launches += 1
    return log_post


ctc_alpha.launches = 0
ctc_beta_post.launches = 0


# ---------------------------------------------------------------------------
# around the kernels: the loss and its gradient on the lattice
# ---------------------------------------------------------------------------
def lengths_i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def final_ll(final_row: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """log p(labels) [B] from the final alpha row: the logsumexp of its last
    blank and last label state (`ctc_kernel.py:216-222`)."""
    last = 2 * label_lengths.long()[:, None]
    a_last = final_row.gather(1, last.clamp(max=final_row.shape[1] - 1))[:, 0]
    a_prev = final_row.gather(1, (last - 1).clamp(
        0, final_row.shape[1] - 1))[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, LOG_EPS)
    m = torch.maximum(a_last, a_prev)
    return m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m))


def zero_infinity_loss(ll: torch.Tensor) -> torch.Tensor:
    """-ll, with 0 for an impossible alignment (`zero_infinity`)."""
    loss = -ll
    loss = torch.where(loss >= -0.5 * LOG_EPS, 0.0, loss)
    return torch.where(torch.isfinite(loss), loss, 0.0)


def lattice_gamma(emit, alpha, ll, input_lengths, label_lengths, allow,
                  g) -> torch.Tensor:
    """The posterior occupancy gamma [B, T, S] scaled by each row's
    cotangent g [B], through #12: exp(clip(log_post - logZ, LOG_EPS, 0)),
    zero at invalid positions, at t >= input length and for rows whose
    alignment is impossible (`ctc_fused.py:210-219`)."""
    log_post = ctc_beta_post(emit, alpha, lengths_i32(input_lengths),
                             lengths_i32(label_lengths), allow)
    B, T, S = emit.shape
    safe = ll > LOG_EPS * 0.5
    logz = torch.where(safe, ll, 0.0)
    gamma = torch.exp((log_post - logz[:, None, None]).clamp(LOG_EPS, 0.0))
    t = torch.arange(T, device=emit.device)[None]
    frame_ok = (t < input_lengths.long()[:, None]) & safe[:, None]
    keep = frame_ok[:, :, None] & _valid(label_lengths, S)[:, None, :]
    return torch.where(keep, gamma, 0.0) * g.float()[:, None, None]


class CTCLossFunction(torch.autograd.Function):
    """Per-sample CTC loss [B] from log_probs [B, T, V]: forward the
    emission gather and #11; backward #12, the combine with logZ and the
    scatter onto the vocabulary."""

    @staticmethod
    def forward(ctx, log_probs, input_lengths, labels, label_lengths,
                blank_id):
        V = log_probs.shape[2]
        ext, allow = lattice(labels, blank_id, V)
        emit = log_probs.float().gather(
            2, ext[:, None, :].expand(-1, log_probs.shape[1], -1)
        ).contiguous()
        alpha, final = ctc_alpha(emit, lengths_i32(input_lengths),
                                 lengths_i32(label_lengths), allow)
        ll = final_ll(final, label_lengths)
        ctx.save_for_backward(emit, alpha, ll, ext, allow, input_lengths,
                              label_lengths)
        ctx.shape, ctx.dtype = log_probs.shape, log_probs.dtype
        return zero_infinity_loss(ll)

    @staticmethod
    def backward(ctx, g):
        emit, alpha, ll, ext, allow, ilen, llen = ctx.saved_tensors
        gamma = lattice_gamma(emit, alpha, ll, ilen, llen, allow, g)
        B, T, V = ctx.shape
        grad = torch.zeros((B, T, V), dtype=torch.float32, device=g.device)
        grad.scatter_add_(2, ext[:, None, :].expand(-1, T, -1), -gamma)
        return grad.to(ctx.dtype), None, None, None, None


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood [B] (reduction 'none',
    zero_infinity) of log_probs [B, T, V], differentiable in log_probs."""
    return CTCLossFunction.apply(log_probs, input_lengths, labels,
                                 label_lengths, blank_id)
