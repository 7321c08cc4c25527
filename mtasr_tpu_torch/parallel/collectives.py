"""The tensor-parallel region operators (Megatron's four), as autograd
Functions over a process group, and the reductions the trainer needs.

* `copy_to_tp`: identity forward, all-reduce backward: a replicated
  activation or parameter entering a sharded region (its gradient is the
  sum of every shard's);
* `reduce_from_tp`: all-reduce forward, identity backward: the partial
  products of a row-parallel linear;
* `gather_from_tp`: all-gather forward along `dim`, own slice backward:
  a column-parallel output made whole (the vocab-parallel head's logits);
* `scatter_to_tp`: own slice forward, all-gather backward.

Everything is built on `all_reduce` and `broadcast` alone: those are the
collectives gloo takes on CUDA tensors as well as on CPU ones, so two
ranks can share one card over gloo. An all-gather is an all-reduce of a
zero-filled buffer into which each rank writes its slice (exact: x + 0).
Floating tensors travel and are summed in float32 and are rounded once to
their own dtype after the sum (a row-parallel product's partial sums are
then added as a single-process bf16 GEMM accumulates them, and gloo's
bf16 support does not matter). A `group` of None, or of one rank, makes
every operator the identity: the single-process path runs no collective.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class CollectiveClock:
    """Wall seconds spent in the collectives while `on` (each one is
    bracketed by device synchronisations, which the caller pays for: a
    measurement switch, off by default)."""
    on = False
    seconds = 0.0
    calls = 0

    @classmethod
    def run(cls, fn, t: torch.Tensor, **kw) -> None:
        if not cls.on:
            fn(t, **kw)
            return
        import time
        cuda = t.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        fn(t, **kw)
        if cuda:
            torch.cuda.synchronize(t.device)
        cls.seconds += time.perf_counter() - t0
        cls.calls += 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` (a new tensor; floating dtypes summed in float32
    and rounded once to x's dtype)."""
    if group_size(group) == 1:
        return x
    wide = x.is_floating_point() and x.dtype != torch.float64
    buf = x.detach().to(torch.float32 if wide else x.dtype, copy=True)
    CollectiveClock.run(dist.all_reduce, buf, group=group)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' x (equal shapes) concatenated along `dim`, in group rank
    order, by an all-reduce of a zero-filled buffer."""
    n = group_size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    wide = x.is_floating_point() and x.dtype != torch.float64
    buf = torch.zeros(shape, dtype=torch.float32 if wide else x.dtype,
                      device=x.device)
    w = x.shape[dim]
    buf.narrow(dim, group_rank(group) * w, w).copy_(x.detach())
    CollectiveClock.run(dist.all_reduce, buf, group=group)
    return buf.to(x.dtype)


def broadcast(x: torch.Tensor, group, src_group_rank: int = 0
              ) -> torch.Tensor:
    """Group rank `src_group_rank`'s x on every rank of `group`."""
    if group_size(group) == 1:
        return x
    buf = x.detach().clone().contiguous()
    CollectiveClock.run(dist.broadcast, buf, group=group,
                        src=dist.get_global_rank(group, src_group_rank))
    return buf


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    w = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * w, w).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Copy.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Reduce.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim % x.dim())


def scatter_to_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Scatter.apply(x, group, dim % x.dim())


# ---------------------------------------------------------------------------
# data-parallel reductions of the trainer
# ---------------------------------------------------------------------------
_DP_GROUP: List[Optional[object]] = [None]


class dp_reduction:
    """Within the block, the losses divide by counts summed over the
    data-parallel `group` (`global_count`): a rank's loss is its local sum
    over the global denominator, so summing the ranks' gradients gives the
    gradient of the global batch's loss."""

    def __init__(self, group):
        self.group = group

    def __enter__(self):
        self.prev = _DP_GROUP[0]
        _DP_GROUP[0] = self.group
        return self

    def __exit__(self, *exc):
        _DP_GROUP[0] = self.prev
        return False


def dp_active() -> bool:
    """Whether a `dp_reduction` over more than one rank is open."""
    return group_size(_DP_GROUP[0]) > 1


def global_count(n: torch.Tensor) -> torch.Tensor:
    """`n` summed over the active data-parallel group (no gradient)."""
    group = _DP_GROUP[0]
    if group_size(group) == 1:
        return n
    return all_reduce(n.detach(), group)


def global_batch(b: int) -> int:
    """The local batch size `b` summed over the active data-parallel
    group."""
    group = _DP_GROUP[0]
    if group_size(group) == 1:
        return b
    t = torch.tensor([b], dtype=torch.int64)
    if dist.get_backend(group) == "nccl":
        t = t.cuda()
    return int(all_reduce(t, group).item())


def batch_mean(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x's mean over its batch `dim`: over the global batch within a
    `dp_reduction` (this rank's sum over the global row count), else
    `x.mean(dim)`."""
    if group_size(_DP_GROUP[0]) == 1:
        return x.mean(dim)
    # the Scalar overload keeps no tensor for its backward, so PCGrad can
    # pull each head's row of the result back separately (as `mean`'s)
    return torch.ops.aten.div.Scalar(x.sum(dim),
                                     float(global_batch(x.shape[dim])))


def sum_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each gradient summed over `group` (the data-parallel sum), flattened
    into one float32 buffer so the group runs one all-reduce."""
    grads = list(grads)
    if group_size(group) == 1 or not grads:
        return grads
    flat = torch.cat([g.detach().float().reshape(-1) for g in grads])
    CollectiveClock.run(dist.all_reduce, flat, group=group)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return out


def tp_dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
           sharded: Sequence[bool], group) -> torch.Tensor:
    """sum_i <a_i, b_i> (float32) over the whole parameters: the sharded
    terms summed over `group`, the replicated ones counted once."""
    zero = torch.zeros((), dtype=torch.float32,
                       device=a[0].device if len(a) else "cpu")
    rep, sh = zero, zero
    for x, y, s in zip(a, b, sharded):
        d = (x.float() * y.float()).sum()
        if s:
            sh = sh + d
        else:
            rep = rep + d
    if group_size(group) > 1:
        sh = all_reduce(sh, group)
    return rep + sh
