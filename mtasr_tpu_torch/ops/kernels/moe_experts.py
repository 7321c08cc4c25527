"""The routed experts' SwiGLU over (token, expert) pairs sorted by expert:
a grouped product, `csrc/moe_experts.cu`. It replaces no TPU kernel: the
JAX package has no experts. It was added for DeepSeek-V3's mixture of
experts (`models/moe.py`), where a plain loop over experts needs each
expert's row count on the host (a sync, so no replayed step) and a dense
"every expert for every token" form does E / k times the work.

`moe_experts` launches the kernel for CUDA tensors and takes
`moe_experts_plain` (a loop over experts) for CPU tensors. Two launches of
the library: `mtasr_moe_gate_up_kernel` computes h = silu(x W_g^T) *
(x W_u^T) for each sorted pair's token, `mtasr_moe_down_kernel` y = h W_d^T;
the .cu file's note says what bounds them and how the design answers it.
The grid is sized for the worst case of the routing (every expert's last
row tile partly full), and a block past the last real tile returns, so
the host never reads the offsets."""
from __future__ import annotations

import torch

from mtasr_tpu_torch.ops.kernels import _build

_ARGS = [_build.P] * 8 + [_build.I] * 5 + [_build.P]
BM = 64          # pair rows a block (`kBM`)
BN_GATE_UP = 64  # intermediate columns a gate / up block (`kBNGateUp`)
BN_DOWN = 128    # output columns a down block (`kBNDown`)
BK = 64          # reduction depth a stage (`kBK`)


def build():
    """The kernel's library, built from csrc/moe_experts.cu if needed."""
    return _build.load("moe_experts", "moe_experts_launch", _ARGS)


def max_tiles(pairs: int, n_experts: int) -> int:
    """Row tiles of BM the grid covers: sum over experts of ceil(n_e / BM)
    is at most pairs / BM + E, whatever the routing."""
    return -(-pairs // BM) + n_experts


def moe_experts_plain(x: torch.Tensor, rows: torch.Tensor,
                      offsets: torch.Tensor, w_gate_up: torch.Tensor,
                      w_down: torch.Tensor) -> torch.Tensor:
    """The same function as a loop over experts (reads the offsets on the
    host): each expert's SwiGLU in x's dtype, as `llama._mlp` computes
    one (each product rounded to the dtype, silu and the product too)."""
    P, H = rows.shape[0], x.shape[1]
    E = offsets.shape[0] - 1
    I = w_down.shape[1]
    wgu = w_gate_up.reshape(E, 2 * I, H).to(x.dtype)
    wd = w_down.reshape(E, H, I).to(x.dtype)
    y = torch.zeros((P, H), dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(E):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        xe = x[rows[a:b].long()]
        g = xe @ wgu[e, :I].t()
        u = xe @ wgu[e, I:].t()
        y[a:b] = (torch.nn.functional.silu(g) * u) @ wd[e].t()
    return y


def moe_experts(x: torch.Tensor, rows: torch.Tensor, offsets: torch.Tensor,
                counts: torch.Tensor, w_gate_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """x [T, H] the tokens' normed hidden states; rows [P] int32 the token
    of each pair, sorted by expert; offsets [E + 1] int32 each expert's
    first sorted pair (offsets[E] = P); counts [E] int32 each expert's
    pairs (offsets[1:] - offsets[:-1], as `moe.dispatch` gives them);
    w_gate_up [E * 2I, H] (an expert's I gate rows, then its I up rows);
    w_down [E * H, I]. Returns y [P, H] in x's dtype, row p the expert's
    output for pair p's token.

    On CUDA: bf16 and contiguous; H % 64 == 0, I % 64 == 0, H % 128 == 0;
    no gradient (the kernel has no backward)."""
    T, H = x.shape
    P, E1 = rows.shape[0], offsets.shape[0]
    E = E1 - 1
    if w_gate_up.dim() != 2 or w_gate_up.shape[1] != H or \
            w_gate_up.shape[0] % (2 * E):
        raise ValueError(f"moe_experts: w_gate_up {tuple(w_gate_up.shape)} "
                         f"is not [E * 2I, {H}] for E = {E}")
    I = w_gate_up.shape[0] // (2 * E)
    if tuple(w_down.shape) != (E * H, I):
        raise ValueError(f"moe_experts: w_down {tuple(w_down.shape)} is not "
                         f"[{E * H}, {I}]")
    if {rows.dtype, offsets.dtype, counts.dtype} != {torch.int32} or \
            counts.shape != (E,):
        raise TypeError("moe_experts: rows, offsets and counts [E] must be "
                        "int32")
    if x.device.type == "cpu":
        return moe_experts_plain(x, rows, offsets, w_gate_up, w_down)
    _build.require_cuda(x, "moe_experts")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_gate_up, w_down)):
        raise NotImplementedError("moe_experts: the grouped kernel has no "
                                  "backward (serving only)")
    if H % BK or H % BN_DOWN or I % BK or I % BN_GATE_UP:
        raise ValueError(f"moe_experts: H = {H} and I = {I} must be "
                         f"multiples of {BN_DOWN} and {BK}")
    for name, t in (("x", x), ("rows", rows), ("offsets", offsets),
                    ("counts", counts), ("w_gate_up", w_gate_up),
                    ("w_down", w_down)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"moe_experts: {name} must be contiguous on "
                             f"{x.device}")
    if {x.dtype, w_gate_up.dtype, w_down.dtype} != {torch.bfloat16}:
        raise TypeError("moe_experts: x and the weights must be bf16")
    h = torch.empty((P, I), dtype=x.dtype, device=x.device)
    y = torch.empty((P, H), dtype=x.dtype, device=x.device)
    # each expert's first row tile, and the tiles in all at [E]: the grid's
    # blocks find their expert in it on the device
    tiles = torch.zeros(E1, dtype=torch.int32, device=x.device)
    tiles[1:] = torch.cumsum(torch.div(counts + (BM - 1), BM,
                                       rounding_mode="floor"), 0,
                             dtype=torch.int32)
    lib = build()
    with torch.cuda.device(x.device):
        code = lib.moe_experts_launch(
            x.data_ptr(), rows.data_ptr(), offsets.data_ptr(),
            tiles.data_ptr(), w_gate_up.data_ptr(), w_down.data_ptr(),
            h.data_ptr(), y.data_ptr(), P, H, I, E, max_tiles(P, E),
            _build.stream_of(x))
    _build.check(lib, code, "moe_experts")
    moe_experts.launches += 1
    return y


moe_experts.launches = 0
