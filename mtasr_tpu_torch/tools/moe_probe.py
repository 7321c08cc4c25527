"""Device times of the routed experts' grouped kernel (`moe_experts`,
`csrc/moe_experts.cu`) at Moonlight-16B-A3B's widths (H 2048, I 1408, 64
experts, top 6) and the two shapes the served cell runs: a decode step
of B 256 (1536 pairs, about 24 an expert) and its prefill (16384 tokens,
about 1536 pairs an expert), routed by random scores. Beside the kernel
(20 calls captured in one CUDA graph, `timing.graph_ms`): its bound (each
expert's weights once, each pair's input and output row, at 3.35 TB/s;
or its operations at the bf16 peak) and share; the plain loop over
experts (`moe_experts_plain`, host-timed: it reads the offsets);
PyTorch's `torch._grouped_mm` computing the same SwiGLU over the sorted
rows (its time in a graph too, or why it has none); each one's largest
difference from the plain loop.

    python -m mtasr_tpu_torch.tools.moe_probe [--tokens 256 16384]

Prints one JSON line; needs a CUDA device."""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from mtasr_tpu_torch.models import moe
from mtasr_tpu_torch.ops.kernels import moe_experts as mk
from mtasr_tpu_torch.tools.timing import cuda_ms, graph_ms

HBM_BYTES_S = 3.35e12
BF16_PEAK = 989e12


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, nargs="+", default=[256, 16384])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    H, I, E, k = 2048, 1408, 64, 6
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).bfloat16()
    w_gu = randn(E * 2 * I, H, scale=H ** -0.5)
    w_d = randn(E * H, I, scale=I ** -0.5)
    out = {"device": torch.cuda.get_device_name(0), "H": H, "I": I, "E": E,
           "k": k, "shapes": []}
    for T in args.tokens:
        x = randn(T, H)
        top = torch.topk(torch.rand((T, E), generator=g, device="cuda"), k,
                         dim=-1).indices
        _, rows, offsets, counts = moe.dispatch(top, E)
        P = T * k
        n_bytes = E * 3 * H * I * 2 + 2 * P * H * 2
        n_ops = 2 * P * 3 * H * I
        bound = max(n_bytes / HBM_BYTES_S, n_ops / BF16_PEAK) * 1e3
        ref = mk.moe_experts_plain(x, rows, offsets, w_gu, w_d).float()
        got = mk.moe_experts(x, rows, offsets, counts, w_gu, w_d).float()
        t_graph = graph_ms(lambda: mk.moe_experts(x, rows, offsets, counts,
                                                   w_gu, w_d))
        rec = {"tokens": T, "pairs": P, "graph_ms": t_graph,
               "bound_ms": bound,
               "bound_by": "bytes" if n_bytes / HBM_BYTES_S
               >= n_ops / BF16_PEAK else "operations",
               "share": bound / t_graph,
               "max_err": float((got - ref).abs().max()),
               "max_ref": float(ref.abs().max()),
               "plain_ms": cuda_ms(lambda: mk.moe_experts_plain(
                   x, rows, offsets, w_gu, w_d), iters=3, repeats=3)}
        xs = x[rows.long()]
        b_gu = w_gu.reshape(E, 2 * I, H).transpose(1, 2)
        b_d = w_d.reshape(E, H, I).transpose(1, 2)
        ends = offsets[1:].contiguous()

        def library():
            gu = torch._grouped_mm(xs, b_gu, offs=ends)
            h = F.silu(gu[:, :I]) * gu[:, I:]
            return torch._grouped_mm(h, b_d, offs=ends)
        try:
            lib = library().float()
            rec["library_max_err"] = float((lib - ref).abs().max())
            rec["library_ms"] = cuda_ms(library)
            rec["library_graph_ms"] = graph_ms(library)
        except (RuntimeError, TypeError) as e:   # reported, not hidden
            rec["library_error"] = str(e).splitlines()[0][:300]
        out["shapes"].append(rec)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
