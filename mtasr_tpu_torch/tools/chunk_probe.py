"""Device times of the int8 chunk kernel (#7) beside the bf16 one (#5) on
the same shapes: LLaMA-3.2-1B's 32 q / 8 kv heads of 64, a chunk of L
positions at the end of an S-slot cache under a causal mask (the last
batch row padded from S / 2), for each L, S and batch. Each call is
captured 20 times in one CUDA graph (`timing.graph_ms`). #7's K / V are
#5's draws quantized by the decoder's own KV quantizer; beside its time
stand its bound (the bytes it must move at 3.35 TB/s), its largest error
against its plain version, the query rows whose error passes 1 bf16 ulp
at the largest |plain| (rows that took an int8 step of p) and whether a
second launch gives the same bits. With `--routes`, #7 is also timed
with its scores recomputed by each pass where its plan keeps them in
registers.
It uses the public wrappers alone, so it also times an older tree's
kernels: run it with that tree's package first on `sys.path`.

    python -m mtasr_tpu_torch.tools.chunk_probe [--ptxas] [--routes] \\
        [--L 8 16] [--seq 158 1000 20000] [--batch 8 64]

Prints one JSON line; needs a CUDA device."""
from __future__ import annotations

import argparse
import json
import math

import torch

from mtasr_tpu_torch.models.llama import _quantize_kv
from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
from mtasr_tpu_torch.tools.timing import graph_ms

HBM_BYTES_S = 3.35e12      # the H100 SXM's published HBM rate


def chunk_inputs(g, B, L, S, Hq=32, Hkv=8, D=64):
    """(q, bf16 k / v, int8 k / v, kv_scale, mask) of a chunk of L
    positions at the end of an S-slot cache."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    q, kc, vc = randn(B, L, Hq, D), randn(B, S, Hkv * D), randn(B, S,
                                                              Hkv * D)
    mask = torch.ones((B, L, S), dtype=torch.bool, device="cuda")
    for pos in range(L):
        mask[:, pos, max(S - L + pos + 1, 1):] = False
    mask[-1, :, S // 2:S - L] = False
    k8, ks = _quantize_kv(kc.view(B, S, Hkv, D))
    v8, vs = _quantize_kv(vc.view(B, S, Hkv, D))
    kvs = torch.stack([ks, vs], -1).reshape(B, S, 2 * Hkv) \
        .transpose(1, 2).contiguous()
    return q, kc, vc, k8.reshape(kc.shape), v8.reshape(vc.shape), kvs, mask


def int8_row(q, k8, v8, kvs, mask, routes: bool) -> dict:
    ref, sp = dc.int8_cache_attention(q, k8, v8, kvs, mask)
    ref = ref.to(torch.bfloat16).float()
    ulp = 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)

    def run():
        return dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
    out = run()
    err = (out.float() - ref).abs().amax(-1)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (q, k8, v8, kvs, mask, q))
    row = {"graph_ms": graph_ms(run), "bound_ms": 1e3 * n_bytes / HBM_BYTES_S,
           "max_abs_err": float(err.max()), "p_step": 127 * float(sp.max()),
           "rows_over_ulp": int((err > ulp).sum()), "rows": err.numel(),
           "same_bits_again": torch.equal(run(), out)}
    plan_of = getattr(dc, "chunk_int8_plan", None)
    if plan_of is not None:
        B, L, Hq, D = q.shape
        plan = plan_of(L, k8.shape[1], D, Hq * D // k8.shape[2])
        row["plan"] = plan._asdict()
        if routes and plan.scores_resident:
            dc.chunk_int8_plan = lambda *a: plan._replace(scores_resident=0)
            try:
                row["recomputed_graph_ms"] = graph_ms(run)
                row["recomputed_same_bits"] = torch.equal(run(), out)
            finally:
                dc.chunk_int8_plan = plan_of
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="registers and spills of the chunk library first")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--L", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--seq", type=int, nargs="+", default=[158, 1000, 20000])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.ptxas:
        from mtasr_tpu_torch.tools.flash_bwd_probe import ptxas_report
        print(ptxas_report("decode_attention_chunk"), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "tree": dc.__file__}
    for B in args.batch:
        for S in args.seq:
            for L in args.L:
                q, kc, vc, k8, v8, kvs, mask = chunk_inputs(g, B, L, S)
                row = int8_row(q, k8, v8, kvs, mask, args.routes)
                row["bf16_graph_ms"] = graph_ms(
                    lambda: dc.decode_attention_chunk(q, kc, vc, mask))
                out[f"B{B}_S{S}_L{L}"] = row
                del q, kc, vc, k8, v8, kvs, mask
                torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
