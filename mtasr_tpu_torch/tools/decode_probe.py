"""Device times of the decode kernel (#4), or with `--int8` of the int8
decode kernel (#6), at the served decode shape (LLaMA-3.2-1B: 32 q / 8 kv
heads of 64, S = 214 or `--seq`, the last row masked past 150) for each
batch and each cluster size forced in turn, each call captured 20 times
in one CUDA graph (`timing.graph_ms`); the chooser's own size is marked.
#4 stands beside SDPA's time on the same inputs (`enable_gqa`, the bool
mask); #6 has no PyTorch call that computes its function, and its K / V
are the same draws quantized by the decoder's own KV quantizer. Beside each size's time:
its largest error against the plain version, the query rows whose error
passes 1 bf16 ulp at the largest |plain| (the int8 kernel's rows that took
an int8 step of p), and whether its output equals C = 1's bit for bit.

    python -m mtasr_tpu_torch.tools.decode_probe [--int8] [--batch 8 64] \\
        [--clusters 1 2 3 4 8] [--seq 214]

Prints one JSON line; needs a CUDA device."""
from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from mtasr_tpu_torch.models.llama import _quantize_kv
from mtasr_tpu_torch.ops.kernels import decode_attention as da
from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
from mtasr_tpu_torch.tools.timing import graph_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--int8", action="store_true",
                    help="the int8 decode kernel (#6) instead of #4")
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--clusters", type=int, nargs="+",
                    default=[1, 2, 3, 4, 8])
    ap.add_argument("--seq", type=int, default=214,
                    help="cache slots S (the served decode: 214)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    Hq, Hkv, D, S = 32, 8, 64, args.seq
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mod, chooser_name = (di, "cluster_size_int8") if args.int8 else \
        (da, "cluster_size")
    chooser = getattr(mod, chooser_name)
    out = {"device": torch.cuda.get_device_name(0),
           "kernel": "decode_attention_int8" if args.int8
           else "decode_attention", "S": S, "sms": sms}
    for B in args.batch:
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").bfloat16()
        q, kc, vc = randn(B, Hq, D), randn(B, S, Hkv * D), randn(B, S,
                                                                  Hkv * D)
        mask = torch.ones((B, S), dtype=torch.bool, device="cuda")
        mask[-1, min(150, S - 1):] = False
        row = {"chosen": chooser(B, Hkv, S, sms, D)}
        if args.int8:
            k8, ks = _quantize_kv(kc.view(B, S, Hkv, D))
            v8, vs = _quantize_kv(vc.view(B, S, Hkv, D))
            kvs = torch.stack([ks, vs], -1).reshape(B, S, 2 * Hkv) \
                .transpose(1, 2).contiguous()
            k8, v8 = k8.reshape(kc.shape), v8.reshape(vc.shape)
            ref, sp = di.int8_cache_attention(q[:, None], k8, v8, kvs,
                                              mask[:, None])
            ref = ref[:, 0].to(torch.bfloat16)
            row["p_step"] = 127 * float(sp.max())

            def run():
                return di.decode_attention_int8(q, k8, v8, kvs, mask)
        else:
            ref = da.decode_attention_plain(q, kc, vc, mask).float()
            kh, vh = (t.view(B, S, Hkv, D).transpose(1, 2) for t in (kc, vc))
            row["sdpa_graph_ms"] = graph_ms(
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kh, vh, attn_mask=mask[:, None, None],
                    enable_gqa=True))

            def run():
                return da.decode_attention(q, kc, vc, mask)
        ref = ref.float()
        ulp = 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)
        one = None
        for C in [1] + args.clusters:
            setattr(mod, chooser_name, lambda *a, C=C, **k: C)
            try:
                o = run()
                if one is None:
                    one = o
                    continue
                err = (o.float() - ref).abs().amax(-1)
                row[f"C{C}"] = {"graph_ms": graph_ms(run),
                                "max_abs_err": float(err.max()),
                                "rows_over_ulp": int((err > ulp).sum()),
                                "rows": err.numel(),
                                "same_bits_as_C1": torch.equal(o, one)}
            finally:
                setattr(mod, chooser_name, chooser)
        out[f"B{B}"] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
