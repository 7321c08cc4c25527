"""Device times of the decode kernel (#4) at the served decode shape
(LLaMA-3.2-1B: 32 q / 8 kv heads of 64, S = 214, the last row masked past
150) for each batch and each cluster size forced in turn, beside SDPA's on
the same inputs (`enable_gqa`, the bool mask), each call captured 20 times
in one CUDA graph (`timing.graph_ms`); the chooser's own size is marked.

    python -m mtasr_tpu_torch.tools.decode_probe [--batch 8 64] \\
        [--clusters 1 2 3 4 8]

Prints one JSON line; needs a CUDA device."""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from mtasr_tpu_torch.ops.kernels import decode_attention as da
from mtasr_tpu_torch.tools.timing import graph_ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--clusters", type=int, nargs="+",
                    default=[1, 2, 3, 4, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    Hq, Hkv, D, S = 32, 8, 64, 214
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chooser = da.cluster_size
    out = {"device": torch.cuda.get_device_name(0), "S": S, "sms": sms}
    for B in args.batch:
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").bfloat16()
        q, kc, vc = randn(B, Hq, D), randn(B, S, Hkv * D), randn(B, S,
                                                                  Hkv * D)
        mask = torch.ones((B, S), dtype=torch.bool, device="cuda")
        mask[-1, 150:] = False
        ref = da.decode_attention_plain(q, kc, vc, mask).float()
        kh, vh = (t.view(B, S, Hkv, D).transpose(1, 2) for t in (kc, vc))
        row = {"chosen": chooser(B, Hkv, S, sms, D),
               "sdpa_graph_ms": graph_ms(
                   lambda: F.scaled_dot_product_attention(
                       q[:, :, None], kh, vh, attn_mask=mask[:, None, None],
                       enable_gqa=True))}
        for C in args.clusters:
            da.cluster_size = lambda *a, C=C, **k: C   # noqa: E731
            try:
                err = float((da.decode_attention(q, kc, vc, mask).float()
                             - ref).abs().max())
                row[f"C{C}"] = {"graph_ms": graph_ms(
                    lambda: da.decode_attention(q, kc, vc, mask)),
                    "max_abs_err": err}
            finally:
                da.cluster_size = chooser
        out[f"B{B}"] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
