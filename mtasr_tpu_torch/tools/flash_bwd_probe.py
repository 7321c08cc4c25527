"""Device times of the flash backward kernels #8-#10 at the attention-mode
training shape (B = 16, T = S = 499, 16 heads of 64, one row of 300 keys,
WavLM's row-padded table), with and without the gated bias, each call
captured 20 times in one CUDA graph (`timing.graph_ms`); the bias row's
difference is what the bias costs each kernel (for #9, whose thread reads
the swizzled bias tile transposed, and for #8, which reads it as the
forward does). With `--ptxas`, first the registers, shared memory and
spills of every kernel of `csrc/flash_attention_bwd.cu`,
`csrc/decode_attention.cu`, `csrc/decode_attention_int8.cu` and
`csrc/conv_frontend.cu` as `nvcc -Xptxas -v` reports them.

    python -m mtasr_tpu_torch.tools.flash_bwd_probe [--ptxas]

Prints one JSON line; needs a CUDA device."""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile

import torch

from mtasr_tpu_torch.ops.kernels import _build
from mtasr_tpu_torch.ops.kernels import flash_attention as fa
from mtasr_tpu_torch.tools.timing import graph_ms


def ptxas_report(name: str = "flash_attention_bwd") -> str:
    """`nvcc -Xptxas -v`'s lines on the kernels of `csrc/<name>.cu`."""
    src = _build.CSRC / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/probe.so", str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return "\n".join(line for line in res.stderr.splitlines()
                     if "registers" in line or "Compiling entry" in line
                     or "spill" in line)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.ptxas:
        for name in ("flash_attention_bwd", "decode_attention",
                     "decode_attention_int8", "conv_frontend"):
            print(ptxas_report(name), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    B, T, H, D = 16, 499, 16, 64
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    q, k, v, dout = (randn(B, T, H, D) for _ in range(4))
    pos_bias = fa.padded_bias(randn(H, T, T, scale=0.5))
    gate = (1 + torch.rand((B, H, T), generator=g, device="cuda")).to(bf)
    kv_lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    kv_lens[-1] = 300
    out = {"device": torch.cuda.get_device_name(0), "shape": [B, T, H, D]}
    for tag, pb, gt in (("bias", pos_bias, gate), ("no_bias", None, None)):
        o, lse = fa._forward(q, k, v, kv_lens, pb, gt, D ** -0.5, True)
        a = (q, k, v, kv_lens, pb, gt, o, lse, dout)
        delta = fa._delta(dout, o)
        kernels = {"dq": fa.flash_attention_bwd_dq,
                   "dkv": fa.flash_attention_bwd_dkv}
        if pb is not None:
            kernels["dpb"] = fa.flash_attention_bwd_dpb
        for name, fn in kernels.items():
            out[f"{name}_{tag}_graph_ms"] = graph_ms(
                lambda fn=fn: fn(*a, delta=delta))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
