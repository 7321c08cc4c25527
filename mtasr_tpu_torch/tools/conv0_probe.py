"""Where the time of conv0 (#1) goes at the main path's shape (8 x 10 s of
16 kHz audio -> [8, 31999, 512] bf16, WavLM's K = 10, stride 5): the
kernel's device time in a CUDA graph (`timing.graph_ms`) with its
LayerNorm and gelu, without the gelu, and as the conv alone, beside a
plain write of the same output (`fill_`: the bytes alone), and the
kernel's error against its plain version with the count of output
elements that differ from it.

    python -m mtasr_tpu_torch.tools.conv0_probe

Prints one JSON line; needs a CUDA device."""
from __future__ import annotations

import json

import torch

from mtasr_tpu_torch.ops.kernels import conv_frontend as cf
from mtasr_tpu_torch.tools.timing import graph_ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).bfloat16()

    wave = randn(8, 160000)
    w = randn(512, 1, 10, scale=10 ** -0.5)
    b, gm, bt = (randn(512, scale=0.02), 1 + randn(512, scale=0.1),
                 randn(512, scale=0.05))

    def run(ln=True, act=True):
        return cf.conv0_fused(wave, w, b, gm, bt, stride=5, fuse_ln=ln,
                              fuse_act=act)

    out = run()
    diff = (out.float() - cf.conv0_plain(wave, w, b, gm, bt,
                                         stride=5).float()).abs()
    filled = torch.empty_like(out)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "shape": list(out.shape),
        "graph_ms": graph_ms(run),
        "no_gelu_graph_ms": graph_ms(lambda: run(act=False)),
        "conv_only_graph_ms": graph_ms(lambda: run(ln=False, act=False)),
        "fill_graph_ms": graph_ms(lambda: filled.fill_(1.0)),
        "max_abs_err": float(diff.max()),
        "elements_differing": int((diff > 0).sum()),
        "elements": diff.numel()}), flush=True)


if __name__ == "__main__":
    main()
