"""The hand-written Hopper kernels of the served and trained paths, each
beside its plain PyTorch version. A wrapper takes the plain version for a
CPU tensor and launches its CUDA kernel (built from `mtasr_tpu_torch/csrc/`
at first use) for a CUDA tensor; it has no other route. Each wrapper counts
its kernel launches in a plain int attribute, `launches`.

Nothing here imports or builds a kernel when the module is imported.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from mtasr_tpu_torch.ops.kernels import (
    conv_frontend, ctc, decode_attention, decode_attention_chunk,
    decode_attention_int8, flash_attention, moe_experts, w8a8_rows,
)

WRAPPERS = {
    "conv0_fused": conv_frontend.conv0_fused,
    "flash_attention": flash_attention.flash_attention,
    "decode_attention": decode_attention.decode_attention,
    "decode_attention_int8": decode_attention_int8.decode_attention_int8,
    "decode_attention_chunk": decode_attention_chunk.decode_attention_chunk,
    "decode_attention_int8_chunk":
        decode_attention_chunk.decode_attention_int8_chunk,
    "flash_attention_bwd_dq": flash_attention.flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention.flash_attention_bwd_dkv,
    "flash_attention_bwd_dpb": flash_attention.flash_attention_bwd_dpb,
    "ctc_alpha": ctc.ctc_alpha,
    "ctc_beta_post": ctc.ctc_beta_post,
    "moe_experts": moe_experts.moe_experts,
    "w8a8_quantize": w8a8_rows.w8a8_quantize,
    "w8a8_rescale": w8a8_rows.w8a8_rescale,
}
# one build function per library (the two chunk kernels share one library,
# the three backward kernels flash_attention_bwd's, the two CTC kernels
# ctc's, the w8a8 quantize and rescale w8a8_rows')
_BUILDS = (conv_frontend.build, flash_attention.build,
           flash_attention.build_bwd, decode_attention.build,
           decode_attention_int8.build, decode_attention_chunk.build,
           ctc.build, moe_experts.build, w8a8_rows.build)


def build_all() -> None:
    """Compile (or load) every kernel library, one `nvcc` per source, all
    started together."""
    with ThreadPoolExecutor(len(_BUILDS)) as pool:
        for f in [pool.submit(build) for build in _BUILDS]:
            f.result()


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
