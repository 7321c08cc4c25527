"""Kernel #2 (`flash_fwd_kernel`): its roofline bound over the traced
calls' encodes, batch by batch (`roofline.flash_attention_call`), as a
share of its device time."""
from bench_h100 import roofline as R


def read(rec):
    t = rec.device_s_having("flash_fwd_kernel")
    if not t:
        return None
    enc = rec.geometry["encoder"]
    n_bytes = n_ops = 0.0
    for batch in rec.geometry["batches"]:
        lengths = batch["lengths"]
        b, o = R.flash_attention_call(enc, len(lengths),
                                      R.conv_len(enc, batch["padded"]),
                                      [R.conv_len(enc, n) for n in lengths])
        n_bytes += b
        n_ops += o
    sec, _ = R.bound(n_bytes, n_ops, "bf16")
    return 100.0 * sec / t
