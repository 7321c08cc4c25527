"""Kernel #6 (`decode_int8_kernel`): its roofline bound over the traced
calls' decode steps, batch by batch (`roofline.decode_attention_call`
over the int8 cache and its scales, int8 operations), as a share of its
device time."""
from bench_h100 import roofline as R


KERNEL = "decode_int8_kernel"
INT8 = True


def read(rec):
    t = rec.device_s_having(KERNEL)
    if not t:
        return None
    g = rec.geometry
    enc, dec = g["encoder"], g["decoder"]
    n_bytes = n_ops = 0.0
    for batch in g["batches"]:
        T8 = R.adapter_lens(enc, R.conv_len(enc, batch["padded"]))[-1]
        n_valid = [R.adapter_lens(enc, R.conv_len(enc, n))[-1]
                   for n in batch["lengths"]]
        b, o = R.decode_attention_call(dec, n_valid, T8, batch["steps"],
                                       INT8)
        n_bytes += b
        n_ops += o
    sec, _ = R.bound(n_bytes, n_ops, "int8" if INT8 else "bf16")
    return 100.0 * sec / t
