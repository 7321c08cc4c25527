"""The whole call's share of the card's peak: the model operations of the
traced SOT calls (`roofline.sot_call_ops`, the decoder's part by its
family's count: bf16 at 989 TFLOP/s, the w8a8 decoder's int8 at 1979
TOP/s) at the peak, over the traced span's wall time."""
from bench_h100 import roofline as R


def read(rec):
    g = rec.geometry
    if not g.get("batches"):
        return None
    int8 = g["precision"] == "w8a8"
    ideal = sum(R.ideal_seconds(R.sot_call_ops(
        g["encoder"], g["decoder"], b["lengths"], b["padded"], b["steps"],
        int8, g["family"])) for b in g["batches"])
    return 100.0 * ideal / rec.window_s
