"""The whole call's share of the card's bf16 peak: the model operations of the
traced CTC calls (`roofline.ctc_call_ops`) at 989 TFLOP/s, over the traced
span's wall time."""
from bench_h100 import roofline as R


def read(rec):
    g = rec.geometry
    if not g.get("batches"):
        return None
    comp = g["composite"]
    ideal = sum(R.ideal_seconds(R.ctc_call_ops(
        g["encoder"], comp["separator_hidden"], comp["talker_numbers"],
        g["decoder"]["vocab_size"], b["lengths"], b["padded"]))
        for b in g["batches"])
    return 100.0 * ideal / rec.window_s
