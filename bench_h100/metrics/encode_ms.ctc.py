"""Wall ms a call of the encoder and separator (`encode_feats`, the
`bench.encode_feats` ranges, ending in a synchronize)."""


def read(rec):
    n = rec.counts.get("calls", 0)
    t = rec.range_s("bench.encode_feats")
    return 1e3 * t / n if n and t else None
