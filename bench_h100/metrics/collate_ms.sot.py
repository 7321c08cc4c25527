"""Host ms a call in the host batching (`pipeline.collate`, the `bench.collate`
ranges): normalised waveforms into the padded batch."""


def read(rec):
    n = rec.counts.get("calls", 0)
    t = rec.range_s("bench.collate")
    return 1e3 * t / n if n and t else None
