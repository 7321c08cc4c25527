"""Wall ms a decode step: the `bench.decode` ranges around `engine._decode`
(ending in a synchronize) over the steps they ran."""


def read(rec):
    steps = rec.counts.get("steps", 0)
    t = rec.range_s("bench.decode")
    return 1e3 * t / steps if steps and t else None
