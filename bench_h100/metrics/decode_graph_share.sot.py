"""Share of the decode steps replayed from a CUDA graph: the program's
`mtasr.engine.decode.graph_replays` counter over its
`mtasr.engine.decode.steps` counter (0 where every step ran eagerly; a
program without the replay counter gives nothing)."""
from bench_h100 import program

REPLAYS = "mtasr.engine.decode.graph_replays"


def read(rec):
    v = program.view(rec)
    n = v and v.counts.get(program.STEPS, 0)
    if not n or REPLAYS not in v.counts:
        return None
    return v.counts[REPLAYS] / n
