"""Device operations a decode step: those whose launch lies inside the
program's `mtasr.engine.decode.step` spans, over the
`mtasr.engine.decode.steps` counter (what a step captured in a CUDA graph
brings from hundreds to a few)."""
from bench_h100 import program


def read(rec):
    v = program.view(rec)
    n = v and v.counts.get(program.STEPS, 0)
    launches = n and program.launches_in(v, "mtasr.engine.decode.step")
    return launches / n if launches else None
