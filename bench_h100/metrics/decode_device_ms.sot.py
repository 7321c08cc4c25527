"""Device ms a decode step: the kernels launched inside the program's
`mtasr.engine.decode.step` spans, over the `mtasr.engine.decode.steps`
counter."""
from bench_h100 import program


def read(rec):
    v = program.view(rec)
    return v and program.per_step(
        v, 1e3 * v.range_device_s("mtasr.engine.decode.step"))
