"""Device ms a call of the kernels launched inside the program's
`mtasr.engine.prefill` spans: the splice, the KV cache's allocation and the
decoder's prefill forward."""
from bench_h100 import program


def read(rec):
    v = program.view(rec)
    return v and program.per_call(
        v, 1e3 * v.range_device_s("mtasr.engine.prefill"))
