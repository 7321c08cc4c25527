"""Device ms a call of the kernels launched inside the program's
`mtasr.ctc.heads` spans: each CTC head's logits over the vocabulary and
their argmax."""
from bench_h100 import program


def read(rec):
    v = program.view(rec)
    return v and program.per_call(
        v, 1e3 * v.range_device_s("mtasr.ctc.heads"))
