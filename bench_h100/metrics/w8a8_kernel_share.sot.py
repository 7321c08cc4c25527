"""Share of the w8a8 linears that ran the hand-written quantize and
rescale kernels: the program's `mtasr.int8.w8a8_kernels` counter over its
`mtasr.int8.w8a8_linears` counter (`models/layers.py::linear`). Under the
replayed step the counters see the prefill, step 1 and the capture, where
the linear's Python runs; 1.0 on the card. A program without the counters
gives nothing."""
from bench_h100 import program

LINEARS = "mtasr.int8.w8a8_linears"
KERNELS = "mtasr.int8.w8a8_kernels"


def read(rec):
    v = program.view(rec)
    n = v and v.counts.get(LINEARS, 0)
    if not n:
        return None
    return v.counts.get(KERNELS, 0) / n
