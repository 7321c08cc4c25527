"""Host ms a call in the serving entry's own work (`program.entry_host_ms`:
the program's `mtasr.api.prepare`, `mtasr.api.to_device` and
`mtasr.api.detokenize` spans) in the CTC calls."""
from bench_h100 import program


def read(rec):
    return program.entry_host_ms(rec)
