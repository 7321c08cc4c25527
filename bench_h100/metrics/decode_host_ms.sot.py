"""Host ms a decode step that the host spends issuing it: the program's
`mtasr.engine.decode.step` spans less the `mtasr.engine.eos_check` spans
inside them (the host blocked on the device), over the
`mtasr.engine.decode.steps` counter. Against `decode_device_ms.sot`: the
larger paces a step."""
from bench_h100 import program


def read(rec):
    v = program.view(rec)
    return v and program.per_step(
        v, 1e3 * (v.range_s("mtasr.engine.decode.step")
                  - v.range_s("mtasr.engine.eos_check")))
