"""`w8a8_kernel_share.sot`: the program's w8a8 kernel counter over its
w8a8 linear counter on synthetic records, nothing for a program without
the counters, and declared for the w8a8 cell alone."""
import json

import pytest

from bench_h100 import cells
from bench_h100.devtrace import Records
from bench_h100.tests._run import ROOT

NAME = "w8a8_kernel_share.sot"
LINEARS = "mtasr.int8.w8a8_linears"
KERNELS = "mtasr.int8.w8a8_kernels"


def records(counts):
    return Records(kernels=[], launched=[],
                   spans={"mtasr.engine.decode.step": [(0.0, 1.0)]},
                   host=[], window_s=1.0, counts={"calls": 1, **counts})


@pytest.mark.parametrize("counts,want", [
    ({LINEARS: 675, KERNELS: 675}, 1.0),
    ({LINEARS: 675}, 0.0),              # linears that ran the plain lines
    ({LINEARS: 600, KERNELS: 150}, 0.25),
    ({}, None),                         # a program without the counters
    ({LINEARS: 0, KERNELS: 0}, None),
])
def test_reader_reads_the_counters(counts, want):
    got = cells.metric_reader(NAME)(records(counts))
    assert got == (None if want is None else pytest.approx(want))


def test_declared_for_the_w8a8_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    [m] = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "share", "higher", "program_counter", "int8 linears", "rtfx")
    assert m["workloads"] == ["mistral7b-w8a8_sot_b256"]
    assert bench["per_layer"][-1] is m
    for cell in m["workloads"]:
        assert NAME in cells.readers(cells.load_cell(cell))
