"""`decode_graph_share.sot`: the program's replay counter over its step
counter on synthetic records, 0 for a program whose counter is there at
0, nothing for one without the counter (a program whose step runs
eagerly by design), and declared for the SOT cells."""
import json

import pytest

from bench_h100 import cells, program
from bench_h100.devtrace import Records
from bench_h100.tests._run import ROOT

NAME = "decode_graph_share.sot"
REPLAYS = "mtasr.engine.decode.graph_replays"


def records(counts):
    return Records(kernels=[], launched=[],
                   spans={"mtasr.engine.decode.step": [(0.0, 1.0)]},
                   host=[], window_s=1.0, counts={"calls": 1, **counts})


@pytest.mark.parametrize("counts,want", [
    ({program.STEPS: 149, REPLAYS: 148}, 148 / 149),
    ({program.STEPS: 298, REPLAYS: 296}, 296 / 298),
    ({program.STEPS: 149, REPLAYS: 0}, 0.0),
    ({program.STEPS: 149}, None),
    ({program.STEPS: 0, REPLAYS: 0}, None),
])
def test_reader_reads_the_counters(counts, want):
    got = cells.metric_reader(NAME)(records(counts))
    assert got == (None if want is None else pytest.approx(want))


def test_declared_for_the_sot_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    [m] = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["layer"], m["moves"]) == (
        "share", "higher", "engine", "rtfx")
    assert m["workloads"] == ["smollm2_sot_b256", "mistral7b-w8a8_sot_b256"]
    for cell in m["workloads"]:
        assert NAME in cells.readers(cells.load_cell(cell))
