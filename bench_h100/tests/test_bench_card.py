"""On the card (`python -m pytest bench_h100/tests -q -m card`, from the
checkout's root on the H100): each cell runs and is correct, and its
lower-precision control, at the cell's own size on three seeds, reads
past the cell's limit while the program reads within it."""
import json
import os
import subprocess
import sys

import pytest

from bench_h100 import cells
from bench_h100.tests._run import ROOT

CELLS = ["smollm2_sot_b256", "mistral7b-w8a8_sot_b256", "smollm2_ctc_b256"]


def command(workload, *extra):
    p = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                        workload, *extra], cwd=ROOT, capture_output=True,
                       text=True, timeout=1500, env=dict(os.environ))
    return p.returncode, [json.loads(x) for x in p.stdout.splitlines()
                          if x.startswith("{")], p.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    rc, lines, err = command(workload, "--seed", "3141592653",
                             "--seconds", "5", "--trace", "0")
    assert rc == 0, err[-3000:]
    last = lines[-1]
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_past_the_limit_on_the_card(card, workload):
    rc, lines, err = command(workload, "--seed", "2718281828",
                             "--seconds", "0", "--readings", "3")
    assert rc == 0, err[-3000:]
    compared = cells.load_cell(workload).limits["compared"]
    assert len(lines) == 3
    for line in lines:
        for name, limit in compared.items():
            assert line["program"][name] <= limit, line
        assert any(line["control"][n] > limit
                   for n, limit in compared.items()), line
