"""The last line's keys, on the tiny CPU geometry (`--cpu-tiny`: the
device is tagged as the CPU and no device metric is reported)."""
import pytest

from bench_h100 import cells
from bench_h100.tests._run import run_cell

CELLS = ["smollm2_sot_b256", "mistral7b-w8a8_sot_b256", "smollm2_ctc_b256"]


@pytest.mark.parametrize("workload", CELLS)
def test_last_line(workload):
    rc, last, err = run_cell(workload)
    assert rc == 0, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True, err[-2000:]
    assert last["attempted"] > 0 and last["failed"] == 0
    cell = cells.load_cell(workload)
    assert set(last["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name, m in last["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert last["device"]["platform"] == "cpu"
    assert last["device"]["count"] == 1
    for name, c in last["checks"].items():
        assert c["value"] <= c["limit"]
    tail = err.strip().splitlines()[-len(last["checks"]):]
    for line, name in zip(tail, last["checks"]):
        assert line.startswith(f"check {name} ") and " limit " in line


def test_traced_run_reports_no_device_metric_on_the_cpu():
    rc, last, err = run_cell("smollm2_sot_b256", trace=1)
    assert rc == 0, err[-3000:]
    assert last["metrics"] == {}
    assert "busy_s" not in last["device"]
    assert last["correct"] is True
