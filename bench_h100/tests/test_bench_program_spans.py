"""The per-layer metrics that read the program's own spans and counter
(`program.py`): each reader against a hand count on synthetic records,
the program's spans brought beside the benchmark's on the profiler's
clock, and nothing reported for a program that keeps no spans."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100 import cells, program
from bench_h100.devtrace import Records
from bench_h100.tests._run import ROOT

NEW = ["entry_host_ms.sot", "entry_host_ms.ctc", "prefill_ms.sot",
       "decode_host_ms.sot", "decode_device_ms.sot", "decode_launches.sot",
       "ctc_heads_ms.ctc"]


def synthetic():
    """Two calls (µs): the entry's host work 250 + 30 + 110; the prefill
    launches 50 + 30 and 40 of device time; three steps of 100 with one
    eos check of 20 inside, launching 5 + 10, 20 and 15; the heads launch
    100 and 60; one operation outside every span, one with no launch."""
    spans = {
        "mtasr.api.prepare": [(0, 100), (1000, 1150)],
        "mtasr.api.to_device": [(100, 120), (1150, 1160)],
        "mtasr.api.detokenize": [(900, 950), (1900, 1960)],
        "mtasr.engine.prefill": [(200, 300), (1200, 1300)],
        "mtasr.engine.decode.step": [(300, 400), (400, 500), (1300, 1400)],
        "mtasr.engine.eos_check": [(300, 320)],
        "mtasr.ctc.heads": [(600, 700), (1600, 1700)],
        "bench.decode": [(300, 500), (1300, 1400)],
    }
    launches = {210: 50, 250: 30, 1210: 40, 310: 5, 350: 10, 450: 20,
                1350: 15, 610: 100, 1650: 60, 800: 7}
    kernels, launched = [], []
    for t, d in sorted(launches.items()):
        kernels.append((f"k{t}", t + 1000, t + 1000 + d))
        launched.append(float(t))
    kernels.append(("copy", 5000, 5009))
    launched.append(None)
    return Records(kernels=kernels, launched=launched,
                   spans={k: [(float(s), float(e)) for s, e in v]
                          for k, v in spans.items()},
                   host=[], window_s=0.002,
                   counts={"calls": 2, "steps": 3.0,
                           "mtasr.engine.decode.steps": 3})


@pytest.mark.parametrize("name,want", [
    ("entry_host_ms.sot", (250 + 30 + 110) / 1e3 / 2),
    ("entry_host_ms.ctc", (250 + 30 + 110) / 1e3 / 2),
    ("prefill_ms.sot", (50 + 30 + 40) / 1e3 / 2),
    ("decode_host_ms.sot", (300 - 20) / 1e3 / 3),
    ("decode_device_ms.sot", (5 + 10 + 20 + 15) / 1e3 / 3),
    ("decode_launches.sot", 4 / 3),
    ("ctc_heads_ms.ctc", (100 + 60) / 1e3 / 2),
])
def test_reader_reads_the_hand_count(name, want):
    assert cells.metric_reader(name)(synthetic()) == pytest.approx(want)


def test_every_new_metric_is_declared_for_cells_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell_names = {w["name"] for w in bench["workloads"]}
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["workloads"] and set(m["workloads"]) <= cell_names
        assert (ROOT / "bench_h100" / "metrics" / f"{name}.py").exists()
        for cell in m["workloads"]:
            assert name in cells.readers(cells.load_cell(cell))


@pytest.fixture
def fresh(monkeypatch):
    from mtasr_tpu_torch.utils import profiling
    monkeypatch.setattr(program, "_taken", None)
    profiling.take()
    return profiling


def test_view_brings_the_programs_spans_on_the_profilers_clock(fresh):
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with fresh.annotate("mtasr.engine.decode.step"):
            x @ x
            fresh.count(program.STEPS)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    rec = Records(kernels=[], launched=[], spans={"bench.decode": []},
                  host=[], window_s=1.0, counts={"calls": 1})
    v = program.view(rec)
    [(s, e)] = v.spans["mtasr.engine.decode.step"]
    assert s <= mm[0].start_ns() / 1e3 <= mm[0].end_ns() / 1e3 <= e
    assert v.counts == {"calls": 1, program.STEPS: 1}
    assert "bench.decode" in v.spans
    assert rec.spans == {"bench.decode": []}      # the harness's untouched
    assert program.view(rec) is not None          # taken once a process


def test_nothing_reported_for_a_program_without_spans(fresh, monkeypatch):
    rec = synthetic()
    rec.spans = {k: v for k, v in rec.spans.items()
                 if not k.startswith("mtasr.")}
    assert program.view(rec) is None
    monkeypatch.delattr(fresh, "take")
    monkeypatch.setattr(program, "_taken", None)
    for name in NEW:
        assert cells.metric_reader(name)(rec) is None, name
