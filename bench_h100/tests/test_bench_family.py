"""A decoder family joins the benchmark by files alone: a configuration
that names its `family` and its `tiny` cut, the family's reference
(`reference/<family>.py`) and count (`counts/<family>.py`), a limits file
and a cell, in a copied checkout whose files that were there stay byte for
byte. The toy family below is LLaMA's program under another name; its
reference and count delegate to LLaMA's."""
import json
import sys
import time
import types

import pytest

from bench_h100 import cells, harness, roofline as R, traffic
from bench_h100.counts import llama as llama_counts
from bench_h100.tests._run import ROOT, run_cell
from bench_h100.tests.test_bench_data_driven import copy_checkout
from bench_h100.tests.test_bench_imports import JAX_SIDE, top_level_imports

FAMILY = "toyllama"
CELL = "toyllama_sot_b256"
REFERENCE = '''"""A toy family: LLaMA's reference under another name."""
from bench_h100.reference import llama


def served_logits(w, dec, speech, tokens, bos_id, quant=None):
    return llama.served_logits(w, {DEC}, speech, tokens, bos_id,
                               quant=quant)
'''
COUNTS = '''"""A toy decoder family: LLaMA's count."""
from bench_h100.counts.llama import call_ops  # noqa: F401
'''


def add_family(root, reference_dec="dec"):
    """The toy family's files and entries in the checkout at `root`."""
    base = root / "bench_h100"
    conf = cells.read_json("configs", "wavlm-large_smollm2-1.7b")
    conf.update(family=FAMILY, tiny={"decoder": {"num_hidden_layers": 3}})
    (base / "configs" / "wavlm-large_toyllama.json").write_text(
        json.dumps(conf))
    (base / "reference" / f"{FAMILY}.py").write_text(
        REFERENCE.replace("{DEC}", reference_dec))
    (base / "counts" / f"{FAMILY}.py").write_text(COUNTS)
    (base / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"compared": {"msq_gap_sd": 8e-05},
         "control": {"reference_bits": 8}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wavlm-large_toyllama",
                             "source": "https://example.org",
                             "file": "bench_h100/configs/"
                                     "wavlm-large_toyllama.json",
                             "reduced": ["vocab_size"],
                             "why": "a test family"})
    bench["workloads"].append({"name": CELL, "config": "wavlm-large_toyllama",
                               "traffic": "sot_b256", "chips": 1,
                               "why": "a test cell"})
    rtfx = next(m for m in bench["end_to_end"] if m["name"] == "rtfx")
    rtfx["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_family_by_files_alone(tmp_path):
    root = copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench_h100").rglob("*")
              if p.is_file()}
    add_family(root)
    cell = cells.load_cell(CELL, root)
    assert cells.family(cell.config) == FAMILY
    _, dec, _, _ = harness.geometry(cell, True)
    assert dec["num_hidden_layers"] == 3 and dec["hidden_size"] == 64
    ref = root / "bench_h100" / "reference" / f"{FAMILY}.py"
    assert not top_level_imports(ref) & (JAX_SIDE | {"mtasr_tpu_torch"})
    env = {"PYTHONPATH": str(ROOT)}
    rc, last, err = run_cell(CELL, root=root, env_extra=env,
                             extra=("--seconds", "0"))
    assert rc == 0 and last["correct"] is True, err[-2000:]
    assert last["checks"]["msq_gap_sd"]["value"] == 0.0
    after = {p: p.read_bytes() for p in before}
    assert after == before          # nothing that was there changed
    # the same cell against a copy of the reference that stops a layer
    # short: the judge holds the served tokens against that reference
    ref.write_text(REFERENCE.replace(
        "{DEC}", 'dict(dec, num_hidden_layers=dec["num_hidden_layers"] - 1)'))
    rc, last, err = run_cell(CELL, root=root, env_extra=env,
                             extra=("--seconds", "0"))
    assert rc == 0 and last["correct"] is False, err[-2000:]
    assert last["checks"]["msq_gap_sd"]["value"] > 8e-05


@pytest.mark.parametrize("config,int8", [
    ("wavlm-large_smollm2-1.7b", False),
    ("wavlm-large_mistral-7b-v0.3_w8a8", True)])
def test_a_family_count_moves_the_call_by_its_share(monkeypatch, config,
                                                    int8):
    """A count that doubles the decoder's operations moves the whole
    call's by exactly the decoder's share: the encoder and the projection
    stay the harness's."""
    double = types.ModuleType("bench_h100.counts.double")
    double.call_ops = lambda *a: {
        k: 2 * v for k, v in llama_counts.call_ops(*a).items()}
    monkeypatch.setitem(sys.modules, double.__name__, double)
    conf = cells.read_json("configs", config)
    enc, dec = conf["encoder"], conf["decoder"]
    n = [int(x) for x in traffic.stratified_lengths(6.0, 10.0, 256)]
    one = R.sot_call_ops(enc, dec, n, 160000, 149, int8)
    two = R.sot_call_ops(enc, dec, n, 160000, 149, int8, "double")
    T8 = R.adapter_lens(enc, R.conv_len(enc, 160000))[-1]
    n_valid = [R.adapter_lens(enc, R.conv_len(enc, k))[-1] for k in n]
    share = llama_counts.call_ops(dec, n_valid, T8, 149, int8)
    assert share["int8" if int8 else "bf16"] > 0
    for kind in ("bf16", "int8"):
        assert two[kind] - one[kind] == share[kind]


def test_program_control_stops_outside_the_llama_family(tmp_path,
                                                        monkeypatch):
    import functools
    root = copy_checkout(tmp_path)
    add_family(root)
    (root / "bench_h100" / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"compared": {"msq_gap_sd": 8e-05},
         "control": {"program": "w8a8", "scope": "all"}}))
    monkeypatch.setattr(harness.cells, "load_cell",
                        functools.partial(cells.load_cell, root=root))
    with pytest.raises(SystemExit, match="reference_bits"):
        harness.main(["--workload", CELL, "--seed", "3", "--seconds", "0",
                      "--cpu-tiny", "--readings", "1"], time.perf_counter())
