"""A configuration, a mix or a per-layer metric is added by adding its
file and an entry in BENCHMARK.json: no file that is there is edited."""
import json
import shutil

from bench_h100 import cells
from bench_h100.tests._run import ROOT, run_cell


def copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_h100", root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_mix_config_and_metric_by_files_alone(tmp_path):
    root = copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench_h100").rglob("*")
              if p.is_file()}
    base = root / "bench_h100"
    mix = cells.read_json("mixes", "sot_b256")
    mix.update(batch=64, lengths_s=[2.0, 4.0])
    (base / "mixes" / "sot_b64.json").write_text(json.dumps(mix))
    conf = cells.read_json("configs", "wavlm-large_smollm2-1.7b")
    conf["decoder"]["num_hidden_layers"] = 12
    (base / "configs" / "wavlm-large_smollm2-12l.json").write_text(
        json.dumps(conf))
    (base / "limits" / "smollm2-12l_sot_b64.json").write_text(
        json.dumps(cells.read_json("limits", "smollm2_sot_b256")))
    (base / "metrics" / "calls.sot64.py").write_text(
        "def read(rec):\n    return rec.counts.get('calls')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wavlm-large_smollm2-12l",
                             "source": "https://example.org",
                             "file": "bench_h100/configs/"
                                     "wavlm-large_smollm2-12l.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "smollm2-12l_sot_b64",
                               "config": "wavlm-large_smollm2-12l",
                               "traffic": "sot_b64", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("smollm2-12l_sot_b64")
    bench["end_to_end"].append({"name": "recordings_per_s",
                                "unit": "samples/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["smollm2-12l_sot_b64"]})
    bench["per_layer"].append({"name": "calls.sot64", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "engine", "moves": "rtfx",
                               "workloads": ["smollm2-12l_sot_b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell("smollm2-12l_sot_b64", root)
    assert cell.mix["batch"] == 64
    assert cell.config["decoder"]["num_hidden_layers"] == 12
    read = cells.readers(cell)["calls.sot64"]
    assert read(type("R", (), {"counts": {"calls": 3}})()) == 3
    rc, last, err = run_cell("smollm2-12l_sot_b64", root=root,
                             env_extra={"PYTHONPATH": str(ROOT)})
    assert rc == 0 and last["correct"] is True, err[-2000:]
    assert "rtfx" in last["metrics"]
    assert last["metrics"]["recordings_per_s"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before          # nothing that was there changed


def test_no_result_without_the_program(tmp_path):
    root = copy_checkout(tmp_path)
    rc, last, err = run_cell("smollm2_sot_b256", root=root)
    assert rc != 0 and last is None


def test_mixed_lengths_are_judged_batch_by_batch(tmp_path, monkeypatch,
                                                 capsys):
    """A mix whose lengths span two buckets (4.6-5.4 s: the 5 s and the
    10 s bucket) runs as two batches a call; the rooflines count each
    batch at its own padded length and the judge pads each judged row as
    its batch was."""
    import functools
    import time
    from bench_h100 import harness
    root = copy_checkout(tmp_path)
    base = root / "bench_h100"
    mix = cells.read_json("mixes", "sot_b256")
    mix.update(batch=4, lengths_s=[4.6, 5.4], distinct_calls=1,
               judge_rows=4)
    (base / "mixes" / "sot_two-buckets.json").write_text(json.dumps(mix))
    (base / "limits" / "smollm2_sot_two-buckets.json").write_text(
        json.dumps(cells.read_json("limits", "smollm2_sot_b256")))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "smollm2_sot_two-buckets",
                               "config": "wavlm-large_smollm2-1.7b",
                               "traffic": "sot_two-buckets", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("smollm2_sot_two-buckets")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness.cells, "load_cell",
                        functools.partial(cells.load_cell, root=root))
    monkeypatch.setattr(harness, "TINY_MIX", {})
    seen = []
    judge = harness.judge

    def judged(cell, w, enc, dec, comp, ids, sample, device, *a):
        seen.extend(padded for _, _, padded, _ in sample)
        return judge(cell, w, enc, dec, comp, ids, sample, device, *a)
    monkeypatch.setattr(harness, "judge", judged)
    rc = harness.main(["--workload", "smollm2_sot_two-buckets", "--seed",
                       "77", "--seconds", "0", "--trace", "0",
                       "--cpu-tiny"], time.perf_counter())
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and last["correct"] is True
    assert sorted(set(seen)) == [5 * 16000, 10 * 16000]
    assert last["attempted"] == 4


def test_generation_options_come_from_the_mix():
    from bench_h100 import harness
    cell = cells.load_cell("smollm2_sot_b256")
    enc, dec, comp, mix = harness.geometry(cell, True)
    cfg, tok, _ = harness.port_config(enc, dec, comp)
    tr = harness.transcriber(cfg, None, tok, True,
                             dict(mix, generation={"encode_chunk": 2}))
    assert tr.gen.encode_chunk == 2 and tr.gen.kv_quant is True
