"""What the harness computes for the three cells, pinned as literals read
at the commit before the decoder family became the configuration's: the
whole-call operations behind `mfu.sot` and `mfu.ctc` at the `sot_b256`
and `ctc_b256` geometry, the weights drawn at the tiny shapes (a sha256 of
every tensor, in order: torch's CPU generator), and the judged numbers of
a `--cpu-tiny` run of one call at one seed, with the reference's own int4
control on the same sample. A configuration without the new keys gives
exactly these."""
import dataclasses
import hashlib
import json
import time

import pytest
import torch

from bench_h100 import cells, harness, roofline as R, traffic

SEED = 2 ** 31 + 77
SOT_OPS = {
    "wavlm-large_smollm2-1.7b": (False, {"bf16": 282916989042688.0,
                                         "int8": 0.0}),
    "wavlm-large_mistral-7b-v0.3_w8a8": (True, {"bf16": 98822991118336.0,
                                                "int8": 773974040510464}),
}
CTC_OPS = 128541815996416.0
WEIGHTS = {
    "smollm2_sot_b256": (130, "19194396dae6f6c438d0286a33b0edcc"
                              "7a658687e66689da4e3f5a9029c7e5bd"),
    "mistral7b-w8a8_sot_b256": (120, "1585ee8a91133b33e8050aa671e4b0ad"
                                     "95e847ff9708ae14f10c7d7d47a2f928"),
}
ZERO = {"max_gap_sd": 0.0, "mean_gap_sd": 0.0, "msq_gap_sd": 0.0}
JUDGED = {
    "smollm2_sot_b256": dict(ZERO, tokens=18),
    "mistral7b-w8a8_sot_b256": dict(ZERO, tokens=18),
    "smollm2_ctc_b256": dict(ZERO, tokens=82),
}
INT4_CONTROL = {
    "smollm2_sot_b256": {"max_gap_sd": 1.166580080986023,
                         "mean_gap_sd": 0.3348671793937683,
                         "msq_gap_sd": 0.2501167058944702, "tokens": 18},
    "mistral7b-w8a8_sot_b256": {"max_gap_sd": 2.776628017425537,
                                "mean_gap_sd": 0.9959551692008972,
                                "msq_gap_sd": 2.0665433406829834,
                                "tokens": 18},
    "smollm2_ctc_b256": {"max_gap_sd": 3.9068655967712402,
                         "mean_gap_sd": 0.8321523247334194,
                         "msq_gap_sd": 1.0373898746970067, "tokens": 98},
}


def b256_lengths():
    return [int(n) for n in traffic.stratified_lengths(6.0, 10.0, 256)]


@pytest.mark.parametrize("config", sorted(SOT_OPS))
def test_sot_call_ops_pinned(config):
    int8, want = SOT_OPS[config]
    conf = cells.read_json("configs", config)
    got = R.sot_call_ops(conf["encoder"], conf["decoder"], b256_lengths(),
                         160000, 149, int8)
    for kind in ("bf16", "int8"):
        assert got[kind] == pytest.approx(want[kind], rel=1e-12, abs=0)


def test_ctc_call_ops_pinned():
    conf = cells.read_json("configs", "wavlm-large_smollm2-1.7b")
    comp = conf["composite"]
    got = R.ctc_call_ops(conf["encoder"], comp["separator_hidden"],
                         comp["talker_numbers"],
                         conf["decoder"]["vocab_size"], b256_lengths(),
                         160000)
    assert got == {"bf16": pytest.approx(CTC_OPS, rel=1e-12, abs=0),
                   "int8": 0.0}


@pytest.mark.parametrize("workload", sorted(WEIGHTS))
def test_weights_checksum_pinned(workload):
    cell = cells.load_cell(workload)
    enc, dec, comp, _ = harness.geometry(cell, True)
    cfg, _, _ = harness.port_config(enc, dec, comp)
    w, _ = harness.build(cfg, cell.config["precision"], SEED,
                         torch.device("cpu"), torch.float32)
    h = hashlib.sha256()
    for name, t in w.items():
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert (len(w), h.hexdigest()) == WEIGHTS[workload]


def run(capsys, workload, *extra):
    rc = harness.main(["--workload", workload, "--seed", str(SEED),
                       "--seconds", "0", "--trace", "0", "--cpu-tiny",
                       *extra], time.perf_counter())
    assert rc == 0
    return capsys.readouterr()


@pytest.mark.parametrize("workload", sorted(JUDGED))
def test_judged_numbers_pinned(capsys, workload):
    err = run(capsys, workload).err
    line = [x for x in err.splitlines() if x.startswith("judged: ")][-1]
    assert json.loads(line[len("judged: "):]) == JUDGED[workload]


@pytest.mark.parametrize("workload", sorted(INT4_CONTROL))
def test_reference_int4_control_pinned(capsys, monkeypatch, workload):
    """The `--readings` path with the reference's own control
    (`reference_bits`), at 4 bits in every cell: the family's reference
    at the precision below, on the served sample."""
    load = cells.load_cell

    def with_int4(name, *a, **kw):
        cell = load(name, *a, **kw)
        return dataclasses.replace(cell, limits=dict(
            cell.limits, control={"reference_bits": 4}))
    monkeypatch.setattr(harness.cells, "load_cell", with_int4)
    out = run(capsys, workload, "--readings", "1").out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["program"] == JUDGED[workload]
    assert line["control"] == INT4_CONTROL[workload]
