"""The judge sees a broken timed path: a run with the program broken
underneath (the harness's look for a card skipped: the tiny CPU
geometry) reports `correct` false, once for each fault a serving cell can
have: a token or an answer altered where it is produced; half of the
batch left out (its rows given another row's answer); a decode step that
returns its state unchanged (its cache writes lost). A fourth, the
exchange between chips left out, has no place in a one-chip cell. A
sound run of the same seed reports true."""
import copy
import json
import time

import pytest
import torch

from bench_h100 import harness


def run(capsys, workload, seed=2 ** 31 + 5):
    rc = harness.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0", "--trace", "0", "--cpu-tiny"],
                      time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def alter_tokens(monkeypatch):
    from mtasr_tpu_torch.generate import engine
    pick = engine._sample_token
    calls = [0]

    def altered(logits, gen, generator):
        tok = pick(logits, gen, generator)
        calls[0] += 1
        if calls[0] % 3 == 0:      # one step in three: the next id
            tok = (tok + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(engine, "_sample_token", altered)


def half_batch(monkeypatch, name):
    from mtasr_tpu_torch import api
    fn = getattr(api, name)

    def half(model, cfg, wav, amask, **kw):
        h = (wav.shape[0] + 1) // 2
        out = fn(model, cfg, wav[:h], amask[:h], **kw)
        fill = torch.zeros(wav.shape[0], dtype=torch.long)    # row 0's
        fill[:h] = torch.arange(h)
        if name == "generate":
            out.sequences = out.sequences[fill]
            out.lengths = out.lengths[fill]
            return out
        trans, lens = out
        return trans[fill], lens[:, fill]
    monkeypatch.setattr(api, name, half)


def stale_state(monkeypatch):
    from mtasr_tpu_torch.generate import engine
    fwd = engine.llama_forward

    def forward(dec, cfg, x, pos, **kw):
        cache = kw.get("kv_cache")
        if x.shape[1] == 1 and cache is not None:
            kw["kv_cache"] = copy.deepcopy(cache)   # the step's writes lost
            logits, _ = fwd(dec, cfg, x, pos, **kw)
            return logits, cache
        return fwd(dec, cfg, x, pos, **kw)
    monkeypatch.setattr(engine, "llama_forward", forward)


def alter_ctc(monkeypatch):
    from mtasr_tpu_torch.models import speech_encoder_decoder as sed
    arg = sed.ctc_argmax

    def altered(head, hs):
        path = arg(head, hs)
        path[:, 5::7] = (path[:, 5::7] + 1) % head.ctc_lo.weight.shape[0]
        return path
    monkeypatch.setattr(sed, "ctc_argmax", altered)


SOT = ["smollm2_sot_b256", "mistral7b-w8a8_sot_b256"]


@pytest.mark.parametrize("workload", SOT + ["smollm2_ctc_b256"])
def test_sound_run_is_correct(capsys, workload):
    assert run(capsys, workload)["correct"] is True


@pytest.mark.parametrize("workload", SOT)
@pytest.mark.parametrize("fault", ["token", "half_batch", "stale_state"])
def test_sot_fault_is_caught(capsys, monkeypatch, workload, fault):
    {"token": alter_tokens,
     "half_batch": lambda m: half_batch(m, "generate"),
     "stale_state": stale_state}[fault](monkeypatch)
    out = run(capsys, workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_ctc_fault_is_caught(capsys, monkeypatch, fault):
    if fault == "answer":
        alter_ctc(monkeypatch)
    else:
        half_batch(monkeypatch, "generate_ctc")
    assert run(capsys, "smollm2_ctc_b256")["correct"] is False


@pytest.mark.parametrize("workload", SOT + ["smollm2_ctc_b256"])
def test_readings_give_the_program_and_its_control(capsys, workload):
    """The readings a limit is set from: the program's numbers and its
    lower-precision control's (the program's w8a8 path, or the reference
    at the precision below the configuration's) on the same sample, one
    line a seed. At this size the control's rounding can flip no token, so
    that it reads past the limit is held on the card
    (`test_bench_card.py`)."""
    rc = harness.main(["--workload", workload, "--seed", "4242",
                       "--seconds", "0", "--cpu-tiny", "--readings", "2"],
                      time.perf_counter())
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["seed"] for x in lines] == [4242, 4243]
    from bench_h100 import cells
    compared = cells.load_cell(workload).limits["compared"]
    for line in lines:
        assert line["program"]["tokens"] == line["control"]["tokens"] > 0
        for name, limit in compared.items():
            assert line["program"][name] <= limit
            assert line["control"][name] >= 0.0
