"""The DeepSeek-V3 family's cell, `moonlight_sot_b256`: its two plain
references agree, the serving faults that `test_bench_faults.py` plants in
the LLaMA cells read `correct` false here too (the tiny CPU geometry), the
count takes the lesser form of latent attention, and the new metrics'
readers give nothing where the program has no experts."""
import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from bench_h100 import cells, harness
from bench_h100.counts import deepseek_v3 as counts
from bench_h100.reference import deepseek_v3 as bench_ref
from bench_h100.tests.test_bench_faults import (
    alter_tokens, half_batch, stale_state,
)
from bench_h100.tests.test_bench_imports import JAX_SIDE, top_level_imports

CELL = "moonlight_sot_b256"
ROOT = Path(__file__).resolve().parents[2]


def _tests_reference():
    path = ROOT / "tests" / "plain_deepseek_v3.py"
    spec = importlib.util.spec_from_file_location("plain_deepseek_v3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


def _tiny():
    cell = cells.load_cell(CELL)
    enc, dec, comp, mix = harness.geometry(cell, True)
    cfg, _, ids = harness.port_config(enc, dec, comp)
    w, _ = harness.build(cfg, "bf16", 11, torch.device("cpu"), torch.float32)
    return dec, w, ids


def test_the_two_references_give_the_same_logits():
    """`reference/deepseek_v3.py::served_logits` (the judge's) against
    `tests/plain_deepseek_v3.py::decoder_logits` (the CPU tests') on the
    cell's tiny cut and weights: rows [BOS | speech | served tokens],
    float32 rounding apart (another order of the same sums)."""
    plain, path = _tests_reference()
    assert not top_level_imports(path) & (JAX_SIDE | {"mtasr_tpu_torch"})
    dec, w, ids = _tiny()
    g = torch.Generator().manual_seed(0)
    speech = [torch.randn(n, dec["hidden_size"], generator=g)
              for n in (5, 9)]
    tokens = [torch.randint(0, dec["vocab_size"], (m,), generator=g)
              for m in (4, 6)]
    got = bench_ref.served_logits(w, dec, speech, tokens, ids["bos"])
    table = w["decoder.model.embed_tokens.weight"].float()
    for s, t, z in zip(speech, tokens, got):
        x = torch.cat([table[[ids["bos"]]], s, table[t[:-1]]])[None]
        n = x.shape[1]
        want = plain.decoder_logits(
            w, dec, x, torch.arange(n)[None],
            torch.ones(1, n, dtype=torch.bool))[0, s.shape[0]:]
        assert float((z - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_reference_bits_move_the_logits():
    """The control: the judge's reference at 8 bits differs from the
    float32 one (its every linear, input and latent rounded)."""
    dec, w, ids = _tiny()
    g = torch.Generator().manual_seed(1)
    speech = [torch.randn(6, dec["hidden_size"], generator=g)]
    tokens = [torch.randint(0, dec["vocab_size"], (5,), generator=g)]
    a = bench_ref.served_logits(w, dec, speech, tokens, ids["bos"])[0]
    b = bench_ref.served_logits(w, dec, speech, tokens, ids["bos"],
                                quant=8)[0]
    assert 0 < float((a - b).abs().max()) < float(a.abs().max())


def _run(capsys):
    rc = harness.main(["--workload", CELL, "--seed", str(2 ** 31 + 5),
                       "--seconds", "0", "--trace", "0", "--cpu-tiny"],
                      time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    assert _run(capsys)["correct"] is True


@pytest.mark.parametrize("fault", ["token", "half_batch", "stale_state"])
def test_sot_fault_is_caught(capsys, monkeypatch, fault):
    {"token": alter_tokens,
     "half_batch": lambda m: half_batch(m, "generate"),
     "stale_state": stale_state}[fault](monkeypatch)
    out = _run(capsys)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_count_takes_the_lesser_form_of_latent_attention():
    """The prefill's scores are narrower expanded (dn + dr + dv against
    2 r + dr a pair); a step's up-projection is cheaper absorbed (one
    query against every cached key): the count is at most either form."""
    conf = cells.read_json("configs", "wavlm-large_moonlight-16b-a3b")
    dec = conf["decoder"]
    n, r = dec["num_attention_heads"], dec["kv_lora_rank"]
    dn, dr, dv = dec["qk_nope_head_dim"], dec["qk_rope_head_dim"], \
        dec["v_head_dim"]
    q, k, p = 256.0, 256.0 * 180, 256.0 * 180
    up = 2 * r * n * (dn + dv)
    got = counts._attention(dec, q, k, p)
    assert got == q * up + 2 * n * p * (2 * r + dr)      # absorbed
    assert got < k * up + 2 * n * p * (dn + dr + dv)
    q = k = 256.0 * 64
    p = 256.0 * 64 * 65 / 2
    assert counts._attention(dec, q, k, p) == \
        k * up + 2 * n * p * (dn + dr + dv)              # expanded
    ops = counts.call_ops(dec, [60] * 256, 63, 149, False)
    assert ops["int8"] == 0.0 and ops["bf16"] > 0
    with pytest.raises(ValueError, match="bf16"):
        counts.call_ops(dec, [60], 63, 1, True)


def test_new_readers_give_nothing_without_experts():
    from bench_h100.devtrace import Records
    rec = Records(kernels=[], launched=[], spans={}, host=[], window_s=1.0,
                  geometry={"decoder": {"n_routed_experts": None}})
    for name in ("moe_experts_roofline.sot", "moe_load_max.sot"):
        assert cells.metric_reader(name)(rec) is None
    rec.spans = {"mtasr.engine.decode.step": [(0.0, 1.0)]}
    rec.counts = {"mtasr.decoder.moe.pairs": 600,
                  "mtasr.decoder.moe.pairs_max": 30}
    rec.geometry = {"decoder": {"n_routed_experts": 64}}
    assert cells.metric_reader("moe_load_max.sot")(rec) == 30 * 64 / 600


@pytest.mark.card
def test_cell_runs_correct_on_the_card(card):
    """The cell at its size on the H100 (`-m card`): correct, on the
    card, its device memory read."""
    from bench_h100.tests.test_bench_card import command
    rc, lines, err = command(CELL, "--seed", "3141592653", "--seconds", "5",
                             "--trace", "0")
    assert rc == 0, err[-3000:]
    last = lines[-1]
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
def test_control_reads_past_the_limit_on_the_card(card):
    """The reference at 8 bits reads past the cell's limit on three seeds
    while the program reads within it."""
    from bench_h100.tests.test_bench_card import command
    rc, lines, err = command(CELL, "--seed", "2718281828", "--seconds", "0",
                             "--readings", "3")
    assert rc == 0, err[-3000:]
    compared = cells.load_cell(CELL).limits["compared"]
    assert len(lines) == 3
    for line in lines:
        for name, limit in compared.items():
            assert line["program"][name] <= limit, line
        assert any(line["control"][n] > limit
                   for n, limit in compared.items()), line
