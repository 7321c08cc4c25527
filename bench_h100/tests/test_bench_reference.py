"""The plain reference against the port's eager float32 path, at the tiny
geometry on the CPU: the logits every decode step chose its token from
(SOT), and the collapsed transcripts (CTC)."""
import numpy as np
import pytest
import torch

from bench_h100 import cells, harness as H, judge as J, traffic
from bench_h100.reference import llama as ref_llama
from bench_h100.reference import separator as ref_sep
from bench_h100.reference import wavlm as ref_wavlm
from bench_h100.reference.common import float32_exact, linear

CPU = torch.device("cpu")


def served(workload, seed=11, precision=None):
    cell = cells.load_cell(workload)
    enc, dec, comp, mix = H.geometry(cell, True)
    cfg, tok, ids = H.port_config(enc, dec, comp)
    w, model = H.build(cfg, precision or cell.config["precision"], seed, CPU,
                       torch.float32)
    pool = traffic.serve_calls(mix, seed, CPU)
    tr = H.transcriber(cfg, model, tok, False, mix)
    return cell, enc, dec, comp, mix, ids, w, pool, tr


@pytest.mark.parametrize("workload", ["smollm2_sot_b256",
                                      "mistral7b-w8a8_sot_b256"])
def test_sot_logits_match_the_port(workload, monkeypatch):
    # float weights: w8a8 rounds the activations, which the float32
    # reference does not (the judge measures that on the card)
    cell, enc, dec, comp, mix, ids, w, pool, tr = served(workload,
                                                         precision="bf16")
    from mtasr_tpu_torch.generate import engine
    steps = []
    pick = engine._sample_token

    def recording(logits, gen, generator):
        steps.append(logits.float().clone())
        return pick(logits, gen, generator)
    monkeypatch.setattr(engine, "_sample_token", recording)
    from mtasr_tpu_torch import api
    out = []
    gen = api.generate

    def keep(model, cfg, wav, amask, **kw):
        o = gen(model, cfg, wav, amask, **kw)
        out.append((o.sequences, wav.shape[1]))
        return o
    monkeypatch.setattr(api, "generate", keep)
    wavs = pool[0].wavs
    tr.transcribe(wavs, batch_size=mix["batch"], **mix["call"])
    port = torch.stack(steps, 1)                           # [B, steps, V]
    toks, padded = out[0]
    with float32_exact():
        _, _, speech, mask8 = ref_wavlm.encode_rows(w, enc, wavs, padded,
                                                    CPU)
        speech = linear(w, "enc_to_dec_proj", speech)
        rows = [speech[i, :int(mask8[i].sum())] for i in range(len(wavs))]
        ref = ref_llama.served_logits(w, dec, rows, list(toks), ids["bos"])
    for i, z in enumerate(ref):
        n = port.shape[1]
        scale = float(z.abs().max())
        assert torch.allclose(port[i, :n], z[:n], atol=2e-4 * scale,
                              rtol=0), i
        assert torch.equal(z[:n].argmax(-1), toks[i, :n])


def test_ctc_transcripts_match_the_port():
    cell, enc, dec, comp, mix, ids, w, pool, tr = served("smollm2_ctc_b256")
    wavs = pool[0].wavs
    from mtasr_tpu_torch.generate.engine import generate_ctc
    from mtasr_tpu_torch.data.pipeline import decode_batches
    batch = next(iter(decode_batches(tr._examples(wavs, ""), tr.cfg, tr.dc,
                                     mix["batch"])))
    wav = torch.from_numpy(batch.arrays["input_values"])
    M = mix["call"]["max_out_len"]
    trans, lens = generate_ctc(tr.model, tr.cfg, wav,
                               torch.from_numpy(batch.arrays["audio_mask"]),
                               max_out_len=M)
    with float32_exact():
        mixed, mask0, _, _ = ref_wavlm.encode_rows(w, enc, wavs,
                                                   wav.shape[1], CPU)
        heads = ref_sep.head_logits(w, comp["talker_numbers"], mixed)
    checked = 0
    for i in range(len(wavs)):
        Tv = int(mask0[i].sum())
        for k in range(comp["talker_numbers"]):
            want = J.collapse(heads[k][i, :Tv].argmax(-1).numpy(),
                              ids["blank"], ids["pad"], M)
            got = trans[i, k * M:k * M + int(lens[k, i])].numpy()
            np.testing.assert_array_equal(got, want)
            checked += len(want)
    assert checked > 20


def test_ctc_path_gap_reads_zero_on_its_own_collapse():
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((40, 12)).astype(np.float32))
    cost = (z.max(-1, keepdim=True).values - z) / z.std(-1, keepdim=True)
    y = J.collapse(z.argmax(-1).numpy(), 11, 10, 150)
    assert J.ctc_path_gap(cost, y, 11, 10, 150) == (0.0, 0.0, 0.0)
    bad = y.copy()
    bad[3] = (bad[3] + 1) % 10
    if bad[3] in (bad[2], bad[4]):
        bad[3] = (bad[3] + 1) % 10
    assert min(J.ctc_path_gap(cost, bad, 11, 10, 150)) > 0.0
    assert J.ctc_path_gap(cost, bad, 11, 10, 150)[0] > 0.1
    assert J.ctc_path_gap(cost, y[:-1], 11, 10, 150)[0] > 0.0
    # a served transcript that the collapse cannot give reads INF
    assert J.ctc_path_gap(cost, np.array([3, 3]), 11, 10, 150)[0] == J.INF


def test_int8_weights_dequantize_as_the_port_does():
    cell, enc, dec, comp, mix, ids, w, pool, tr = served(
        "mistral7b-w8a8_sot_b256")
    from bench_h100.reference.common import weight
    from mtasr_tpu_torch.models.layers import QuantLinear
    lin = tr.model.decoder.model.layers["0"].mlp.down_proj
    assert isinstance(lin, QuantLinear)
    got = weight(w, "decoder.model.layers.0.mlp.down_proj")
    want = lin.weight_int8.float() * lin.scale[:, None]
    assert torch.equal(got, want)
