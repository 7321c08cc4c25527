"""The port's pipelined stream (`mtasr_tpu_torch/generate/pipelined.py`)
against the JAX package's (`mtasr_tpu/generate/pipelined.py`) and against
the port's own `engine.generate` batch by batch, on the CPU (`tiny_cfg`,
JAX's init from a key carried across with `load_flat`, the decoder's
matrices scaled so that the tokens vary, waveforms from a numpy seed whose
rows differ in tone and length, so that every row of a stream decodes
differently). Tokens must be equal, exactly:

* greedy streams of 3 batches of 2, 8 new tokens: attention mode with 3
  encoder layers (the interleave: a layer every 3 steps), hybrid with 1
  layer (nothing to interleave), 4 layers and 3 tokens (the slots
  overrun), the softmax CTC bridge, an instruct prompt, a decoder LoRA, an
  int8 KV cache (`int8_cfg`: Hkv * D = 128, the JAX side through its
  interpreted int8 kernel, as the int8 A/Bs run it);
* sampled decoding: one seeded generator drawn through the stream equals
  sequential `generate` calls drawing from a generator of the same seed;
* a stream whose rows end early (the all-done exit, every EOS_CHECK_EVERY
  steps), so that encoder layers are left when the loop stops and run
  after it;
* the inference CLI with `--pipelined` writes the JAX CLI's `--pipelined`
  `decod` and `wer` (the last batch of another shape ends the run), and
  the port's own without the flag; the audio is read lazily, through both
  packages' native loaders;
* two ranks on gloo (tp = 2 greedy, dp = 2 sampled) equal one process.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.cli import create_from_pretrained as jcreate
from mtasr_tpu.cli import inference_asr as jinference
from mtasr_tpu.config import GenerationConfig as JaxGenerationConfig
from mtasr_tpu.data.audio import write_wav
from mtasr_tpu.generate.pipelined import (
    generate_pipelined as jax_generate_pipelined,
)
from mtasr_tpu.models.speech_encoder_decoder import init_model_params
from mtasr_tpu.train.lora import init_decoder_lora
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.cli import inference_asr as tinference
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.generate.pipelined import generate_pipelined
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.utils.convert import load_flat
from tests._torch_parallel_worker import Ranks
from tests.test_composite import EOS, tiny_cfg
from tests.test_torch_quantize import int8_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

INSTRUCT_IDS = dict(bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
                    eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)
PROMPT = [52, 20, 21, 53, 54, 55, 56]


def _tiny(mode, n_layers, **kw):
    cfg = tiny_cfg(train_mode=mode, talker_ctc=mode != "attention", **kw)
    cfg.encoder.num_hidden_layers = n_layers
    return cfg


def _model(cfg, seed=0, lora=False, decoder_scale=30.0):
    """(port config, port model, JAX parameters): JAX's init, the
    decoder's matrices scaled by `decoder_scale` (at the init's 0.02 the
    random decoder repeats one token)."""
    params = init_model_params(jax.random.key(seed), cfg)
    params["decoder"] = jax.tree_util.tree_map(
        lambda x: x * decoder_scale if x.ndim == 2 else x, params["decoder"])
    if lora:
        params["decoder_lora"] = init_decoder_lora(
            jax.random.key(seed + 1), params["decoder"], r=4, alpha=8.0)
        rng = np.random.default_rng(seed + 2)
        for li, projs in params["decoder_lora"].items():
            if li != "__meta__":
                for ab in projs.values():
                    ab["lora_B"] = jnp.asarray(rng.standard_normal(
                        ab["lora_B"].shape).astype(np.float32) * 0.05)
    pcfg = tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)
    model = SpeechEncoderDecoderModel(pcfg)
    load_flat(model, tree_to_flat(params), training=lora)
    return pcfg, model.eval(), params


def _stream(n=3, B=2, S=8000, seed=0, instruct=False):
    """n batches (numpy dicts): tones of random pitch and level in noise,
    every row cut to its own length."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 16000
    out = []
    for _ in range(n):
        f, a = rng.uniform(100, 3000, (B, 1)), rng.uniform(0.2, 2.0, (B, 1))
        wav = (a * np.sin(2 * np.pi * f * t)
               + 0.1 * rng.standard_normal((B, S))).astype(np.float32)
        amask = np.ones((B, S), np.int32)
        for b in range(B):
            amask[b, rng.integers(S // 2, S + 1):] = 0
        d = {"input_values": wav, "audio_mask": amask}
        if instruct:
            d["prompt_ids"] = np.tile(PROMPT, (B, 1))
        out.append(d)
    return out


def _torch(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def _sequential(model, cfg, batches, gen, max_new, generator=None):
    return [engine.generate(model, cfg, b["input_values"], b["audio_mask"],
                            prompt_ids=b.get("prompt_ids"), gen=gen,
                            generator=generator, max_new_tokens=max_new)
            for b in _torch(batches)]


CASES = {
    "attention-3": lambda: (_tiny("attention", 3), {}, {}, 8, 3),
    "hybrid-1": lambda: (_tiny("hybrid", 1), {}, {}, 8, 3),
    "overrun": lambda: (_tiny("attention", 4), {}, {}, 3, 2),
    "ctc-bridge": lambda: (_tiny("hybrid", 2, ctc_bridge=True,
                                 ctc_bridge_type="softmax"), {}, {}, 6, 2),
    "instruct": lambda: (_tiny("attention", 3, instruct=True,
                               **INSTRUCT_IDS), {}, {}, 8, 3),
    "lora": lambda: (_tiny("attention", 3), dict(lora=True), {}, 8, 3),
    "int8-kv": lambda: (_int8(), dict(decoder_scale=8.0),
                        dict(kv_quant=True), 8, 3),
}


def _int8():
    cfg = int8_cfg()
    cfg.encoder.num_hidden_layers = 3
    return cfg


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_matches_jax_and_sequential_generate(case):
    cfg, model_kw, gen_kw, max_new, n = CASES[case]()
    pcfg, model, params = _model(cfg, **model_kw)
    batches = _stream(n=n, instruct=cfg.instruct)
    ref = jax_generate_pipelined(
        params, cfg, [{k: jnp.asarray(v) for k, v in b.items()}
                      for b in batches],
        gen=JaxGenerationConfig(**gen_kw), max_new_tokens=max_new)
    gen = tconfig.GenerationConfig(**gen_kw)
    outs = generate_pipelined(model, pcfg, _torch(batches), gen=gen,
                              max_new_tokens=max_new)
    seq = _sequential(model, pcfg, batches, gen, max_new)
    assert len(outs) == len(ref) == n
    for i in range(n):
        np.testing.assert_array_equal(outs[i].sequences.numpy(),
                                      np.asarray(ref[i].sequences),
                                      err_msg=f"{case} batch {i} vs JAX")
        np.testing.assert_array_equal(outs[i].lengths.numpy(),
                                      np.asarray(ref[i].lengths))
        assert torch.equal(outs[i].sequences, seq[i].sequences), i
        assert outs[i].steps == seq[i].steps
    rows = {tuple(r) for o in outs for r in o.sequences.tolist()}
    assert len(rows) >= (2 if case == "overrun" else n), rows
    if case == "attention-3":      # every row of the stream its own tokens
        assert len(rows) == 2 * n


def test_sampled_stream_draws_as_sequential_generate():
    pcfg, model, _ = _model(_tiny("attention", 3))
    batches = _stream(seed=1)
    gen = tconfig.GenerationConfig(do_sample=True, temperature=1.5,
                                   top_k=20)
    outs = generate_pipelined(model, pcfg, _torch(batches), gen=gen,
                              max_new_tokens=8,
                              generator=torch.Generator().manual_seed(5))
    seq = _sequential(model, pcfg, batches, gen, 8,
                      torch.Generator().manual_seed(5))
    for o, s in zip(outs, seq):
        assert torch.equal(o.sequences, s.sequences)
    greedy = _sequential(model, pcfg, batches, tconfig.GenerationConfig(), 8)
    assert any(not torch.equal(o.sequences, g.sequences)
               for o, g in zip(outs, greedy))


def test_rows_that_end_early_leave_layers_that_still_run(monkeypatch):
    """A token is eos when its argmax is a multiple of 4, so rows end
    early; the loop stops at an all-done check (every 8 steps) while
    encoder layers of the next batch are still to run."""
    real = engine._sample_token

    def eos_often(logits, gen, generator):
        tok = real(logits, gen, generator)
        return torch.where(tok % 4 == 0, EOS, tok)
    monkeypatch.setattr(engine, "_sample_token", eos_often)
    pcfg, model, _ = _model(_tiny("attention", 3))
    batches = _stream(n=4, seed=2)
    gen = tconfig.GenerationConfig()
    outs = generate_pipelined(model, pcfg, _torch(batches), gen=gen,
                              max_new_tokens=20)
    seq = _sequential(model, pcfg, batches, gen, 20)
    for o, s in zip(outs, seq):
        assert torch.equal(o.sequences, s.sequences)
        assert o.steps == s.steps
    # k = 19 // 2 = 9: layer 2 runs after step 18; a batch that stopped
    # sooner (all its rows done) left it for after the loop
    assert min(o.steps for o in outs[:-1]) < 18, [o.steps for o in outs]
    assert (outs[0].sequences == EOS).any()


def test_speculative_is_refused():
    pcfg, model, _ = _model(_tiny("attention", 1))
    with pytest.raises(ValueError, match="speculative"):
        generate_pipelined(model, pcfg, _torch(_stream(n=1)),
                           gen=tconfig.GenerationConfig(speculative="ctc"))


# ---------------------------------------------------------------------------
# the inference CLI
# ---------------------------------------------------------------------------
def _kaldi_dir(root, n=5):
    d = root / "data"
    d.mkdir()
    rng = np.random.default_rng(0)
    texts = ["hi there<sc>good day", "one two<sc>three four",
             "cat sat<sc>dog ran", "go now<sc>stay here", "a b<sc>c d"]
    with open(d / "wav.scp", "w") as fw, open(d / "text", "w") as ft:
        for i in range(n):
            p = str(d / f"u{i}.wav")
            write_wav(p, rng.standard_normal(int(rng.uniform(0.4, 0.6)
                                                 * 16000)) * 0.1)
            fw.write(f"u{i} {p}\n")
            ft.write(f"u{i} {texts[i]}\n")
    return str(d)


def test_inference_cli_pipelined_matches_the_jax_cli(tmp_path):
    model = str(tmp_path / "jm")
    jcreate.main(["--init_random", "tiny", "--output_dir", model])
    data = _kaldi_dir(tmp_path)

    def infer(out, *extra, jax_cli=False):
        argv = ["--model_name_or_path", model, "--data_dir", data,
                "--output_dir", str(tmp_path / out), "--batch_size", "2",
                "--max_duration_in_seconds", "2.0", "--max_length", "10",
                *extra]
        if jax_cli:
            jinference.main(argv + ["--dp_size", "1"])
        else:
            tinference.main(argv + ["--device", "cpu"])
        return [open(tmp_path / out / name).read()
                for name in ("decod", "wer")]
    ref = infer("j", "--pipelined", jax_cli=True)
    got = infer("t", "--pipelined")
    assert got == ref
    assert len(got[0].splitlines()) == 5     # batches of 2, 2 and 1
    assert infer("plain") == got


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------
def test_two_ranks_equal_one_process(tmp_path):
    cfg = _tiny("attention", 3)
    cfg.encoder.num_attention_heads = 4
    pcfg, model, params = _model(cfg, decoder_scale=8.0)
    batches = _stream(n=3, B=4, seed=3)
    flat = {k: np.asarray(v) for k, v in tree_to_flat(params).items()}
    greedy = tconfig.GenerationConfig()
    sampled = tconfig.GenerationConfig(do_sample=True, temperature=1.5,
                                       top_k=20)
    base = dict(kind="serve", route="pipelined", cfg=pcfg, flat=flat,
                stream=batches, max_new_tokens=8)
    job = str(tmp_path / "job.pt")
    torch.save({"scenarios": {
        "tp": dict(base, gen=greedy, mesh=(1, 2)),
        "dp": dict(base, gen=sampled, mesh=(2, 1), sample_seed=7)}}, job)
    ranks = Ranks(job, 2)
    want = {
        "tp": generate_pipelined(model, pcfg, _torch(batches), gen=greedy,
                                 max_new_tokens=8),
        "dp": generate_pipelined(model, pcfg, _torch(batches), gen=sampled,
                                 max_new_tokens=8,
                                 generator=torch.Generator().manual_seed(7))}
    res = ranks.results()
    for name, outs in want.items():
        for r in range(2):
            got = res[r][name]["sequences"]
            assert len(got) == len(outs)
            for i, o in enumerate(outs):
                np.testing.assert_array_equal(
                    got[i], o.sequences.numpy(),
                    err_msg=f"{name} rank {r} batch {i}")
