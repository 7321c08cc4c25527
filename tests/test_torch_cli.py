"""The port's CLIs (`mtasr_tpu_torch/cli/`) and its sampling filter, on the
CPU (`--device cpu`).

* The parsers carry every dest of the JAX package's, with its default,
  type and choices; the port adds `--device` alone.
* create -> finetune (2 steps, resumed to 4; attention mode, with CTC
  heads for the CTC decode) -> inference (greedy, CTC, w8a8 + int8 KV,
  two shards) -> merge / WER on the JAX e2e test's mini dataset
  (`tests/test_cli_e2e.py:15-30`).
* The port's inference CLI on a directory the JAX CLI created writes the
  same `decod` text as the JAX inference CLI, greedy and CTC.
* Top-k / top-p: the survivor sets of `engine.filter_logits` against the
  JAX engine's filter on the same logits: identical in float32, and for
  top-k in bfloat16; for top-p in bfloat16 a token may differ only where
  its cumulative probability straddles top_p within 2^-5 (the two sides
  round a 128k-long bf16 cumulative sum in different orders); every token
  survives, and sampling runs, where the sum never reaches top_p."""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.cli import args as jargs
from mtasr_tpu.cli import create_from_pretrained as jcreate
from mtasr_tpu.cli import finetune_asr as jfinetune
from mtasr_tpu.cli import inference_asr as jinference
from mtasr_tpu.config import GenerationConfig as JaxGenerationConfig
from mtasr_tpu.data.audio import write_wav
from mtasr_tpu.generate import engine as jengine
from mtasr_tpu_torch.cli import args as targs
from mtasr_tpu_torch.cli import create_from_pretrained as tcreate
from mtasr_tpu_torch.cli import finetune_asr as tfinetune
from mtasr_tpu_torch.cli import inference_asr as tinference
from mtasr_tpu_torch.config import GenerationConfig
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.utils import model_io

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


class _Stop(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The parser a CLI's `main` builds, caught at `parse_args`."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["p"] = self
        raise _Stop
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Stop):
        main(["x"])
    monkeypatch.undo()
    return seen["p"]


def _spec(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        typ = a.type
        if callable(typ) and getattr(typ, "__name__", "") == "<lambda>":
            typ = ("lambda", typ("false"), typ("true"))
        out[a.dest] = (a.default, typ, tuple(a.choices or ()), a.required,
                       a.const, a.nargs, type(a).__name__)
    return out


@pytest.mark.parametrize("which", ["create", "finetune", "inference",
                                   "groups"])
def test_parsers_match_the_jax_clis(which, monkeypatch):
    if which == "create":
        ref = _parser_of(jcreate.main, monkeypatch)
        port = tcreate.build_argparser()
    elif which == "finetune":
        ref, port = jfinetune.build_argparser(), tfinetune.build_argparser()
    elif which == "inference":
        ref, port = jinference.build_argparser(), tinference.build_argparser()
    else:
        ref, port = argparse.ArgumentParser(), argparse.ArgumentParser()
        for name in ("add_model_args", "add_data_args", "add_training_args",
                     "add_generation_args"):
            getattr(jargs, name)(ref)
            getattr(targs, name)(port)
        port.add_argument("--device")
    a, b = _spec(ref), _spec(port)
    assert set(b) - set(a) == {"device"}
    assert set(a) <= set(b)
    for dest in a:
        assert b[dest] == a[dest], dest
    assert b["device"][0] in ("cuda", None)


@pytest.fixture(scope="module")
def mini_dataset(tmp_path_factory):
    """The JAX e2e test's Kaldi mini dataset: 4 utterances of 0.5 s."""
    d = tmp_path_factory.mktemp("libri2mix_mini") / "train"
    d.mkdir()
    rng = np.random.default_rng(0)
    texts = ["hi there<sc>good day", "one two<sc>three four",
             "cat sat<sc>dog ran", "go now<sc>stay here"]
    with open(d / "wav.scp", "w") as fw, open(d / "text", "w") as ft:
        for i, t in enumerate(texts):
            p = str(d / f"u{i}.wav")
            write_wav(p, rng.standard_normal(8000) * 0.1)
            fw.write(f"u{i} {p}\n")
            ft.write(f"u{i} {t}\n")
    return str(d)


def _infer(model_dir, data, out, *extra, jax_cli=False):
    argv = ["--model_name_or_path", model_dir, "--data_dir", data,
            "--output_dir", out, "--batch_size", "2",
            "--max_duration_in_seconds", "2.0", "--max_length", "12",
            "--eager_audio", *extra]
    if jax_cli:
        jinference.main(argv + ["--dp_size", "1"])
    else:
        tinference.main(argv + ["--device", "cpu"])
    with open(os.path.join(out, "decod")) as f:
        return f.read()


def test_cli_pipeline(mini_dataset, tmp_path):
    """create -> finetune (2 steps, then the same command to 4 resumes at
    step 3; bit-equality of a resume is `test_torch_checkpoint.py`'s) ->
    inference -> merge / WER."""
    m0, data = str(tmp_path / "m0"), mini_dataset
    tcreate.main(["--init_random", "tiny", "--talker_ctc", "--output_dir",
                  m0, "--check_generate", "--device", "cpu"])
    assert sorted(os.listdir(m0)) == ["char_tokenizer.json", "config.json",
                                      "model.safetensors"]

    def finetune(exp, steps):
        return tfinetune.main([
            "--model_name_or_path", m0, "--data_dir", data,
            "--output_dir", exp, "--talker_ctc",
            "--use_lora", "--per_device_train_batch_size", "2",
            "--max_duration_in_seconds", "2.0", "--learning_rate", "1e-3",
            "--warmup_steps", "1", "--logging_steps", "1",
            "--eval_steps", "100", "--save_steps", "2",
            "--max_steps", str(steps), "--device", "cpu"])

    exp = str(tmp_path / "exp")
    first = finetune(exp, 2)
    assert first.state.step == 2
    resumed = finetune(exp, 4)
    assert resumed.state.step == 4 and resumed.metrics_log[0]["step"] == 3
    assert {"checkpoint-2", "checkpoint-4", "final",
            "model_unmerge"} <= set(os.listdir(exp))
    with pytest.raises(ValueError, match="non-empty"):
        tfinetune.main(["--model_name_or_path", m0, "--data_dir", data,
                        "--output_dir", m0, "--device", "cpu"])

    final = os.path.join(exp, "final")
    dec = str(tmp_path / "dec")
    greedy = _infer(final, data, dec)
    assert len(greedy.splitlines()) == 4
    report = open(os.path.join(dec, "wer")).read()
    assert report.startswith("Overall -> ")
    for extra in (["--ctc_decoding"], ["--quantize", "w8a8", "--kv_quant"]):
        out = _infer(final, data, str(tmp_path / extra[0].strip("-")),
                     *extra)
        assert [l.split()[0] for l in out.splitlines()] == \
            ["u0", "u1", "u2", "u3"]
    shards = str(tmp_path / "sharded")
    for shard in ("0", "1"):
        tinference.main(["--model_name_or_path", final, "--data_dir", data,
                         "--output_dir", shards, "--batch_size", "2",
                         "--max_duration_in_seconds", "2.0",
                         "--max_length", "12", "--eager_audio",
                         "--shard_index", shard, "--num_shards", "2",
                         "--device", "cpu"])
    tinference.main(["--model_name_or_path", final, "--data_dir", data,
                     "--output_dir", shards, "--num_shards", "2", "--merge"])
    assert open(os.path.join(shards, "decod")).read() == greedy


@pytest.mark.parametrize("mode", ["greedy", "ctc"])
def test_inference_cli_matches_jax_on_a_jax_created_dir(mini_dataset,
                                                        tmp_path, mode):
    """A directory made by the JAX create CLI; the same `decod` text from
    both inference CLIs."""
    model = str(tmp_path / "jm")
    jcreate.main(["--init_random", "tiny", "--talker_ctc", "--train_mode",
                  "hybrid", "--output_dir", model])
    extra = ["--ctc_decoding"] if mode == "ctc" else []
    ref = _infer(model, mini_dataset, str(tmp_path / "j"), *extra,
                 jax_cli=True)
    got = _infer(model, mini_dataset, str(tmp_path / "t"), *extra)
    assert got == ref
    assert open(tmp_path / "t" / "wer").read() == \
        open(tmp_path / "j" / "wer").read()


def test_unported_flags_and_incompatible_combinations_refuse(
        tmp_path, mini_dataset):
    """No flag of the JAX CLIs is refused any more; incompatible decode
    flags exit. The bridge and adapter family's flags (item 6) are
    ported: the create CLI builds adapters, the fine-tune CLI trains with
    the flags passed onto the config, the inference CLI takes them. The
    decoding variants (item 7) run: `--speculative ctc` decodes the
    directory to greedy's own text, `--num_beams 2` to the JAX CLI's, and
    `--pipelined` to the JAX CLI's `--pipelined` text."""
    common = ["--model_name_or_path", "unused", "--data_dir", "unused",
              "--output_dir", str(tmp_path), "--device", "cpu"]
    # data and tensor parallelism run (tests/test_torch_parallel*.py); a
    # grid that does not cover the ranks (one process here) raises
    for flags in (["--dp_size", "2"], ["--tp_size", "2"]):
        with pytest.raises(ValueError, match="ranks"):
            tinference.main(common + flags)
    for flags in (["--pipelined", "--ctc_decoding"],
                  ["--num_beams", "2", "--speculative", "ctc"],
                  ["--num_beams", "2", "--do_sample"]):
        with pytest.raises(SystemExit):
            tinference.main(common + flags)
    with pytest.raises(ValueError, match="4x1 != 1 ranks"):
        tfinetune.main(common + ["--dp_size", "4"])
    model = str(tmp_path / "fam")
    tcreate.main(["--init_random", "tiny", "--talker_ctc", "--train_mode",
                  "hybrid", "--decoder_cross_attention",
                  "--decoder_cross_attention_type", "gatetiny",
                  "--output_dir", model, "--device", "cpu"])
    cfg = model_io.read_config(model)
    assert cfg.decoder_cross_attention and \
        cfg.decoder_cross_attention_type == "gatetiny"
    assert "cross_att_adap.1.gate_logit" in model_io.read_flat(model)
    for flags in (["--ctc_bridge"], ["--decoder_cross_attention"]):
        out = _infer(model, mini_dataset, str(tmp_path / flags[0][2:]),
                     *flags)
        assert len(out.splitlines()) == 4
    piped = _infer(model, mini_dataset, str(tmp_path / "pipe"),
                   "--pipelined")
    assert piped == _infer(model, mini_dataset, str(tmp_path / "jpipe"),
                           "--pipelined", jax_cli=True)
    assert len(piped.splitlines()) == 4
    greedy = _infer(model, mini_dataset, str(tmp_path / "greedy"))
    assert piped == greedy
    assert _infer(model, mini_dataset, str(tmp_path / "spec"),
                  "--speculative", "ctc") == greedy
    beam = ("--num_beams", "2", "--length_penalty", "0.5")
    assert _infer(model, mini_dataset, str(tmp_path / "beam"), *beam) == \
        _infer(model, mini_dataset, str(tmp_path / "jbeam"), *beam,
               jax_cli=True)
    trainer = tfinetune.main([
        "--model_name_or_path", model, "--data_dir", mini_dataset,
        "--output_dir", str(tmp_path / "ft"), "--talker_ctc", "--train_mode",
        "hybrid", "--ctc_bridge", "--ctc_bridge_type", "raw",
        "--decoder_cross_attention", "--decoder_cross_attention_type",
        "gatetiny", "--decoder_cross_attention_feature", "sep",
        "--per_device_train_batch_size", "2", "--max_duration_in_seconds",
        "2.0", "--warmup_steps", "0", "--eval_steps", "100", "--save_steps",
        "100", "--max_steps", "1", "--device", "cpu"])
    assert trainer.state.step == 1
    assert trainer.cfg.ctc_bridge and \
        trainer.cfg.decoder_cross_attention_feature == "sep"


# ---------------------------------------------------------------------------
# top-k / top-p
# ---------------------------------------------------------------------------
def _jax_filter(logits, gen):
    """The JAX engine's filter: its `_sample_token` with the draw replaced
    by the identity, so it returns the filtered logits."""
    real = jax.random.categorical
    jax.random.categorical = lambda rng, lg, axis=-1: lg
    try:
        return np.asarray(jax.jit(lambda x: jengine._sample_token(
            x, gen, None))(logits).astype(jnp.float32))
    finally:
        jax.random.categorical = real


def _survivors(V, scale, dtype, top_k, top_p, temperature=1.0, seed=0):
    x = (np.random.default_rng(seed).standard_normal((4, V)) * scale
         ).astype(np.float32)
    jgen = JaxGenerationConfig(do_sample=True, top_k=top_k, top_p=top_p,
                               temperature=temperature)
    tgen = GenerationConfig(do_sample=True, top_k=top_k, top_p=top_p,
                            temperature=temperature)
    ref = _jax_filter(jnp.asarray(x).astype(dtype), jgen) > -1e29
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = engine.filter_logits(tx, tgen)
    assert got.dtype == tx.dtype
    return x, ref, got.float().numpy() > -1e29


@pytest.mark.parametrize("V,scale,top_k,top_p,temperature", [
    (1000, 1.0, 0, 0.9, 1.0), (1000, 1.0, 50, 0.95, 0.7),
    (1000, 3.0, 0, 0.5, 1.0), (128264, 1.0, 0, 0.9, 1.0),
    (128264, 1.0, 20, 1.0, 1.0), (128264, 0.1, 0, 0.9, 1.0)])
def test_top_k_top_p_survivors_match_jax_in_float32(V, scale, top_k, top_p,
                                                    temperature):
    _, ref, got = _survivors(V, scale, "float32", top_k, top_p,
                             temperature)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size


def test_top_k_survivors_match_jax_in_bfloat16():
    for V, k in ((1000, 50), (128264, 20)):
        _, ref, got = _survivors(V, 1.0, "bfloat16", k, 1.0)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("V,scale,top_k,top_p", [
    (1000, 1.0, 0, 0.9), (128264, 1.0, 0, 0.9), (128264, 0.1, 0, 0.5),
    (5000, 3.0, 50, 0.95)])
def test_top_p_survivors_match_jax_in_bfloat16_at_the_boundary(V, scale,
                                                               top_k, top_p):
    x, ref, got = _survivors(V, scale, "bfloat16", top_k, top_p)
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    if top_k:
        kth = np.sort(xb, -1)[:, -top_k][:, None]
        xb = np.where(xb < kth, -np.inf, xb)
    p = np.exp(xb - xb.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    for r in range(x.shape[0]):
        # the probability mass above a token and up to and with it (ties
        # counted together), from the values in ascending order
        order = np.argsort(xb[r])
        vals, cum = xb[r][order], np.cumsum(p[r][order][::-1])[::-1]
        mis = xb[r][got[r] != ref[r]]
        lo = np.searchsorted(vals, mis, "left")
        hi = np.searchsorted(vals, mis, "right")
        through = cum[lo]
        before = np.where(hi < len(vals), cum[np.minimum(hi, len(vals) - 1)],
                          0.0)
        assert np.all(before - 2 ** -5 <= top_p), r
        assert np.all(top_p <= through + 2 ** -5), r
    assert (got != ref).mean() < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_p_keeps_every_token_where_the_sum_never_reaches_it(dtype):
    """randn x 0.1 over 128264 ids, top_p 0.99999999: the cumulative sum
    ends below top_p in float32, so the cutoff is V, which once indexed
    past the end; every token is kept, as JAX keeps them, and sampling
    runs."""
    x, ref, got = _survivors(128264, 0.1, dtype, 0, 0.99999999)
    if dtype == "float32":
        assert got.all() and ref.all()
    else:
        assert got.mean() > 0.99 and ref.mean() > 0.99
    g = torch.Generator().manual_seed(0)
    tok = engine._sample_token(torch.from_numpy(x).to(getattr(torch, dtype)),
                               GenerationConfig(do_sample=True,
                                                top_p=0.99999999), g)
    assert tok.shape == (4,) and bool((tok >= 0).all())


def test_prepare_examples_match_jax_with_cache_and_pool(mini_dataset,
                                                        tmp_path,
                                                        monkeypatch):
    """The Kaldi dir's utterances and their prepared examples (labels,
    prompt ids, lengths; the waveforms when eager, the paths when lazy)
    equal the JAX package's; the JSONL cache is read back under the same
    settings and rebuilt under others; two spawned workers give the same
    examples; the duration filter drops what is out of bounds."""
    import dataclasses

    from mtasr_tpu.config import DataConfig as JaxDataConfig
    from mtasr_tpu.data import audio as jaudio
    from mtasr_tpu.data import pipeline as jpipe
    from mtasr_tpu.data import tokenizer as jtok
    from mtasr_tpu_torch.config import DataConfig
    from mtasr_tpu_torch.data import audio as taudio
    from mtasr_tpu_torch.data import pipeline as tpipe
    from mtasr_tpu_torch.data import tokenizer as ttok
    jt, tt = jtok.CharTokenizer(), ttok.CharTokenizer()
    jt.add_special_tokens()
    tt.add_special_tokens()
    ju = jaudio.load_kaldi_dir(mini_dataset, prompt="p")
    tu = taudio.load_kaldi_dir(mini_dataset, prompt="p")
    assert [dataclasses.astuple(u) for u in tu] == \
        [dataclasses.astuple(u) for u in ju]
    dc = DataConfig(max_duration_in_seconds=2.0)

    def rows(examples):
        return [(e.utt_id, list(e.labels), list(e.prompt_ids), e.n_samples,
                 e.wav_path) for e in examples]
    for lazy in (True, False):
        jx = jpipe.prepare_examples(ju, jt, JaxDataConfig(
            max_duration_in_seconds=2.0), lazy=lazy)
        tx = tpipe.prepare_examples(tu, tt, dc, lazy=lazy)
        assert rows(tx) == rows(jx)
        for a, b in zip(tx, jx):
            np.testing.assert_array_equal(a.waveform(dc), b.waveform(dc))
    cache = str(tmp_path / "prep.jsonl")
    first = tpipe.prepare_examples(tu, tt, dc, cache_path=cache)
    stamp = open(cache).readline()
    assert rows(tpipe.prepare_examples(tu, tt, dc, cache_path=cache)) == \
        rows(first)
    upper = DataConfig(max_duration_in_seconds=2.0, do_lower_case=False)
    tpipe.prepare_examples(tu, tt, upper, cache_path=cache)
    assert open(cache).readline() != stamp
    # the spawned workers take the parent's environment: one thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert rows(tpipe.prepare_examples(tu, tt, dc, num_proc=2)) == \
        rows(first)
    assert tpipe.prepare_examples(
        tu, tt, DataConfig(max_duration_in_seconds=0.4)) == []
