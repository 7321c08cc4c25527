"""Beam search of the port (`mtasr_tpu_torch/generate/beam.py`) against the
JAX package's on the CPU, float32:

* `_top_k_wide` equals `jax.lax.top_k` in values and indices (ties to the
  lower index) below and above its 4096-wide switch; on a row whose
  values are all at or below -1e7, the JAX `_top_k_wide` repeats an index
  (its mask is -1e7) and the port's does not (its mask is -inf);
* `beam_state_*` on the synthetic Markov tables of
  `tests/test_beam_scorer_ab.py`: sequences and lengths bit-equal, scores
  equal, for length penalties 0.5, 1 and 2, with a first-step eos,
  differing finish lengths and the all-done exit;
* `beam_generate` on `tiny_cfg` models: sequences and lengths equal to
  JAX's, scores within 1e-5 (f32 log-softmax sums in two libraries'
  orders), with W 1 and 3, instruct, an int8 KV cache (`int8_cfg`: JAX's
  interpreted int8 kernels; there scores within INT8_SCORE_ATOL),
  `encode_chunk` 1, gatetiny adapters and a decoder LoRA; W = 1 equal to
  the port's greedy decode;
* `Transcriber.transcribe(num_beams=3)` the JAX `Transcriber`'s strings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.api import Transcriber as JaxTranscriber
from mtasr_tpu.config import DataConfig
from mtasr_tpu.data.tokenizer import CharTokenizer
from mtasr_tpu.generate import beam as jbeam
from mtasr_tpu.models.speech_encoder_decoder import init_model_params
from mtasr_tpu.train.lora import init_decoder_lora as jax_init_lora
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.data.tokenizer import CharTokenizer as TCharTokenizer
from mtasr_tpu_torch.generate import beam, engine
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.utils.convert import load_flat
from tests.test_beam_scorer_ab import EOS, PAD, _run_ours, _tables
from tests.test_composite import tiny_cfg
from tests.test_torch_family_slice import family
from tests.test_torch_quantize import int8_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

INSTRUCT_IDS = dict(bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
                    eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)
SCORE_ATOL = 1e-5
# an int8 KV cache: a K / V element (or the kernels' quantized q or p) whose
# f32 value differs by an ulp between the two libraries may round to the
# other int8 step; with the decoder's matrices at 8x (varied tokens) that
# moves the mean log-prob of a beam by up to 9.8e-4 over three input seeds,
# and the sequences stay equal
INT8_SCORE_ATOL = 2e-3


def _port(cfg):
    return tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)


# -- top-k -------------------------------------------------------------------
@pytest.mark.parametrize("N", [300, 5000])
@pytest.mark.parametrize("k", [2, 8])
def test_top_k_wide_matches_lax_top_k(N, k):
    rng = np.random.default_rng(N + k)
    x = rng.integers(-40, 40, (3, N)).astype(np.float32) / 4.0
    x[0, [5, 9, 17, N - 1]] = 50.0           # planted four-way tie
    x[1, :] = 1.0                            # a row of ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = beam._top_k_wide(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    jv, ji = jbeam._top_k_wide(jnp.asarray(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(jv))


def test_top_k_wide_does_not_copy_the_minus_1e7_mask():
    """Values at or below -1e7: the JAX mask (-1e7) makes the first
    chosen index win again; the port's -inf mask gives distinct ones."""
    x = np.full((1, 5000), -2e7, np.float32)
    x[0, 7] = -1e7
    _, ji = jbeam._top_k_wide(jnp.asarray(x), 3)
    assert np.asarray(ji)[0].tolist() == [7, 7, 7]
    v, i = beam._top_k_wide(torch.from_numpy(x), 3)
    assert i[0].tolist() == [7, 0, 1]
    assert v[0].tolist() == [-1e7, -2e7, -2e7]


# -- the pure bookkeeping ------------------------------------------------------
def _run_port(logp0, table, W, T, lp):
    B = logp0.shape[0]
    state = beam.beam_state_init(torch.from_numpy(logp0), W, EOS, PAD, T)
    t = 1
    while t < T and not bool(state[5].all()):
        last = state[0][:, :, t - 1].numpy()
        logp = np.stack([table[t, b, last[b]] for b in range(B)])
        state, _ = beam.beam_state_step(t, torch.from_numpy(logp), state, W,
                                        EOS, lp)
        t += 1
    out = beam.beam_state_finalize(state, W, T, lp)
    return out.sequences.numpy(), out.scores.numpy(), out.lengths.numpy()


TABLES = {
    "first-step-eos": dict(B=3, V=12, T=7, seed=1, first_eos_batch=1),
    "differing-finish": dict(B=2, V=10, T=8, seed=2, eos_ramp=0.6),
    "all-done-exit": dict(B=2, V=9, T=12, seed=3, eos_bias=3.5),
}


@pytest.mark.parametrize("lp", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("case", sorted(TABLES))
def test_beam_state_matches_jax(case, lp):
    kw = dict(TABLES[case])
    B, V, T = kw.pop("B"), kw.pop("V"), kw.pop("T")
    logp0, table = _tables(B, V, T, **kw)
    W = 3
    want = _run_ours(logp0, table, W, T, lp)
    got = _run_port(logp0, table, W, T, lp)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if case == "all-done-exit":
        assert (want[2] < T).all()       # every batch finished early
    if case == "differing-finish":
        assert len(np.unique(want[2])) > 1


# -- beam_generate -------------------------------------------------------------
def _lora_params(cfg, seed):
    params = init_model_params(jax.random.key(seed), cfg)
    params["decoder_lora"] = jax_init_lora(
        jax.random.key(seed + 1), params["decoder"], r=4, alpha=8.0)
    rng = np.random.default_rng(seed + 2)
    for li, projs in params["decoder_lora"].items():
        if li != "__meta__":
            for ab in projs.values():
                ab["lora_B"] = jnp.asarray(rng.standard_normal(
                    ab["lora_B"].shape).astype(np.float32) * 0.05)
    return params


def _pair(case):
    """(JAX cfg, JAX params, port model, generate kwargs) of a case."""
    kw = {}
    if case == "int8":
        cfg = int8_cfg()
        params = init_model_params(jax.random.key(0), cfg)
        params["decoder"] = jax.tree_util.tree_map(
            lambda x: x * 8 if x.ndim == 2 else x, params["decoder"])
        model = SpeechEncoderDecoderModel(_port(cfg))
        load_flat(model, tree_to_flat(params))
        return cfg, params, model, dict(kv_quant=True)
    if case == "instruct":
        cfg = tiny_cfg(train_mode="attention", instruct=True, **INSTRUCT_IDS)
    elif case == "gatetiny":
        cfg = family("gatetiny", "sep", "raw")
    else:
        cfg = tiny_cfg(train_mode="attention")
    if case == "lora":
        params = _lora_params(cfg, 4)
    else:
        params = init_model_params(jax.random.key(2), cfg)
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, tree_to_flat(params), training=case == "lora")
    if case == "encode_chunk":
        kw["encode_chunk"] = 1
    return cfg, params, model, kw


def _inputs(cfg, B=2, S=6000, seed=3):
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((B, S)).astype(np.float32)
    amask = np.ones((B, S), np.int32)
    amask[-1, S * 3 // 5:] = 0
    prompt = None
    if cfg.instruct:
        prompt = np.tile([52, 20, 21, 53, 54, 55, 56], (B, 1))
    return wav, amask, prompt


CASES = [("plain", 1), ("plain", 3), ("instruct", 3), ("int8", 3),
         ("encode_chunk", 3), ("gatetiny", 3), ("lora", 3)]


@pytest.mark.parametrize("case,W", CASES, ids=[f"{c}-W{w}" for c, w in CASES])
def test_beam_generate_matches_jax(case, W):
    cfg, params, model, kw = _pair(case)
    wav, amask, prompt = _inputs(cfg)
    T = 7
    ref = jbeam.beam_generate(
        params, cfg, jnp.asarray(wav), jnp.asarray(amask),
        prompt_ids=None if prompt is None else jnp.asarray(prompt),
        num_beams=W, max_new_tokens=T, length_penalty=1.0, **kw)
    out = beam.beam_generate(
        model, _port(cfg), torch.from_numpy(wav), torch.from_numpy(amask),
        prompt_ids=None if prompt is None else torch.from_numpy(prompt),
        num_beams=W, max_new_tokens=T, length_penalty=1.0, **kw)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(
        out.scores.numpy(), np.asarray(ref.scores), rtol=0,
        atol=INT8_SCORE_ATOL if case == "int8" else SCORE_ATOL)
    assert len(np.unique(out.sequences.numpy())) >= 3
    if W == 1:
        greedy = engine.generate(
            model, _port(cfg), torch.from_numpy(wav),
            torch.from_numpy(amask),
            gen=tconfig.GenerationConfig(**kw), max_new_tokens=T)
        np.testing.assert_array_equal(out.sequences[:, 0].numpy(),
                                      greedy.sequences.numpy())


def test_extra_steps_after_all_done_change_nothing():
    """The host asks whether every batch is done only every
    EOS_CHECK_EVERY steps: steps run past the point where all are done
    leave the finalized output as it was."""
    logp0, table = _tables(2, 9, 16, 3, eos_bias=3.5)
    W, T, lp = 3, 16, 1.0
    state = beam.beam_state_init(torch.from_numpy(logp0), W, EOS, PAD, T)
    snapshots = []
    for t in range(1, T):
        if bool(state[5].all()):
            snapshots.append(beam.beam_state_finalize(state, W, T, lp))
        last = state[0][:, :, t - 1].numpy()
        logp = np.stack([table[t, b, last[b]] for b in range(2)])
        state, _ = beam.beam_state_step(t, torch.from_numpy(logp), state, W,
                                        EOS, lp)
    assert len(snapshots) >= 2
    for s in snapshots[1:] + [beam.beam_state_finalize(state, W, T, lp)]:
        for f in ("sequences", "scores", "lengths"):
            assert torch.equal(getattr(s, f), getattr(snapshots[0], f))


def test_transcriber_beam_matches_jax():
    cfg = tiny_cfg(train_mode="attention")
    tok, ttok = CharTokenizer(), TCharTokenizer()
    sp = tok.add_special_tokens()
    ttok.add_special_tokens()
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    params = init_model_params(jax.random.key(6), cfg)
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, tree_to_flat(params))
    dc = DataConfig(min_duration_in_seconds=0.0, max_duration_in_seconds=1e9,
                    bucket_boundaries_seconds=(0.5,))
    jt = JaxTranscriber(cfg, params, tok, dc=dc)
    tt = Transcriber(_port(cfg), model, ttok,
                     dc=tconfig.from_fields(tconfig.DataConfig, dc))
    rng = np.random.default_rng(9)
    wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (7000, 5000)]
    kw = dict(max_new_tokens=6, batch_size=2, clean=False, num_beams=3)
    texts = tt.transcribe(wavs, **kw)
    assert texts == jt.transcribe(wavs, **kw)
    assert len(set(texts)) > 1
