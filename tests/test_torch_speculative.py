"""Speculative decoding of the port (`mtasr_tpu_torch/generate/
speculative.py`) against the JAX package's on the CPU, float32:

* `ctc_sot_draft` equals JAX's, at the layout test's cap of 6 tokens a
  speaker (`tests/test_speculative.py:134`) and at 12;
* `generate_speculative` with CTC, oracle (greedy's own tokens),
  adversarial (pad) and mixed drafts (oracle in row 0, pads in row 1,
  `spec_cache_factor` 1.0, so the slot budget runs out and the one-token
  fallback finishes), in instruct mode, with an int8 KV cache (`int8_cfg`:
  the chunk kernel #7 and #6 interpreted on the JAX side) and with
  gatetiny adapters: sequences equal to JAX's and to the port's greedy
  decode, every `SpecStats` field equal to JAX's;
* spec_k = 16 (a chunk of 17 positions: plain attention over the cache)
  stays exact;
* the JAX package's refusals: sampling, no CTC heads, an unknown source;
* `engine.generate(speculative="ctc")` takes the speculative route;
* `use_cache=False` decodes as the JAX package does (neither reads it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.config import GenerationConfig
from mtasr_tpu.generate import generate as jax_generate
from mtasr_tpu.generate import speculative as jspec
from mtasr_tpu.models.speech_encoder_decoder import (
    encode_speech as jax_encode, init_model_params,
)
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.generate import engine, speculative
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel, encode_speech,
)
from mtasr_tpu_torch.utils.convert import load_flat
from tests.test_composite import PAD, make_batch, tiny_cfg
from tests.test_torch_family_slice import family
from tests.test_torch_quantize import int8_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

INSTRUCT_IDS = dict(bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
                    eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)
MAX_NEW = 12


def _port(cfg):
    return tconfig.from_fields(
        tconfig.GenerationConfig if isinstance(cfg, GenerationConfig)
        else tconfig.SpeechEncoderDecoderConfig, cfg)


def _pair(case="hybrid"):
    """(JAX cfg, params, port model, wav, amask, prompt or None)."""
    if case == "int8":
        cfg = int8_cfg()
        params = init_model_params(jax.random.key(0), cfg)
        params["decoder"] = jax.tree_util.tree_map(
            lambda x: x * 8 if x.ndim == 2 else x, params["decoder"])
    else:
        if case == "instruct":
            cfg = tiny_cfg(train_mode="hybrid", talker_ctc=True,
                           instruct=True, **INSTRUCT_IDS)
        elif case == "gatetiny":
            cfg = family("gatetiny", "sep", "raw")
        else:
            cfg = tiny_cfg(train_mode="hybrid", talker_ctc=True)
        params = init_model_params(jax.random.key(4 if case == "instruct"
                                                  else 3), cfg)
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, tree_to_flat(params))
    wav, amask, _ = make_batch(cfg, seed=5)
    prompt = None
    if cfg.instruct:
        prompt = np.tile(np.array([[52, 30, 31, 53, 54, 55, 56]]), (2, 1))
    return cfg, params, model, wav, amask, prompt


def _run_both(case, gen, draft=None, mn=MAX_NEW):
    """(JAX output, JAX stats, port output, port stats, port greedy)."""
    cfg, params, model, wav, amask, prompt = _pair(case)
    jp = None if prompt is None else jnp.asarray(prompt)
    tp = None if prompt is None else torch.from_numpy(prompt)
    if draft in ("oracle", "mixed"):
        oracle = np.array(jax_generate(
            params, cfg, jnp.asarray(wav), jnp.asarray(amask), prompt_ids=jp,
            gen=GenerationConfig(kv_quant=gen.kv_quant),
            max_new_tokens=mn).sequences)
        if draft == "mixed":          # row 0 oracle, row 1 pads
            oracle[1] = PAD
        draft = oracle
    elif draft == "pad":
        draft = np.full((wav.shape[0], mn), PAD, np.int32)
    jout, jst = jspec.generate_speculative(
        params, cfg, jnp.asarray(wav), jnp.asarray(amask), prompt_ids=jp,
        gen=gen, max_new_tokens=mn,
        draft_tokens=None if draft is None else jnp.asarray(draft))
    tout, tst = speculative.generate_speculative(
        model, _port(cfg), torch.from_numpy(wav), torch.from_numpy(amask),
        prompt_ids=tp, gen=_port(gen), max_new_tokens=mn,
        draft_tokens=None if draft is None else torch.from_numpy(draft))
    greedy = engine.generate(
        model, _port(cfg), torch.from_numpy(wav), torch.from_numpy(amask),
        prompt_ids=tp, gen=tconfig.GenerationConfig(kv_quant=gen.kv_quant),
        max_new_tokens=mn)
    return jout, jst, tout, tst, greedy


def _check(jout, jst, tout, tst, greedy):
    seqs = tout.sequences.numpy()
    np.testing.assert_array_equal(seqs, np.asarray(jout.sequences))
    np.testing.assert_array_equal(seqs, greedy.sequences.numpy())
    np.testing.assert_array_equal(tout.lengths.numpy(),
                                  np.asarray(jout.lengths))
    assert tst.spec_steps == int(jst.spec_steps)
    assert tst.accepted_drafts == int(jst.accepted_drafts)
    assert tst.fallback_steps == int(jst.fallback_steps)
    np.testing.assert_array_equal(tst.emitted.numpy(),
                                  np.asarray(jst.emitted))
    np.testing.assert_array_equal(tst.emitted.numpy(),
                                  (seqs != PAD).sum(1))


@pytest.mark.parametrize("mol", [6, 12])
def test_ctc_sot_draft_matches_jax(mol):
    cfg, params, model, wav, amask, _ = _pair()
    want = np.asarray(jspec.ctc_sot_draft(
        params, cfg, jax_encode(params, cfg, jnp.asarray(wav),
                                jnp.asarray(amask)), max_out_len=mol))
    with torch.inference_mode():
        enc = encode_speech(model, _port(cfg), torch.from_numpy(wav),
                            torch.from_numpy(amask))
        got = speculative.ctc_sot_draft(model, _port(cfg), enc,
                                        max_out_len=mol)
    assert got.shape == (2, 2 * mol + 2)
    np.testing.assert_array_equal(got.numpy(), want)


GEN = GenerationConfig(do_sample=False, speculative="ctc", spec_k=3)
CASES = {
    "ctc": ("hybrid", GEN, None),
    "oracle": ("hybrid", GEN, "oracle"),
    "adversarial": ("hybrid", GEN, "pad"),
    "mixed": ("hybrid", GenerationConfig(do_sample=False, speculative="ctc",
                                         spec_k=3, spec_cache_factor=1.0),
              "mixed"),
    "instruct": ("instruct", GenerationConfig(do_sample=False,
                                              speculative="ctc", spec_k=4),
                 None),
    "int8-oracle": ("int8", GenerationConfig(speculative="ctc", spec_k=4,
                                             kv_quant=True), "oracle"),
    "int8-mixed": ("int8", GenerationConfig(speculative="ctc", spec_k=4,
                                            kv_quant=True,
                                            spec_cache_factor=1.0), "mixed"),
    "gatetiny": ("gatetiny", GEN, None),
    "spec_k-16": ("hybrid", GenerationConfig(speculative="ctc", spec_k=16),
                  "oracle"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_generate_speculative_matches_jax(name):
    case, gen, draft = CASES[name]
    jout, jst, tout, tst, greedy = _run_both(case, gen, draft)
    _check(jout, jst, tout, tst, greedy)
    assert tst.spec_steps >= 1
    if draft == "oracle":
        assert tst.fallback_steps == 0 and tst.accepted_drafts > 0
    if draft == "pad":
        assert tst.accepted_drafts == 0
    if draft == "mixed":
        assert tst.fallback_steps > 0


def test_refusals_match_jax():
    cfg, params, model, wav, amask, _ = _pair()
    tcfg, w, m = _port(cfg), torch.from_numpy(wav), torch.from_numpy(amask)
    with pytest.raises(ValueError, match="greedy-only"):
        speculative.generate_speculative(
            model, tcfg, w, m, gen=tconfig.GenerationConfig(
                do_sample=True, speculative="ctc"), max_new_tokens=4)
    with pytest.raises(ValueError, match="unknown speculative draft"):
        speculative.generate_speculative(
            model, tcfg, w, m, gen=tconfig.GenerationConfig(
                speculative="lm"), max_new_tokens=4)
    plain = tiny_cfg(train_mode="attention")
    pmodel = SpeechEncoderDecoderModel(_port(plain))
    load_flat(pmodel, tree_to_flat(init_model_params(jax.random.key(0),
                                                     plain)))
    with pytest.raises(ValueError, match="talker_ctc"):
        speculative.generate_speculative(
            pmodel, _port(plain), w, m,
            gen=tconfig.GenerationConfig(speculative="ctc"),
            max_new_tokens=4)
    with pytest.raises(ValueError, match="talker_ctc"):
        jspec.generate_speculative(
            init_model_params(jax.random.key(0), plain), plain,
            jnp.asarray(wav), jnp.asarray(amask),
            gen=GenerationConfig(speculative="ctc"), max_new_tokens=4)


def test_generate_dispatches_to_speculative(monkeypatch):
    cfg, params, model, wav, amask, _ = _pair()
    ref = jax_generate(params, cfg, jnp.asarray(wav), jnp.asarray(amask),
                       gen=GenerationConfig(speculative="ctc"),
                       max_new_tokens=8)
    seen = []
    real = speculative.generate_speculative
    monkeypatch.setattr(speculative, "generate_speculative",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    out = engine.generate(model, _port(cfg), torch.from_numpy(wav),
                          torch.from_numpy(amask),
                          gen=tconfig.GenerationConfig(speculative="ctc"),
                          max_new_tokens=8)
    assert seen == [1]
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))


@pytest.mark.parametrize("use_cache", [True, False])
def test_use_cache_decodes_as_jax(use_cache):
    cfg, params, model, wav, amask, _ = _pair()
    ref = jax_generate(params, cfg, jnp.asarray(wav), jnp.asarray(amask),
                       gen=GenerationConfig(use_cache=use_cache),
                       max_new_tokens=8)
    out = engine.generate(model, _port(cfg), torch.from_numpy(wav),
                          torch.from_numpy(amask),
                          gen=tconfig.GenerationConfig(use_cache=use_cache),
                          max_new_tokens=8)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
