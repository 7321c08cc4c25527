"""The slice as a whole: the port's greedy `generate` and `Transcriber`
against the JAX package's on `tiny_cfg(train_mode="attention")`, the same
weights and the same seeded inputs (float32, CPU). Greedy output must be
token-for-token identical, in non-instruct and instruct mode, with a padded
row; transcripts must be the same strings."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.api import Transcriber as JaxTranscriber
from mtasr_tpu.config import DataConfig, GenerationConfig
from mtasr_tpu.data.tokenizer import CharTokenizer
from mtasr_tpu.generate import generate as jax_generate
from mtasr_tpu.models.speech_encoder_decoder import init_model_params
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.data.tokenizer import CharTokenizer as TCharTokenizer
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.ops import kernels
from mtasr_tpu_torch.utils.convert import init_random, load_flat
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

INSTRUCT_IDS = dict(bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
                    eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)


_PORT_CLASS = {GenerationConfig: tconfig.GenerationConfig,
               DataConfig: tconfig.DataConfig}


def _port(cfg):
    """The port's config with the fields of the JAX config `cfg`."""
    return tconfig.from_fields(
        _PORT_CLASS.get(type(cfg), tconfig.SpeechEncoderDecoderConfig), cfg)


def _pair(cfg, seed=0):
    params = init_model_params(jax.random.key(seed), cfg)
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, tree_to_flat(params))
    return params, model


def _batch(B=3, S=8000, seed=0):
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((B, S)).astype(np.float32)
    amask = np.ones((B, S), np.int32)
    amask[-1, 5000:] = 0
    return wav, amask


@pytest.mark.parametrize("instruct", [False, True])
def test_generate_token_identical_to_jax(instruct):
    cfg = tiny_cfg(train_mode="attention", instruct=instruct,
                   **(INSTRUCT_IDS if instruct else {}))
    params, model = _pair(cfg, seed=1 if instruct else 0)
    wav, amask = _batch()
    prompt = None
    if instruct:
        prompt = np.tile([52, 20, 21, 22, 53, 54, 55, 56], (3, 1))
    ref = jax_generate(params, cfg, jnp.asarray(wav), jnp.asarray(amask),
                       prompt_ids=None if prompt is None
                       else jnp.asarray(prompt), max_new_tokens=12)
    kernels.reset_launch_counts()
    out = engine.generate(model, _port(cfg), torch.from_numpy(wav),
                          torch.from_numpy(amask),
                          prompt_ids=None if prompt is None
                          else torch.from_numpy(prompt), max_new_tokens=12)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert out.steps == 11
    assert sum(kernels.launch_counts().values()) == 0   # CPU: plain only


def test_chunked_encode_and_early_exit():
    """encode_chunk gives the same tokens as a whole-batch encode, and the
    loop stops early (checking every EOS_CHECK_EVERY steps) once every row
    is done, with pads after eos as in the JAX loop."""
    cfg = tiny_cfg(train_mode="attention")
    params, model = _pair(cfg)
    wav, amask = _batch()
    w, m = torch.from_numpy(wav), torch.from_numpy(amask)
    whole = engine.generate(model, _port(cfg), w, m, max_new_tokens=12)
    chunked = engine.generate(model, _port(cfg), w, m, max_new_tokens=12,
                              gen=tconfig.GenerationConfig(encode_chunk=2))
    np.testing.assert_array_equal(whole.sequences.numpy(),
                                  chunked.sequences.numpy())
    first = int(whole.sequences[0, 0])
    cfg.eos_token_id = first          # every row's first token is now eos
    out = engine.generate(model, _port(cfg), w, m, max_new_tokens=30)
    assert out.steps < 29
    ref = jax_generate(params, cfg, jnp.asarray(wav), jnp.asarray(amask),
                       max_new_tokens=30)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))


def _transcribers(instruct=False):
    """The JAX and the port's Transcriber, each with its own package's
    config, tokenizer, generation and data settings."""
    cfg = tiny_cfg(train_mode="attention")
    tok, ttok = CharTokenizer(), TCharTokenizer()
    sp = tok.add_special_tokens(instruct=instruct)
    ttok.add_special_tokens(instruct=instruct)
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    if instruct:
        cfg.instruct = True
        for name in INSTRUCT_IDS:
            setattr(cfg, name, getattr(sp, name))
    params, model = _pair(cfg, seed=2)
    gen = GenerationConfig(do_sample=False)
    # short buckets (4000 / 8000 / 16000 samples) keep the tiny model fast
    dc = DataConfig(min_duration_in_seconds=0.0, max_duration_in_seconds=1e9,
                    bucket_boundaries_seconds=(0.25, 0.5, 1.0))
    return (JaxTranscriber(cfg, params, tok, gen=gen, dc=dc),
            Transcriber(_port(cfg), model, ttok, gen=_port(gen),
                        dc=_port(dc)))


@pytest.mark.parametrize("instruct", [False, True])
def test_transcriber_matches_jax(instruct):
    """Mixed lengths land in two duration buckets (two batches, out of
    input order, one padded); the transcripts equal the JAX Transcriber's."""
    jt, tt = _transcribers(instruct)
    rng = np.random.default_rng(5)
    wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (12000, 3000, 9000)]
    kw = dict(max_new_tokens=6, batch_size=2, clean=False,
              prompt="transcribe both speakers" if instruct else "")
    assert tt.transcribe(wavs, **kw) == jt.transcribe(wavs, **kw)


def test_unported_routes_raise():
    jt, tt = _transcribers()
    wav = [np.zeros(4000, np.float32)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.transcribe(wav, num_beams=4)
    with pytest.raises(ValueError, match="talker_ctc"):
        tt.transcribe_ctc(wav)          # no CTC heads on this model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transcriber.from_pretrained("exp/model", tp_size=2, device="cpu")
    # the raw CTC bridge (ROADMAP item 6) is ported: it builds and decodes
    bridged = _port(tiny_cfg(train_mode="hybrid", talker_ctc=True,
                             ctc_bridge=True))
    model = init_random(bridged, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    out = engine.generate(model, bridged, torch.zeros(1, 4000), None,
                          max_new_tokens=2)
    assert out.sequences.shape == (1, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.generate(tt.model, tt.cfg, torch.zeros(1, 4000), None,
                        gen=tconfig.GenerationConfig(speculative="ctc"))


def test_prompt_layout_refuses_heterogeneous_batch():
    cfg = _port(tiny_cfg(train_mode="attention", instruct=True,
                         **INSTRUCT_IDS))
    ok = np.array([[52, 20, 53, 54, 55, 56], [52, 21, 53, 54, 55, 56]])
    ids, splice = engine.prompt_layout(cfg, 2, torch.from_numpy(ok), "cpu")
    assert splice == 5 and ids.shape == (2, 7)
    bad = np.array([[52, 20, 53, 54, 55, 56], [52, 53, 54, 55, 56, 50]])
    with pytest.raises(ValueError, match="heterogeneous"):
        engine.prompt_layout(cfg, 2, torch.from_numpy(bad), "cpu")
