"""Model directories: the port's own safetensors I/O, config.json, save /
load of a composite model, the assembly from HF directories and the
streamed int8 load, against the JAX package and the `safetensors` and
`transformers` packages (CPU, float32 unless stated).

Tolerances: tensors bit-equal; greedy tokens identical; the port's WavLM
and LLaMA, loaded from HF directories, against HF's own forward within
rtol 1e-4 (atol 2e-5 for values near 0)."""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mtasr_tpu import config as jconfig
from mtasr_tpu.generate import generate as jax_generate
from mtasr_tpu.models.speech_encoder_decoder import init_model_params
from mtasr_tpu.train.lora import init_decoder_lora as jax_init_lora
from mtasr_tpu.utils import model_io as jio
from mtasr_tpu.utils.quantize import (
    quantize_decoder_for_serving as jax_quantize_decoder,
)
from mtasr_tpu.utils.torch_interop import (
    save_safetensors_tree, tree_to_flat,
)
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models.llama import Llama, embed_tokens, llama_forward
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel,
)
from mtasr_tpu_torch.models.wavlm import WavLM, wavlm_forward
from mtasr_tpu_torch.train.lora import merge_decoder_lora
from mtasr_tpu_torch.utils import model_io
from mtasr_tpu_torch.utils import safetensors_io as sio
from mtasr_tpu_torch.utils.convert import init_random, load_flat
from mtasr_tpu_torch.utils.quantize import quantize_for_serving
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

INSTRUCT_IDS = dict(bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
                    eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)


def _bits(a):
    """(shape, dtype width, raw bits as unsigned ints) of a torch tensor or
    a numpy array (bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        shape, width = tuple(a.shape), a.element_size()
        raw = a.reshape(-1).view(torch.uint8).numpy()
    else:
        a = np.asarray(a)
        shape, width = a.shape, a.dtype.itemsize
        raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return shape, width, raw.view(f"u{width}")


def _assert_bits(a, b, what=""):
    x, y = _bits(a), _bits(b)
    assert x[:2] == y[:2], (what, x[:2], y[:2])
    np.testing.assert_array_equal(x[2], y[2], err_msg=what)


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 7, generator=g).to(torch.bfloat16),
        "f16": torch.randn(6, generator=g).half(),
        "i8": torch.randint(-128, 128, (5, 3), generator=g,
                            dtype=torch.int8),
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (9,), generator=g,
                             dtype=torch.int32),
        "scalar": torch.tensor(16.0),
        "empty": torch.zeros(0, 4),
    }


def test_safetensors_port_written_file_reads_in_the_package(tmp_path):
    """f32, bf16, f16, int8 and int32 bit-equal through
    `safetensors.numpy.load_file` and `safe_open`; metadata format pt."""
    from safetensors import safe_open
    from safetensors.numpy import load_file
    t = _tensors()
    path = str(tmp_path / "x.safetensors")
    n = sio.save_file(t, path)
    assert n == os.path.getsize(path)
    back = load_file(path)
    assert set(back) == set(t)
    for k in t:
        _assert_bits(back[k], t[k], k)
    with safe_open(path, framework="numpy") as f:
        assert f.metadata() == {"format": "pt"}
        _assert_bits(f.get_tensor("bf16"), t["bf16"])


def test_safetensors_package_written_file_reads_in_the_port(tmp_path):
    """A JAX-package file (its bf16 through ml_dtypes) read by the port
    through the memory map, one tensor at a time, bit-equal."""
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                  "b": rng.standard_normal(5).astype(ml_dtypes.bfloat16)},
            "q": rng.integers(-127, 128, (3, 2)).astype(np.int8),
            "n": np.arange(7, dtype=np.int32),
            "h": rng.standard_normal(3).astype(np.float16)}
    path = str(tmp_path / "j.safetensors")
    save_safetensors_tree(tree, path)
    f = sio.SafetensorsFile(path)
    assert f.metadata == {"format": "pt"}
    flat = tree_to_flat(tree)
    assert set(f.keys()) == set(flat)
    for k, v in flat.items():
        got = f.get(k)
        assert got.dtype == sio._as_tensor(v).dtype, k
        _assert_bits(got, v, k)


def _json_cfgs():
    return [tiny_cfg(train_mode="attention"),
            tiny_cfg(train_mode="hybrid", talker_ctc=True, instruct=True,
                     **INSTRUCT_IDS),
            jconfig.SpeechEncoderDecoderConfig(
                encoder=jconfig.wavlm_large_config(),
                decoder=jconfig.llama_1b_config(vocab_size=128264))]


@pytest.mark.parametrize("i", range(3))
def test_config_json_round_trips(i):
    """JAX -> port -> JAX and port -> JAX give equal configs."""
    ref = _json_cfgs()[i]
    port = tconfig.SpeechEncoderDecoderConfig.from_json(ref.to_json())
    again = jconfig.SpeechEncoderDecoderConfig.from_json(port.to_json())
    assert dataclasses.asdict(again) == dataclasses.asdict(ref)
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    fresh = tconfig.SpeechEncoderDecoderConfig()
    assert dataclasses.asdict(jconfig.SpeechEncoderDecoderConfig.from_json(
        fresh.to_json())) == dataclasses.asdict(
            jconfig.SpeechEncoderDecoderConfig())
    assert {f.name for f in dataclasses.fields(tconfig.GenerationConfig)} \
        == {f.name for f in dataclasses.fields(jconfig.GenerationConfig)}
    assert {f.name for f in dataclasses.fields(tconfig.DataConfig)} \
        == {f.name for f in dataclasses.fields(jconfig.DataConfig)}


def test_unported_switches_raise_with_their_item():
    """Unported switches raise with their ROADMAP item; the adapters (item
    6, ported) now build from a config read back from its JSON."""
    cfg = tconfig.SpeechEncoderDecoderConfig.from_json(
        tiny_cfg(train_mode="attention", decoder_cross_attention=True,
                 decoder_cross_attention_type="gatetiny").to_json())
    model = SpeechEncoderDecoderModel(cfg)
    assert len(model.cross_att_adap) == cfg.decoder.num_hidden_layers
    assert model.cross_att_adap["0"].gate_logit.dim() == 0
    bad = tconfig.SpeechEncoderDecoderConfig.from_json(
        tiny_cfg(ctc_bridge_type="nope").to_json())
    with pytest.raises(ValueError, match="ctc_bridge_type"):
        bad.validate()
    with pytest.raises(NotImplementedError, match="item 7"):
        engine._check_gen(tconfig.GenerationConfig(use_cache=False))
    with pytest.raises(NotImplementedError, match="item 8"):
        Transcriber.from_pretrained("unused", dp_size=2, device="cpu")


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """Model directories written by the JAX package: attention mode, and
    instruct with a decoder LoRA (B nonzero, so it changes the tokens)."""
    root = tmp_path_factory.mktemp("jaxdirs")
    out = {}
    cfg = tiny_cfg(train_mode="attention")
    params = init_model_params(jax.random.key(0), cfg)
    jio.save_model(str(root / "plain"), cfg, params)
    out[False] = (str(root / "plain"), cfg, params)
    cfg = tiny_cfg(train_mode="attention", instruct=True, **INSTRUCT_IDS)
    params = init_model_params(jax.random.key(1), cfg)
    lora = jax_init_lora(jax.random.key(2), params["decoder"], r=4,
                         alpha=8.0)
    for li in lora:
        if li != "__meta__":
            for ab in lora[li].values():
                ab["lora_B"] = jax.random.normal(jax.random.key(3),
                                                 ab["lora_B"].shape) * 0.1
    params["decoder_lora"] = lora
    jio.save_model(str(root / "instruct"), cfg, params)
    out[True] = (str(root / "instruct"), cfg, params)
    return out


def _wav(B=3, S=8000, seed=0):
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((B, S)).astype(np.float32)
    amask = np.ones((B, S), np.int32)
    amask[-1, 5000:] = 0
    return wav, amask


@pytest.mark.parametrize("instruct", [False, True])
def test_jax_written_dir_serves_the_same_tokens(jax_dirs, instruct):
    """JAX save_model -> port load_model (and from_pretrained) -> greedy
    tokens identical to JAX's generate on the same inputs."""
    path, cfg, params = jax_dirs[instruct]
    pcfg, model = model_io.load_model(path, "cpu")
    assert next(model.parameters()).dtype == torch.float32
    wav, amask = _wav()
    prompt = (np.tile([52, 20, 21, 22, 53, 54, 55, 56], (3, 1))
              if instruct else None)
    ref = jax_generate(params, cfg, jnp.asarray(wav), jnp.asarray(amask),
                       prompt_ids=None if prompt is None
                       else jnp.asarray(prompt), max_new_tokens=10)
    out = engine.generate(model, pcfg, torch.from_numpy(wav),
                          torch.from_numpy(amask),
                          prompt_ids=None if prompt is None
                          else torch.from_numpy(prompt), max_new_tokens=10)
    np.testing.assert_array_equal(out.sequences.numpy(),
                                  np.asarray(ref.sequences))
    tr = Transcriber.from_pretrained(path, device="cpu")
    assert tr.model.training is False and tr.gen.kv_quant is False
    assert tr.cfg.instruct == instruct


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_written_dir_loads_in_jax_bit_equal(tmp_path, dtype):
    """Port save_model (hybrid, with a decoder LoRA; f32 and bf16) -> JAX
    load_model: every parameter bit-equal, config equal; and back."""
    from mtasr_tpu_torch.train.lora import init_decoder_lora
    cfg = tconfig.SpeechEncoderDecoderConfig.from_json(
        tiny_cfg(train_mode="hybrid", talker_ctc=True).to_json())
    g = torch.Generator().manual_seed(0)
    model = init_random(cfg, g, "cpu", dtype)
    init_decoder_lora(model, g, r=4, alpha=8.0)
    model_io.save_model(str(tmp_path), cfg, model)
    jcfg, jparams = jio.load_model(str(tmp_path))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jflat = tree_to_flat(jparams)
    mine = model_io.flat_state(model)
    assert set(jflat) == set(mine)
    for k, v in mine.items():
        _assert_bits(jflat[k], v, k)
    _, again = model_io.load_model(str(tmp_path), "cpu")
    for k, v in model.state_dict().items():
        _assert_bits(again.state_dict()[k], v, k)
    assert again.decoder_lora.r == 4 and again.decoder_lora.alpha == 8


# ---------------------------------------------------------------------------
# HF directories: create_from_pretrained and HF parity
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Random tiny HF WavLM and LLaMA directories (save_pretrained), the
    LLaMA in float32 and in bfloat16."""
    from transformers import LlamaConfig as HFLlama
    from transformers import LlamaForCausalLM
    from transformers import WavLMConfig as HFWavLM
    from transformers import WavLMModel
    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    wavlm = WavLMModel(HFWavLM(
        vocab_size=32, hidden_size=48, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=72,
        conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3),
        num_feat_extract_layers=2, conv_bias=True, num_buckets=32,
        max_bucket_distance=50, do_stable_layer_norm=True,
        feat_extract_norm="layer", num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, add_adapter=False,
        mask_time_prob=0.05, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0)).eval()
    wavlm.save_pretrained(root / "wavlm", safe_serialization=True)
    llama = LlamaForCausalLM(HFLlama(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, bos_token_id=1, eos_token_id=2,
        attn_implementation="eager")).eval()
    llama.save_pretrained(root / "llama", safe_serialization=True)
    copy.deepcopy(llama).to(torch.bfloat16).save_pretrained(
        root / "llama_bf16", safe_serialization=True)
    return {"wavlm": str(root / "wavlm"), "f32": str(root / "llama"),
            "bf16": str(root / "llama_bf16"), "hf_wavlm": wavlm,
            "hf_llama": llama}


@pytest.mark.parametrize("dec", ["f32", "bf16"])
def test_create_from_pretrained_matches_jax(hf_dirs, dec, tmp_path):
    """The JAX and the port's assembly of the same HF directories: equal
    configs, every grafted tensor bit-equal to JAX's (the weight-normed
    pos conv fused as JAX fuses it), the grown embedding rows bit-equal to
    JAX's mean row, the fresh glue modules of the same names, shapes and
    dtypes; the port's directory loads in JAX."""
    special = {"pad_token_id": 130, "sc_token_id": 131, "instruct": False}
    over = dict(talker_ctc=True, talker_numbers=2, separator_hidden=24,
                train_mode="hybrid")
    jcfg, jparams = jio.create_from_pretrained(
        hf_dirs["wavlm"], hf_dirs[dec], tokenizer_len=132,
        special_ids=special, model_overrides=over)
    pcfg, model = model_io.create_from_pretrained(
        hf_dirs["wavlm"], hf_dirs[dec], tokenizer_len=132,
        special_ids=special, model_overrides=over, device="cpu")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    jflat = tree_to_flat(jparams)
    mine = dict(model.state_dict())
    assert set(jflat) == set(mine)
    grafted = {"encoder." + k for k in model_io.load_hf_pretrained_dir(
        hf_dirs["wavlm"])[1]} | {"decoder." + k for k in
                                 model_io.load_hf_pretrained_dir(
                                     hf_dirs[dec])[1]}
    assert "decoder.model.embed_tokens.weight" in grafted
    for k, v in mine.items():
        if k in grafted:
            _assert_bits(jflat[k], v, k)
        else:                      # fresh: same geometry, own random draw
            assert tuple(np.shape(jflat[k])) == tuple(v.shape), k
            assert sio._as_tensor(np.asarray(jflat[k])).dtype == v.dtype, k
    emb = mine["decoder.model.embed_tokens.weight"]
    assert emb.shape[0] == 132
    src = model_io.read_flat(hf_dirs[dec])["model.embed_tokens.weight"]
    _assert_bits(emb[:128], src)
    for row in emb[128:]:
        _assert_bits(row, emb[128])
    out = str(tmp_path / "composite")
    model_io.save_model(out, pcfg, model)
    _, again = jio.load_model(out)
    for k, v in tree_to_flat(again).items():
        _assert_bits(v, mine[k], k)


def test_port_loaded_from_hf_dirs_matches_hf_forward(hf_dirs):
    """Port WavLM and LLaMA, loaded from the HF directories, against HF
    `WavLMModel` hidden states and `LlamaForCausalLM` logits (float32)."""
    cfg_d, flat = model_io.load_hf_pretrained_dir(hf_dirs["wavlm"])
    wcfg = model_io._hf_config_to_wavlm(cfg_d)
    wavlm = WavLM(wcfg)
    load_flat(wavlm, flat)
    rng = np.random.default_rng(1)
    S = 3200
    wav = rng.standard_normal((2, S)).astype(np.float32)
    amask = (np.arange(S)[None] < np.array([[S], [S - 700]])).astype(np.int64)
    with torch.no_grad():
        ref = hf_dirs["hf_wavlm"](torch.tensor(wav),
                                  attention_mask=torch.tensor(amask))
        out = wavlm_forward(wavlm.eval(), wcfg, torch.tensor(wav),
                            torch.tensor(amask))
    np.testing.assert_allclose(out.last_hidden_state.numpy(),
                               ref.last_hidden_state.numpy(),
                               rtol=1e-4, atol=2e-5)

    cfg_d, flat = model_io.load_hf_pretrained_dir(hf_dirs["f32"])
    lcfg = model_io._hf_config_to_llama(cfg_d)
    llama = Llama(lcfg)
    load_flat(llama, flat)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 9)))
    with torch.no_grad():
        ref = hf_dirs["hf_llama"](ids).logits
        emb = embed_tokens(llama, lcfg, ids, dtype=torch.float32)
        pos = torch.arange(9)[None].expand(2, -1)
        logits, _ = llama_forward(llama.eval(), lcfg, emb, pos)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# streamed int8 load
# ---------------------------------------------------------------------------
def _big_dec_cfg(tied: bool):
    cfg = tiny_cfg(train_mode="attention")
    d = cfg.decoder
    d.hidden_size, d.intermediate_size = 256, 512
    d.num_attention_heads, d.num_key_value_heads, d.head_dim = 4, 2, 64
    d.vocab_size, d.tie_word_embeddings = 512, tied
    return cfg


@pytest.fixture(scope="module")
def int8_dirs(tmp_path_factory):
    """Decoder widths the quantizer targets, tied and untied heads."""
    root = tmp_path_factory.mktemp("int8")
    out = {}
    for tied in (False, True):
        cfg = _big_dec_cfg(tied)
        params = init_model_params(jax.random.key(0), cfg)
        if tied:
            params["decoder"] = {"model": params["decoder"]["model"]}
        jio.save_model(str(root / f"tied{tied}"), cfg, params)
        out[tied] = str(root / f"tied{tied}")
    return out


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_streamed_int8_load_matches_both_quantizers(int8_dirs, tied, mode):
    """The streamed load's int8 weights and scales equal the port's
    load-then-`quantize_for_serving` and JAX's `load_model_quantized`, bit
    for bit (all three quantize the stored float32 weights); every other
    tensor is the stored one cast to bf16; the tied head is materialised
    quantized; the tokens of the two port models agree."""
    path = int8_dirs[tied]
    cfg, streamed = model_io.load_model_quantized(path, mode, device="cpu")
    _, ref = model_io.load_model(path, "cpu")
    quantize_for_serving(ref, mode)
    for name, t in list(ref.named_parameters()) + list(ref.named_buffers()):
        if t.is_floating_point() and not name.endswith(".scale"):
            t.data = t.data.to(torch.bfloat16)
    s, r = streamed.state_dict(), ref.state_dict()
    assert set(s) == set(r)
    for k in s:
        _assert_bits(s[k], r[k], k)
    wkey = "weight_q8a8" if mode == "w8a8" else "weight_q8"
    assert f"decoder.lm_head.{wkey}" in s
    # JAX's streamed load divides by 127 in numpy, its device quantizer
    # (and the port) multiplies by f32(1 / 127): the scales are bit-equal
    # to the device quantizer's and within 1 ulp of the streamed one's
    _, jq = jio.load_model_quantized(path, mode=mode)
    jflat = tree_to_flat(jq)
    jdev = tree_to_flat(jax_quantize_decoder(jio.load_model(path)[1], mode))
    q_keys = [k for k in s if k.endswith((wkey, ".scale"))]
    assert len(q_keys) == 2 * (2 * 5 + 1)
    for k in q_keys:
        _assert_bits(jdev[k], s[k], k)
        if k.endswith(wkey):
            _assert_bits(jflat[k], s[k], k)
        else:
            np.testing.assert_array_max_ulp(np.asarray(jflat[k]),
                                            s[k].numpy(), maxulp=1)
    wav, amask = _wav(B=2)
    outs = [engine.generate(m, cfg, torch.from_numpy(wav),
                            torch.from_numpy(amask), max_new_tokens=6)
            for m in (streamed, ref)]
    np.testing.assert_array_equal(outs[0].sequences, outs[1].sequences)


def test_streamed_load_refuses_lora_and_from_pretrained_merges(tmp_path):
    """A LoRA directory is refused by the streamed load; from_pretrained
    loads it, merges the LoRA, then quantizes: the same weights as doing
    those steps by hand."""
    cfg = _big_dec_cfg(False)
    params = init_model_params(jax.random.key(0), cfg)
    lora = jax_init_lora(jax.random.key(1), params["decoder"], r=4,
                         alpha=8.0)
    for li in lora:
        if li != "__meta__":
            for ab in lora[li].values():
                ab["lora_B"] = jnp.full(ab["lora_B"].shape, 0.05)
    params["decoder_lora"] = lora
    jio.save_model(str(tmp_path), cfg, params)
    with pytest.raises(ValueError, match="merge"):
        model_io.load_model_quantized(str(tmp_path), "w8a8", device="cpu")
    tr = Transcriber.from_pretrained(str(tmp_path), quantize="w8a8",
                                     kv_quant=True, device="cpu")
    assert tr.gen.kv_quant and not hasattr(tr.model, "decoder_lora")
    _, ref = model_io.load_model(str(tmp_path), "cpu")
    quantize_for_serving(merge_decoder_lora(ref), "w8a8")
    got = tr.model.state_dict()
    for k, v in ref.state_dict().items():
        _assert_bits(got[k], v, k)
