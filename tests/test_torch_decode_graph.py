"""The decode step whose inputs all live on the device (the step that
`generate/engine.py` replays from a CUDA graph on a card), on the CPU at a
tiny size: `llama_forward` at L = 1 with a 0-d tensor `cache_offset` gives
the logits, KV cache, scales and slot mask of the int offset bit for bit;
`engine._decode` gives the tokens and cache of the int-offset loop it
replaced; and `_replayable` engages the graph only on a card, greedy, with
no tp group. The replay itself runs in `tests/test_torch_cuda.py`."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models import llama as tllama
from mtasr_tpu_torch.models.speech_encoder_decoder import adapter_callback
from mtasr_tpu_torch.utils import profiling
from mtasr_tpu_torch.utils.convert import init_random
from mtasr_tpu_torch.utils.quantize import quantize_for_serving, quantize_tree
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


def _decoder(D: int, int8: bool):
    """A two-layer decoder with 2 q / 1 kv heads of D: bf16 weights, or
    float32 weights quantized w8a8 (the linears of 256 outputs and more)
    beside an int8 cache."""
    H = 2 * D
    cfg = tconfig.LlamaConfig(vocab_size=300, hidden_size=H,
                              intermediate_size=2 * H, num_hidden_layers=2,
                              num_attention_heads=2, num_key_value_heads=1,
                              head_dim=D, rope_theta=10000.0)
    torch.manual_seed(D)
    dec = tllama.Llama(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.normal_(0.0, 0.3 if p.dim() == 2 else 1.0)
    if int8:
        quantize_tree(dec, "w8a8")
        return cfg, dec, torch.float32
    return cfg, dec.to(torch.bfloat16), torch.bfloat16


@pytest.mark.parametrize("D,int8", [(64, False), (128, True)],
                         ids=["bf16-d64", "int8-d128"])
@torch.inference_mode()
def test_tensor_offset_step_equals_int_offset(D, int8):
    """A prefill over a padded slot, then three steps twice: with the int
    offset and with the offset as a 0-d tensor, each into its own copy of
    the prefilled cache. The logits and every cache buffer equal exactly."""
    cfg, dec, dtype = _decoder(D, int8)
    B, L, steps = 3, 6, 3
    S_max = L + steps
    g = torch.Generator().manual_seed(1)
    emb = torch.randn((B, L, cfg.hidden_size), generator=g).to(dtype)
    valid = torch.ones((B, L), dtype=torch.bool)
    valid[1, 3] = False
    cache = tllama.KVCache.init(cfg, B, S_max, dtype, "cpu", quantized=int8)
    tllama.llama_forward(dec, cfg, emb, torch.arange(L).expand(B, L),
                         key_valid_mask=valid, kv_cache=cache)

    def copy(c):
        return tllama.KVCache(
            k=[x.clone() for x in c.k], v=[x.clone() for x in c.v],
            valid=c.valid.clone(),
            kv_scale=None if c.kv_scale is None else
            [x.clone() for x in c.kv_scale])
    by_int, by_tensor = copy(cache), copy(cache)
    for t in range(steps):
        x = torch.randn((B, 1, cfg.hidden_size), generator=g).to(dtype)
        pos = torch.full((B, 1), L + t)
        a, _ = tllama.llama_forward(dec, cfg, x, pos, kv_cache=by_int,
                                    cache_offset=L + t, logits_to_keep=1)
        b, _ = tllama.llama_forward(
            dec, cfg, x, pos, kv_cache=by_tensor,
            cache_offset=torch.tensor(L + t), logits_to_keep=1)
        assert torch.equal(a, b), t
    assert torch.equal(by_int.valid, by_tensor.valid)
    assert bool(by_tensor.valid[:, L:].all())
    for name in ("k", "v") + (("kv_scale",) if int8 else ()):
        for layer, (p, q) in enumerate(zip(getattr(by_int, name),
                                           getattr(by_tensor, name))):
            assert torch.equal(p, q), (name, layer)
    assert by_int.kv_scale is None or by_int.kv_scale[0][:, :, -1].any()


def _served(int8: bool):
    cfg = tiny_cfg(train_mode="attention")
    cfg.encoder.num_hidden_layers = 2
    cfg = tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)
    model = init_random(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    with torch.no_grad():
        # at the init's scale this decoder picks one token everywhere
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.mul_(8)
    if int8:
        quantize_for_serving(model, "w8a8")
    return cfg, model


def _int_offset_loop(model, cfg, cache, last, n_valid, Lp, total,
                     max_new):
    """The greedy loop as it was before its inputs moved to the device:
    the host hands each step its offset and positions as ints."""
    dec, dcfg = model.decoder, cfg.decoder
    eos, pad = cfg.eos_token_id, cfg.pad_token_id
    cur = last.argmax(-1)
    out = torch.full((cur.shape[0], max_new), pad, dtype=torch.long)
    out[:, 0] = cur
    done = cur == eos
    for t in range(1, max_new):
        emb = tllama.embed_tokens(dec, dcfg, cur[:, None],
                                  dtype=torch.float32)
        logits, cache = tllama.llama_forward(
            dec, dcfg, emb, (Lp + n_valid)[:, None] - 1 + t, kv_cache=cache,
            cache_offset=total + t - 1, logits_to_keep=1)
        nxt = torch.where(done, pad, logits[:, -1].argmax(-1))
        out[:, t] = nxt
        done = done | (nxt == eos)
        cur = nxt
    return out, cache


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "w8a8-int8kv"])
@torch.inference_mode()
def test_decode_loop_equals_the_int_offset_loop(int8):
    """`engine._decode` against the int-offset loop on the same prefill:
    the same tokens and, every step run, the same cache, bit for bit."""
    cfg, model = _served(int8)
    gen = tconfig.GenerationConfig(do_sample=False, kv_quant=int8)
    rng = np.random.default_rng(5)
    wav = torch.from_numpy(
        (rng.standard_normal((3, 4000)) * 0.2).astype(np.float32))
    amask = torch.ones_like(wav, dtype=torch.int32)
    amask[2, 2500:] = 0
    enc = engine.encode_maybe_chunked(model, cfg, wav, amask, None)
    ids, splice = engine.prompt_layout(cfg, 3, None, "cpu")
    max_new = 12
    S_max = ids.shape[1] + enc.encoder_hidden_states.shape[1] + max_new
    cb = adapter_callback(model, cfg, enc, keep_kv=True)

    def prefill():
        return engine._prefill(model, cfg, enc, ids, splice, S_max,
                               int8, cb)
    cache, last, n_valid, total = prefill()
    got = engine._decode(model, cfg, cache, last, n_valid, ids.shape[1],
                         total, torch.float32, gen, max_new, None, cb)
    ref_cache, last, n_valid, total = prefill()
    want, ref_cache = _int_offset_loop(model, cfg, ref_cache, last, n_valid,
                                       ids.shape[1], total, max_new)
    assert torch.equal(got.sequences, want)
    assert len(set(want.flatten().tolist())) > 2     # the tokens vary
    assert got.steps == max_new - 1
    assert torch.equal(cache.valid, ref_cache.valid)
    for a, b in zip(cache.k + cache.v, ref_cache.k + ref_cache.v):
        assert torch.equal(a, b)


class _Mesh:
    dp_group = object()


@pytest.mark.parametrize("device,sample,dp,tp,want", [
    ("cuda", False, False, False, True),
    ("cpu", False, False, False, False),
    ("cuda", True, False, False, False),
    ("cuda", True, True, False, False),
    ("cuda", False, True, False, True),
    ("cuda", False, False, True, False),
], ids=["card-greedy", "cpu", "sampling", "dp-sampling", "dp-greedy", "tp"])
def test_replayable(device, sample, dp, tp, want):
    """The graph engages on a card for the greedy pick of one process or
    one dp index (whose pick gathers nothing), and for nothing else."""
    cfg, model = _served(False)
    if tp:
        model.decoder.model.layers["1"].mlp.tp = object()
    gen = tconfig.GenerationConfig(do_sample=sample)
    pick = engine._Picker(gen, None, _Mesh() if dp else None,
                          slice(0, 2) if dp else None)
    assert (pick.group is not None) == (dp and sample)
    assert engine._replayable(model, pick, torch.device(device)) is want


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_cpu_loop_counts_no_replay(sample):
    """On the CPU the step runs eagerly: the replay counter is there, at
    0, beside one step count a step."""
    cfg, model = _served(False)
    wav = torch.zeros((2, 3000))
    gen = tconfig.GenerationConfig(do_sample=sample)
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = engine.generate(model, cfg, wav, None, gen=gen,
                              generator=torch.Generator().manual_seed(0),
                              max_new_tokens=5)
    _, counts = profiling.take()
    assert counts[engine.REPLAYS] == 0
    assert counts["mtasr.engine.decode.steps"] == out.steps > 0
