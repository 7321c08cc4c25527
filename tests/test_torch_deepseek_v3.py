"""DeepSeek-V3's blocks in the port (Moonlight-16B-A3B: latent attention
over a one-latent-a-slot cache, sigmoid-routed experts with shared ones),
at a tiny size in float32 on seeded random weights, against the plain
reference `tests/plain_deepseek_v3.py` and against `transformers`'
`DeepseekV3ForCausalLM` loaded through the port's expert stacking. Logits
are compared, not tokens.

Tolerance: TOL of the largest |reference logit|. Both sides compute the
same float32 function with the products and sums in another order (the
absorbed form reassociates q (W_uk c) as (q W_uk) c; the experts'
combine sums in another order) through a few layers: a few float32 ulps
each, measured at 1e-6 relative. TOL is 1e-4 relative, and every planted
fault below misses it by orders of magnitude."""
import dataclasses

import pytest
import torch

from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.models import mla, moe
from mtasr_tpu_torch.models.llama import KVCache, Llama, llama_forward
from tests import plain_deepseek_v3 as ref

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

TOL = 1e-4
DEC = dict(vocab_size=40, hidden_size=64, intermediate_size=96,
           num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
           rms_norm_eps=1e-5, rope_theta=50000.0, tie_word_embeddings=False,
           kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
           n_shared_experts=2, moe_intermediate_size=24,
           first_k_dense_replace=1, routed_scaling_factor=2.446)
B, L = 2, 20


def _decoder(seed=0, **kw):
    """(config, the port's decoder, its flat weights under `decoder.`):
    matrices N(0, 1/fan_in), the router's correction bias N(0, 0.3^2),
    the norms' scales N(1, 0.1^2)."""
    cfg = tconfig.LlamaConfig(**{**DEC, **kw})
    g = torch.Generator().manual_seed(seed)
    dec = Llama(cfg).float()
    w = {}
    with torch.no_grad():
        for n, p in dec.named_parameters():
            if p.dim() > 1:
                p.normal_(0, p.shape[1] ** -0.5, generator=g)
            elif n.endswith("bias"):
                p.normal_(0, 0.3, generator=g)
            else:
                p.normal_(1, 0.1, generator=g)
            w["decoder." + n] = p.detach().clone()
    return cfg, dec, w


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, DEC["hidden_size"], generator=g)
    pos = torch.arange(L)[None].expand(B, L)
    valid = torch.ones(B, L, dtype=torch.bool)
    valid[1, 5:8] = False        # padding inside row 1's speech block
    return x, pos, valid


def _reference(w, dec=DEC):
    x, pos, valid = _inputs()
    return ref.decoder_logits(w, dec, x, pos, valid)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _full(cfg, dec):
    x, pos, valid = _inputs()
    with torch.no_grad():
        return llama_forward(dec, cfg, x, pos, key_valid_mask=valid)[0]


def _cached(cfg, dec, prefill, chunk=1):
    """A prefill of `prefill` positions into the latent cache, then the
    rest `chunk` positions at a time (a device-side offset, as the
    replayed step gives it): the logits of every position."""
    x, pos, valid = _inputs()
    cache = KVCache.init(cfg, B, L, torch.float32, "cpu")
    with torch.no_grad():
        out = [llama_forward(dec, cfg, x[:, :prefill], pos[:, :prefill],
                             key_valid_mask=valid[:, :prefill],
                             kv_cache=cache, cache_offset=0)[0]]
        for t in range(prefill, L, chunk):
            s = slice(t, min(t + chunk, L))
            out.append(llama_forward(
                dec, cfg, x[:, s], pos[:, s], key_valid_mask=valid[:, s],
                kv_cache=cache, cache_offset=torch.tensor(t))[0])
    assert cache.v == [] and tuple(cache.k[0].shape) == (B, L, 32 + 8)
    return torch.cat(out, dim=1)


def test_full_forward_matches_the_reference():
    cfg, dec, w = _decoder()
    assert _rel(_full(cfg, dec), _reference(w)) < TOL


@pytest.mark.parametrize("prefill,chunk", [(17, 1), (12, 1), (6, 5), (8, 4)])
def test_cached_decode_matches_the_reference_full_pass(prefill, chunk):
    """The expanded form for a prefill of L > 16, the absorbed one for a
    first chunk of L <= 16 and for every later step and chunk, over the
    cache the earlier ones wrote."""
    cfg, dec, w = _decoder()
    assert _rel(_cached(cfg, dec, prefill, chunk), _reference(w)) < TOL


def test_transformers_deepseek_v3_matches_the_port_and_the_reference():
    """`transformers`' DeepseekV3ForCausalLM at the same tiny config (its
    own random weights, the router's bias made nonzero), its state dict
    through `convert.stack_experts`: the source's interleaved rope, its
    kv_a norm's eps 1e-6 and its router are what the port and the
    reference compute."""
    tf = pytest.importorskip("transformers")
    if not hasattr(tf, "DeepseekV3ForCausalLM"):
        pytest.skip("transformers has no DeepseekV3ForCausalLM")
    from mtasr_tpu_torch.utils.convert import stack_experts
    torch.manual_seed(0)
    kw = {k: v for k, v in DEC.items()}
    hf = tf.DeepseekV3ForCausalLM(tf.DeepseekV3Config(
        attn_implementation="eager", q_lora_rank=None, n_group=1,
        topk_group=1, max_position_embeddings=64, **kw)).float().eval()
    with torch.no_grad():
        hf.model.layers[1].mlp.gate.e_score_correction_bias.normal_(0, 0.3)
        hf.model.layers[2].mlp.gate.e_score_correction_bias.normal_(0, 0.3)
    flat = stack_experts({"decoder." + k: v
                          for k, v in hf.state_dict().items()})
    cfg = tconfig.LlamaConfig(**DEC)
    dec = Llama(cfg).float()
    dec.load_state_dict({k[len("decoder."):]: v for k, v in flat.items()},
                        strict=True)
    ids = torch.randint(0, DEC["vocab_size"], (B, L),
                        generator=torch.Generator().manual_seed(2))
    pos = torch.arange(L)[None].expand(B, L)
    with torch.no_grad():
        want = hf(input_ids=ids).logits
        emb = dec.model.embed_tokens.weight[ids]
        port = llama_forward(dec, cfg, emb, pos)[0]
        plain = ref.decoder_logits(flat, DEC, emb, pos,
                                   torch.ones(B, L, dtype=torch.bool))
    assert _rel(port, want) < TOL
    assert _rel(plain, want) < TOL


def test_stack_experts_refuses_a_missing_expert_weight():
    from mtasr_tpu_torch.utils.convert import stack_experts
    t = torch.zeros(2, 2)
    flat = {f"m.mlp.experts.{e}.{p}_proj.weight": t
            for e in range(3) for p in ("gate", "up", "down")}
    assert set(stack_experts(flat)) == {"m.mlp.experts.gate_up_proj",
                                        "m.mlp.experts.down_proj"}
    del flat["m.mlp.experts.1.up_proj.weight"]
    with pytest.raises(KeyError, match="numbered"):
        stack_experts(flat)


def _bias_in_weights(monkeypatch, cfg):
    real = moe.route

    def route(m, c, x):
        top, _ = real(m, c, x)
        s = torch.sigmoid(x.float() @ m.gate.weight.float().t()) \
            + m.gate.e_score_correction_bias.float()
        w = s.gather(1, top)
        return top, w / (w.sum(-1, keepdim=True) + 1e-20) \
            * c.routed_scaling_factor
    monkeypatch.setattr(moe, "route", route)
    return cfg


FAULTS = {
    "bias_in_weights": _bias_in_weights,
    "no_scaling_factor": lambda m, cfg: dataclasses.replace(
        cfg, routed_scaling_factor=1.0),
    "no_normalization": lambda m, cfg: dataclasses.replace(
        cfg, norm_topk_prob=False),
    "rotate_half_pairing": lambda m, cfg: (
        m.setattr(mla, "deinterleave", lambda x: x), cfg)[1],
    "kv_a_norm_skipped": lambda m, cfg: (
        m.setattr(mla, "rms_norm", lambda x, g, eps: x), cfg)[1],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(monkeypatch, fault):
    """Each departure from the source's equations, planted in the port,
    moves the logits past TOL, full pass and cached decode alike."""
    cfg, dec, w = _decoder()
    cfg = FAULTS[fault](monkeypatch, cfg)
    want = _reference(w)
    assert _rel(_full(cfg, dec), want) > 100 * TOL
    assert _rel(_cached(cfg, dec, 12), want) > 100 * TOL


@pytest.mark.parametrize("field,value", [
    ("scoring_func", "softmax"), ("topk_method", "greedy"),
    ("n_group", 2), ("q_lora_rank", 16),
    ("rope_scaling", {"rope_type": "linear", "factor": 2.0})])
def test_unimplemented_settings_are_refused_by_name(field, value):
    with pytest.raises(ValueError, match=field):
        tconfig.LlamaConfig(**{**DEC, field: value})


def test_int8_latent_cache_tp_and_int8_weights_are_refused():
    from mtasr_tpu_torch.parallel.mesh import layout
    from mtasr_tpu_torch.utils.quantize import quantize_decoder_for_serving
    cfg = tconfig.LlamaConfig(**DEC)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        KVCache.init(cfg, 1, 4, torch.float32, "cpu", quantized=True)
    comp = tconfig.SpeechEncoderDecoderConfig(decoder=cfg)
    with pytest.raises(NotImplementedError, match="tp"):
        layout({}, comp, 2)
    holder = torch.nn.Module()
    holder.decoder = Llama(cfg)
    with pytest.raises(NotImplementedError, match="w8a8"):
        quantize_decoder_for_serving(holder, "w8a8")


def test_a_llama_config_json_leaves_out_the_deepseek_fields():
    """A LLaMA config round-trips through config.json without the port's
    DeepSeek-V3 keys (so the JAX package reads it); a Moonlight one keeps
    them."""
    import json
    llama = tconfig.SpeechEncoderDecoderConfig()
    d = json.loads(llama.to_json())["decoder"]
    assert not set(tconfig.DEEPSEEK_FIELDS) & set(d)
    moon = tconfig.SpeechEncoderDecoderConfig(
        decoder=tconfig.moonlight_16b_a3b_config(vocab_size=128264))
    back = tconfig.SpeechEncoderDecoderConfig.from_json(moon.to_json())
    assert dataclasses.asdict(back.decoder) == dataclasses.asdict(moon.decoder)


def _composite(seed=0):
    """A tiny WavLM with the tiny DeepSeek-V3 decoder, float32, random."""
    from mtasr_tpu_torch.utils.convert import init_random
    enc = tconfig.WavLMConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=48, conv_dim=(8, 8), conv_stride=(5, 2),
        conv_kernel=(10, 3), num_buckets=16, max_bucket_distance=20,
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2,
        add_adapter=True, num_adapter_layers=3, output_hidden_size=16,
        mask_time_prob=0.0, do_stable_layer_norm=True,
        feat_extract_norm="layer")
    dec = tconfig.LlamaConfig(**{**DEC, "bos_token_id": 1,
                                 "eos_token_id": 39})
    cfg = tconfig.SpeechEncoderDecoderConfig(
        encoder=enc, decoder=dec, pad_token_id=37, sc_token_id=38,
        eos_token_id=39, bos_token_id=1, decoder_start_token_id=1)
    model = init_random(cfg, torch.Generator().manual_seed(seed), "cpu",
                        torch.float32)
    with torch.no_grad():     # tokens that vary from step to step
        for p in model.decoder.parameters():
            if p.dim() == 2:
                p.mul_(4)
    g = torch.Generator().manual_seed(seed + 1)
    wav = torch.randn((3, 4000), generator=g)
    amask = torch.ones_like(wav, dtype=torch.int32)
    amask[-1, 2500:] = 0
    return cfg, model, wav, amask


def test_beam_and_speculative_decoding_run_on_the_latent_cache():
    """Both work through the cache's interface (`KVCache.k` the latents,
    `v` empty): beam search at one beam is greedy, at three beams it runs;
    speculative decoding with the greedy tokens as drafts, or with wrong
    ones, gives the greedy tokens."""
    from mtasr_tpu_torch.config import GenerationConfig
    from mtasr_tpu_torch.generate import beam, engine, speculative
    cfg, model, wav, amask = _composite()
    greedy = engine.generate(model, cfg, wav, amask,
                             gen=GenerationConfig(do_sample=False),
                             max_new_tokens=8).sequences
    assert len(set(greedy[0].tolist())) > 2
    b1 = beam.beam_generate(model, cfg, wav, amask, num_beams=1,
                            max_new_tokens=8)
    assert torch.equal(b1.sequences[:, 0], greedy)
    b3 = beam.beam_generate(model, cfg, wav, amask, num_beams=3,
                            max_new_tokens=8)
    assert tuple(b3.sequences.shape) == (3, 3, 8)
    for drafts, accepted in ((greedy[:, :4], True),
                             ((greedy[:, :4] + 1) % 37, False)):
        out, st = speculative.generate_speculative(
            model, cfg, wav, amask, gen=GenerationConfig(do_sample=False),
            max_new_tokens=8, draft_tokens=drafts)
        assert torch.equal(out.sequences, greedy)
        assert (st.accepted_drafts > 0) == accepted


def test_traced_call_counts_the_routed_pairs():
    """Under a profiler the engine reads the experts' tally once a call:
    each forward's tokens times top-k over the expert layers, the busiest
    expert's share, and the experts that had pairs."""
    from torch.profiler import ProfilerActivity, profile
    from mtasr_tpu_torch.config import GenerationConfig
    from mtasr_tpu_torch.generate import engine
    from mtasr_tpu_torch.utils import profiling
    cfg, model, wav, amask = _composite()
    engine.generate(model, cfg, wav, amask, max_new_tokens=3)
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = engine.generate(model, cfg, wav, amask,
                              gen=GenerationConfig(do_sample=False),
                              max_new_tokens=6)
    spans, counts = profiling.take()
    enc = cfg.encoder
    T8 = enc.adapter_output_length(enc.conv_output_length(wav.shape[1]))
    forwards = 3 * (1 + T8) + 3 * out.steps
    layers, k = 2, DEC["num_experts_per_tok"]
    assert counts[moe.PAIRS] == layers * k * forwards
    assert counts[moe.PAIRS] / layers <= counts[moe.PAIRS_MAX] * 8
    assert layers * (1 + out.steps) <= counts[moe.EXPERTS_READ] \
        <= layers * 8 * (1 + out.steps)
    names = {s.name for s in spans}
    assert {"mtasr.decoder.moe.route", "mtasr.decoder.moe.experts",
            "mtasr.decoder.moe.shared", "mtasr.decoder.attention"} <= names


def test_an_untraced_forward_keeps_no_tally():
    """Without a profiler the layer neither makes the experts' tally nor
    adds to it (the counts are read only while spans are kept); under one
    it adds each expert layer's pairs."""
    from torch.profiler import ProfilerActivity, profile
    cfg, dec, _ = _decoder()
    _full(cfg, dec)
    assert "_moe_tally" not in dec.__dict__
    with profile(activities=[ProfilerActivity.CPU]):
        _full(cfg, dec)
    tally = dec.__dict__["_moe_tally"]
    assert int(tally[:, 0].sum()) == 2 * B * L * DEC["num_experts_per_tok"]
    _full(cfg, dec)
    assert int(tally[:, 0].sum()) == 2 * B * L * DEC["num_experts_per_tok"]


def test_dispatch_sorts_the_pairs_by_expert_and_counts_them():
    """The dispatch's sorted pairs, offsets and counts, which the grouped
    kernel reads on the device, against a count on the host."""
    g = torch.Generator().manual_seed(3)
    top = torch.stack([torch.randperm(8, generator=g)[:2] for _ in range(13)])
    order, rows, offsets, counts = moe.dispatch(top, 8)
    flat = top.reshape(-1)
    want = torch.bincount(flat, minlength=8)
    assert torch.equal(counts.long(), want)
    assert torch.equal(offsets[1:].long(), torch.cumsum(want, 0))
    assert torch.equal(flat[order], torch.sort(flat, stable=True).values)
    assert torch.equal(rows.long(), order // 2)
