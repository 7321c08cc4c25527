"""The port's spans and counters (`mtasr_tpu_torch/utils/profiling.py`) on
the serving path, on the CPU at a tiny size: off outside a profiler (one
shared no-op, the same tokens), one root span a call with every child
inside its parent and of its call, the decode loop's steps and eos checks
counted as the loop runs them, the decoder's blocks once a layer a
forward, the CTC heads once a head, and a span's clock the profiler's."""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.data.tokenizer import CharTokenizer
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models.llama import llama_forward
from mtasr_tpu_torch.models.speech_encoder_decoder import forward_ctc
from mtasr_tpu_torch.utils import profiling
from mtasr_tpu_torch.utils.convert import init_random
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

STEPS = "mtasr.engine.decode.steps"
GREEDY = tconfig.GenerationConfig(do_sample=False)


def _cfg(**kw):
    cfg = tiny_cfg(train_mode="hybrid", talker_ctc=True, **kw)
    cfg.encoder.num_hidden_layers = 2
    tok = CharTokenizer()
    sp = tok.add_special_tokens()
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    return tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg), tok


@pytest.fixture(scope="module")
def served():
    cfg, tok = _cfg()
    model = init_random(cfg, torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
    dc = tconfig.DataConfig(min_duration_in_seconds=0.0,
                            max_duration_in_seconds=1e9,
                            bucket_boundaries_seconds=(0.25, 0.5, 1.0))
    tr = Transcriber(cfg, model, tok, gen=GREEDY, dc=dc)
    rng = np.random.default_rng(3)
    wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (12000, 3000, 9000)]
    return cfg, model, tr, wavs


def _recorded(fn):
    """(fn's result, spans, counters) of one run under a CPU profiler."""
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    spans, counts = profiling.take()
    return out, spans, counts


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_is_one_shared_noop_and_keeps_nothing():
    profiling.take()
    a, b = profiling.annotate("mtasr.a"), profiling.annotate("mtasr.b")
    assert a is b
    with a as entered:
        assert entered is None
    profiling.count(STEPS)
    assert profiling.take() == ([], {})


def test_same_tokens_with_spans_on_and_off(served):
    cfg, model, tr, wavs = served
    wav = torch.from_numpy(np.stack([w[:3000] for w in wavs]))
    amask = torch.ones_like(wav, dtype=torch.int32)

    def run():
        return (tr.transcribe(wavs, batch_size=2, max_new_tokens=6),
                engine.generate(model, cfg, wav, amask, gen=GREEDY,
                                max_new_tokens=6).sequences)
    off_text, off_ids = run()
    (on_text, on_ids), spans, _ = _recorded(run)
    assert on_text == off_text
    assert torch.equal(on_ids, off_ids)
    assert spans


@pytest.mark.parametrize("entry", ["transcribe", "transcribe_ctc"])
def test_one_root_a_call_and_children_nest(served, entry):
    _, _, tr, wavs = served
    kw = {"max_new_tokens": 5} if entry == "transcribe" else {}
    _, spans, _ = _recorded(
        lambda: getattr(tr, entry)(wavs, batch_size=2, **kw))
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == [f"mtasr.api.{entry}"]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.call == p.call
        assert s.call == roots[0].id
    names = {s.name for s in spans}
    engine_root = ("mtasr.engine.generate" if entry == "transcribe"
                   else "mtasr.engine.generate_ctc")
    for want in ("mtasr.api.prepare", "mtasr.api.to_device",
                 "mtasr.api.to_host", "mtasr.api.detokenize",
                 "mtasr.pipeline.collate", engine_root,
                 "mtasr.encoder.wavlm", "mtasr.encoder.separator"):
        assert want in names, want
    # two batches (3 recordings, batch_size 2): one engine call each
    assert len(_named(spans, engine_root)) == 2
    assert len(_named(spans, "mtasr.pipeline.collate")) == 2


@pytest.mark.parametrize("max_new", [2, 9, 18])
def test_decode_steps_and_eos_checks_counted(served, max_new):
    cfg, model, _, wavs = served
    wav = torch.from_numpy(np.stack([w[:3000] for w in wavs]))
    out, spans, counts = _recorded(lambda: engine.generate(
        model, cfg, wav, None, gen=GREEDY, max_new_tokens=max_new))
    steps = _named(spans, "mtasr.engine.decode.step")
    checks = _named(spans, "mtasr.engine.eos_check")
    early = out.steps < max_new - 1
    assert len(steps) == out.steps + early
    assert counts.get(STEPS, 0) == out.steps
    # one check every EOS_CHECK_EVERY iterations, the first before step 1
    iterations = out.steps + early
    assert len(checks) == -(-iterations // engine.EOS_CHECK_EVERY)
    step_ids = {s.id for s in steps}
    assert all(c.parent in step_ids for c in checks)
    picks = _named(spans, "mtasr.engine.pick")
    assert len(picks) == out.steps + 1       # the prefill's pick, each step
    assert len(_named(spans, "mtasr.engine.prefill")) == 1
    assert len(_named(spans, "mtasr.engine.encode")) == 1


class _AllEos:
    """A token choice that emits eos for every row."""
    generator = None

    def __init__(self, eos):
        self.eos = eos

    def __call__(self, logits):
        return torch.full(logits.shape[:1], self.eos, dtype=torch.long)

    def all_done(self, done):
        return bool(done.all())


def test_a_loop_stopped_at_a_check_holds_that_check_alone(served):
    cfg, model, _, wavs = served
    wav = torch.from_numpy(np.stack([w[:3000] for w in wavs]))
    enc = engine.encode_maybe_chunked(model, cfg, wav, None, None)
    ids, splice = engine.prompt_layout(cfg, wav.shape[0], None, "cpu")
    out, spans, counts = _recorded(lambda: engine.decode_encoded(
        model, cfg, enc, ids, splice, GREEDY, 10, _AllEos(cfg.eos_token_id)))
    assert out.steps == 0 and STEPS not in counts
    [step] = _named(spans, "mtasr.engine.decode.step")
    [check] = _named(spans, "mtasr.engine.eos_check")
    assert check.parent == step.id
    # the prefill's layers alone: no step ran the decoder
    assert len(_named(spans, "mtasr.decoder.attention")) == \
        cfg.decoder.num_hidden_layers


def test_decoder_blocks_once_a_layer_a_forward(served):
    cfg, model, _, _ = served
    dec = cfg.decoder
    x = torch.randn(2, 5, dec.hidden_size)
    pos = torch.arange(5)[None].expand(2, 5)
    _, spans, _ = _recorded(
        lambda: llama_forward(model.decoder, dec, x, pos))
    n = dec.num_hidden_layers
    assert len(_named(spans, "mtasr.decoder.attention")) == n
    assert len(_named(spans, "mtasr.decoder.mlp")) == n
    [head] = _named(spans, "mtasr.decoder.head")
    attn, mlp = (_named(spans, f"mtasr.decoder.{k}")
                 for k in ("attention", "mlp"))
    for a, m in zip(attn, mlp):     # in layer order, attention first
        assert a.end_ns <= m.start_ns
    assert mlp[-1].end_ns <= head.start_ns


def test_ctc_heads_once_a_head(served):
    cfg, model, _, wavs = served
    wav = torch.from_numpy(np.stack([w[:3000] for w in wavs]))
    _, spans, _ = _recorded(lambda: forward_ctc(model, cfg, wav, None, 20))
    k = cfg.talker_numbers
    assert len(_named(spans, "mtasr.ctc.heads")) == k
    assert len(_named(spans, "mtasr.ctc.collapse")) == k
    assert len(_named(spans, "mtasr.encoder.wavlm")) == 1
    assert len(_named(spans, "mtasr.encoder.separator")) == 1


def test_a_span_is_on_the_profilers_clock():
    x = torch.randn(64, 64)
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("mtasr.clock"):
            x @ x
    [span], _ = profiling.take()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert ops
    for e in ops:
        assert span.start_ns <= e.start_ns() <= e.end_ns() <= span.end_ns


def test_threads_keep_their_own_parents():
    profiling.take()
    barrier = threading.Barrier(2)

    def work(name):
        with profiling.annotate(f"mtasr.{name}"):
            barrier.wait(timeout=30)
            with profiling.annotate(f"mtasr.{name}.inner"):
                barrier.wait(timeout=30)

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans, _ = profiling.take()
    by_name = {s.name: s for s in spans}
    for n in ("a", "b"):
        outer, inner = by_name[f"mtasr.{n}"], by_name[f"mtasr.{n}.inner"]
        assert outer.parent == 0 and outer.call == outer.id
        assert inner.parent == outer.id and inner.call == outer.id
    assert by_name["mtasr.a"].call != by_name["mtasr.b"].call
