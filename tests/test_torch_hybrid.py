"""Hybrid SOT+CTC training and the one-shot CTC decode in the port against
the JAX package, on the CPU in float32 (`tiny_cfg(train_mode="hybrid",
talker_ctc=True)`, dropouts 0 where the two are compared, the same
`mask_time_indices` given to both):

* the losses: `build_perm`, `batch_swap_stats`, `serialized_ctc_loss`,
  `pit_ctc_loss`, `hybrid_loss` (ctc and hybrid); `model_forward`'s loss
  and aux;
* `pcgrad_project` on random gradients with a negative dot;
* train steps against the jitted JAX `make_train_step`, 2 steps each:
  PCGrad's three-stage split with freeze_decoder + LoRA, the PIT branch,
  PCGrad off; loss, loss_attn, loss_ctc, grad_norm, ctc_head_grad_norms and
  every parameter (the encoder adapter, which no head reads, moves by its
  weight decay alone); remat on equals remat off;
* `Trainer.train` in hybrid mode, vector metrics logged as lists;
* `forward_ctc` and `Transcriber.transcribe_ctc` string-identical to JAX;
* `load_flat` of a talker_ctc tree, strict.

Tolerances as `tests/test_torch_train.py`: loss rtol 1e-5, grad norms rtol
1e-4, parameters within 1 % of lr. The train steps run AdamW with
adam_epsilon 1e-4: the CTC's losses of 10^2-10^3 make the clipped gradient
of a few elements fall near the f32 rounding of the sums, where Adam's
g / (|g| + eps) at eps 1e-8 turns the two sides' rounding into a visible
fraction of lr (a pos-conv element moved 0.44 lr apart, a separator LSTM
element 0.012 lr at eps 1e-6); at 1e-4 such an element moves in
proportion to its gradient, and the typical one (|g| ~ 3e-3) still by
about lr.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.api import Transcriber as JaxTranscriber
from mtasr_tpu.config import DataConfig, GenerationConfig
from mtasr_tpu.config import TrainingConfig as JaxTrainingConfig
from mtasr_tpu.data.tokenizer import CharTokenizer
from mtasr_tpu.models import losses as jlosses
from mtasr_tpu.models.speech_encoder_decoder import (
    forward_ctc as jax_forward_ctc, init_model_params,
    model_forward as jax_model_forward,
)
from mtasr_tpu.train import freeze as jfreeze
from mtasr_tpu.train.lora import init_decoder_lora as jax_init_lora
from mtasr_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from mtasr_tpu.train.train_step import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
    pcgrad_project as jax_pcgrad_project,
)
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.data.pipeline import (
    PreparedExample, batches_from_examples,
)
from mtasr_tpu_torch.data.specaugment import compute_mask_indices
from mtasr_tpu_torch.data.tokenizer import CharTokenizer as TCharTokenizer
from mtasr_tpu_torch.models import losses as tlosses
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel, ctc_heads, forward_ctc, model_forward,
)
from mtasr_tpu_torch.ops import kernels
from mtasr_tpu_torch.train.freeze import apply_trainable_mask, trainable_mask
from mtasr_tpu_torch.train.loop import Trainer
from mtasr_tpu_torch.train.optimizer import is_no_decay, make_optimizer
from mtasr_tpu_torch.train.train_step import (
    make_eval_step, make_train_step, pcgrad_project,
)
from mtasr_tpu_torch.utils.convert import load_flat
from tests.test_composite import make_batch, tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
LR = 1e-3
PARAM_ATOL = 1e-2 * LR


def _cfg(mode="hybrid", **kw):
    cfg = tiny_cfg(**{"train_mode": mode, "talker_ctc": True,
                      "lora_dropout": 0.0, "separator_dropout": 0.0, **kw})
    cfg.encoder.num_hidden_layers = 2
    cfg.encoder.mask_time_prob = 0.05   # gives the model masked_spec_embed
    return cfg


def _port(cfg):
    return tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)


def _params(cfg, lora=False, seed=0):
    params = init_model_params(jax.random.key(seed), cfg)
    if lora:
        params["decoder_lora"] = jax_init_lora(
            jax.random.key(seed + 1), params["decoder"], r=4, alpha=8.0)
        rng = np.random.default_rng(seed + 2)
        for li, projs in params["decoder_lora"].items():
            if li != "__meta__":
                for ab in projs.values():   # a nonzero B: A gets gradients
                    ab["lora_B"] = jnp.asarray(rng.standard_normal(
                        ab["lora_B"].shape).astype(np.float32) * 0.05)
    return params


def _model(cfg, params):
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, tree_to_flat(params), training=True)
    return model


def _batch(cfg, B=2, seed=2):
    # 0.2 s rows: 319 frames at 50 Hz (the second padded to half)
    wav, amask, arr = make_batch(cfg, B=B, S=3200, seed=seed)
    T0 = cfg.encoder.conv_output_length(wav.shape[1])
    lens = [cfg.encoder.conv_output_length(int(m.sum())) for m in amask]
    feat = (np.arange(T0)[None] < np.asarray(lens)[:, None]).astype(int)
    mti = compute_mask_indices((B, T0), 0.05, 10, attention_mask=feat,
                               min_masks=2, rng=np.random.default_rng(seed))
    return {"input_values": wav, "audio_mask": amask, "mask_time_indices": mti,
            **{k: arr[k] for k in ("decoder_input_ids", "ce_labels",
                                   "label_spks", "label_spk_lens")}}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [None, "swap01", "reverse", "rotate"])
def test_build_perm_matches_jax(mode):
    for n, step in ((2, 0), (3, 150), (3, 250)):
        assert tlosses.build_perm(n, mode, step) == \
            jlosses.build_perm(n, mode, step)
    with pytest.raises(ValueError):
        tlosses.build_perm(2, "bogus")


def test_batch_swap_stats_matches_jax():
    bp = np.array([[0, 1], [1, 0], [1, 0], [0, 1], [1, 0]])
    cnt, B, ratio = tlosses.batch_swap_stats(torch.from_numpy(bp))
    jc, jB, jr = jlosses.batch_swap_stats(jnp.asarray(bp))
    assert int(cnt) == int(jc) == 3 and B == jB
    assert float(ratio) == pytest.approx(float(jr))


def _heads_and_streams(cfg, seed=4, B=3, T=15):
    params = init_model_params(jax.random.key(seed), cfg)
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, tree_to_flat(params))
    rng = np.random.default_rng(seed)
    d50 = cfg.encoder.hidden_size
    sep = [rng.standard_normal((B, T, d50)).astype(np.float32)
           for _ in range(cfg.talker_numbers)]
    hlens = np.array([T, T - 4, 9], np.int32)
    spks = rng.integers(3, 40, (2, B, 4)).astype(np.int32)
    spk_lens = np.array([[4, 2, 3], [3, 4, 0]], np.int32)
    jheads = [params["serialized_ctc"][str(k)]
              for k in range(cfg.talker_numbers)]
    return jheads, ctc_heads(model, _port(cfg)), sep, hlens, spks, spk_lens


@pytest.mark.parametrize("perm", [None, [1, 0]])
def test_serialized_and_pit_ctc_match_jax(perm):
    cfg = _cfg()
    jh, th, sep, hl, spks, sl = _heads_and_streams(cfg)
    blank = cfg.ctc_blank_id
    ref, ref_ph = jlosses.serialized_ctc_loss(
        jh, [jnp.asarray(s) for s in sep], jnp.asarray(hl),
        jnp.asarray(spks), jnp.asarray(sl), blank, perm)
    tsep = [torch.from_numpy(s) for s in sep]
    with torch.no_grad():
        got, ph = tlosses.serialized_ctc_loss(
            th, tsep, *_tb({"a": hl, "b": spks, "c": sl}).values(), blank,
            perm)
        pit, assigned, best = tlosses.pit_ctc_loss(
            th, tsep, *_tb({"a": hl, "b": spks, "c": sl}).values(), blank)
    _close(float(got), float(ref), LOSS_RTOL)
    _close(ph.numpy(), ref_ph, LOSS_RTOL)
    jpit, jassigned, jbest = jlosses.pit_ctc_loss(
        jh, [jnp.asarray(s) for s in sep], jnp.asarray(hl),
        jnp.asarray(spks), jnp.asarray(sl), blank)
    _close(float(pit), float(jpit), LOSS_RTOL)
    _close(assigned.numpy(), jassigned, LOSS_RTOL)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))


@pytest.mark.parametrize("mode", ["ctc", "hybrid"])
def test_model_forward_and_eval_step_match_jax(mode):
    cfg = _cfg(mode)
    params = _params(cfg)
    model = _model(cfg, params)
    batch = _batch(cfg)
    jb, tb = _jb(batch), _tb(batch)
    kw = dict(ce_labels=jb["ce_labels"], label_spks=jb["label_spks"],
              label_spk_lens=jb["label_spk_lens"])
    ref = jax_model_forward(params, cfg, jb["input_values"],
                            jb["audio_mask"], jb["decoder_input_ids"], **kw)
    with torch.no_grad():
        out = model_forward(model, _port(cfg), tb["input_values"],
                            tb["audio_mask"], tb["decoder_input_ids"],
                            ce_labels=tb["ce_labels"],
                            label_spks=tb["label_spks"],
                            label_spk_lens=tb["label_spk_lens"])
    _close(float(out.loss), float(ref.loss), LOSS_RTOL)
    assert set(out.aux) == set(ref.aux)
    for k in out.aux:
        _close(out.aux[k].numpy(), ref.aux[k], LOSS_RTOL, k)
    jm = jax_make_eval_step(cfg)(params, jb)
    m = make_eval_step(_port(cfg))(model, tb)
    assert set(m) == set(jm)
    for k in m:
        _close(float(m[k]), float(jm[k]), LOSS_RTOL, k)


# ---------------------------------------------------------------------------
# PCGrad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [2, 3])
def test_pcgrad_project_matches_jax(K):
    rng = np.random.default_rng(K)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(K)]
    # head 1 points against head 0: a negative dot, so a projection
    grads[1] = [-g * 0.7 + rng.standard_normal(g.shape).astype(np.float32)
                * 0.1 for g in grads[0]]
    dot01 = sum(float((a * b).sum()) for a, b in zip(grads[0], grads[1]))
    assert dot01 < 0
    ref = jax_pcgrad_project([{str(i): jnp.asarray(g) for i, g in
                               enumerate(gs)} for gs in grads])
    got = pcgrad_project([[torch.from_numpy(g) for g in gs] for gs in grads])
    plain_sum = [sum(gs[i] for gs in grads) for i in range(len(shapes))]
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[str(i)]),
                                   rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[0].numpy(), plain_sum[0])


VARIANTS = {
    # the recipe: freeze_decoder + LoRA, PCGrad three-stage, warmup 0
    "pcgrad": dict(pcgrad=True, pit=False, lora=True,
                   freeze=dict(freeze_decoder=True)),
    "pit": dict(pcgrad=True, pit=True, lora=False,
                freeze=dict(freeze_decoder=True)),
    "no_pcgrad": dict(pcgrad=False, pit=False, lora=False, freeze=dict()),
}


def _steps(variant, n_steps=2, remat=False):
    v = VARIANTS[variant]
    cfg = _cfg()
    params = _params(cfg, v["lora"])
    tc_kw = dict(learning_rate=LR, warmup_steps=0, max_steps=10,
                 weight_decay=0.01, max_grad_norm=1.0, adam_epsilon=1e-4,
                 pcgrad=v["pcgrad"])
    jmask = jfreeze.trainable_mask(params, train_mode="hybrid", **v["freeze"])
    jopt = jax_make_optimizer(JaxTrainingConfig(**tc_kw), jmask)
    jstep = jax_make_train_step(cfg, JaxTrainingConfig(**tc_kw), jopt,
                                trainable_mask=jmask, use_pit=v["pit"],
                                donate=False)
    pcfg = _port(cfg)
    pcfg.encoder.remat = remat
    model = _model(cfg, params)
    mask = trainable_mask(model, train_mode="hybrid", **v["freeze"])
    apply_trainable_mask(model, mask)
    jflat = tree_to_flat(jmask)
    assert {n: bool(jflat[n]) for n in mask} == mask
    tc = tconfig.TrainingConfig(**tc_kw)
    step = make_train_step(pcfg, tc, make_optimizer(model, tc),
                           use_pit=v["pit"])
    return cfg, params, model, mask, step, jstep, jopt


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_steps_match_jax(variant):
    cfg, params, model, mask, step, jstep, jopt = _steps(variant)
    adapter0 = {n: p.detach().clone() for n, p in model.named_parameters()
                if n.startswith("encoder.adapter.") and mask[n]}
    jparams, jstate = params, jopt.init(params)
    kernels.reset_launch_counts()
    for i in range(2):
        batch = _batch(cfg, seed=10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, _jb(batch),
                                    jax.random.key(i))
        m = step(model, _tb(batch), None)
        assert set(m) == set(jm), (set(m), set(jm))
        for k in ("loss", "loss_attn", "loss_ctc"):
            _close(float(m[k]), float(jm[k]), LOSS_RTOL, k)
        _close(float(m["grad_norm"]), float(jm["grad_norm"]), GNORM_RTOL)
        if "ctc_head_grad_norms" in m:
            _close(m["ctc_head_grad_norms"].numpy(),
                   jm["ctc_head_grad_norms"], GNORM_RTOL)
        if "pit_swap_ratio" in m:
            _close(float(m["pit_swap_ratio"]), float(jm["pit_swap_ratio"]),
                   1e-6)
        jf = tree_to_flat(jparams)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), np.reshape(jf[name], tuple(p.shape)),
                rtol=0, atol=PARAM_ATOL, err_msg=f"{name} step {i + 1}")
    assert sum(kernels.launch_counts().values()) == 0    # CPU: plain only
    if VARIANTS[variant]["pcgrad"]:
        # no head reads the adapter and the total loss's shared gradient is
        # discarded: its update is AdamW's weight decay alone
        assert adapter0
        # lr is LR at the first update, 0.9 LR at the second (linear decay
        # over 10 steps, no warmup); biases and norms take no decay
        for n, p0 in adapter0.items():
            p = dict(model.named_parameters())[n].detach()
            wd = 0.0 if is_no_decay(n) else 0.01
            want = p0 * (1 - LR * wd) * (1 - 0.9 * LR * wd)
            torch.testing.assert_close(p, want, rtol=1e-6, atol=1e-9, msg=n)


def test_remat_on_equals_remat_off():
    cfg = _cfg()
    batch = _tb(_batch(cfg, seed=3))
    out = {}
    for remat in (False, True):
        _, _, model, _, step, _, _ = _steps("pcgrad", remat=remat)
        m = step(model, batch, None)
        out[remat] = (m, {n: p.detach().clone()
                          for n, p in model.named_parameters()})
    (m0, p0), (m1, p1) = out[False], out[True]
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-5, atol=1e-6)
    for n in p0:
        torch.testing.assert_close(p1[n], p0[n], rtol=0, atol=1e-7, msg=n)


def _dataset(tok, n=6, seed=0):
    rng = np.random.default_rng(seed)
    words = ["hello", "world", "good", "day"]
    out = []
    for i in range(n):
        text = (" ".join(rng.choice(words, 2)) + " <sc> "
                + " ".join(rng.choice(words, 2)))
        wav = (rng.standard_normal(int(rng.integers(3000, 3900)))
               * 0.2).astype(np.float32)
        out.append(PreparedExample(f"u{i}", wav, [], tok.encode(text, False)))
    return out


def test_trainer_trains_hybrid(tmp_path):
    """Trainer.train in hybrid mode with PCGrad, dropout (separator and
    LoRA), SpecAugment and remat on: a few steps, metrics.jsonl with the
    per-head gradient norms as lists; eval_loss with loss_ctc."""
    tok = TCharTokenizer()
    sp = tok.add_special_tokens()
    cfg = _cfg(pad_token_id=sp.pad_token_id, sc_token_id=sp.sc_token_id,
               lora_dropout=0.1, separator_dropout=0.2)
    cfg.decoder.vocab_size = len(tok) + 8
    cfg.encoder.remat = True
    model = _model(cfg, _params(cfg, lora=True))
    pcfg = _port(cfg)
    dc = tconfig.DataConfig(bucket_boundaries_seconds=(0.25,),
                            max_label_length=40)
    tc = tconfig.TrainingConfig(output_dir=str(tmp_path), learning_rate=1e-3,
                                warmup_steps=1, max_steps=3, logging_steps=1,
                                pcgrad=True)
    trainer = Trainer(pcfg, tc, dc, model,
                      freeze_kwargs=dict(freeze_decoder=True))
    sep0 = model.separator.pre_proj.weight.detach().clone()
    examples = _dataset(tok)
    state = trainer.train(lambda epoch: batches_from_examples(
        examples, pcfg, dc, 2, seed=epoch))
    assert state.step == 3
    log = [json.loads(x) for x in
           (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(log) == 3
    for m in log:
        assert isinstance(m["ctc_head_grad_norms"], list)
        assert len(m["ctc_head_grad_norms"]) == 2
        assert np.isfinite([m["loss"], m["loss_ctc"], m["loss_attn"]]).all()
    assert not torch.equal(model.separator.pre_proj.weight, sep0)
    batches = list(batches_from_examples(examples, pcfg, dc, 3,
                                         training=False, shuffle=False))
    assert np.isfinite(trainer.evaluate(batches, with_generate=False)[
        "eval_loss"])


# ---------------------------------------------------------------------------
# one-shot CTC decode and loading
# ---------------------------------------------------------------------------
def test_forward_ctc_matches_jax():
    cfg = _cfg()
    params = _params(cfg, seed=5)
    model = _model(cfg, params)
    wav, amask, _ = make_batch(cfg, B=3, seed=6)
    ref, ref_len = jax_forward_ctc(params, cfg, jnp.asarray(wav),
                                   jnp.asarray(amask), max_out_len=12)
    with torch.no_grad():
        got, got_len = forward_ctc(model, _port(cfg), torch.from_numpy(wav),
                                   torch.from_numpy(amask), max_out_len=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert int(got_len.sum()) > 0


def test_transcribe_ctc_matches_jax():
    cfg = _cfg()
    tok, ttok = CharTokenizer(), TCharTokenizer()
    sp = tok.add_special_tokens()
    ttok.add_special_tokens()
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    params = _params(cfg, seed=7)
    model = _model(cfg, params)
    gen = GenerationConfig(do_sample=False)
    dc = DataConfig(min_duration_in_seconds=0.0, max_duration_in_seconds=1e9,
                    bucket_boundaries_seconds=(0.25, 0.5, 1.0))
    jt = JaxTranscriber(cfg, params, tok, gen=gen, dc=dc)
    tt = Transcriber(_port(cfg), model, ttok,
                     gen=tconfig.from_fields(tconfig.GenerationConfig, gen),
                     dc=tconfig.from_fields(tconfig.DataConfig, dc))
    rng = np.random.default_rng(8)
    wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (12000, 3000, 9000)]
    for clean in (False, True):
        got = tt.transcribe_ctc(wavs, batch_size=2, max_out_len=20,
                                clean=clean)
        assert got == jt.transcribe_ctc(wavs, batch_size=2, max_out_len=20,
                                        clean=clean)
        assert len(got) == 3 and all(len(s) == 2 for s in got)
    assert any(any(s) for s in got)
    with pytest.raises(ValueError, match="talker_ctc"):
        Transcriber(dataclasses.replace(_port(cfg), talker_ctc=False,
                                        train_mode="attention"), model,
                    ttok).transcribe_ctc(wavs)


def test_load_flat_talker_ctc_tree_is_strict():
    cfg = _cfg()
    flat = tree_to_flat(init_model_params(jax.random.key(0), cfg))
    assert any(k.startswith("separator.lstm.cells.") for k in flat)
    assert "serialized_ctc.1.ctc_lo.weight" in flat
    model = SpeechEncoderDecoderModel(_port(cfg))
    load_flat(model, flat)
    torch.testing.assert_close(
        model.serialized_ctc["1"].ctc_lo.weight,
        torch.from_numpy(np.array(flat["serialized_ctc.1.ctc_lo.weight"])))
    assert model.serialized_ctc["0"].ctc_lo.weight.shape[0] == cfg.ctc_odim
    missing = {k: v for k, v in flat.items()
               if k != "separator.post_ln.weight"}
    with pytest.raises(RuntimeError, match="post_ln"):
        load_flat(SpeechEncoderDecoderModel(_port(cfg)), missing)
