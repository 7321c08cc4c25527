"""Training and model directories with the bridge and adapter family, the
port against the JAX package on the CPU (float32, `tiny_cfg` widths):

* one hybrid PCGrad step (the three-stage split and the PIT branch) of a
  model with the refiner, the raw bridge and adapgatetiny adapters over
  the separated streams, against the jitted JAX step: loss, loss_attn,
  loss_ctc within rtol 1e-5, grad_norm and the per-head gradient norms
  within rtol 1e-4, every parameter within 1 % of lr (`tests/
  test_torch_hybrid.py`'s tolerances and adam_epsilon 1e-4); the
  trainable mask and the decay mask equal to JAX's key for key, the 0-d
  parameters included; the encoder adapter, which the raw bridge reads in
  stage B, moves by its weight decay alone;
* `Trainer` in attention mode (adapters, no CTC heads) and in hybrid mode
  (the family with PCGrad): steps with a finite loss that move the
  family's parameters;
* a model directory with adapters written by the JAX package: loaded
  strictly by the port, served with JAX's transcripts; the port's
  `save_model` -> `load_model` keeps every tensor, the 0-d ones too, and
  the JAX package reads the port's directory back bit-equal.
"""
import json

import jax
import numpy as np
import pytest
import torch

from mtasr_tpu.api import Transcriber as JaxTranscriber
from mtasr_tpu.config import DataConfig, GenerationConfig
from mtasr_tpu.config import TrainingConfig as JaxTrainingConfig
from mtasr_tpu.data.tokenizer import CharTokenizer
from mtasr_tpu.train import freeze as jfreeze
from mtasr_tpu.train.lora import init_decoder_lora as jax_init_lora
from mtasr_tpu.train.optimizer import hf_decay_mask
from mtasr_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from mtasr_tpu.train.train_step import make_train_step as jax_make_train_step
from mtasr_tpu.utils import model_io as jmodel_io
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.data.pipeline import batches_from_examples
from mtasr_tpu_torch.data.tokenizer import CharTokenizer as TCharTokenizer
from mtasr_tpu_torch.train.freeze import apply_trainable_mask, trainable_mask
from mtasr_tpu_torch.train.loop import Trainer
from mtasr_tpu_torch.train.optimizer import is_no_decay, make_optimizer
from mtasr_tpu_torch.train.train_step import make_train_step
from mtasr_tpu_torch.utils import model_io
from tests.test_torch_family_slice import _model, _params, _port, family
from tests.test_torch_hybrid import _batch, _dataset, _jb, _tb

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
LR = 1e-3
PARAM_ATOL = 1e-2 * LR


def _train_cfg(**kw):
    cfg = family("adapgatetiny", "sep", "raw", True, lora_dropout=0.0,
                 separator_dropout=0.0, **kw)
    cfg.encoder.num_hidden_layers = 2
    cfg.encoder.mask_time_prob = 0.05
    return cfg


@pytest.mark.parametrize("pit", [False, True])
def test_pcgrad_step_with_the_family_matches_jax(pit):
    cfg = _train_cfg()
    params = _params(cfg)
    params["decoder_lora"] = jax_init_lora(jax.random.key(1),
                                           params["decoder"], r=4, alpha=8.0)
    tc_kw = dict(learning_rate=LR, warmup_steps=0, max_steps=10,
                 weight_decay=0.01, max_grad_norm=1.0, adam_epsilon=1e-4,
                 pcgrad=True)
    freeze = dict(freeze_decoder=True)
    jmask = jfreeze.trainable_mask(params, train_mode="hybrid", **freeze)
    jopt = jax_make_optimizer(JaxTrainingConfig(**tc_kw), jmask)
    jstep = jax_make_train_step(cfg, JaxTrainingConfig(**tc_kw), jopt,
                                trainable_mask=jmask, use_pit=pit,
                                donate=False)
    model = _model(cfg, params)
    mask = trainable_mask(model, train_mode="hybrid", **freeze)
    apply_trainable_mask(model, mask)
    # the LoRA's r and alpha are JAX leaves, attributes in the port
    jflat = {k: v for k, v in tree_to_flat(jmask).items()
             if "__meta__" not in k}
    jdecay = tree_to_flat(hf_decay_mask(params))
    assert set(jflat) == set(mask)
    assert {n: bool(jflat[n]) for n in mask} == mask
    assert {n: not is_no_decay(n) for n in mask} == \
        {n: bool(jdecay[n]) for n in mask}
    family_names = [n for n in mask if n.split(".")[0] in (
        "cross_att_adap", "serilized_refine")]
    assert family_names and all(mask[n] for n in family_names)
    assert mask["cross_att_adap.0.gate_logit"]
    assert not is_no_decay("serilized_refine.mlp.0.weight")
    tc = tconfig.TrainingConfig(**tc_kw)
    step = make_train_step(_port(cfg), tc, make_optimizer(model, tc),
                           use_pit=pit)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = _batch(cfg, seed=10)
    jparams, _, jm = jstep(params, jopt.init(params), _jb(batch),
                           jax.random.key(0))
    m = step(model, _tb(batch), None)
    assert set(m) == set(jm)
    for k in ("loss", "loss_attn", "loss_ctc"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GNORM_RTOL)
    np.testing.assert_allclose(m["ctc_head_grad_norms"].numpy(),
                               np.asarray(jm["ctc_head_grad_norms"]),
                               rtol=GNORM_RTOL)
    jf = tree_to_flat(jparams)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.reshape(jf[name], tuple(p.shape)),
            rtol=0, atol=PARAM_ATOL, err_msg=name)
    moved = [n for n in family_names
             if not torch.equal(before[n], dict(model.named_parameters())[n])]
    assert len(moved) > len(family_names) // 2
    if not pit:
        # the raw bridge reads the encoder adapter in stage B; no head does,
        # so it moves by AdamW's weight decay alone (lr LR at step 1)
        for n, p0 in before.items():
            if n.startswith("encoder.adapter.") and mask[n]:
                wd = 0.0 if is_no_decay(n) else 0.01
                torch.testing.assert_close(
                    dict(model.named_parameters())[n].detach(),
                    p0 * (1 - LR * wd), rtol=1e-6, atol=1e-9, msg=n)


@pytest.mark.parametrize("mode", ["attention", "hybrid"])
def test_trainer_trains_the_family(mode, tmp_path):
    tok = TCharTokenizer()
    sp = tok.add_special_tokens()
    kw = dict(pad_token_id=sp.pad_token_id, sc_token_id=sp.sc_token_id)
    if mode == "attention":
        cfg = family("gatetiny", "raw", train_mode="attention",
                     talker_ctc=False, **kw)
    else:
        cfg = family("ctcaware", "ctctoken", "softmax", True, **kw)
    cfg.decoder.vocab_size = len(tok) + 8
    model = _model(cfg, _params(cfg))
    pcfg = _port(cfg)
    dc = tconfig.DataConfig(bucket_boundaries_seconds=(0.25,),
                            max_label_length=40)
    tc = tconfig.TrainingConfig(output_dir=str(tmp_path), learning_rate=1e-3,
                                warmup_steps=0, max_steps=2, logging_steps=1,
                                pcgrad=True)
    trainer = Trainer(pcfg, tc, dc, model,
                      freeze_kwargs=dict(freeze_decoder=True))
    fam = {n: p.detach().clone() for n, p in model.named_parameters()
           if n.split(".")[0] in ("cross_att_adap", "serilized_refine",
                                  "ctc_extractor_concat")}
    examples = _dataset(tok)
    state = trainer.train(lambda epoch: batches_from_examples(
        examples, pcfg, dc, 2, seed=epoch))
    assert state.step == 2
    log = [json.loads(x) for x in
           (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(m["loss"]) for m in log)
    params = dict(model.named_parameters())
    assert sum(not torch.equal(params[n], p0) for n, p0 in fam.items()) \
        > len(fam) // 2


def test_jax_written_family_dir_loads_and_serves(tmp_path):
    cfg = family("adapgatetiny", "ctctoken", "ctcprompt", True)
    tok, ttok = CharTokenizer(), TCharTokenizer()
    sp = tok.add_special_tokens()
    ttok.add_special_tokens()
    cfg.pad_token_id, cfg.sc_token_id = sp.pad_token_id, sp.sc_token_id
    params = _params(cfg, seed=6)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmodel_io.save_model(jdir, cfg, params)
    tcfg, model = model_io.load_model(jdir, "cpu")
    flat, ref = model_io.flat_state(model), tree_to_flat(params)
    assert set(flat) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)
    assert flat["cross_att_adap.1.lora_scale"].dim() == 0
    gen = GenerationConfig(do_sample=False)
    dc = DataConfig(min_duration_in_seconds=0.0, max_duration_in_seconds=1e9,
                    bucket_boundaries_seconds=(0.25, 0.5))
    rng = np.random.default_rng(6)
    wavs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (3000, 7000, 2000)]
    kw = dict(max_new_tokens=5, batch_size=2, clean=False)
    tt = Transcriber.from_pretrained(
        jdir, gen=tconfig.from_fields(tconfig.GenerationConfig, gen),
        device="cpu")
    tt.dc = tconfig.from_fields(tconfig.DataConfig, dc)
    texts = tt.transcribe(wavs, **kw)
    assert texts == JaxTranscriber(cfg, params, tok, gen=gen,
                                   dc=dc).transcribe(wavs, **kw)
    model_io.save_model(tdir, tcfg, model)
    _, again = model_io.load_model(tdir, "cpu")
    for k, v in model_io.flat_state(again).items():
        assert torch.equal(v, flat[k]) and v.shape == flat[k].shape, k
    _, jback = jmodel_io.load_model(tdir)
    for k, v in tree_to_flat(jback).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
        assert np.shape(v) == np.shape(ref[k]), k
