"""Attention-mode training in the port against the JAX package, on the
CPU in float32:

* train steps: the port's `make_train_step` against the jitted JAX
  `make_train_step` on a tiny config (dropouts and the LoRA dropout at 0,
  the same `mask_time_indices` given to both: the torch and JAX random
  streams differ), freeze_decoder + LoRA and everything trainable (the
  positional conv's weight norm trained as (g, v)): loss, grad_norm and
  every parameter, updated or frozen, after 1 and 3 steps;
* the optimizer against `mtasr_tpu.train.optimizer.make_optimizer`
  (optax) on the same gradients: the lr-0 first step, the no-decay
  grouping, clipping over the trainable gradients, frozen parameters
  unchanged bitwise, and accumulation;
* accumulation of k micro-batches equal to one step on the k-times batch
  (`tests/test_train_round2.py:50`);
* the decoder LoRA's init and merge; the teacher-forced forward and the
  eval step; dropout with an explicit generator; `Trainer` end to end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.config import TrainingConfig as JaxTrainingConfig
from mtasr_tpu.models.speech_encoder_decoder import (
    init_model_params, model_forward as jax_model_forward,
)
from mtasr_tpu.train import freeze as jfreeze
from mtasr_tpu.train.lora import (
    init_decoder_lora as jax_init_lora, merge_decoder_lora as jax_merge,
)
from mtasr_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from mtasr_tpu.train.train_step import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.data.pipeline import (
    PreparedExample, batches_from_examples,
)
from mtasr_tpu_torch.data.specaugment import compute_mask_indices
from mtasr_tpu_torch.data.tokenizer import CharTokenizer
from mtasr_tpu_torch.models.layers import dropout
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    SpeechEncoderDecoderModel, model_forward,
)
from mtasr_tpu_torch.train import lora as tlora
from mtasr_tpu_torch.train.freeze import (
    apply_trainable_mask, freeze_summary, trainable_mask,
)
from mtasr_tpu_torch.train.loop import Trainer
from mtasr_tpu_torch.train.optimizer import is_no_decay, make_optimizer
from mtasr_tpu_torch.train.train_step import make_eval_step, make_train_step
from tests.test_composite import make_batch, tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

# f32 on the CPU; the two sides sum in other orders (XLA vs ATen)
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
PARAM_ATOL = 1e-5     # 1 % of lr: Adam moves an element about lr a step,
#                      and where its gradient is near the sums' rounding the
#                      two sides move it by visibly different fractions of lr


def _cfg(**kw):
    cfg = tiny_cfg(**{"train_mode": "attention", "lora_dropout": 0.0, **kw})
    cfg.encoder.num_hidden_layers = 2
    cfg.encoder.mask_time_prob = 0.05   # gives the model masked_spec_embed
    return cfg


def _port(cfg):
    return tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)


def _batch(cfg, B=2, seed=2, tile=1):
    wav, amask, arr = make_batch(cfg, B=B, seed=seed)
    T0 = cfg.encoder.conv_output_length(wav.shape[1])
    lens = [cfg.encoder.conv_output_length(int(m.sum())) for m in amask]
    feat = (np.arange(T0)[None] < np.asarray(lens)[:, None]).astype(int)
    mti = compute_mask_indices((B, T0), 0.05, 10, attention_mask=feat,
                               min_masks=2, rng=np.random.default_rng(seed))
    out = {"input_values": wav, "audio_mask": amask, "mask_time_indices": mti,
           "decoder_input_ids": arr["decoder_input_ids"],
           "ce_labels": arr["ce_labels"]}
    return {k: np.tile(v, (tile,) + (1,) * (v.ndim - 1))
            for k, v in out.items()}


def _params(cfg, lora: bool, seed=0):
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
    tconfig_load(model, params)
    return model


def tconfig_load(model, params):
    from mtasr_tpu_torch.utils.convert import load_flat
    load_flat(model, tree_to_flat(params), training=True)


def _compare_params(model, params, where):
    flat = tree_to_flat(params)
    for name, p in model.named_parameters():
        want = np.reshape(flat[name], tuple(p.shape))
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=PARAM_ATOL,
                                   err_msg=f"{name} {where}")


VARIANTS = {
    # freeze_decoder + LoRA: the standard recipe; warmup 0: the first
    # update moves the parameters
    "lora": dict(lora=True, freeze=dict(freeze_decoder=True), warmup=0,
                 weight_norm=False),
    # everything trainable, the pos conv as (g, v); warmup 1: the first
    # update runs at lr 0
    "full": dict(lora=False, freeze=dict(train_all=True), warmup=1,
                 weight_norm=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_steps_match_jax(variant):
    v = VARIANTS[variant]
    cfg = _cfg()
    cfg.encoder.pos_conv_weight_norm = v["weight_norm"]
    params = _params(cfg, v["lora"])
    tc_kw = dict(learning_rate=1e-3, warmup_steps=v["warmup"], max_steps=10,
                 weight_decay=0.01, max_grad_norm=1.0, pcgrad=False)
    jmask = jfreeze.trainable_mask(params, train_mode="attention",
                                   **v["freeze"])
    jopt = jax_make_optimizer(JaxTrainingConfig(**tc_kw), jmask)
    jstep = jax_make_train_step(cfg, JaxTrainingConfig(**tc_kw), jopt,
                                trainable_mask=jmask, donate=False)
    model = _model(cfg, params)
    mask = trainable_mask(model, train_mode="attention", **v["freeze"])
    apply_trainable_mask(model, mask)
    jflat = tree_to_flat(jmask)
    assert {n: bool(jflat[n]) for n in mask} == mask
    pcfg = _port(cfg)
    tc = tconfig.TrainingConfig(**tc_kw)
    step = make_train_step(pcfg, tc, make_optimizer(model, tc))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not mask[n]}
    jparams, jstate = params, jopt.init(params)
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        jparams, jstate, jm = jstep(
            jparams, jstate, {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.key(i))
        m = step(model, {k: torch.from_numpy(a) for k, a in batch.items()},
                 None)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["loss_attn"]),
                                   float(jm["loss_attn"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GNORM_RTOL)
        if i in (0, 2):
            _compare_params(model, jparams, f"after step {i + 1}")
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


def _module_from_flat(flat):
    root = torch.nn.Module()
    for name, a in flat.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        mod.register_parameter(leaf, torch.nn.Parameter(torch.tensor(a)))
    return root


def _tree(flat):
    tree = {}
    for name, a in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


@pytest.mark.parametrize("accum,grad_scale,warmup", [(1, 5.0, 2),
                                                     (3, 0.01, 1),
                                                     (1, 0.01, 0)])
def test_optimizer_matches_optax(accum, grad_scale, warmup):
    """The same gradients through the port's AdamW and the JAX package's
    optax chain: every parameter after every call, the frozen one
    bitwise; grad_scale 5 makes the clip fire, 0.01 not."""
    rng = np.random.default_rng(0)
    names = ["encoder.layer_norm.weight", "encoder.proj.weight",
             "encoder.proj.bias", "decoder.model.norm.weight",
             "decoder.lm.weight", "sep.ln_a.weight", "frozen.weight"]
    flat = {n: rng.standard_normal((3, 4) if n.endswith("proj.weight")
                                   or n.startswith("decoder.lm")
                                   else (4,)).astype(np.float32)
            for n in names}
    trainable = {n: not n.startswith("frozen") for n in names}
    kw = dict(learning_rate=1e-2, warmup_steps=warmup, max_steps=8,
              weight_decay=0.1, max_grad_norm=1.0,
              gradient_accumulation_steps=accum)
    jopt = jax_make_optimizer(JaxTrainingConfig(**kw), _tree(trainable))
    jparams = jax.tree_util.tree_map(jnp.asarray, _tree(flat))
    jstate = jopt.init(jparams)
    model = _module_from_flat(flat)
    apply_trainable_mask(model, trainable)
    opt = make_optimizer(model, tconfig.TrainingConfig(**kw))
    frozen0 = model.frozen.weight.detach().clone()
    for call in range(3 * accum):
        grads = {n: (rng.standard_normal(a.shape) * grad_scale)
                 .astype(np.float32) for n, a in flat.items()}
        upd, jstate = jopt.update(_tree({n: jnp.asarray(g) for n, g in
                                         grads.items()}), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n])
        applied = opt.step()
        assert applied == ((call + 1) % accum == 0)
        jflat = tree_to_flat(jparams)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), jflat[n],
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{n} call {call}")
    assert opt.count == 3
    assert torch.equal(model.frozen.weight, frozen0)
    if warmup:   # lr 0 on the first update: only the moments moved
        assert opt.schedule(0) == 0.0


def test_no_decay_grouping():
    for name in ("encoder.layer_norm.weight", "a.bias", "x.rmsnorm.weight",
                 "sep.ln.weight", "sep.ln_1.weight", "x.out_ln.weight",
                 "decoder.model.layers.0.input_layernorm.weight"):
        assert is_no_decay(name), name
    for name in ("encoder.proj.weight", "decoder_lora.0.q_proj.lora_A",
                 "encoder.masked_spec_embed", "x.lnx.weight"):
        assert not is_no_decay(name), name


def test_accumulation_equals_the_large_batch():
    """4 micro-batches of one batch with accumulation 4 update the model
    as one step on the 4x tiled batch; parameters do not move before the
    4th call and the schedule counts one update. adam_epsilon 1e-3 keeps
    the update smooth where a gradient is near zero (fp noise there would
    otherwise flip Adam's sign, which is not the property under test)."""
    cfg = _cfg()
    params = _params(cfg, lora=False)
    kw = dict(learning_rate=1e-3, warmup_steps=0, max_steps=10,
              adam_epsilon=1e-3, pcgrad=False)
    pcfg = _port(cfg)
    micro = {k: torch.from_numpy(a) for k, a in _batch(cfg).items()}
    big = {k: torch.from_numpy(a) for k, a in _batch(cfg, tile=4).items()}
    m4 = _model(cfg, params)
    tc4 = tconfig.TrainingConfig(gradient_accumulation_steps=4, **kw)
    opt4 = make_optimizer(m4, tc4)
    step4 = make_train_step(pcfg, tc4, opt4)
    before = {n: p.detach().clone() for n, p in m4.named_parameters()}
    for i in range(4):
        step4(m4, micro, None)
        if i < 3:
            assert all(torch.equal(p, before[n])
                       for n, p in m4.named_parameters())
    assert opt4.count == 1
    m1 = _model(cfg, params)
    tc1 = tconfig.TrainingConfig(**kw)
    make_train_step(pcfg, tc1, make_optimizer(m1, tc1))(m1, big, None)
    for (n, a), (_, b) in zip(m4.named_parameters(), m1.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)


def test_lora_init_and_merge_match_jax():
    cfg = _cfg()
    params = _params(cfg, lora=True)
    model = _model(cfg, params)
    assert model.decoder_lora.r == 4.0 and model.decoder_lora.alpha == 8.0
    merged = tree_to_flat(jax_merge(params))
    tlora.merge_decoder_lora(model)
    assert not hasattr(model, "decoder_lora")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.reshape(merged[name], tuple(p.shape)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    # init: the JAX key set and shapes, B = 0, A uniform within the bound
    fresh = _model(cfg, init_model_params(jax.random.key(0), cfg))
    g = torch.Generator().manual_seed(0)
    lora = tlora.init_decoder_lora(fresh, g, r=4, alpha=8.0)
    jlora = jax_init_lora(jax.random.key(1), params["decoder"], r=4,
                          alpha=8.0)
    want = {f"decoder_lora.{k}": v.shape
            for k, v in tree_to_flat(jlora).items() if "__meta__" not in k}
    got = {f"decoder_lora.{n}": tuple(p.shape)
           for n, p in lora.named_parameters()}
    assert got == {k: tuple(s) for k, s in want.items()}
    for n, p in lora.named_parameters():
        if n.endswith("lora_B"):
            assert not p.any()
        else:
            assert float(p.detach().abs().max()) <= \
                (6.0 / 3.0 / p.shape[1]) ** 0.5


def test_lora_activation_forward_equals_merged():
    cfg = _cfg()
    model = _model(cfg, _params(cfg, lora=True))
    batch = {k: torch.from_numpy(a) for k, a in _batch(cfg).items()}

    def logits():
        with torch.no_grad():
            return model_forward(model, _port(cfg), batch["input_values"],
                                 batch["audio_mask"],
                                 batch["decoder_input_ids"]).logits
    act = logits()
    with tlora.merged(model):
        lora, model.decoder_lora = model.decoder_lora, None
        folded = logits()
        model.decoder_lora = lora
    torch.testing.assert_close(act, folded, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(logits(), act)        # restored


@pytest.mark.parametrize("instruct", [False, True])
def test_forward_and_eval_step_match_jax(instruct):
    ids = dict(bosp_token_id=52, eosp_token_id=53, boss_token_id=54,
               eoss_token_id=55, bosr_token_id=56, eosr_token_id=57)
    cfg = _cfg(instruct=instruct, **(ids if instruct else {}))
    params = _params(cfg, lora=True)
    model = _model(cfg, params)
    batch = _batch(cfg)
    splice = 1
    if instruct:     # a prompt of 2 ids: [bosp p p eosp boss eoss bosr ...]
        pre = np.tile([52, 20, 21, 53, 54, 55, 56], (2, 1))
        for k in ("decoder_input_ids", "ce_labels"):
            batch[k] = np.concatenate([pre, batch[k]], axis=1)
        splice = 2 + 4
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    ref = jax_model_forward(params, cfg, jb["input_values"],
                            jb["audio_mask"], jb["decoder_input_ids"],
                            splice_index=splice, ce_labels=jb["ce_labels"])
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    with torch.no_grad():
        out = model_forward(model, _port(cfg), tb["input_values"],
                            tb["audio_mask"], tb["decoder_input_ids"],
                            splice_index=splice, ce_labels=tb["ce_labels"])
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out.loss), float(ref.loss),
                               rtol=LOSS_RTOL)
    jm = jax_make_eval_step(cfg, splice_index=splice)(params, jb)
    m = make_eval_step(_port(cfg), splice_index=splice)(model, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)


def test_freeze_summary_matches_jax():
    cfg = _cfg()
    params = _params(cfg, lora=True)
    model = _model(cfg, params)
    for kw in (dict(freeze_decoder=True), dict(), dict(freeze_encoder=True)):
        mask = trainable_mask(model, **kw)
        jmask = jfreeze.trainable_mask(params, **kw)
        got, want = freeze_summary(model, mask), jfreeze.freeze_summary(
            params, jmask)
        # the JAX tree also counts the two LoRA __meta__ scalars (frozen)
        assert got["trainable"] == want["trainable"]
        assert got["total"] == want["total"] - 2


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(dropout(x, 0.1, torch.Generator().manual_seed(0)), y)
    assert not torch.equal(dropout(x, 0.1, g), y)     # the stream advanced
    assert dropout(x, 0.1, g, deterministic=True) is x
    assert dropout(x, 0.0, g) is x and dropout(x, 0.1, None) is x
    xb = torch.ones(1000, dtype=torch.bfloat16)
    assert dropout(xb, 0.5, g).dtype == torch.bfloat16


def _dataset(tok, n=6, seed=0):
    rng = np.random.default_rng(seed)
    words = ["hello", "world", "good", "day"]
    out, refs = [], {}
    for i in range(n):
        text = (" ".join(rng.choice(words, 2)) + " <sc> "
                + " ".join(rng.choice(words, 2)))
        wav = (rng.standard_normal(int(rng.integers(3000, 3900)))
               * 0.2).astype(np.float32)
        out.append(PreparedExample(f"u{i}", wav, [], tok.encode(text, False)))
        refs[f"u{i}"] = text
    return out, refs


def test_trainer_trains_and_evaluates(tmp_path):
    """Trainer.train: a few steps of freeze_decoder + LoRA training with
    dropout, SpecAugment and remat on, then evaluate (loss and WER through
    generate); metrics.jsonl written; the final checkpoint resumes."""
    tok = CharTokenizer()
    sp = tok.add_special_tokens()
    cfg = _cfg(pad_token_id=sp.pad_token_id, sc_token_id=sp.sc_token_id,
               lora_dropout=0.1)
    cfg.decoder.vocab_size = len(tok) + 8
    cfg.encoder.hidden_dropout = cfg.encoder.activation_dropout = 0.1
    cfg.encoder.remat = cfg.decoder.remat = True
    model = _model(cfg, _params(cfg, lora=True))
    pcfg = _port(cfg)
    dc = tconfig.DataConfig(bucket_boundaries_seconds=(0.25,),
                            max_label_length=40)
    tc = tconfig.TrainingConfig(output_dir=str(tmp_path), learning_rate=1e-3,
                                warmup_steps=1, max_steps=4, logging_steps=1,
                                eval_steps=4, pcgrad=False)
    examples, refs = _dataset(tok)
    trainer = Trainer(pcfg, tc, dc, model, tokenizer=tok,
                      freeze_kwargs=dict(freeze_decoder=True),
                      gen_cfg=tconfig.GenerationConfig(max_new_tokens=6))
    assert not model.decoder.model.embed_tokens.weight.requires_grad
    base = {n: p.detach().clone() for n, p in model.named_parameters()
            if not p.requires_grad}
    lora_a = model.decoder_lora["0"]["q_proj"].lora_A.detach().clone()
    state = trainer.train(
        lambda epoch: batches_from_examples(examples, pcfg, dc, 2,
                                            seed=epoch))
    assert state.step == 4 and state.epoch == 2
    log = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(log) == 4 and all(np.isfinite(m["loss"])
                                 for m in trainer.metrics_log)
    assert not torch.equal(model.decoder_lora["0"]["q_proj"].lora_A, lora_a)
    for n, p in model.named_parameters():
        if n in base:
            assert torch.equal(p, base[n]), n
    batches = list(batches_from_examples(examples, pcfg, dc, 3,
                                         training=False, shuffle=False))
    em = trainer.evaluate(batches, refs)
    assert np.isfinite(em["eval_loss"]) and em["eval_wer"] >= 0.0
    # train ended with a checkpoint, which a fresh trainer resumes from
    assert (tmp_path / "checkpoint-4" / "model.safetensors").exists()
    fresh = Trainer(pcfg, tc, dc, _model(cfg, _params(cfg, lora=True)),
                    tokenizer=tok, freeze_kwargs=dict(freeze_decoder=True))
    assert fresh.maybe_resume()
    assert (fresh.state.step, fresh.state.epoch,
            fresh.state.batch_in_epoch) == (4, 2, 1)
    for n, p in model.named_parameters():
        assert torch.equal(dict(fresh.model.named_parameters())[n], p), n


def test_pcgrad_with_ctc_heads_raises():
    """PCGrad with CTC heads builds a step (hybrid training is ported,
    `tests/test_torch_hybrid.py`); a model with the CTC refiner (ROADMAP
    item 6, ported) now builds, with the refiner at the 50 Hz width."""
    cfg = dataclasses.replace(_port(_cfg()), talker_ctc=True,
                              train_mode="hybrid")
    assert callable(make_train_step(cfg, tconfig.TrainingConfig(pcgrad=True),
                                    None))
    model = SpeechEncoderDecoderModel(dataclasses.replace(
        cfg, talker_ctc_refine=True))
    d50 = cfg.encoder.hidden_size
    assert model.serilized_refine.mlp["0"].in_features == 2 * d50 + 1
