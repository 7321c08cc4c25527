"""Training at dp2 x tp2 on the port's ranks against the JAX package's
mesh, and the sharded save -> resume (`test_torch_parallel.py` holds the
rule table, the collectives and serving; its docstring says how the ranks
and the JAX reference run).

* an attention-mode Trainer step with LoRA (decoder frozen) and the
  host-drawn SpecAugment masks, two steps, and a hybrid SOT+CTC step with
  PCGrad's three-stage split, one step (dropout off), against JAX's
  jitted `make_train_step` on `make_mesh(2, 2)` with sharded parameters
  and batch: the loss, the grad norm before clipping and every updated
  trainable parameter (gathered whole from the tp slices), on every rank;
* at dp2 x tp2 a run saved at step 1 and resumed to step 2 is bit-equal
  to the straight run; the same checkpoint resumed in one process agrees
  within the A/B tolerance.

Tolerances are `test_torch_train.py`'s and `test_torch_hybrid.py`'s.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from mtasr_tpu_torch import config as tconfig
from tests._torch_parallel_worker import Ranks
from tests.test_torch_parallel import (
    GNORM_RTOL, MESH, TRAIN_TC, _attention, _compare_train, _flat, _hybrid,
    _jax_mesh, _params, _port, _sharded, _train_batch,
)

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


def _scenarios(tmp):
    sc, ref = {}, {}
    acfg = _attention()
    aparams = _params(acfg, seed=6, lora=True)
    abatches = [_train_batch(acfg, seed=10 + i) for i in range(2)]
    ref["train_attn"] = (acfg, aparams, abatches)
    sc["train_attn"] = dict(
        kind="train", cfg=_port(acfg), flat=_flat(aparams), training=True,
        tc=tconfig.TrainingConfig(pcgrad=False, **TRAIN_TC,
                                  output_dir=str(tmp / "attn")),
        freeze=dict(freeze_decoder=True), batches=abatches, mesh=MESH)
    hcfg2 = _hybrid()
    hparams2 = _params(hcfg2, seed=7, lora=True)
    hbatches = [_train_batch(hcfg2, seed=20)]
    ref["train_hybrid"] = (hcfg2, hparams2, hbatches)
    sc["train_hybrid"] = dict(
        kind="train", cfg=_port(hcfg2), flat=_flat(hparams2), training=True,
        tc=tconfig.TrainingConfig(pcgrad=True, adam_epsilon=1e-4,
                                  **TRAIN_TC, output_dir=str(tmp / "hyb")),
        freeze=dict(freeze_decoder=True), batches=hbatches, mesh=MESH)
    ckpt = dict(sc["train_attn"], tc=dataclasses.replace(
        sc["train_attn"]["tc"], output_dir=str(tmp / "ckpt")))
    sc["straight"] = dict(ckpt, save_at=1)
    sc["resumed"] = dict(ckpt, resume=True)
    return sc, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    sc, ref = _scenarios(tmp)
    job = str(tmp / "job.pt")
    torch.save({"scenarios": sc}, job)
    return Ranks(job, 4), sc, ref


def _jax_train(name, ref, pcgrad, **tc_kw):
    import jax

    from mtasr_tpu.config import TrainingConfig
    from mtasr_tpu.train import freeze as jfreeze
    from mtasr_tpu.train.optimizer import make_optimizer
    from mtasr_tpu.train.train_step import make_train_step
    from mtasr_tpu.utils.torch_interop import tree_to_flat
    cfg, params, batches = ref[name]
    tc = TrainingConfig(pcgrad=pcgrad, **TRAIN_TC, **tc_kw)
    mask = jfreeze.trainable_mask(params, train_mode=cfg.train_mode,
                                  freeze_decoder=True)
    opt = make_optimizer(tc, mask)
    step = make_train_step(cfg, tc, opt, trainable_mask=mask, donate=False)
    mesh = _jax_mesh(*MESH)
    p, _ = _sharded(params, {}, mesh)
    state = opt.init(p)
    out = {"metrics": [], "params": []}
    flat_mask = tree_to_flat(mask)
    for i, batch in enumerate(batches):
        _, b = _sharded({}, batch, mesh)
        p, state, m = step(p, state, b, jax.random.key(i))
        out["metrics"].append({k: np.asarray(v) for k, v in m.items()})
        out["params"].append({k: np.asarray(v) for k, v in
                              tree_to_flat(p).items() if flat_mask[k]})
    return out


def test_attention_steps_match_jax_mesh(ranks):
    job, sc, ref = ranks
    want = _jax_train("train_attn", ref, pcgrad=False)
    res = job.results()
    for r in range(4):
        _compare_train(res[r]["train_attn"], want, 2)


def test_hybrid_pcgrad_step_matches_jax_mesh(ranks):
    job, sc, ref = ranks
    want = _jax_train("train_hybrid", ref, pcgrad=True, adam_epsilon=1e-4)
    res = job.results()
    for r in range(4):
        got = res[r]["train_hybrid"]
        _compare_train(got, want, 1)
        np.testing.assert_allclose(
            got["metrics"][0]["ctc_head_grad_norms"],
            want["metrics"][0]["ctc_head_grad_norms"], rtol=GNORM_RTOL)


def test_sharded_save_resume_is_bit_equal(ranks):
    """dp2 x tp2: saved at step 1 and resumed to step 2 equals the
    straight run bit for bit; the same checkpoint resumed in one process
    agrees within the A/B tolerance."""
    from tests._torch_parallel_worker import run_train
    job, sc, ref = ranks
    res = job.results()
    for r in range(4):
        straight = res[r]["straight"]["params"][1]
        resumed = res[r]["resumed"]["params"][0]
        assert set(straight) == set(resumed)
        for k in straight:
            np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)
    assert os.path.isdir(os.path.join(sc["straight"]["tc"].output_dir,
                                      "checkpoint-1"))
    one = run_train(dict(sc["resumed"], mesh=(1, 1)))
    _compare_train(one, {"metrics": res[0]["straight"]["metrics"][1:],
                         "params": res[0]["straight"]["params"][1:]}, 1)
