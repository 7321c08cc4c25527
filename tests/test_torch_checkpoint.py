"""Training checkpoints of the port (`train/checkpoint.py`, `Trainer.save`
/ `maybe_resume`, best-model retention) on tiny models on the CPU.

Save at step 2 and resume to step 4 gives parameters and AdamW state
bit-equal to an uninterrupted 4-step run (dropout on, a mid-epoch resume
over distinct batches), in attention mode and in hybrid PCGrad mode, as
`tests/test_resume_determinism.py` pins it for the JAX package, on one
CPU thread (with several, two identical runs already differ in the last
bits from their second step: the threads split the reductions another way
each time; `torch.use_deterministic_algorithms` also makes them equal, but
runs these tests 50-150x slower when the suite's workers share the
cores);
`load_partial` equals the JAX package's on flat trees, bit for bit."""
import os
import threading

import numpy as np
import pytest
import torch

from mtasr_tpu.train import checkpoint as jckpt
from mtasr_tpu.utils.torch_interop import tree_to_flat
from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.data.pipeline import (
    PreparedExample, batches_from_examples,
)
from mtasr_tpu_torch.train import checkpoint as ckpt
from mtasr_tpu_torch.train.lora import init_decoder_lora
from mtasr_tpu_torch.train.loop import Trainer
from mtasr_tpu_torch.utils import model_io
from mtasr_tpu_torch.utils.convert import init_random
from tests.test_composite import SC, tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


def _cfg(hybrid: bool):
    cfg = tiny_cfg(train_mode="hybrid" if hybrid else "attention",
                   talker_ctc=hybrid, lora_dropout=0.1)
    cfg.encoder.hidden_dropout = cfg.encoder.activation_dropout = 0.1
    return tconfig.SpeechEncoderDecoderConfig.from_json(cfg.to_json())


def _examples(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [PreparedExample(
        f"u{i}", (rng.standard_normal(3600) * 0.2).astype(np.float32), [],
        list(rng.integers(3, 40, 3)) + [SC] + list(rng.integers(3, 40, 4)))
        for i in range(n)]


DC = tconfig.DataConfig(bucket_boundaries_seconds=(0.25,),
                        max_label_length=16)


def _trainer(cfg, outdir, hybrid, **tc_kw):
    g = torch.Generator().manual_seed(0)
    model = init_random(cfg, g, "cpu", torch.float32)
    init_decoder_lora(model, g, r=2, alpha=4.0)
    kw = dict(output_dir=str(outdir), max_steps=4, logging_steps=1,
              save_steps=2, learning_rate=1e-3, warmup_steps=1, seed=7,
              pcgrad=hybrid)
    kw.update(tc_kw)
    return Trainer(cfg, tconfig.TrainingConfig(**kw), DC, model,
                   freeze_kwargs=dict(freeze_decoder=True))


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("hybrid", [False, True])
def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, hybrid,
                                                     one_thread):
    cfg = _cfg(hybrid)
    ex = _examples()

    def epoch_batches(epoch):       # 4 distinct batches, shuffled by epoch
        return batches_from_examples(ex, cfg, DC, 2, seed=epoch)

    t1 = _trainer(cfg, tmp_path / "a", hybrid)
    t1.train(epoch_batches)
    t2 = _trainer(cfg, tmp_path / "b", hybrid)
    t2.train(epoch_batches, max_steps=2)
    assert ckpt.list_checkpoints(str(tmp_path / "b")) == [2]
    t3 = _trainer(cfg, tmp_path / "b", hybrid)
    assert t3.maybe_resume()
    assert (t3.state.step, t3.state.epoch, t3.state.batch_in_epoch) == \
        (2, 1, 2)
    t3.train(epoch_batches)
    assert t3.state.step == 4
    a, b = t1.model.state_dict(), t3.model.state_dict()
    assert sum(not torch.equal(a[k], t2.model.state_dict()[k])
               for k in a) > 0              # t2 stopped early: they differ
    for k in a:
        assert torch.equal(a[k], b[k]), k
    o1, o3 = t1.optimizer.state_dict(), t3.optimizer.state_dict()
    assert o1["count"] == o3["count"] == 4
    for slot in ("mu", "nu"):
        for k in o1[slot]:
            assert torch.equal(o1[slot][k], o3[slot][k]), (slot, k)
    assert ckpt.list_checkpoints(str(tmp_path / "b")) == [2, 4]


def test_resume_without_the_moments_is_not_bit_equal(tmp_path,
                                                     one_thread):
    """The planted fault the resume gate must catch: AdamW's moments left
    at zero on resume."""
    cfg = _cfg(False)
    ex = _examples()
    runs = []
    for name, steps in (("a", 4), ("b", 2)):
        t = _trainer(cfg, tmp_path / name, False)
        t.train(lambda epoch: batches_from_examples(ex, cfg, DC, 2,
                                                    seed=epoch),
                max_steps=steps)
        runs.append(t)
    t3 = _trainer(cfg, tmp_path / "b", False)
    assert t3.maybe_resume()
    for m in t3.optimizer.mu + t3.optimizer.nu:
        m.zero_()
    t3.train(lambda epoch: batches_from_examples(ex, cfg, DC, 2, seed=epoch))
    a, b = runs[0].model.state_dict(), t3.model.state_dict()
    assert any(not torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_layout_retention_and_atomic_names(tmp_path):
    """A checkpoint is a model directory plus optimizer and trainer
    state; retention keeps the newest `limit`; a temporary directory is
    never listed."""
    cfg = _cfg(False)
    t = _trainer(cfg, tmp_path, False, save_total_limit=2)
    for step in (1, 2, 3, 5):
        t.state.step = step
        t.save()
    assert ckpt.list_checkpoints(str(tmp_path)) == [3, 5]
    os.makedirs(tmp_path / ".tmp-checkpoint-9")
    assert ckpt.last_checkpoint(str(tmp_path)).endswith("checkpoint-5")
    ckpt.apply_retention(str(tmp_path), 0)          # the newest stays
    assert ckpt.list_checkpoints(str(tmp_path)) == [5]
    path = ckpt.last_checkpoint(str(tmp_path))
    assert sorted(os.listdir(path)) == ["config.json", "model.safetensors",
                                        "optimizer", "trainer_state.json"]
    _, model = model_io.load_model(path, "cpu")
    for k, v in t.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_resume_or_raise(tmp_path):
    out = str(tmp_path / "out")
    assert ckpt.resume_or_raise(out) is None            # absent
    os.makedirs(out)
    assert ckpt.resume_or_raise(out) is None            # empty
    open(os.path.join(out, "notes.txt"), "w").close()
    with pytest.raises(ValueError, match="non-empty"):
        ckpt.resume_or_raise(out)
    assert ckpt.resume_or_raise(out, overwrite=True) is None
    os.makedirs(os.path.join(out, "checkpoint-7"))
    os.makedirs(os.path.join(out, "checkpoint-12"))
    assert ckpt.resume_or_raise(out).endswith("checkpoint-12")
    assert ckpt.resume_or_raise(out, resume=False) is None


def test_best_model_survives_rotation_and_is_loaded_at_the_end(tmp_path):
    """eval every step, save_total_limit 1: `best/` holds the step of the
    lowest eval loss whatever the rotation deleted, and its parameters
    are in the model after `train`."""
    cfg = _cfg(False)
    ex = _examples()
    t = _trainer(cfg, tmp_path, False, eval_steps=1, save_steps=1,
                 save_total_limit=1, learning_rate=3e-2)
    losses = []
    real = t.evaluate

    def evaluate(batches, refs=None):
        m = real(batches, refs)
        losses.append(m["eval_loss"])
        return m
    t.evaluate = evaluate
    t.train(lambda epoch: batches_from_examples(ex, cfg, DC, 2, seed=epoch),
            lambda: batches_from_examples(ex[:2], cfg, DC, 2,
                                          training=False, shuffle=False))
    best = int(np.argmin(losses)) + 1
    assert t.best_step == best and ckpt.list_checkpoints(str(tmp_path)) == [4]
    assert ckpt.list_checkpoints(str(tmp_path / "best")) == [best]
    saved = model_io.read_flat(ckpt.last_checkpoint(str(tmp_path / "best")))
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, saved[k]), k


@pytest.fixture
def held_writes(monkeypatch):
    """The background writer held at its start until the test releases it
    (`release.set()`): a save's write is then surely in flight."""
    release = threading.Event()
    real = ckpt.save_model

    def held(*a, **kw):
        assert release.wait(30), "the test never released the write"
        return real(*a, **kw)
    monkeypatch.setattr(ckpt, "save_model", held)
    yield release
    release.set()
    ckpt.wait_for_pending_saves()


def test_background_save_stores_the_state_of_its_call(tmp_path,
                                                      held_writes):
    """Parameters and moments changed in place after `save_checkpoint`
    returned (the port's AdamW does so) are not in the checkpoint;
    `last_checkpoint` right after a save sees its step; retention with a
    write in flight keeps that step."""
    cfg = _cfg(False)
    t = _trainer(cfg, tmp_path, False, save_total_limit=1)
    t.state.step = 1
    held_writes.set()
    t.save()
    held_writes.clear()
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    mu = {k: v.clone() for k, v in t.optimizer.state_dict()["mu"].items()}
    t.state.step = 2
    path = t.save()
    assert not os.path.exists(path)              # the write is held
    with torch.no_grad():
        for p in t.model.parameters():
            p.add_(1.0)
        for m in t.optimizer.mu:
            m.add_(1.0)
    held_writes.set()
    assert ckpt.last_checkpoint(str(tmp_path)) == path
    assert ckpt.list_checkpoints(str(tmp_path)) == [2]   # 1 rotated out
    saved = model_io.read_flat(path)
    for k, v in before.items():
        assert torch.equal(saved[k], v), k
    opt = model_io.read_flat(os.path.join(path, "optimizer"))
    for k, v in mu.items():
        assert torch.equal(opt[f"mu.{k}"], v), k
    held_writes.clear()
    t.state.step = 3
    t.save()
    threading.Timer(0.2, held_writes.set).start()
    ckpt.apply_retention(str(tmp_path), 1)       # step 3 still held here
    assert ckpt.list_checkpoints(str(tmp_path)) == [3]


def test_a_failed_background_write_is_raised(tmp_path, monkeypatch):
    """An exception in the writer comes out of the next drain, once, and
    the failed step is never listed; a blocking save raises it itself."""
    def broken(*a, **kw):
        raise OSError("disk gone")
    monkeypatch.setattr(ckpt, "save_model", broken)
    t = _trainer(_cfg(False), tmp_path, False)
    t.state.step = 1
    t.save()
    with pytest.raises(RuntimeError, match="background") as info:
        ckpt.wait_for_pending_saves()
    assert isinstance(info.value.__cause__, OSError)
    assert ckpt.list_checkpoints(str(tmp_path)) == []
    t.save()
    with pytest.raises(RuntimeError):
        ckpt.last_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="background"):
        ckpt.save_checkpoint(str(tmp_path), 2, t.cfg, t.model,
                             blocking=True)
    ckpt.wait_for_pending_saves()               # raised once: nothing left


def _flat_trees(rng, v_dst, v_src):
    def ctc(v):
        return {"ctc_lo": {"weight": rng.standard_normal((v, 6)).astype(
            np.float32), "bias": rng.standard_normal(v).astype(np.float32)}}
    params = {"encoder": {"w": rng.standard_normal(3).astype(np.float32)},
              "separator": {"pre_proj": {"weight": rng.standard_normal(
                  (4, 6)).astype(np.float32)}},
              "serialized_ctc": {"0": ctc(v_dst), "1": ctc(v_dst)}}
    donor = {"encoder": {"w": np.zeros(3, np.float32)},
             "separator": {"pre_proj": {"weight": rng.standard_normal(
                 (4, 6)).astype(np.float32)},
                 "extra": {"b": np.ones(2, np.float32)}},
             "serialized_ctc": {"0": ctc(v_src), "1": ctc(v_src)}}
    return params, donor


@pytest.mark.parametrize("v_dst,v_src", [(9, 9), (9, 7), (7, 9)])
def test_load_partial_matches_jax(v_dst, v_src):
    """Separator and CTC heads grafted from a donor, `ctc_lo` rows of a
    different vocabulary copied over the overlap; the encoder untouched;
    any other shape mismatch refused by both."""
    params, donor = _flat_trees(np.random.default_rng(0), v_dst, v_src)
    prefixes = ("separator", "serialized_ctc")
    ref = tree_to_flat(jckpt.load_partial(params, donor, prefixes))
    t = {k: torch.from_numpy(v) for k, v in tree_to_flat(params).items()}
    d = {k: torch.from_numpy(v) for k, v in tree_to_flat(donor).items()}
    got = ckpt.load_partial(t, d, prefixes)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    sub = ckpt.extract_by_prefix(t, prefixes)
    assert set(sub) == set(tree_to_flat(jckpt.extract_by_prefix(
        params, prefixes)))
    donor["separator"]["pre_proj"]["weight"] = np.zeros((5, 6), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        jckpt.load_partial(params, donor, prefixes)
    d = {k: torch.from_numpy(np.asarray(v))
         for k, v in tree_to_flat(donor).items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_partial(t, d, prefixes)
