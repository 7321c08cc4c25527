"""The training loop (counterpart of `mtasr_tpu/train/loop.py::Trainer`):
steps over epochs of batches, logging to `metrics.jsonl`, periodic eval
(teacher-forced loss, and WER through the port's `generate`).

As in the JAX trainer, every step's randomness is a function of (seed,
step): its dropout comes from a fresh `torch.Generator` seeded from both,
and the position in the data stream (epoch, batch in epoch) is kept in
the state. `save` writes `output_dir/checkpoint-<step>` (`train/checkpoint.py`:
the parameters, AdamW's state, the trainer state; written in the background,
the last write drained before `train` returns) every `save_steps` and at
the end; `maybe_resume` restores the newest, and `train` then re-enters the
interrupted epoch and skips the batches it had consumed, so a resumed run
sees the data an uninterrupted one does. With eval batches, the best
model by `metric_for_best_model` is kept in `output_dir/best/`, outside the
rotation, and loaded at the end (`load_best_model_at_end`).

With a dp x tp `mesh` (`parallel/mesh.py`) the model is sharded before
the optimizer is built, every rank assembles the whole global batch on
the host (so the shuffle and the SpecAugment masks are the single
process's) and keeps its dp index's rows, and the steps sum the
gradients over dp (`train_step.py`). The dropout generator of a step is
the same on the ranks of a tp group and differs between dp indices. Eval
decodes each dp index's rows, gathers the hypotheses and computes the
WER once on every rank; only rank 0 writes `metrics.jsonl` and the
checkpoints.
"""
from __future__ import annotations

import inspect
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from mtasr_tpu_torch.config import (
    DataConfig, GenerationConfig, SpeechEncoderDecoderConfig, TrainingConfig,
)
from mtasr_tpu_torch.data.pipeline import Batch
from mtasr_tpu_torch.generate.engine import generate
from mtasr_tpu_torch.parallel import multihost
from mtasr_tpu_torch.parallel.mesh import shard_batch, shard_model
from mtasr_tpu_torch.train.checkpoint import (
    last_checkpoint, restore_checkpoint, save_checkpoint,
    wait_for_pending_saves,
)
from mtasr_tpu_torch.train.freeze import (
    apply_trainable_mask, freeze_summary, trainable_mask,
)
from mtasr_tpu_torch.train.optimizer import make_optimizer
from mtasr_tpu_torch.train.train_step import make_eval_step, make_train_step
from mtasr_tpu_torch.utils.wer import Calculator, clean_decoded_text

logger = logging.getLogger("mtasr_tpu_torch.trainer")


@dataclass
class TrainState:
    step: int = 0
    epoch: int = 0            # data-stream position: the epoch of the
    batch_in_epoch: int = 0   # last batch and how many it had consumed


def step_generator(seed: int, step: int, device,
                   dp_index: int = 0) -> torch.Generator:
    """The dropout generator of one step: a function of (seed, step) and,
    past the first, of the data-parallel index (the rows differ, so do
    their masks)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step) + int(dp_index) * 2 ** 40)
                  % (2 ** 63))
    return g


class Trainer:
    """Trains `model` in place on its device. Batches come from
    `data/pipeline.py` (numpy arrays); each step moves one to the device."""

    def __init__(self, cfg: SpeechEncoderDecoderConfig, tc: TrainingConfig,
                 dc: DataConfig, model: torch.nn.Module, tokenizer=None,
                 freeze_kwargs: Optional[dict] = None,
                 gen_cfg: Optional[GenerationConfig] = None,
                 total_steps: Optional[int] = None, mesh=None):
        """`mesh`: a dp x tp `parallel.mesh.Mesh`; the model (whole, with
        its LoRA attached) is sharded over it here."""
        self.cfg, self.tc, self.dc = cfg, tc, dc
        if mesh is not None and getattr(model, "mesh", None) is None:
            shard_model(model, cfg, mesh)
        self.mesh = getattr(model, "mesh", None)
        self.model = model
        self.tokenizer = tokenizer
        self.gen_cfg = gen_cfg or GenerationConfig()
        self.device = next(model.parameters()).device
        self.mask = trainable_mask(model, train_mode=cfg.train_mode,
                                   **(freeze_kwargs or {}))
        apply_trainable_mask(model, self.mask)
        summ = freeze_summary(model, self.mask)
        logger.info("params: total=%d trainable=%d frozen=%d", summ["total"],
                    summ["trainable"], summ["frozen"])
        sched_total = tc.max_steps if tc.max_steps > 0 else total_steps
        self.optimizer = make_optimizer(model, tc, total_steps=sched_total)
        self.state = TrainState()
        self._train_steps: Dict[int, Callable] = {}
        self._eval_steps: Dict[int, Callable] = {}
        self.metrics_log: List[dict] = []
        self.best_metric: Optional[float] = None
        self.best_step: Optional[int] = None

    def _train_step(self, splice_index: int) -> Callable:
        if splice_index not in self._train_steps:
            self._train_steps[splice_index] = make_train_step(
                self.cfg, self.tc, self.optimizer, splice_index=splice_index,
                mesh=self.mesh)
        return self._train_steps[splice_index]

    def _eval_step(self, splice_index: int) -> Callable:
        if splice_index not in self._eval_steps:
            self._eval_steps[splice_index] = make_eval_step(
                self.cfg, splice_index=splice_index, mesh=self.mesh)
        return self._eval_steps[splice_index]

    def _tensors(self, batch: Batch, rows: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """The batch on the device; with `rows`, this dp index's rows."""
        arrays = {k: v for k, v in batch.arrays.items() if k != "prompt_ids"}
        if rows:
            arrays = shard_batch(arrays, self.mesh)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _write_metrics(self, m: dict) -> None:
        """Append one JSON line to `output_dir/metrics.jsonl` (rank 0)."""
        if multihost.process_index() != 0:
            return
        try:
            os.makedirs(self.tc.output_dir, exist_ok=True)
            with open(os.path.join(self.tc.output_dir, "metrics.jsonl"),
                      "a") as f:
                f.write(json.dumps(m) + "\n")
        except OSError:
            pass

    # -- checkpointing ------------------------------------------------------
    def save(self, output_dir: Optional[str] = None) -> str:
        """Write `checkpoint-<step>` (parameters, AdamW state, trainer
        state) under `output_dir` (default `tc.output_dir`), keeping the
        newest `save_total_limit`."""
        st = self.state
        return save_checkpoint(
            output_dir or self.tc.output_dir, st.step, self.cfg, self.model,
            self.optimizer.state_dict(),
            extra={"step": st.step, "epoch": st.epoch,
                   "batch_in_epoch": st.batch_in_epoch,
                   "best_metric": self.best_metric,
                   "best_step": self.best_step},
            save_total_limit=self.tc.save_total_limit)

    def maybe_resume(self) -> bool:
        """Restore the newest checkpoint of `tc.output_dir`, if any."""
        ckpt = last_checkpoint(self.tc.output_dir)
        if ckpt is None:
            return False
        st = restore_checkpoint(ckpt, self.model, self.optimizer)
        self.state = TrainState(st["step"], st["epoch"],
                                st["batch_in_epoch"])
        self.best_metric = st.get("best_metric")
        self.best_step = st.get("best_step")
        logger.info("resumed from %s at step %d (epoch %d, batch %d)", ckpt,
                    self.state.step, self.state.epoch,
                    self.state.batch_in_epoch)
        return True

    def _best_dir(self) -> str:
        return os.path.join(self.tc.output_dir, "best")

    def _maybe_update_best(self, eval_metrics: Dict[str, float]) -> None:
        key = self.tc.metric_for_best_model
        if key not in eval_metrics and not key.startswith("eval_"):
            key = f"eval_{key}"          # HF's metric-name normalisation
        if key not in eval_metrics:
            return
        value = float(eval_metrics[key])
        better = (self.best_metric is None
                  or (value > self.best_metric if self.tc.greater_is_better
                      else value < self.best_metric))
        if not better:
            return
        self.best_metric, self.best_step = value, self.state.step
        # outside the checkpoint-N rotation: retention never evicts it
        save_checkpoint(self._best_dir(), self.state.step, self.cfg,
                        self.model, extra={"step": self.state.step,
                                           "metric": value},
                        save_total_limit=1)
        logger.info("new best %s=%.4f at step %d", key, value,
                    self.state.step)

    def _maybe_load_best(self) -> None:
        """The best parameters back into the model (the optimizer keeps
        the last step's moments, as the JAX trainer's does)."""
        if not self.tc.load_best_model_at_end or self.best_step is None:
            return
        ckpt = last_checkpoint(self._best_dir())
        if ckpt is not None:
            restore_checkpoint(ckpt, self.model)
            logger.info("loaded best model (step %d, %s=%.4f)",
                        self.best_step, self.tc.metric_for_best_model,
                        self.best_metric)

    def train(self, train_batches: Callable[..., Iterable[Batch]],
              eval_batches: Optional[Callable[[], Iterable[Batch]]] = None,
              eval_refs: Optional[Dict[str, str]] = None,
              max_steps: Optional[int] = None) -> TrainState:
        """`train_batches()` (or `train_batches(epoch)`, so that the
        shuffle is a function of the epoch) yields an epoch's batches."""
        max_steps = max_steps or self.tc.max_steps
        if max_steps <= 0:
            max_steps = int(1e12)   # epoch mode: num_train_epochs bounds it
        try:
            takes_epoch = len(
                inspect.signature(train_batches).parameters) >= 1
        except (TypeError, ValueError):
            takes_epoch = False
        self.model.train()
        t_start, samples = time.perf_counter(), 0
        # a mid-epoch resume re-enters the interrupted epoch and skips the
        # batches it consumed; a clean epoch boundary starts the next one
        skip = self.state.batch_in_epoch
        epoch = self.state.epoch - 1 if skip > 0 else self.state.epoch
        while self.state.step < max_steps:
            epoch += 1
            n_batches, completed_epoch = 0, True
            it = train_batches(epoch) if takes_epoch else train_batches()
            for bi, batch in enumerate(it):
                n_batches += 1
                if bi < skip:
                    continue          # consumed before the resume point
                if self.state.step >= max_steps:
                    completed_epoch = False
                    break
                gen = step_generator(
                    self.tc.seed, self.state.step, self.device,
                    self.mesh.dp_index if self.mesh is not None else 0)
                metrics = self._train_step(batch.splice_index)(
                    self.model, self._tensors(batch, rows=True), gen)
                self.state = TrainState(self.state.step + 1, epoch, bi + 1)
                samples += batch.arrays["input_values"].shape[0]
                if self.state.step % self.tc.logging_steps == 0:
                    m = {k: (v.tolist() if v.dim() else float(v))
                         for k, v in metrics.items()}
                    dt = time.perf_counter() - t_start
                    m.update(step=self.state.step, epoch=epoch,
                             samples_per_second=round(samples / dt, 2),
                             steps_per_second=round(self.state.step / dt, 3))
                    self.metrics_log.append(m)
                    self._write_metrics(m)
                    logger.info("step %d: %s", self.state.step, m)
                if self.state.step % self.tc.save_steps == 0:
                    self.save()
                if (eval_batches is not None
                        and self.state.step % self.tc.eval_steps == 0):
                    em = self.evaluate(eval_batches(), eval_refs)
                    logger.info("eval @%d: %s", self.state.step, em)
                    self._maybe_update_best(em)
                    self.model.train()
            skip = 0
            if completed_epoch:
                # epoch boundary: a resume from here starts the next epoch
                self.state = TrainState(self.state.step, epoch, 0)
            if n_batches == 0:
                logger.warning("no batches produced this epoch; stopping")
                break
            if epoch >= self.tc.num_train_epochs and self.tc.max_steps <= 0:
                break
        self.save()
        self._maybe_load_best()
        # the last write commits before control returns (an exit with a
        # write in flight would cut it short); its failure is raised here
        wait_for_pending_saves()
        return self.state

    def evaluate(self, batches: Iterable[Batch],
                 refs: Optional[Dict[str, str]] = None,
                 with_generate: bool = True) -> Dict[str, float]:
        """eval_loss over `batches`; with `refs` and a tokenizer also
        eval_wer (%), from greedy `generate` (the decoder LoRA merged)."""
        self.model.eval()
        losses = []
        calc = Calculator() if (refs and self.tokenizer) else None
        for batch in batches:
            arrays = self._tensors(batch)
            m = self._eval_step(batch.splice_index)(
                self.model, self._tensors(batch, rows=True))
            losses.append(float(m["loss"]))
            if calc is not None and with_generate:
                prompt = batch.arrays.get("prompt_ids")
                out = generate(self.model, self.cfg, arrays["input_values"],
                               arrays.get("audio_mask"),
                               prompt_ids=None if prompt is None
                               else torch.from_numpy(prompt),
                               gen=self.gen_cfg)
                seqs = out.sequences.cpu().numpy()
                for i, utt_id in enumerate(batch.utt_ids):
                    hyp = clean_decoded_text(self.tokenizer.decode(
                        seqs[i], skip_special_tokens=False))
                    calc.calculate(utt_id, clean_decoded_text(
                        refs.get(utt_id, "")), hyp)
        out_metrics = {"eval_loss": float(np.mean(losses)) if losses
                       else 0.0}
        if calc is not None:
            out_metrics["eval_wer"] = calc.overall().wer
        return out_metrics
