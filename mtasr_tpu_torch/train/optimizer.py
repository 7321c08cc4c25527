"""AdamW with the JAX package's semantics (counterpart of
`mtasr_tpu/train/optimizer.py`, which is optax: clip_by_global_norm ->
adamw with HF's decay mask and linear warmup schedule, masked to the
trainable parameters, in MultiSteps for accumulation). What
`tests/test_reference_ab.py:404` pins, and this keeps:

* the schedule is HF's `get_linear_schedule_with_warmup` indexed by the
  number of updates already applied, so with warmup the first update runs
  at lr 0 while the moments still advance;
* biases and normalisation parameters (any name part "bias", containing
  "norm", "ln", "ln_*" or "*_ln") get no weight decay;
* the global-norm clip is taken over the trainable gradients only (a
  frozen parameter has none: `requires_grad` is off);
* the moments are kept in each parameter's dtype, as optax keeps them;
* with `gradient_accumulation_steps` k, micro-batch gradients are averaged
  (a running mean, as `optax.MultiSteps`) and applied every k-th call; the
  schedule counts updates, not micro-batches.

A trainable parameter that got no gradient is updated with a zero one, as
its zero cotangent is in JAX.

`state_dict` / `load_state_dict` carry what a resume needs: the update
count (the schedule's position and the bias correction), the micro-batch
position, both moments and the accumulated gradient of every trainable
tensor, by parameter name.

On a model sharded over tp (`parallel/mesh.py::shard_model`, before the
optimizer is built) the clip's global norm sums the squares of the
sharded parameters' gradients over the tp group and counts the
replicated ones once: the norm of the whole model's gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mtasr_tpu_torch.config import TrainingConfig
from mtasr_tpu_torch.parallel.collectives import tp_dot


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int):
    """step -> learning rate, computed in float32 as the JAX schedule is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return float(f32(lr) * f32(step) / f32(max(1, warmup_steps)))
        decay = f32(lr) * f32(total_steps - step) / f32(
            max(1, total_steps - warmup_steps))
        return float(max(decay, f32(0.0)))
    return schedule


def is_no_decay(name: str) -> bool:
    """HF's no-decay names (bias, *norm*, ln, ln_*, *_ln) on the name's
    parts, as `hf_decay_mask` reads the JAX tree's keys."""
    for k in name.split("."):
        if k == "bias" or "norm" in k:
            return True
        if k == "ln" or k.startswith("ln_") or k.endswith("_ln"):
            return True
    return False


class AdamW:
    """The optimizer over the parameters of `model` that require a
    gradient when it is built. `step()` reads their `.grad`."""

    def __init__(self, model: torch.nn.Module, tc: TrainingConfig,
                 total_steps: Optional[int] = None):
        total = total_steps or tc.max_steps
        if total is None or total <= 0:
            raise ValueError(
                "linear schedule needs a positive total step count: set "
                "TrainingConfig.max_steps > 0, or pass total_steps")
        self.tc = tc
        self.schedule = linear_warmup_schedule(tc.learning_rate,
                                               tc.warmup_steps, total)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [not is_no_decay(n) for n, _ in named]
        layout = getattr(model, "tp_layout", {})
        self.sharded = [n in layout for n in self.names]
        mesh = getattr(model, "mesh", None)
        self.tp_group = mesh.tp_group if mesh is not None else None
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0          # updates applied
        self.mini_step = 0      # micro-batches accumulated toward the next
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if tc.gradient_accumulation_steps > 1 else None)

    def state_dict(self) -> Dict[str, object]:
        """{"count", "mini_step", "mu", "nu"[, "acc"]}: the moments (and the
        accumulated gradient) as {parameter name: tensor}."""
        state = {"count": self.count, "mini_step": self.mini_step,
                 "mu": dict(zip(self.names, self.mu)),
                 "nu": dict(zip(self.names, self.nu))}
        if self.acc is not None:
            state["acc"] = dict(zip(self.names, self.acc))
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore `state_dict()`'s content into this optimizer's tensors
        (same trainable names, same shapes)."""
        slots = [("mu", self.mu), ("nu", self.nu)]
        if self.acc is not None:
            slots.append(("acc", self.acc))
        for key, mine in slots:
            theirs = state[key]
            if set(theirs) != set(self.names):
                raise KeyError(f"optimizer state {key}: names differ from "
                               "the trainable parameters: "
                               f"{sorted(set(theirs) ^ set(self.names))[:8]}")
            for name, t in zip(self.names, mine):
                t.copy_(theirs[name])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def grad_norm(self) -> torch.Tensor:
        """Global L2 norm of the trainable gradients (in float32)."""
        return self._norm(self.grads())

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        if self.tp_group is None:
            return _global_norm(grads)
        return torch.sqrt(tp_dot(grads, grads, self.sharded,
                                 self.tp_group))

    @torch.no_grad()
    def step(self) -> bool:
        """Take this call's gradients; returns True when an update was
        applied (every `gradient_accumulation_steps`-th call)."""
        grads = self.grads()
        k = self.tc.gradient_accumulation_steps
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        self._update(grads)
        return True

    def _update(self, grads: List[torch.Tensor]) -> None:
        tc = self.tc
        norm = self._norm(grads)
        if not bool(norm < tc.max_grad_norm):
            grads = [(g / norm.to(g.dtype)) * tc.max_grad_norm for g in grads]
        b1, b2, eps = tc.adam_beta1, tc.adam_beta2, tc.adam_epsilon
        count_inc = self.count + 1
        c1 = np.float32(1.0) - np.float32(b1) ** np.float32(count_inc)
        c2 = np.float32(1.0) - np.float32(b2) ** np.float32(count_inc)
        lr = self.schedule(self.count)
        for p, g, mu, nu, decay in zip(self.params, grads, self.mu, self.nu,
                                       self.decay):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / float(c1)) / (torch.sqrt(nu / float(c2)) + eps)
            if decay and tc.weight_decay:
                u = u + tc.weight_decay * p
            p.copy_((p + u * -lr).to(p.dtype))
        self.count = count_inc


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_optimizer(model: torch.nn.Module, tc: TrainingConfig,
                   total_steps: Optional[int] = None) -> AdamW:
    """AdamW over `model`'s trainable parameters (set `requires_grad` from
    `train.freeze.trainable_mask` first)."""
    return AdamW(model, tc, total_steps)
