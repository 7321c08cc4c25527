"""Training checkpoints (counterpart of `mtasr_tpu/train/checkpoint.py`,
whose orbax format the port cannot read; this one is safetensors + JSON).

`checkpoint-<step>/` holds
  config.json, model.safetensors -- the model, a model directory as
                                    `utils/model_io.py` writes one;
  optimizer/state.safetensors    -- AdamW's moments (and accumulated
                                    gradient) as `mu.<name>`, `nu.<name>`
                                    (`acc.<name>`), absent when no
                                    optimizer state is saved (a
                                    subdirectory, so that the checkpoint
                                    loads as a model directory too);
  trainer_state.json             -- step, epoch, batch_in_epoch, the best
                                    metric and its step, the optimizer's
                                    update count and micro-batch position.
It is written into a temporary directory beside it and renamed when
complete, so a reader never sees half of one. Retention keeps the newest
`save_total_limit` and never deletes the newest.

By default `save_checkpoint` writes in the background, as the JAX
package's does (`mtasr_tpu/train/checkpoint.py:32-80`): it returns once
the state is copied to host memory, and one writer thread serialises that
copy and commits it. The copy is the point: the port's AdamW updates the
parameters and moments in place, so a write that read the live tensors
after the call returned would store a later step. `wait_for_pending_saves`
drains the write and raises the writer's exception if it failed, and so
does every call here that reads or rotates checkpoints (`list_checkpoints`,
`last_checkpoint`, `restore_checkpoint`, `apply_retention`) and the next
save; `Trainer.train` drains before it returns. Retention runs in the
writer after the commit, so it never deletes the step in flight.

`resume_or_raise` is the reference's refuse-to-clobber rule.
`extract_by_prefix` / `load_partial` move the separator and CTC heads
between flat parameter dicts, copying the overlapping rows of a `ctc_lo`
whose vocabulary differs.

On a dp x tp mesh (`parallel/mesh.py`) every rank gathers the model and
the AdamW moments from the tp slices and rank 0 writes them, in the
single-process format; a restore reads the whole state and takes this
rank's slices, so a checkpoint moves between geometries (one process, dp,
tp) as it is. Every rank calls the save and the readers; after a save, a
rank's next drain waits at a barrier until rank 0's write has committed.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig
from mtasr_tpu_torch.parallel import multihost
from mtasr_tpu_torch.parallel.mesh import gather_state_dict, tp_local
from mtasr_tpu_torch.utils.model_io import (
    LORA_META, check_disk, flat_state, read_flat, save_model, tensor_bytes,
)
from mtasr_tpu_torch.utils.safetensors_io import load_file, save_file

_NAME = re.compile(r"checkpoint-(\d+)")
OPT_FILE = os.path.join("optimizer", "state.safetensors")
STATE_FILE = "trainer_state.json"


def ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")


def _opt_flat(opt_state: dict, model=None) -> Dict[str, torch.Tensor]:
    """The moments by `<slot>.<parameter name>`, each gathered whole from
    the tp slices when `model` is sharded."""
    return {f"{slot}.{name}": t for slot in ("mu", "nu", "acc")
            for name, t in gather_state_dict(
                dict(opt_state.get(slot) or {}), model).items()}


class _Writer:
    """The process's background checkpoint writer: one write at a time on
    its own thread; the write's exception is kept for the next drain."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._unsynced = False   # a save since this rank's last drain

    def start(self, fn) -> None:
        def run():
            try:
                fn()
            except Exception as e:     # raised again by drain()
                self._error = e
        # not a daemon: the interpreter waits for a write at exit
        self._thread = threading.Thread(target=run, name="checkpoint-writer")
        self._thread.start()

    def saved(self) -> None:
        self._unsynced = True

    def drain(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("the background checkpoint write failed") \
                from err
        if self._unsynced:
            self._unsynced = False
            multihost.barrier("checkpoint")


_WRITER = _Writer()


def wait_for_pending_saves() -> None:
    """Block until the background checkpoint write has committed (on a
    mesh, until rank 0's has); raise its exception if it failed."""
    _WRITER.drain()


def _host_copy(flat: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().to("cpu", copy=True) for k, t in flat.items()}


def save_checkpoint(output_dir: str, step: int,
                    cfg: SpeechEncoderDecoderConfig, model: torch.nn.Module,
                    opt_state: Optional[dict] = None,
                    extra: Optional[dict] = None,
                    save_total_limit: Optional[int] = None,
                    blocking: bool = False) -> str:
    """Write `checkpoint-<step>` under `output_dir` (replacing one of that
    step), then apply retention; returns its path. `opt_state` is
    `AdamW.state_dict()`; `extra` goes into trainer_state.json. On a mesh
    every rank calls it (the tp slices are gathered) and rank 0 writes.
    Unless `blocking`, it returns once the state is on the host, and the
    write commits in the background (`wait_for_pending_saves`)."""
    wait_for_pending_saves()
    path = ckpt_dir(output_dir, step)
    flat = gather_state_dict(flat_state(model), model)
    opt = _opt_flat(opt_state or {}, model)
    _WRITER.saved()
    if multihost.process_index() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        check_disk(path, tensor_bytes(flat.values()) +
                   tensor_bytes(opt.values()))
        state = dict(extra or {})
        if opt_state is not None:
            state["optimizer"] = {"count": opt_state["count"],
                                  "mini_step": opt_state["mini_step"]}
        host = _host_copy(flat)
        host_opt = None if opt_state is None else _host_copy(opt)
        _WRITER.start(lambda: _write(output_dir, step, cfg, host, host_opt,
                                     state, save_total_limit))
    if blocking:
        wait_for_pending_saves()
    return path


def _write(output_dir: str, step: int, cfg: SpeechEncoderDecoderConfig,
           flat: Dict[str, torch.Tensor],
           opt: Optional[Dict[str, torch.Tensor]], state: dict,
           save_total_limit: Optional[int]) -> None:
    """The writer's part of a save: the tensors into a temporary directory,
    renamed to `checkpoint-<step>` when complete, then retention."""
    path = ckpt_dir(output_dir, step)
    tmp = os.path.join(os.path.dirname(path), f".tmp-checkpoint-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    save_model(tmp, cfg, flat)
    if opt is not None:
        os.makedirs(os.path.join(tmp, "optimizer"))
        save_file(opt, os.path.join(tmp, OPT_FILE))
    with open(os.path.join(tmp, STATE_FILE), "w") as f:
        json.dump(state, f, indent=2)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if save_total_limit:
        _retain(output_dir, save_total_limit)


def apply_retention(output_dir: str, limit: int) -> None:
    """Delete all but the newest `limit` checkpoints (the newest always
    stays), after the write in flight has committed."""
    wait_for_pending_saves()
    _retain(output_dir, limit)


def _retain(output_dir: str, limit: int) -> None:
    for s in _steps(output_dir)[:-max(limit, 1)]:
        shutil.rmtree(ckpt_dir(output_dir, s), ignore_errors=True)


def _steps(output_dir: str) -> List[int]:
    if not os.path.isdir(output_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch,
                                               os.listdir(output_dir))
                  if m)


def list_checkpoints(output_dir: str) -> List[int]:
    """The steps of the complete checkpoints under `output_dir`, sorted
    (the write in flight committed first)."""
    wait_for_pending_saves()
    return _steps(output_dir)


def last_checkpoint(output_dir: str) -> Optional[str]:
    steps = list_checkpoints(output_dir)
    return ckpt_dir(output_dir, steps[-1]) if steps else None


def resume_or_raise(output_dir: str, overwrite: bool = False,
                    resume: bool = True) -> Optional[str]:
    """The newest checkpoint to resume from (None if there is none, or if
    not `resume`). A non-empty `output_dir` without a checkpoint is
    refused unless `overwrite`."""
    if not os.path.isdir(output_dir):
        return None
    ckpt = last_checkpoint(output_dir)
    if ckpt is None:
        if os.listdir(output_dir) and not overwrite:
            raise ValueError(
                f"Output directory ({output_dir}) is non-empty with no "
                "checkpoint. Pass overwrite=True to train from scratch.")
        return None
    return ckpt if resume else None


@torch.no_grad()
def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer=None) -> dict:
    """Copy a checkpoint's parameters into `model` (strict: the same names
    and shapes; the parameters keep their identity, so an optimizer built
    over them stays valid) and, when given, its optimizer state into
    `optimizer`; returns trainer_state.json. A sharded model takes its
    rank's slices of the whole state. The write in flight commits first."""
    wait_for_pending_saves()
    flat = read_flat(path)
    for key in LORA_META:
        flat.pop(key, None)
    model.load_state_dict({k: tp_local(model, k, v) for k, v in flat.items()},
                          strict=True)
    with open(os.path.join(path, STATE_FILE)) as f:
        state = json.load(f)
    if optimizer is not None:
        opt = load_file(os.path.join(path, OPT_FILE))
        slots: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, t in opt.items():
            slot, name = key.split(".", 1)
            slots.setdefault(slot, {})[name] = tp_local(model, name, t)
        optimizer.load_state_dict({**slots, **state["optimizer"]})
    return state


# ---------------------------------------------------------------------------
# compositional checkpointing, on flat parameter dicts
# ---------------------------------------------------------------------------
def _top(key: str) -> str:
    return key.split(".", 1)[0]


def extract_by_prefix(flat: Mapping[str, torch.Tensor],
                      prefixes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """The entries whose top-level name is one of `prefixes`."""
    return {k: v for k, v in flat.items() if _top(k) in prefixes}


def load_partial(flat: Mapping[str, torch.Tensor],
                 donor: Mapping[str, torch.Tensor],
                 prefixes: Tuple[str, ...],
                 vocab_tolerant_keys: Tuple[str, ...] = ("ctc_lo",)
                 ) -> Dict[str, torch.Tensor]:
    """`flat` with the donor's entries under `prefixes` grafted in. A
    donor tensor whose shape differs is refused, unless its name holds one
    of `vocab_tolerant_keys` and the ranks agree: then the overlapping
    rows (and columns) are copied and the rest of `flat`'s kept."""
    out = dict(flat)
    for key, src in donor.items():
        if _top(key) not in prefixes:
            continue
        dst = out.get(key)
        if dst is None or tuple(dst.shape) == tuple(src.shape):
            out[key] = src
        elif any(t in key for t in vocab_tolerant_keys) \
                and dst.dim() == src.dim():
            sl = tuple(slice(0, min(a, b))
                       for a, b in zip(dst.shape, src.shape))
            merged = dst.clone()
            merged[sl] = src[sl].to(merged.dtype)
            out[key] = merged
        else:
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(dst.shape)} vs {tuple(src.shape)}")
    return out
