"""Tracing and speed metrics (counterpart of `mtasr_tpu/utils/profiling.py`,
the analogue of HF's `speed_metrics` and memory tracker):

* `trace(logdir)`: a `torch.profiler` run over the CPU and, where there is
  one, the card, written into `logdir` as a Chrome / TensorBoard trace;
* `annotate(name)`: a named region in that trace
  (`torch.profiler.record_function`);
* `StepTimer`: wall-clock samples/s and steps/s under HF's keys;
* `device_memory_stats`: the card's bytes in use, their peak and the
  card's size; `{}` on the CPU, as the JAX CPU device gives.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; the trace lands in `logdir` (a `*.pt.trace.json`
    that TensorBoard's profiler plugin and Perfetto read). The card's
    work is synchronised before the profiler stops."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()


def annotate(name: str):
    """A named region of the trace, as a context manager."""
    return torch.profiler.record_function(name)


class StepTimer:
    """HF `speed_metrics`: `{prefix}_runtime`, `_samples_per_second` and
    `_steps_per_second` since the last reset."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.samples = 0

    def update(self, n_samples: int):
        self.steps += 1
        self.samples += n_samples

    def metrics(self, prefix: str = "train") -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            f"{prefix}_runtime": round(dt, 4),
            f"{prefix}_samples_per_second": round(self.samples / dt, 3),
            f"{prefix}_steps_per_second": round(self.steps / dt, 3),
        }


def device_memory_stats(device: Optional[torch.device] = None
                        ) -> Dict[str, int]:
    """`bytes_in_use` and `peak_bytes_in_use` (the caching allocator's
    allocated bytes, now and at their peak) and `bytes_limit` (the card's
    total memory) of a CUDA device (the current one by default); `{}` for
    the CPU."""
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}
