"""The port's spans and counters, tracing, and device memory (counterpart of
`mtasr_tpu/utils/profiling.py`, the analogue of HF's memory tracker):

* `annotate(name)`: a span, as a context manager. Spans and counters are
  kept only while a `torch.profiler` runs (the program is being traced);
  otherwise `annotate` returns one shared no-op and `count` does nothing,
  at the cost of one attribute read and a branch. A kept span has its
  name, its start and end in ns of `time.time_ns()` (the wall clock the
  profiler stamps its events with, so a span and the kernels launched
  inside it line up), its parent (the innermost span open on the same
  thread) and its call id (the id of its root span: one call of the
  program). Inside `trace(logdir)` a span is also a
  `torch.profiler.record_function`, so the Chrome trace names it;
* `annotated(name)`: a function decorator that runs each call in a span;
* `count(name, n=1)`: a counter beside the spans;
* `take()`: the spans and counters kept since the last `take`, cleared;
* `trace(logdir)`: a `torch.profiler` run over the CPU and, where there is
  one, the card, written into `logdir` as a Chrome / TensorBoard trace;
* `device_memory_stats`: the card's bytes in use, their peak and the
  card's size; `{}` on the CPU, as the JAX CPU device gives.

Every span of the port is named `mtasr.<layer>.<what>` (README.md lists
them); the counters are `mtasr.engine.decode.steps`,
`mtasr.engine.decode.graph_replays`, `mtasr.int8.w8a8_linears` and
`.w8a8_kernels` (`models/layers.py::linear`: w8a8 calls, and those that
ran the quantize and rescale kernels) and, for a decoder with experts,
`mtasr.decoder.moe.pairs`, `.pairs_max` and `.experts_read`
(`models/moe.py::read_tally`, from a tally kept only while spans are).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int      # the enclosing span's id; 0 for a root span
    call: int        # the root span's id


_ids = itertools.count(1)
_spans: List[Span] = []
_counts: Dict[str, int] = {}
_lock = threading.Lock()
_stack = threading.local()
_in_trace = False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start", "region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_stack, "open", None)
        if stack is None:
            stack = _stack.open = []
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = 0, self.id
        stack.append(self)
        self.region = None
        if _in_trace:
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.region is not None:
            self.region.__exit__(*exc)
        _stack.open.pop()
        _spans.append(Span(self.name, self.start, end, self.id, self.parent,
                           self.call))
        return False


def annotate(name: str):
    """A span named `name`: kept while a `torch.profiler` runs, a shared
    no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def tracing() -> bool:
    """Whether spans and counters are kept now (a `torch.profiler` runs)."""
    return bool(_profiler._is_profiler_enabled)


def annotated(name: str):
    """A decorator: each call of the function runs in a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while a `torch.profiler` runs."""
    if _profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def take() -> Tuple[List[Span], Dict[str, int]]:
    """(spans in the order they closed, counters) kept since the last
    `take`; both are cleared."""
    global _spans, _counts
    with _lock:
        out = (_spans, _counts)
        _spans, _counts = [], {}
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; the trace lands in `logdir` (a `*.pt.trace.json`
    that TensorBoard's profiler plugin and Perfetto read), each span of
    the body a named region of it. The card's work is synchronised before
    the profiler stops."""
    global _in_trace
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        _in_trace = True
        try:
            yield
        finally:
            _in_trace = False
            if torch.cuda.is_available():
                torch.cuda.synchronize()


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
