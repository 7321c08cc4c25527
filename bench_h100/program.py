"""The program's own spans and counter (`mtasr_tpu_torch/utils/profiling.py`:
`annotate`, `count`), for the per-layer metrics that read them. The
program keeps them while a `torch.profiler` runs, so the traced window's
profile brings them, on the profiler's clock; its `take()` hands them over
once the window has closed, and this module takes them once a process.

`view(records)` is the traced run's records with the program's spans (µs,
by name, as the benchmark's own) and counters beside the benchmark's, the
records the harness holds left as they are; records that already carry
`mtasr.*` spans are their own view. A program without spans gives None:
its metrics are not reported."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

PREFIX = "mtasr."
STEPS = "mtasr.engine.decode.steps"
_taken: Optional[Tuple[list, Dict[str, int]]] = None


def _program() -> Tuple[list, Dict[str, int]]:
    global _taken
    if _taken is None:
        from mtasr_tpu_torch.utils import profiling
        take = getattr(profiling, "take", None)
        _taken = take() if take is not None else ([], {})
    return _taken


def view(rec):
    if any(n.startswith(PREFIX) for n in rec.spans):
        return rec
    spans, counts = _program()
    if not spans:
        return None
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append((s.start_ns / 1e3,
                                               s.end_ns / 1e3))
    return dataclasses.replace(
        rec, spans={**rec.spans, **{k: sorted(v)
                                    for k, v in by_name.items()}},
        counts={**rec.counts, **counts})


def launches_in(rec, name: str) -> int:
    """Device operations the host launched inside the `name` span's
    intervals (disjoint, in order), by the rule of
    `Records.range_device_s`."""
    iv = rec.spans.get(name, [])
    t = np.array([x for x in rec.launched if x is not None])
    if not iv or not t.size:
        return 0
    starts = np.array([s for s, _ in iv])
    ends = np.array([e for _, e in iv])
    i = np.searchsorted(starts, t, side="right") - 1
    return int(((i >= 0) & (t <= ends[np.maximum(i, 0)])).sum())


def per_call(rec, ms: float) -> Optional[float]:
    n = rec.counts.get("calls", 0)
    return ms / n if n and ms else None


def per_step(rec, ms: float) -> Optional[float]:
    n = rec.counts.get(STEPS, 0)
    return ms / n if n and ms else None


def entry_host_ms(rec) -> Optional[float]:
    """Host ms a call in the serving entry's own work: preparing the
    recordings, the batches' copies to the device, the tokenizer."""
    v = view(rec)
    return v and per_call(v, 1e3 * sum(
        v.range_s(f"mtasr.api.{k}")
        for k in ("prepare", "to_device", "detokenize")))
