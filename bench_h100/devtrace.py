"""The traced run's records, from `torch.profiler`'s CUDA activity
(CUPTI): the device's operations with their intervals and the host time
of the runtime call that launched each, the runtime's host calls, and the
benchmark's host spans (`spans.py`), for the device time launched under a
span and for naming the device's idle gaps by what the host was doing.
The raw events are read (`kineto_results`), not the profiler's event
tree, which takes minutes to build for a call of 10^5 kernels. The
profiler keeps its events in memory; nothing is written to disk."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as disjoint intervals in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ms(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (µs in, ms out): the
    arithmetic of `mtasr_tpu_torch/tools/profile_path.py:70` (`busy_ms`),
    over `union`."""
    return sum(e - s for s, e in union(intervals)) / 1e3


@dataclass
class Records:
    """What a per-layer metric's reader reads. Times in µs on the host's
    wall clock (the profiler's)."""
    kernels: List[Tuple[str, float, float]]     # name, start, end
    launched: List[Optional[float]]             # each kernel's launch
    spans: Dict[str, List[Tuple[float, float]]]  # bench.* host intervals
    host: List[Tuple[str, float, float]]        # the runtime's host calls
    window_s: float                             # the traced span
    counts: Dict[str, float] = field(default_factory=dict)
    geometry: dict = field(default_factory=dict)

    def device_s_having(self, *parts: str) -> float:
        """Seconds of the kernels whose name contains one of `parts`."""
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in parts)) / 1e6

    def range_s(self, name: str) -> float:
        """Host seconds inside the `name` span's intervals, summed."""
        return sum(e - s for s, e in self.spans.get(name, [])) / 1e6

    def range_device_s(self, name: str) -> float:
        """Device seconds of the kernels the host launched inside the
        `name` span's intervals, summed."""
        iv = self.spans.get(name, [])
        if not iv:
            return 0.0
        starts = np.array([s for s, _ in iv])
        ends = np.array([e for _, e in iv])
        total = 0.0
        for (_, s, e), t in zip(self.kernels, self.launched):
            if t is None:
                continue
            i = int(np.searchsorted(starts, t, side="right")) - 1
            if i >= 0 and t <= ends[i]:
                total += e - s
        return total / 1e6

    def busy_s(self) -> float:
        return busy_ms([(s, e) for _, s, e in self.kernels]) / 1e3


def collect(prof, window_s: float, spans: Dict[str, List[Tuple[int, int]]],
            bounds_ns: Tuple[int, int]) -> Records:
    """Records of a profile of CUDA activity: every device operation
    (kernels and copies; not the profiler's own annotations) with the
    host time of the runtime call that launched it (matched by the
    correlation id), the runtime's host calls, and the spans' intervals
    inside `bounds_ns` (the traced span, host wall clock)."""
    from torch.autograd import DeviceType
    kernels, corr, host, launch_at = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((e.name(), start, end))
                corr.append(e.correlation_id())
        else:
            host.append((e.name(), start, end))
            launch_at[e.correlation_id()] = start
    kernels_sorted = sorted(zip(kernels, corr), key=lambda kc: kc[0][1])
    return Records(
        kernels=[k for k, _ in kernels_sorted],
        launched=[launch_at.get(c) for _, c in kernels_sorted],
        spans={k: sorted((s / 1e3, e / 1e3) for s, e in v
                         if bounds_ns[0] <= s and e <= bounds_ns[1])
               for k, v in spans.items()},
        host=host, window_s=window_s)


def _short(name: str) -> str:
    name = name.replace("void (anonymous namespace)::", "")
    return name[:120]


def _covering(intervals: List[Tuple[str, float, float]], t: float):
    """The name of the latest-starting interval that covers t, or None."""
    best = None
    for name, s, e in intervals:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return None if best is None else best[0]


def breakdown(rec: Records, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    gaps (the complement of the operations' union inside the span they
    cover), summed by what the host was doing at each gap's middle: the
    benchmark's span under way there and the runtime call, if any
    ("python" when the host was in neither: between launches). The
    `gaps_read` longest gaps are named, the rest summed as "shorter
    gaps". Seconds, unrounded."""
    by_name: Dict[str, float] = {}
    for n, s, e in rec.kernels:
        by_name[_short(n)] = by_name.get(_short(n), 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(s, e) for _, s, e in rec.kernels])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    spans = [(n, s, e) for n, iv in rec.spans.items()
             if not n.startswith("bench.int8_linear") for s, e in iv]
    host = sorted(rec.host, key=lambda h: h[1])
    hs = np.array([h[1] for h in host]) if host else np.zeros(0)
    named: Dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        where = _covering(spans, mid) or "outside the spans"
        k = int(np.searchsorted(hs, mid, side="right"))
        call = next((h[0] for h in reversed(host[max(0, k - 8):k])
                     if h[2] >= mid), "python")
        label = f"{where} / {call}"
        named[label] = named.get(label, 0.0) + (e - s) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
