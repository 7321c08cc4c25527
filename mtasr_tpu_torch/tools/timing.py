"""The time of one call on a CUDA device, as `chip_smoke.py` and the tools
measure it: `cuda_ms` around eager calls (a short kernel's time is then
its wrapper's host time), `graph_ms` with the calls captured in one CUDA
graph (the device's time alone)."""
from __future__ import annotations

import torch


def cuda_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """ms a call: CUDA events around `iters` calls after 3 warm-ups, the
    median of `repeats` such runs. A wrapper whose host time exceeds its
    kernel's is timed by the host, where a single pause moves the mean of
    20 calls; the median of the runs steps over it."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[repeats // 2]


def graph_ms(fn, iters: int = 20, repeats: int = 5, stream=None) -> float:
    """ms a call on the device alone: `iters` calls captured in one CUDA
    graph (after 3 warm-ups on a side stream), replayed between CUDA events,
    the median of `repeats` replays. A kernel shorter than its wrapper's host
    time is then timed by the device, not by the host. `stream`: warm up
    and capture on it (a backward runs on its forward's stream). A call a
    graph cannot hold raises."""
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(runs)[repeats // 2]
