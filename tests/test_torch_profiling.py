"""The port's tracing helpers (`mtasr_tpu_torch/utils/profiling.py`)
against the JAX package's (`mtasr_tpu/utils/profiling.py`) on the CPU:
`device_memory_stats` empty on the CPU (as the JAX CPU device gives), and
a `trace` that writes a file naming the spans `annotate` marked, the
pipelined stream's among them."""
import glob
import os

import numpy as np
import torch

from mtasr_tpu.utils import profiling as jprof
from mtasr_tpu_torch.utils import profiling as tprof

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


def test_device_memory_stats_empty_on_the_cpu():
    assert tprof.device_memory_stats() == {}
    assert tprof.device_memory_stats(torch.device("cpu")) == {}
    assert jprof.device_memory_stats() == {}


def test_trace_writes_the_annotated_regions(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.randn(16, 16)
    with tprof.trace(logdir):
        with tprof.annotate("mtasr/region_a"):
            y = x @ x
        with tprof.annotate("mtasr/region_b"):
            y = torch.relu(y)
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1
    text = open(files[0]).read()
    assert "mtasr/region_a" in text and "mtasr/region_b" in text
    assert np.isfinite(y.numpy()).all()


def test_pipelined_stream_names_its_regions(tmp_path):
    from mtasr_tpu_torch.generate.pipelined import generate_pipelined
    from tests.test_torch_pipelined import _model, _stream, _tiny, _torch
    cfg, model, _ = _model(_tiny("attention", 3))
    logdir = str(tmp_path / "pipe")
    with tprof.trace(logdir):
        generate_pipelined(model, cfg, _torch(_stream(n=2)),
                           max_new_tokens=4)
    text = open(glob.glob(os.path.join(logdir, "*.json"))[0]).read()
    for name in ("mtasr.pipelined.frontend", "mtasr.pipelined.stage",
                 "mtasr.pipelined.post_encode"):
        assert name in text, name
