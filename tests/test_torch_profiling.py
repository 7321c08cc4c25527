"""The port's tracing helpers (`mtasr_tpu_torch/utils/profiling.py`)
against the JAX package's (`mtasr_tpu/utils/profiling.py`) on the CPU:
`StepTimer`'s keys and rounding, `device_memory_stats` empty on the CPU
(as the JAX CPU device gives), and a `trace` that writes a file naming the
regions `annotate` marked, the pipelined stream's among them."""
import glob
import os

import numpy as np
import torch

from mtasr_tpu.utils import profiling as jprof
from mtasr_tpu_torch.utils import profiling as tprof

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


def test_step_timer_keys_match_jax():
    got, want = tprof.StepTimer(), jprof.StepTimer()
    for t in (got, want):
        t.update(8)
        t.update(4)
    g, w = got.metrics("eval"), want.metrics("eval")
    assert list(g) == list(w) == ["eval_runtime", "eval_samples_per_second",
                                  "eval_steps_per_second"]
    assert got.samples == 12 and got.steps == 2
    assert g["eval_samples_per_second"] > 0
    assert g["eval_runtime"] == round(g["eval_runtime"], 4)
    assert g["eval_steps_per_second"] == round(g["eval_steps_per_second"], 3)
    got.reset()
    assert got.metrics()["train_samples_per_second"] == 0.0


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
    for name in ("pipelined/frontend", "pipelined/stage",
                 "pipelined/post_encode"):
        assert name in text, name
