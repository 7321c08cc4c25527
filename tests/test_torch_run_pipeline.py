"""The port's stage machine (`mtasr_tpu_torch/cli/run_pipeline.py`) on the
CPU, after `tests/test_pipeline_stage6.py`:

* stages 1-3 (data check, a tiny hybrid model from `--init_random`, two
  fine-tuning steps) write the model and run directories the stage names
  say, under the JAX `encode_run_name`;
* stages 4-6 (decode, decode another set, decode in 2 shards then merge)
  on that run directory write the `decod` and `wer` files the JAX
  pipeline's stages 4-6 write on a copy of it; both read the lazy WAVs
  through their native loaders (the same bits);
* stage 6 at `--dp_size 2` and at `--tp_size 2` runs the inference CLI
  on two ranks under `torch.distributed.run` and writes the
  single-process files.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from mtasr_tpu.cli import run_pipeline as jpipe
from mtasr_tpu.data.audio import write_wav
from mtasr_tpu_torch.cli import run_pipeline as tpipe

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

TEXTS = ["hi there<sc>good day", "one two<sc>three four",
         "cat sat<sc>dog ran", "go now<sc>stay here"]


def _kaldi(d, n, seed):
    d.mkdir()
    rng = np.random.default_rng(seed)
    with open(d / "wav.scp", "w") as fw, open(d / "text", "w") as ft:
        for i, t in enumerate(TEXTS[:n]):
            p = str(d / f"u{i}.wav")
            write_wav(p, rng.standard_normal(8000) * 0.1)
            fw.write(f"u{i} {p}\n")
            ft.write(f"u{i} {t}\n")
    return str(d)


def _argv(root, data, *extra):
    return ["--root", root, "--data_dir", data, "--init_random", "tiny",
            "--talker_ctc", "--train_mode", "hybrid", "--max_steps", "2",
            "--per_device_train_batch_size", "2", "--max_length", "6",
            "--dp_size", "1", *extra]


def test_stages_match_jax(tmp_path):
    data = _kaldi(tmp_path / "data", 4, 0)
    evals = _kaldi(tmp_path / "eval", 2, 1)
    root_j, root_t = str(tmp_path / "jax"), str(tmp_path / "port")

    tpipe.main(_argv(root_t, data, "--stop_stage", "3", "--device", "cpu"))
    run = os.listdir(os.path.join(root_t, "exp"))
    assert run == [jpipe.encode_run_name(
        tpipe.build_argparser().parse_args(_argv(root_t, data)))]
    assert os.path.exists(os.path.join(root_t, "models", run[0],
                                       "config.json"))
    assert os.path.exists(os.path.join(root_t, "exp", run[0], "final",
                                       "model.safetensors"))
    shutil.copytree(root_t, root_j)
    later = ["--stage", "4", "--stop_stage", "6", "--eval_data_dir", evals,
             "--num_shards", "2"]
    jpipe.main(_argv(root_j, data, *later))
    tpipe.main(_argv(root_t, data, *later, "--device", "cpu"))
    for stage, n in ((4, 4), (5, 2), (6, 4)):
        for name in ("decod", "wer"):
            rel = os.path.join("exp", run[0], f"decode_stage{stage}", name)
            with open(os.path.join(root_j, rel)) as f:
                want = f.read()
            with open(os.path.join(root_t, rel)) as f:
                assert f.read() == want, rel
            if name == "decod":
                assert len(want.splitlines()) == n


RUNS = [dict(), dict(talker_ctc=True, ctc_bridge=True, instruct=True),
        dict(decoder_cross_attention=True,
             decoder_cross_attention_type="gatetiny", dataset_name="libri")]


@pytest.mark.parametrize("kw", RUNS)
def test_run_name_matches_jax(kw):
    argv = ["--root", "r", "--data_dir", "d"]
    for k, v in kw.items():
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    args = tpipe.build_argparser().parse_args(argv)
    assert tpipe.encode_run_name(args) == jpipe.encode_run_name(args)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A run directory after stages 1-3 and its single-process stage 6."""
    tmp = tmp_path_factory.mktemp("pipeline")
    data = _kaldi(tmp / "data", 4, 0)
    root = str(tmp / "port")
    tpipe.main(_argv(root, data, "--stop_stage", "3", "--device", "cpu"))
    tpipe.main(_argv(root, data, "--stage", "6", "--stop_stage", "6",
                     "--device", "cpu"))
    return root, data


def _stage6(root):
    run = os.listdir(os.path.join(root, "exp"))[0]
    return os.path.join(root, "exp", run, "decode_stage6")


@pytest.mark.parametrize("flags", [["--dp_size", "2"], ["--tp_size", "2"]])
def test_parallel_sizes_refused(trained, tmp_path, monkeypatch, flags):
    """Data and tensor parallelism run (no longer refused): stage 6 at
    `--dp_size 2` or `--tp_size 2` runs the inference CLI on two ranks
    under `torch.distributed.run` (gloo, `--device cpu`), and rank 0
    writes the single-process `decod`, `label` and `wer`."""
    root, data = trained
    copy = str(tmp_path / "root")
    shutil.copytree(root, copy)
    shutil.rmtree(_stage6(copy))
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tpipe.main(_argv(copy, data, "--stage", "6", "--stop_stage", "6",
                     "--device", "cpu", *flags))
    for name in ("decod", "label", "wer"):
        with open(os.path.join(_stage6(root), name)) as f:
            want = f.read()
        with open(os.path.join(_stage6(copy), name)) as f:
            assert f.read() == want, name
    # one writer: no rank wrote a shard of its own
    assert sorted(os.listdir(_stage6(copy))) == sorted(
        os.listdir(_stage6(root)))
