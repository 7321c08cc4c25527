"""The port's `cli/tools.py` subcommands and its cpWER against the JAX
package's, on the CPU:

* on a model directory the JAX package writes (a tiny hybrid model with a
  decoder LoRA): `extract` and `merge-lora` write the tensors the JAX
  tools write (extract bit-equal, the merge within rtol 1e-6: the f32
  low-rank product in two libraries' orders) and print the same lines;
  `check-keys` prints the same listing;
* `compute-wer` prints the JAX tool's report, word and char mode, case
  folded or not, with and without the per-utterance alignments;
* `cpwer` equals the JAX `cpwer`, with its native enumeration and on its
  Python path, over 2 and 3 streams and unequal stream counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtasr_tpu.cli import tools as jtools
from mtasr_tpu.models.speech_encoder_decoder import init_model_params
from mtasr_tpu.train.lora import init_decoder_lora as jax_init_lora
from mtasr_tpu.utils import native as jnative
from mtasr_tpu.utils import wer as jwer
from mtasr_tpu.utils.model_io import save_model as jax_save
from mtasr_tpu_torch.cli import tools as ttools
from mtasr_tpu_torch.utils import wer as twer
from mtasr_tpu_torch.utils.model_io import read_config, read_flat
from tests.test_composite import tiny_cfg

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX-written hybrid model directory with a decoder LoRA (B != 0)."""
    cfg = tiny_cfg(train_mode="hybrid", talker_ctc=True)
    params = init_model_params(jax.random.key(0), cfg)
    params["decoder_lora"] = jax_init_lora(jax.random.key(1),
                                           params["decoder"], r=4, alpha=8.0)
    rng = np.random.default_rng(2)
    for li, projs in params["decoder_lora"].items():
        if li != "__meta__":
            for ab in projs.values():
                ab["lora_B"] = jnp.asarray(rng.standard_normal(
                    ab["lora_B"].shape).astype(np.float32) * 0.05)
    d = str(tmp_path_factory.mktemp("jaxmodel"))
    jax_save(d, cfg, params)
    return d


def _run(tools, argv, capsys):
    tools.main(argv)
    return capsys.readouterr().out


def _flat(d):
    return {k: t.clone() for k, t in read_flat(d).items()}


def test_extract_matches_jax(jax_dir, tmp_path, capsys):
    outs = {}
    for side, tools in (("jax", jtools), ("port", ttools)):
        d = str(tmp_path / side)
        printed = _run(tools, ["extract", "--model_dir", jax_dir,
                               "--output_dir", d], capsys)
        outs[side] = (printed.replace(d, "OUT"), _flat(d),
                      read_config(d).to_json())
    assert outs["port"][0] == outs["jax"][0]
    assert "separator" in outs["port"][0]
    assert outs["port"][2] == outs["jax"][2]
    assert outs["port"][1].keys() == outs["jax"][1].keys()
    assert {k.split(".")[0] for k in outs["port"][1]} == \
        {"separator", "serialized_ctc"}
    for k, t in outs["port"][1].items():
        assert torch.equal(t, outs["jax"][1][k]), k


def test_merge_lora_matches_jax(jax_dir, tmp_path, capsys):
    outs = {}
    for side, tools, extra in (("jax", jtools, []),
                               ("port", ttools, ["--device", "cpu"])):
        d = str(tmp_path / side)
        printed = _run(tools, ["merge-lora", "--model_dir", jax_dir,
                               "--output_dir", d] + extra, capsys)
        outs[side] = (printed.replace(d, "OUT"), _flat(d))
    assert outs["port"][0] == outs["jax"][0]
    got, want = outs["port"][1], outs["jax"][1]
    assert got.keys() == want.keys()
    assert not any("lora" in k for k in got)
    src = read_flat(jax_dir)
    moved = 0
    for k, t in got.items():
        torch.testing.assert_close(t, want[k], rtol=1e-6, atol=1e-7, msg=k)
        moved += not torch.equal(t, src[k])
    assert moved == 2 * 4   # q / k / v / o of both decoder layers


def test_check_keys_matches_jax(jax_dir, capsys):
    want = _run(jtools, ["check-keys", "--model_dir", jax_dir], capsys)
    got = _run(ttools, ["check-keys", "--model_dir", jax_dir], capsys)
    assert got == want
    assert "decoder_lora.0.q_proj.lora_A" in got


REFS = {"u1": "hello world <sc> good day", "u2": "one two three",
        "u3": "你好世界 <sc> 早上好", "u4": "Cat Sat", "u5": "gone"}
HYPS = {"u1": "hello word <sc> good day day", "u2": "one three",
        "u3": "你好世 <sc> 早上好啊", "u4": "cat sat"}


@pytest.mark.parametrize("flags", [[], ["--char", "1"], ["--cs", "1"],
                                   ["--v", "0"]],
                         ids=["words", "chars", "case", "summary"])
def test_compute_wer_matches_jax(tmp_path, capsys, flags):
    ref, hyp = tmp_path / "ref", tmp_path / "hyp"
    ref.write_text("".join(f"{k} {v}\n" for k, v in REFS.items()))
    hyp.write_text("".join(f"{k} {v}\n" for k, v in HYPS.items()))
    argv = ["compute-wer", str(ref), str(hyp)] + flags
    want = _run(jtools, argv, capsys)
    assert _run(ttools, argv, capsys) == want
    assert "Overall ->" in want


CPWER = [(["a b c", "d e"], ["d e", "a b x"]),
         (["one two", "three", "four five six"],
          ["four five", "one two", "three three"]),
         (["x y z"], ["z", "x y"]),
         (["a a", "a a"], ["a", "a a a"])]


@pytest.mark.parametrize("native", [True, False])
def test_cpwer_matches_jax(native, monkeypatch):
    if not native:
        monkeypatch.setattr(jnative, "cpwer_native", lambda *a: None)
    for refs, hyps in CPWER:
        for char_mode in (False, True):
            want = jwer.cpwer(refs, hyps, char_mode=char_mode)
            got = twer.cpwer(refs, hyps, char_mode=char_mode)
            assert got[0] == pytest.approx(want[0], rel=0, abs=0)
            assert tuple(got[1]) == tuple(want[1])
