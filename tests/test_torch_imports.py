"""The port runs with JAX and the JAX package unavailable: a subprocess
blocks `jax` and `mtasr_tpu`, imports every module of `mtasr_tpu_torch`,
serves a tiny model on the CPU through `generate` and `Transcriber` with the
port's own config and tokenizer, then quantized (w8a8, int8 KV cache), and
takes a train step through `Trainer` (which ends with a checkpoint), saves
and reloads a model directory through the port's own safetensors I/O with
the `safetensors` package blocked too, then a hybrid SOT+CTC model through
a PCGrad `Trainer` step and `transcribe_ctc`, then a model of the bridge and
adapter family through `generate`, then a pipelined stream of two batches
and a `collate` of WAV files read by the port's native loader, and checks
that no kernel was launched (CPU tensors take the plain versions). No file
of the port, and not `chip_smoke.py`, imports jax, the JAX package or
`safetensors`, or builds from the repo-root `native/`, and `transformers`
is imported only inside `HFTokenizer`. Every module of the JAX package has
its counterpart in the port, but for the two named exceptions, and so has
every public function and class, by name, by a named rename, or with the
reason it is JAX's alone. Every port test file pins torch to one intra-op
thread."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import torch

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# a subprocess's torch starts one intra-op thread per core unless told:
# under the suite's workers that oversubscribes the cores many times over
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

_SCRIPT = r"""
import os, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["mtasr_tpu"] = None    # and so does the JAX package
sys.modules["safetensors"] = None  # the GPU machine has neither
sys.modules["transformers"] = None
import tempfile
import importlib, pkgutil
import numpy as np, torch
import mtasr_tpu_torch
for m in pkgutil.walk_packages(mtasr_tpu_torch.__path__, "mtasr_tpu_torch."):
    importlib.import_module(m.name)
from mtasr_tpu_torch.config import (DataConfig, GenerationConfig,
                                    LlamaConfig, SpeechEncoderDecoderConfig,
                                    WavLMConfig)
from mtasr_tpu_torch.data.tokenizer import CharTokenizer
from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.generate import generate
from mtasr_tpu_torch.ops import kernels
from mtasr_tpu_torch.utils.convert import init_random

tok = CharTokenizer()
sp = tok.add_special_tokens()
enc = WavLMConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                  intermediate_size=48, conv_dim=(32, 8), conv_stride=(5, 2),
                  conv_kernel=(10, 3), num_buckets=16, max_bucket_distance=20,
                  num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2,
                  output_hidden_size=16, mask_time_prob=0.0,
                  do_stable_layer_norm=True, feat_extract_norm="layer",
                  conv_bias=True)
dec = LlamaConfig(vocab_size=64, hidden_size=24, intermediate_size=48,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=6, bos_token_id=1,
                  eos_token_id=2)
cfg = SpeechEncoderDecoderConfig(
    encoder=enc, decoder=dec, pad_token_id=sp.pad_token_id,
    sc_token_id=sp.sc_token_id, bos_token_id=1, eos_token_id=2,
    decoder_start_token_id=1)
g = torch.Generator()
g.manual_seed(0)
model = init_random(cfg, g, "cpu", torch.float32)
kernels.reset_launch_counts()
wav = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4000))
                       .astype(np.float32))
amask = torch.ones((2, 4000), dtype=torch.int32)
amask[1, 2500:] = 0
out = generate(model, cfg, wav, amask, max_new_tokens=5)
assert out.sequences.shape == (2, 5) and out.steps == 4
dc = DataConfig(min_duration_in_seconds=0.0, max_duration_in_seconds=1e9,
                bucket_boundaries_seconds=(0.25,))
texts = Transcriber(cfg, model, tok, dc=dc).transcribe(
    [wav[0].numpy(), wav[1, :2500].numpy()], max_new_tokens=4)
assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
assert set(kernels.launch_counts().values()) == {0}, kernels.launch_counts()
from mtasr_tpu_torch.utils.quantize import quantize_for_serving
quantize_for_serving(model, "w8a8")
out = generate(model, cfg, wav, amask, max_new_tokens=5,
               gen=GenerationConfig(kv_quant=True))
assert out.sequences.shape == (2, 5)
assert set(kernels.launch_counts().values()) == {0}, kernels.launch_counts()
assert len(kernels.launch_counts()) == 14
# one attention-mode train step through Trainer (fresh model, LoRA)
from mtasr_tpu_torch.config import TrainingConfig
from mtasr_tpu_torch.data.pipeline import (PreparedExample,
                                          batches_from_examples)
from mtasr_tpu_torch.train.lora import init_decoder_lora
from mtasr_tpu_torch.train.loop import Trainer
model = init_random(cfg, g, "cpu", torch.float32)
init_decoder_lora(model, g, r=2, alpha=4.0)
ex = [PreparedExample(f"u{i}", wav[0].numpy(), [],
                      [5, 6, sp.sc_token_id, 7]) for i in range(2)]
out = out_dir = tempfile.mkdtemp()
trainer = Trainer(cfg, TrainingConfig(max_steps=1, warmup_steps=0,
                                      output_dir=out),
                  dc, model, freeze_kwargs=dict(freeze_decoder=True))
trainer.train(lambda: batches_from_examples(ex, cfg, dc, 2))
assert trainer.state.step == 1
assert os.path.exists(os.path.join(out, "checkpoint-1", "model.safetensors"))
from mtasr_tpu_torch.utils import model_io
model_io.save_model(os.path.join(out, "m"), cfg, model)
cfg2, model2 = model_io.load_model(os.path.join(out, "m"), "cpu")
assert all(torch.equal(v, model2.state_dict()[k])
           for k, v in model.state_dict().items())
assert set(kernels.launch_counts().values()) == {0}, kernels.launch_counts()
# hybrid SOT+CTC with PCGrad, then the one-shot CTC decode
import dataclasses
hcfg = dataclasses.replace(cfg, train_mode="hybrid", talker_ctc=True,
                           separator_hidden=8)
model = init_random(hcfg, g, "cpu", torch.float32)
trainer = Trainer(hcfg, TrainingConfig(max_steps=1, warmup_steps=0,
                                       pcgrad=True, output_dir=out),
                  dc, model, freeze_kwargs=dict(freeze_decoder=True))
trainer.train(lambda: batches_from_examples(ex, hcfg, dc, 2))
assert trainer.state.step == 1
streams = Transcriber(hcfg, model, tok, dc=dc).transcribe_ctc(
    [wav[0].numpy()], max_out_len=5)
assert len(streams) == 1 and len(streams[0]) == 2
assert set(kernels.launch_counts().values()) == {0}, kernels.launch_counts()
# the bridge and adapter family: refiner, CTC prompt, CTC-token memory
fcfg = dataclasses.replace(hcfg, talker_ctc_refine=True, ctc_bridge=True,
                           ctc_bridge_type="ctcprompt",
                           decoder_cross_attention=True,
                           decoder_cross_attention_type="ctcaware",
                           decoder_cross_attention_feature="ctctoken",
                           cross_attn_dim=8)
model = init_random(fcfg, g, "cpu", torch.float32)
out = generate(model, fcfg, wav, amask, max_new_tokens=3)
assert out.sequences.shape == (2, 3)
assert set(kernels.launch_counts().values()) == {0}, kernels.launch_counts()
# a pipelined stream of two batches: the tokens of sequential generate
from mtasr_tpu_torch.generate.pipelined import generate_pipelined
model = init_random(cfg, g, "cpu", torch.float32)
stream = [{"input_values": wav, "audio_mask": amask},
          {"input_values": wav.flip(1), "audio_mask": amask}]
outs = generate_pipelined(model, cfg, stream, max_new_tokens=4)
for b, o in zip(stream, outs):
    ref = generate(model, cfg, b["input_values"], b["audio_mask"],
                   max_new_tokens=4)
    assert torch.equal(o.sequences, ref.sequences)
assert set(kernels.launch_counts().values()) == {0}, kernels.launch_counts()
# collate through the native loader (built under the port's native/)
from mtasr_tpu_torch.data import pipeline as tpl
from mtasr_tpu_torch.data.audio import Utterance, write_wav
from mtasr_tpu_torch.utils import native
utts = []
for i, n in enumerate((3000, 4000)):
    p = os.path.join(out_dir, f"u{i}.wav")
    write_wav(p, np.random.default_rng(i).standard_normal(n) * 0.1)
    utts.append(Utterance(f"u{i}", p, "a b"))
exs = tpl.prepare_examples(utts, tok, dc, lazy=True)
batch = tpl.collate(exs, cfg, dc)
assert batch.arrays["audio_mask"].sum(1).tolist() == [3000, 4000]
assert native.get_lib("audio") is not None
assert str(native.library_path("audio")).startswith(
    os.path.join(os.path.dirname(mtasr_tpu_torch.__file__), "native"))
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m]}
assert not loaded & {"jax", "mtasr_tpu", "safetensors", "transformers"}, \
    loaded
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, **ONE_THREAD})
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout


def _offenders(pattern):
    files = sorted((ROOT / "mtasr_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return [str(f.relative_to(ROOT)) for f in files
            if pattern.search(f.read_text())]


def test_no_port_file_imports_jax():
    assert _offenders(re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)",
                                 re.M)) == []


def test_no_port_file_imports_the_jax_package():
    # `\b` does not match between `mtasr_tpu` and `_torch`
    assert _offenders(re.compile(
        r"^\s*(import|from)\s+mtasr_tpu\b", re.M)) == []


def test_no_port_file_imports_safetensors():
    assert _offenders(re.compile(
        r"^\s*(import|from)\s+safetensors\b", re.M)) == []


def test_no_port_file_builds_from_the_repo_root_native_dir():
    """The port compiles its own copies of the host C++
    (`mtasr_tpu_torch/native/`), never the JAX package's `native/`."""
    from mtasr_tpu_torch.utils import native
    assert native.NATIVE == ROOT / "mtasr_tpu_torch" / "native"
    assert sorted(p.name for p in native.NATIVE.glob("*.cpp")) == \
        ["audio_loader.cpp", "wer_kernel.cpp"]
    assert _offenders(re.compile(
        r"parents\[2\]\s*/\s*[\"']native|[\"']\.\.[\"'],\s*[\"']\.\.[\"']"
        r"|_ROOT,\s*[\"']native")) == []


# JAX modules without a module of the same path in the port, and why
NOT_PORTED = {
    "ops/pallas": "the Pallas kernels: each is a CUDA kernel under "
                  "mtasr_tpu_torch/csrc/ with its wrapper and plain version "
                  "in mtasr_tpu_torch/ops/kernels/ (spmd.py's custom "
                  "partitioning is the ranks' shard-local calls, "
                  "parallel/)",
    "utils/torch_interop.py": "the tests' bridge from JAX parameter trees "
                              "to the port's state dicts",
}


def test_every_jax_module_has_a_port_counterpart():
    jax_pkg, port = ROOT / "mtasr_tpu", ROOT / "mtasr_tpu_torch"
    missing = []
    for f in sorted(jax_pkg.rglob("*.py")):
        rel = f.relative_to(jax_pkg).as_posix()
        if any(rel == k or rel.startswith(k + "/") for k in NOT_PORTED):
            continue
        if not (port / rel).exists():
            missing.append(rel)
    assert missing == []
    for k in NOT_PORTED:
        assert (jax_pkg / k).exists(), k


# public names of JAX modules that the port's module of the same path does
# not define: the port's name for the same function ...
RENAMED = {
    "ops/ctc.py::ctc_loss": "ops/kernels/ctc.py::ctc_loss",
    "parallel/mesh.py::partition_spec_for_tree": "parallel/mesh.py::layout",
    "parallel/mesh.py::shard_params": "parallel/mesh.py::shard_model",
    "parallel/mesh.py::spec_for_path": "parallel/mesh.py::spec_for_name",
    "train/optimizer.py::hf_decay_mask": "train/optimizer.py::is_no_decay",
    "utils/native.py::get_audio_lib": "utils/native.py::get_lib",
    "utils/quantize.py::init_quantized_llama_params":
        "utils/quantize.py::init_quantized_llama",
    "utils/wer.py::normalize_tokens": "utils/wer.py::_tokens",
    "utils/wer.py::stripoff_tags": "utils/wer.py::_strip_tags",
    "utils/wer.py::tokenize": "utils/wer.py::_tokens",
}
# ... or why the port has none (a pattern over "module::name")
JAX_ONLY = {
    r"models/\w+\.py::(init_\w+|\w+_init)":
        "parameter-tree builders: the port's nn.Modules construct their "
        "parameters, utils/convert.py::init_random draws them",
    r"models/layers\.py::tree_cast": "a pytree cast: nn.Module.to(dtype)",
    r"parallel/mesh\.py::batch_sharding": "a jax NamedSharding; the port's "
                                          "ranks take their rows "
                                          "(parallel/mesh.py::shard_batch)",
    r"ops/attention\.py::make_causal_mask": "called by nothing in the JAX "
                                            "package; the port's decoder "
                                            "builds its mask in place",
    r"utils/profiling\.py::StepTimer": "HF's speed_metrics, read by "
                                       "nothing: train/loop.py computes "
                                       "samples and steps a second inline",
}


def _public_names(path: pathlib.Path):
    """The module's top-level functions, classes and assigned names (all
    of them), and its public functions and classes."""
    tree = ast.parse(path.read_text())
    defined, public = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defined.add(node.name)
            if not node.name.startswith("_"):
                public.add(node.name)
        elif isinstance(node, ast.Assign):
            defined.update(t.id for t in node.targets
                           if isinstance(t, ast.Name))
    return defined, public


def test_every_public_jax_name_has_a_port_counterpart():
    """Every public function and class of a ported JAX module is defined
    under its name in the port's module of the same path, or RENAMED names
    its counterpart, or JAX_ONLY says why there is none. No entry of
    either is stale."""
    jax_pkg, port = ROOT / "mtasr_tpu", ROOT / "mtasr_tpu_torch"
    missing, used = [], set()
    for f in sorted(jax_pkg.rglob("*.py")):
        rel = f.relative_to(jax_pkg).as_posix()
        if any(rel == k or rel.startswith(k + "/") for k in NOT_PORTED):
            continue
        have, _ = _public_names(port / rel)
        for name in sorted(_public_names(f)[1] - have):
            key = f"{rel}::{name}"
            why = [p for p in JAX_ONLY if re.fullmatch(p, key)]
            if key in RENAMED:
                mod, new = RENAMED[key].split("::")
                assert new in _public_names(port / mod)[0], RENAMED[key]
                used.add(key)
            elif why:
                used.update(why)
            else:
                missing.append(key)
    assert missing == []
    assert used == set(RENAMED) | set(JAX_ONLY)


def test_transformers_is_imported_only_inside_hftokenizer():
    """The one `transformers` import of the port is in `HFTokenizer`'s
    constructor (indented: at call time, never at module import)."""
    pattern = re.compile(r"^(\s*)(import|from)\s+transformers\b", re.M)
    found = []
    for f in sorted((ROOT / "mtasr_tpu_torch").rglob("*.py")) + \
            [ROOT / "chip_smoke.py"]:
        for m in pattern.finditer(f.read_text()):
            found.append((str(f.relative_to(ROOT)), len(m.group(1))))
    assert [f for f, _ in found] == ["mtasr_tpu_torch/data/tokenizer.py"]
    assert all(indent > 0 for _, indent in found)
    src = (ROOT / "mtasr_tpu_torch/data/tokenizer.py").read_text()
    cls = src[src.index("class HFTokenizer"):]
    cls = cls[:cls.index("\ndef ") if "\ndef " in cls else len(cls)]
    assert "from transformers import" in cls


def test_every_port_test_file_pins_one_thread():
    """Each `tests/test_torch_*.py` sets torch to one intra-op thread at
    import, and every subprocess a port test starts gets OMP_NUM_THREADS=1:
    with the default of a thread per core, the suite's xdist workers
    oversubscribe the cores and the port's tests ran about 4x slower."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 20
    pin = re.compile(r"^torch\.set_num_threads\(1\)$", re.M)
    assert [f.name for f in files if not pin.search(f.read_text())] == []
    spawns = re.compile(r"subprocess\.(run|Popen|call|check_output)\(|"
                        r"get_context\(\"spawn\"\)|num_proc=[2-9]")
    for f in files:
        src = f.read_text()
        if spawns.search(src.replace("spawns = re.compile", "")):
            assert "OMP_NUM_THREADS" in src, f.name
