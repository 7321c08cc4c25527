"""The port runs with JAX and the JAX package unavailable: a subprocess
blocks `jax` and `mtasr_tpu`, imports every module of `mtasr_tpu_torch`,
serves a tiny model on the CPU through `generate` and `Transcriber` with the
port's own config and tokenizer, then quantized (w8a8, int8 KV cache), and
takes a train step through `Trainer` (which ends with a checkpoint), saves
and reloads a model directory through the port's own safetensors I/O with
the `safetensors` package blocked too, then a hybrid SOT+CTC model through
a PCGrad `Trainer` step and `transcribe_ctc`, and checks that no kernel was
launched (CPU tensors take the plain versions). No file of the port, and not
`chip_smoke.py`, imports jax, the JAX package or `safetensors`, and
`transformers` is imported only inside `HFTokenizer`."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

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
assert len(kernels.launch_counts()) == 11
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
out = tempfile.mkdtemp()
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
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m]}
assert not loaded & {"jax", "mtasr_tpu", "safetensors", "transformers"}, \
    loaded
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
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
