"""The served model at full width with random weights: WavLM-Large +
LLaMA-3.2-1B (vocabulary 128 264: the 128 256 of LLaMA-3 plus the eight SOT
specials), attention mode, the character tokenizer's special ids, weights
drawn from a seeded `torch.Generator` on the device. There is no
checkpoint in the repository, so this is the configuration that
`chip_smoke.py` and `profile_path` drive. With `quantize="w8a8"` and
`kv_quant=True` it is the int8 serving leg: the seeded bf16 model
quantized in place, served with an int8 KV cache.

`build_train` is the same model for training, the reference recipe's
trainability (`cli/finetune_asr.py:80-84`): SpecAugment at mask_time_prob
0.05 and the default dropouts, a decoder LoRA on q/k/v/o (r 16, alpha 32,
float32 as the JAX bench adds it); attention mode, or with `hybrid=True`
the JAX bench's flagship recipe (`bench.py:93-100, 283-304`): hybrid
SOT+CTC (ctc_alpha 0.7) with the separator (hidden 896, LSTM dropout 0.2)
and two CTC heads of 128265 outputs, trained with PCGrad. `train_batch` is
a batch shaped like the JAX bench's (`bench.py:108-131`): 10 s of noise a
row, 24 label positions, two talkers split by <sc> (with `split_speakers`
also as the per-talker CTC targets).

`build_8b` serves WavLM-Large + LLaMA-3.1-8B (the composite of the JAX
bench's 8B leg, `benchmarks/stream_8b.py:54-64`: attention mode, the same
vocabulary): with `quantize="w8a8"` the decoder is built directly in int8
serving form (`utils/quantize.py::init_quantized_llama`, about 8.6 GiB on
the device with the encoder), with `quantize=None` in bf16 (16.7 GB).

`family` (a key of `FAMILY`) switches on a configuration of the bridge and
adapter family on the hybrid model (its separator and CTC heads):
A the refiner, the CTC prompt and ctcaware adapters over CTC-token memory;
B the raw bridge and adapgatetiny adapters (LoRA r 16) over the separated
streams; C the softmax bridge and gatetiny adapters over the 50 Hz
features. The adapters are 512 wide (`cross_attn_dim`), one a decoder
layer."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.config import (
    GenerationConfig, SpeechEncoderDecoderConfig, llama_1b_config,
    llama_8b_config, wavlm_large_config,
)
from mtasr_tpu_torch.data.pipeline import Batch
from mtasr_tpu_torch.data.specaugment import compute_mask_indices
from mtasr_tpu_torch.data.tokenizer import CharTokenizer
from mtasr_tpu_torch.train.lora import init_decoder_lora
from mtasr_tpu_torch.utils.convert import init_random
from mtasr_tpu_torch.utils.quantize import quantize_for_serving

SAMPLING_RATE = 16000
VOCAB_SIZE = 128264
_ADAPTERS = dict(decoder_cross_attention=True, cross_attn_dim=512)
FAMILY = {
    "A": dict(talker_ctc_refine=True, ctc_bridge=True,
              ctc_bridge_type="ctcprompt",
              decoder_cross_attention_type="ctcaware",
              decoder_cross_attention_feature="ctctoken", **_ADAPTERS),
    "B": dict(ctc_bridge=True, ctc_bridge_type="raw",
              decoder_cross_attention_type="adapgatetiny",
              decoder_cross_attention_feature="sep", r_max=16, **_ADAPTERS),
    "C": dict(ctc_bridge=True, ctc_bridge_type="softmax",
              decoder_cross_attention_type="gatetiny",
              decoder_cross_attention_feature="mix", **_ADAPTERS),
}


def config(hybrid: bool = False, family: Optional[str] = None,
           decoder=llama_1b_config, **encoder_kw
           ) -> Tuple[SpeechEncoderDecoderConfig, CharTokenizer]:
    """The full-width config (attention mode, or with `hybrid` the hybrid
    SOT+CTC recipe with 2 talkers' CTC heads; `family` implies it) and its
    tokenizer; `decoder` builds the LLaMA geometry (LLaMA-3.2-1B's, or
    `llama_8b_config`)."""
    hybrid = hybrid or family is not None
    tok = CharTokenizer()
    sp = tok.add_special_tokens(instruct=False)
    dec = decoder(vocab_size=VOCAB_SIZE, bos_token_id=sp.bos_token_id,
                  eos_token_id=sp.eos_token_id)
    cfg = SpeechEncoderDecoderConfig(
        encoder=wavlm_large_config(**encoder_kw), decoder=dec,
        train_mode="hybrid" if hybrid else "attention", talker_ctc=hybrid,
        talker_numbers=2, separator_hidden=896, separator_dropout=0.2,
        ctc_alpha=0.7,
        pad_token_id=sp.pad_token_id, sc_token_id=sp.sc_token_id,
        bos_token_id=sp.bos_token_id, eos_token_id=sp.eos_token_id,
        decoder_start_token_id=sp.bos_token_id,
        **(FAMILY[family] if family else {}))
    return cfg, tok


def build(seed: int = 0, device="cuda",
          dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None,
          kv_quant: bool = False, hybrid: bool = False,
          family: Optional[str] = None
          ) -> Tuple[SpeechEncoderDecoderConfig, torch.nn.Module, Transcriber]:
    """(config, model, greedy Transcriber) with weights from `seed`;
    `quantize` ("w8" / "w8a8") quantizes the decoder in place, `kv_quant`
    gives the Transcriber an int8 KV cache; `hybrid` adds the separator
    and the CTC heads (`Transcriber.transcribe_ctc`), `family` a
    configuration of the bridge and adapter family on them."""
    cfg, tok = config(hybrid, family, mask_time_prob=0.0)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = init_random(cfg, g, device, dtype)
    if quantize:
        quantize_for_serving(model, quantize)
    return cfg, model, _greedy(cfg, model, tok, kv_quant)


def build_8b(seed: int = 0, device="cuda", quantize: Optional[str] = "w8a8",
             kv_quant: bool = True
             ) -> Tuple[SpeechEncoderDecoderConfig, torch.nn.Module,
                        Transcriber]:
    """(config, model, greedy Transcriber) of WavLM-Large + LLaMA-3.1-8B
    with weights from `seed`, bf16: with `quantize` ("w8" / "w8a8") the
    decoder initialised directly in int8 serving form, never in bf16;
    `kv_quant` gives the Transcriber an int8 KV cache."""
    cfg, tok = config(decoder=llama_8b_config, mask_time_prob=0.0)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = init_random(cfg, g, device, torch.bfloat16, quantize=quantize)
    return cfg, model, _greedy(cfg, model, tok, kv_quant)


def _greedy(cfg, model, tok, kv_quant: bool) -> Transcriber:
    return Transcriber(cfg, model, tok,
                       gen=GenerationConfig(do_sample=False,
                                            kv_quant=kv_quant))


def build_train(seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.bfloat16, hybrid: bool = False,
                family: Optional[str] = None
                ) -> Tuple[SpeechEncoderDecoderConfig, torch.nn.Module]:
    """(config, model) for training, attention mode or with `hybrid` the
    hybrid SOT+CTC recipe (with `family`, a configuration of the bridge and
    adapter family on it): WavLM-Large's default SpecAugment and dropouts,
    a float32 decoder LoRA (r 16, alpha 32)."""
    cfg, _ = config(hybrid, family)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = init_random(cfg, g, device, dtype).train()
    init_decoder_lora(model, g, r=16, alpha=32.0)
    return cfg, model


def train_batch(cfg: SpeechEncoderDecoderConfig, batch: int, seconds: int,
                seed: int = 0, split_speakers: Optional[bool] = None
                ) -> Batch:
    """One training batch (numpy): `seconds` of noise a row, no padding;
    labels of 24 positions, 9 and 10 ids in [3, 40) split by <sc>, through
    the label surgery (`split_speakers`, by default with CTC heads: also
    label_spks [2, B, 10] and label_spk_lens); the SpecAugment time mask
    drawn from `seed`."""
    if split_speakers is None:
        split_speakers = cfg.talker_ctc
    from mtasr_tpu_torch.data.labels import build_training_arrays
    rng = np.random.default_rng(seed)
    S = SAMPLING_RATE * seconds
    labels = np.full((batch, 24), -100, np.int64)
    for b in range(batch):
        labels[b, :20] = (list(rng.integers(3, 40, 9)) + [cfg.sc_token_id]
                          + list(rng.integers(3, 40, 10)))
    arr = build_training_arrays(
        labels, pad_token_id=cfg.pad_token_id,
        decoder_start_token_id=cfg.decoder_start_token_id,
        eos_token_id=cfg.eos_token_id, sc_token_id=cfg.sc_token_id,
        talker_numbers=cfg.talker_numbers, split_speakers=split_speakers)
    splice = arr.pop("splice_index")
    enc = cfg.encoder
    T0 = enc.conv_output_length(S)
    arrays = {"input_values": rng.standard_normal((batch, S))
              .astype(np.float32),
              "audio_mask": np.ones((batch, S), np.int32),
              "mask_time_indices": compute_mask_indices(
                  (batch, T0), enc.mask_time_prob, enc.mask_time_length,
                  min_masks=enc.mask_time_min_masks, rng=rng),
              **arr}
    return Batch([f"train{b}" for b in range(batch)], arrays, splice)


def waveforms(seed: int, n_requests: int, batch: int,
              seconds: Tuple[float, float] = (6.0, 10.0)
              ) -> List[List[np.ndarray]]:
    """`n_requests` lists of `batch` noise waveforms whose lengths are drawn
    uniformly from `seconds`, so that every batch is padded."""
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(int(rng.uniform(*seconds) * SAMPLING_RATE))
              * 0.1).astype(np.float32) for _ in range(batch)]
            for _ in range(n_requests)]
