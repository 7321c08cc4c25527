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
also as the per-talker CTC targets)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.config import (
    GenerationConfig, SpeechEncoderDecoderConfig, llama_1b_config,
    wavlm_large_config,
)
from mtasr_tpu_torch.data.pipeline import Batch
from mtasr_tpu_torch.data.specaugment import compute_mask_indices
from mtasr_tpu_torch.data.tokenizer import CharTokenizer
from mtasr_tpu_torch.train.lora import init_decoder_lora
from mtasr_tpu_torch.utils.convert import init_random
from mtasr_tpu_torch.utils.quantize import quantize_for_serving

SAMPLING_RATE = 16000
VOCAB_SIZE = 128264


def config(hybrid: bool = False, **encoder_kw
           ) -> Tuple[SpeechEncoderDecoderConfig, CharTokenizer]:
    """The full-width config (attention mode, or with `hybrid` the hybrid
    SOT+CTC recipe with 2 talkers' CTC heads) and its tokenizer."""
    tok = CharTokenizer()
    sp = tok.add_special_tokens(instruct=False)
    dec = llama_1b_config(vocab_size=VOCAB_SIZE, bos_token_id=sp.bos_token_id,
                          eos_token_id=sp.eos_token_id)
    cfg = SpeechEncoderDecoderConfig(
        encoder=wavlm_large_config(**encoder_kw), decoder=dec,
        train_mode="hybrid" if hybrid else "attention", talker_ctc=hybrid,
        talker_numbers=2, separator_hidden=896, separator_dropout=0.2,
        ctc_alpha=0.7,
        pad_token_id=sp.pad_token_id, sc_token_id=sp.sc_token_id,
        bos_token_id=sp.bos_token_id, eos_token_id=sp.eos_token_id,
        decoder_start_token_id=sp.bos_token_id)
    return cfg, tok


def build(seed: int = 0, device="cuda",
          dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None,
          kv_quant: bool = False, hybrid: bool = False
          ) -> Tuple[SpeechEncoderDecoderConfig, torch.nn.Module, Transcriber]:
    """(config, model, greedy Transcriber) with weights from `seed`;
    `quantize` ("w8" / "w8a8") quantizes the decoder in place, `kv_quant`
    gives the Transcriber an int8 KV cache; `hybrid` adds the separator
    and the CTC heads (`Transcriber.transcribe_ctc`)."""
    cfg, tok = config(hybrid, mask_time_prob=0.0)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = init_random(cfg, g, device, dtype)
    if quantize:
        quantize_for_serving(model, quantize)
    return cfg, model, Transcriber(
        cfg, model, tok,
        gen=GenerationConfig(do_sample=False, kv_quant=kv_quant))


def build_train(seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.bfloat16, hybrid: bool = False
                ) -> Tuple[SpeechEncoderDecoderConfig, torch.nn.Module]:
    """(config, model) for training, attention mode or with `hybrid` the
    hybrid SOT+CTC recipe: WavLM-Large's default SpecAugment and dropouts,
    a float32 decoder LoRA (r 16, alpha 32)."""
    cfg, _ = config(hybrid)
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
