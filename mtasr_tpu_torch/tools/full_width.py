"""The served model at full width with random weights: WavLM-Large +
LLaMA-3.2-1B (vocabulary 128 264: the 128 256 of LLaMA-3 plus the eight SOT
specials), attention mode, the character tokenizer's special ids, weights
drawn from a seeded `torch.Generator` on the device. There is no
checkpoint in the repository, so this is the configuration that
`chip_smoke.py` and `profile_path` drive. With `quantize="w8a8"` and
`kv_quant=True` it is the int8 serving leg: the seeded bf16 model
quantized in place, served with an int8 KV cache."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mtasr_tpu_torch.api import Transcriber
from mtasr_tpu_torch.config import (
    GenerationConfig, SpeechEncoderDecoderConfig, llama_1b_config,
    wavlm_large_config,
)
from mtasr_tpu_torch.data.tokenizer import CharTokenizer
from mtasr_tpu_torch.utils.convert import init_random
from mtasr_tpu_torch.utils.quantize import quantize_for_serving

SAMPLING_RATE = 16000
VOCAB_SIZE = 128264


def build(seed: int = 0, device="cuda",
          dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None,
          kv_quant: bool = False
          ) -> Tuple[SpeechEncoderDecoderConfig, torch.nn.Module, Transcriber]:
    """(config, model, greedy Transcriber) with weights from `seed`;
    `quantize` ("w8" / "w8a8") quantizes the decoder in place, `kv_quant`
    gives the Transcriber an int8 KV cache."""
    tok = CharTokenizer()
    sp = tok.add_special_tokens(instruct=False)
    dec = llama_1b_config(vocab_size=VOCAB_SIZE, bos_token_id=sp.bos_token_id,
                          eos_token_id=sp.eos_token_id)
    cfg = SpeechEncoderDecoderConfig(
        encoder=wavlm_large_config(mask_time_prob=0.0), decoder=dec,
        train_mode="attention", talker_ctc=False,
        pad_token_id=sp.pad_token_id, sc_token_id=sp.sc_token_id,
        bos_token_id=sp.bos_token_id, eos_token_id=sp.eos_token_id,
        decoder_start_token_id=sp.bos_token_id)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    model = init_random(cfg, g, device, dtype)
    if quantize:
        quantize_for_serving(model, quantize)
    return cfg, model, Transcriber(
        cfg, model, tok,
        gen=GenerationConfig(do_sample=False, kv_quant=kv_quant))


def waveforms(seed: int, n_requests: int, batch: int,
              seconds: Tuple[float, float] = (6.0, 10.0)
              ) -> List[List[np.ndarray]]:
    """`n_requests` lists of `batch` noise waveforms whose lengths are drawn
    uniformly from `seconds`, so that every batch is padded."""
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(int(rng.uniform(*seconds) * SAMPLING_RATE))
              * 0.1).astype(np.float32) for _ in range(batch)]
            for _ in range(n_requests)]
