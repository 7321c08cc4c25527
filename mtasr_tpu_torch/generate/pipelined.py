"""Pipelined batch-stream decoding (counterpart of
`mtasr_tpu/generate/pipelined.py`): the encoder of batch i+1 runs inside the
decode loop of batch i.

The encode is split in three: `_frontend` (the conv feature encoder, the
projection, the encoder prologue and layer 0), the remaining layers one at
a time, and `_post_encode` (the final LayerNorm, the adapter, the masks,
the separator and the bridge, which give the `EncodedSpeech`). While batch
i decodes, one encoder layer of batch i+1 runs every k = max(1,
(max_new_tokens - 1) // (L - 1)) decode steps, as the JAX engine threads
them through its compiled loop. The decode loop keeps the engine's
`EOS_CHECK_EVERY` early exit; layers still to run when every row is done
run after it. The first batch is encoded alone and the last decodes alone.

On a GPU the next batch's frontend and layers go on a second CUDA stream,
so the card can run them while the decode loop's own stream waits on the
host (a TPU core runs one program at a time, which is why the JAX engine
interleaves inside one program). An event orders `_post_encode` and the
next prefill after those layers; the tensors that cross streams are
recorded on the stream that reads them. On the CPU there is one stream and
the order is the JAX engine's.

The outputs are token-identical to `engine.generate` on each batch, greedy
or sampled: one `torch.Generator` is drawn batch after batch exactly as
sequential `generate` calls draw it. On a dp x tp mesh each dp index
streams its rows (`dp_rows`), the tp ranks run the encoder layers sharded,
and every rank returns whole batches, as `generate` does.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterable, List, Mapping, Optional

import torch

from mtasr_tpu_torch.config import GenerationConfig, SpeechEncoderDecoderConfig
from mtasr_tpu_torch.generate.engine import (
    GenerateOutput, _Picker, decode_encoded, gather_output, prompt_layout,
)
from mtasr_tpu_torch.models.layers import layer_norm
from mtasr_tpu_torch.models.speech_encoder_decoder import (
    EncodedSpeech, SpeechEncoderDecoderModel, bridge_features, speech_feats,
)
from mtasr_tpu_torch.models.wavlm import (
    feature_frontend, wavlm_adapter, wavlm_encoder_layer,
    wavlm_encoder_prologue,
)
from mtasr_tpu_torch.parallel.mesh import dp_rows, take_rows
from mtasr_tpu_torch.train.lora import merged
from mtasr_tpu_torch.utils.profiling import annotate


@dataclass
class _Encoding:
    """A batch whose encoder is under way, on the encoder's stream."""
    hidden: torch.Tensor
    position_bias: torch.Tensor
    feat_mask: Optional[torch.Tensor]
    next_layer: int = 1


def _frontend(model: SpeechEncoderDecoderModel,
              cfg: SpeechEncoderDecoderConfig, input_values: torch.Tensor,
              audio_mask: Optional[torch.Tensor]) -> _Encoding:
    """The conv feature encoder (#1), the projection, the prologue and
    encoder layer 0 (#2)."""
    wm, enc_cfg = model.encoder, cfg.encoder
    hidden, feat_mask, _ = feature_frontend(wm, enc_cfg, input_values,
                                            audio_mask)
    hidden, position_bias = wavlm_encoder_prologue(wm.encoder, enc_cfg,
                                                   hidden, feat_mask)
    hidden = wavlm_encoder_layer(wm.encoder.layers["0"], enc_cfg, hidden,
                                 position_bias, feat_mask)
    return _Encoding(hidden, position_bias, feat_mask)


def _layer(model: SpeechEncoderDecoderModel,
           cfg: SpeechEncoderDecoderConfig, e: _Encoding) -> None:
    """The next encoder layer of `e`, in place."""
    e.hidden = wavlm_encoder_layer(
        model.encoder.encoder.layers[str(e.next_layer)], cfg.encoder,
        e.hidden, e.position_bias, e.feat_mask)
    e.next_layer += 1


def _post_encode(model: SpeechEncoderDecoderModel,
                 cfg: SpeechEncoderDecoderConfig, hidden: torch.Tensor,
                 audio_mask: Optional[torch.Tensor]) -> EncodedSpeech:
    """The tail of `wavlm_forward` and of `encode_speech` (inference):
    the final LayerNorm, the adapter, the masks, the separator, the
    bridge."""
    wm, enc_cfg = model.encoder, cfg.encoder
    if enc_cfg.do_stable_layer_norm:
        hidden = layer_norm(wm.encoder.layer_norm, hidden,
                            enc_cfg.layer_norm_eps)
    speech = (wavlm_adapter(wm.adapter, enc_cfg, hidden)[0]
              if enc_cfg.add_adapter else hidden)
    return bridge_features(model, cfg, speech_feats(model, cfg, hidden,
                                                    speech, audio_mask))


class _Streams:
    """Where the next batch's encoder runs: a second CUDA stream on a
    card, the current one on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.main = torch.cuda.current_stream(device) if self.cuda else None
        self.side = torch.cuda.Stream(device) if self.cuda else None

    def encoder(self):
        """A context that runs its body on the encoder's stream."""
        return (torch.cuda.stream(self.side) if self.cuda
                else contextlib.nullcontext())

    def inputs(self, *tensors: Optional[torch.Tensor]) -> None:
        """Tensors made on the decode stream that the encoder's stream
        reads: it waits for the decode stream's work so far, and the
        caching allocator keeps them until it is done with them."""
        if not self.cuda:
            return
        self.side.wait_stream(self.main)
        for t in tensors:
            if t is not None and t.is_cuda:
                t.record_stream(self.side)

    def join(self, e: _Encoding) -> None:
        """The decode stream waits for the encoder's layers, and keeps the
        hidden state they made until it is done with it."""
        if self.cuda:
            self.main.wait_stream(self.side)
            e.hidden.record_stream(self.main)


def generate_pipelined(model: SpeechEncoderDecoderModel,
                       cfg: SpeechEncoderDecoderConfig,
                       batches: Iterable[Mapping[str, torch.Tensor]],
                       gen: Optional[GenerationConfig] = None,
                       max_new_tokens: Optional[int] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> List[GenerateOutput]:
    """Decode a stream of batches with the encode of batch i+1 under the
    decode of batch i; one `GenerateOutput` a batch, token-identical to
    `engine.generate` on it.

    `batches` holds dicts of `input_values` [B, S], `audio_mask` [B, S]
    (optional) and, in instruct mode, `prompt_ids` [B, P]; it is read one
    batch ahead, so a generator keeps two batches alive at a time. A
    decoder LoRA is merged for the call (`train.lora.merged`)."""
    gen = gen or GenerationConfig()
    if gen.speculative:
        raise ValueError("the pipelined stream decodes greedy or sampled "
                         "tokens; speculative decoding is engine.generate's")
    if max_new_tokens is None:
        max_new_tokens = gen.max_new_tokens or gen.max_length
    max_new_tokens = int(max_new_tokens)
    mesh = getattr(model, "mesh", None)
    device = next(model.parameters()).device
    streams = _Streams(device)
    n_layers = cfg.encoder.num_hidden_layers
    # one encoder layer of the next batch every k decode steps
    k = max(1, (max_new_tokens - 1) // (n_layers - 1)) if n_layers > 1 \
        else None

    def layers_to_end(e: _Encoding) -> None:
        with streams.encoder():
            while e.next_layer < n_layers:
                _layer(model, cfg, e)

    def decode(prev, nxt: Optional[_Encoding]) -> GenerateOutput:
        """Batch `prev`'s prefill and decode, `nxt`'s layers in between."""
        enc, prefill_ids, splice_index, rows = prev

        def after_step(steps: int) -> None:
            if steps % k == 0 and nxt.next_layer < n_layers:
                with streams.encoder():
                    _layer(model, cfg, nxt)
        pick = _Picker(gen, generator, mesh, rows)
        with annotate("mtasr.pipelined.stage"):
            out = decode_encoded(
                model, cfg, enc, prefill_ids, splice_index, gen,
                max_new_tokens, pick,
                after_step if nxt is not None and k is not None else None)
            if nxt is not None:
                layers_to_end(nxt)
        return gather_output(out, mesh, rows, cfg.pad_token_id)

    outs: List[GenerateOutput] = []
    prev = None
    with merged(model), torch.inference_mode():
        for b in batches:
            rows = dp_rows(mesh, b["input_values"].shape[0])
            wav, amask, prompt = (
                take_rows(None if x is None else torch.as_tensor(x), rows)
                for x in (b["input_values"], b.get("audio_mask"),
                          b.get("prompt_ids")))
            wav = wav.to(device)
            amask = None if amask is None else amask.to(device)
            streams.inputs(wav, amask)
            with annotate("mtasr.pipelined.frontend"), streams.encoder():
                nxt = _frontend(model, cfg, wav, amask)
            if prev is None:
                layers_to_end(nxt)
            else:
                outs.append(decode(prev, nxt))
            streams.join(nxt)
            with annotate("mtasr.pipelined.post_encode"):
                enc = _post_encode(model, cfg, nxt.hidden, amask)
            prefill_ids, splice_index = prompt_layout(
                cfg, wav.shape[0], prompt, device)
            prev = (enc, prefill_ids, splice_index, rows)
        if prev is not None:       # the last batch decodes alone
            outs.append(decode(prev, None))
    return outs
