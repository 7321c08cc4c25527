"""What the benchmark puts around the program's functions, by wrapping
them in their modules (the program is not edited).

`Recorder` (every run) keeps what the timed path served, batch by batch:
for each batch that `api.Transcriber` hands the engine, its rows' places
in the call (`Transcriber._batches`' utterance ids), its padded length
in samples, the audio mask's row lengths, and what the engine returned
for it: the token ids of `generate` (or of `beam_generate`'s best beam)
with the steps the decode loop ran, or the collapsed CTC transcripts of
`generate_ctc`. `end_call` closes a call's batches, so that the judge
reads the program's own output, row by row.

`Spans` (the traced run only) keeps host intervals, on the wall clock
that the profiler's events use, named `bench.<what>`: the host batching
(`pipeline.collate`), the encoder (`encode_feats`), the decode loop
(`engine._decode`) and the int8 linears inside it (`layers.linear` on a
`QuantLinear`). The encoder's and the decode loop's end in a
synchronize, so their wall is the device's too. A kernel belongs to a
span when the host launched it inside one of the span's intervals; the
profiler records no host operator (its CUDA activity alone), which keeps
its cost on the host small."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class _Patches:
    def __init__(self):
        self._saved = []

    def set(self, mod, name, value):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def undo(self):
        for mod, name, value in reversed(self._saved):
            setattr(mod, name, value)
        self._saved.clear()


class Recorder(_Patches):
    def __init__(self):
        super().__init__()
        self.calls: List[List[dict]] = []
        self._batches: List[dict] = []
        self._rows: List[int] = []

    def _keep(self, wav, amask, **out):
        self._batches.append({"rows": list(self._rows),
                              "padded": int(wav.shape[1]),
                              "lengths": amask.sum(1), **out})

    def install(self):
        from mtasr_tpu_torch import api
        gen, beam = api.generate, api.beam_generate
        gen_ctc, batches = api.generate_ctc, api.Transcriber._batches
        rec = self

        def _batches(tr, *a, **kw):
            for b in batches(tr, *a, **kw):
                rec._rows = [int(u[1:]) for u in b.utt_ids]    # "@<i>"
                yield b

        def generate(model, cfg, wav, amask, **kw):
            out = gen(model, cfg, wav, amask, **kw)
            rec._keep(wav, amask, tokens=out.sequences, steps=out.steps)
            return out

        def beam_generate(model, cfg, wav, amask, **kw):
            out = beam(model, cfg, wav, amask, **kw)
            rec._keep(wav, amask, tokens=out.sequences[:, 0], steps=0)
            return out

        def generate_ctc(model, cfg, wav, amask, **kw):
            trans, lens = gen_ctc(model, cfg, wav, amask, **kw)
            rec._keep(wav, amask, ctc=trans, ctc_lens=lens, steps=0)
            return trans, lens
        self.set(api.Transcriber, "_batches", _batches)
        self.set(api, "generate", generate)
        self.set(api, "beam_generate", beam_generate)
        self.set(api, "generate_ctc", generate_ctc)
        return self

    def end_call(self):
        """The batches recorded since the last `end_call` make a call."""
        self.calls.append(self._batches)
        self._batches = []

    def take(self) -> List[List[dict]]:
        out, self.calls = self.calls, []
        return out


class Spans(_Patches):
    def __init__(self):
        super().__init__()
        # label -> [(start, end)] in ns of the host's wall clock (the
        # profiler's clock), in order
        self.intervals: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.sync = torch.cuda.is_available()
        self._in_decode = False

    def clear(self):
        self.intervals.clear()

    def _wrap(self, mod, name, label, sync=False):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            t0 = time.time_ns()
            out = fn(*a, **kw)
            if sync and self.sync:
                torch.cuda.synchronize()
            self.intervals[label].append((t0, time.time_ns()))
            return out
        self.set(mod, name, wrapped)

    def install(self):
        from mtasr_tpu_torch.data import pipeline
        from mtasr_tpu_torch.generate import engine
        from mtasr_tpu_torch.models import layers, llama
        from mtasr_tpu_torch.models import speech_encoder_decoder as sed
        self._wrap(pipeline, "collate", "bench.collate")
        self._wrap(sed, "encode_feats", "bench.encode_feats", sync=True)
        decode = engine._decode

        def decode_wrapped(*a, **kw):
            self._in_decode = True
            t0 = time.time_ns()
            try:
                out = decode(*a, **kw)
                if self.sync:
                    torch.cuda.synchronize()
            finally:
                self._in_decode = False
            self.intervals["bench.decode"].append((t0, time.time_ns()))
            return out
        self.set(engine, "_decode", decode_wrapped)
        for mod in (layers, llama):
            self._wrap_linear(mod, layers.QuantLinear)
        return self

    def _wrap_linear(self, mod, quant_cls):
        lin = mod.linear

        def linear(m, x):
            if not (self._in_decode and isinstance(m, quant_cls)):
                return lin(m, x)
            t0 = time.time_ns()
            out = lin(m, x)
            self.intervals["bench.int8_linear.decode"].append(
                (t0, time.time_ns()))
            return out
        self.set(mod, "linear", linear)
