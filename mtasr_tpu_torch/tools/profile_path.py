"""Where the time of one full-width batch goes on the GPU.

    python -m mtasr_tpu_torch.tools.profile_path [--batch 8] [--steps 32]
        [--quantize w8a8] [--kv_quant] [--family A|B|C] [--trace-dir DIR]
    python -m mtasr_tpu_torch.tools.profile_path --train [--hybrid]
        [--family A|B|C] [--batch 16]

Builds the served model (`full_width.build`; `--quantize` / `--kv_quant`:
the int8 serving leg), prepares one batch of 6-10 s
waveforms through the Transcriber's batcher, and after two warm-up passes
runs encode, prefill and `--steps` decode steps twice: once without the
profiler for the wall time of each phase, then under `torch.profiler` for
the device time. Device busy is the union of the CUDA kernel intervals of
the profiled run, so overlapping kernels count once; idle share = 1 - busy
/ wall. Prints one line per phase with the ten largest kernels by device
time and every kernel of the port's own (`csrc/`), then one JSON line of
the numbers. With `--trace-dir`, writes each phase's
Chrome trace there.

With `--train`: one attention-mode train step instead (`full_width.
build_train`, the reference recipe's trainability, a fixed batch of 10 s
rows, `Trainer`'s step: forward, backward, AdamW), after two warm-up
steps, timed and profiled the same way. `--hybrid`: the hybrid SOT+CTC
step of the flagship recipe (`full_width.build_train(hybrid=True)`: the
separator, two CTC heads, PCGrad's three stages).

`--family` serves (or trains) a configuration of the bridge and adapter
family (`full_width.FAMILY`, on the hybrid model). Serving adds two
profiled runs: the encode with the family's switches off on the same
model (the separator still runs), and the decode steps with the
adapters' layer hook removed (same memory, same cache); the differences of
device busy time are the bridge's ms a batch (refiner, bridge, adapter
memory) and the adapters' ms over the steps, with their shares.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, List, Tuple

import torch

from mtasr_tpu_torch.config import GenerationConfig
from mtasr_tpu_torch.generate import engine
from mtasr_tpu_torch.models.speech_encoder_decoder import adapter_callback
from mtasr_tpu_torch.tools import full_width

MAX_NEW = 150


def busy_ms(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (µs in, ms out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _mode(inference: bool):
    return torch.inference_mode() if inference else contextlib.nullcontext()


def wall_ms(fn: Callable, inference: bool = True):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _mode(inference):
        out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _own_kernels() -> Tuple[str, ...]:
    """Profiler-name prefixes of the port's own kernels: each `__global__`
    of csrc/*.cu, which keeps its kernels in an unnamed namespace."""
    from mtasr_tpu_torch.ops.kernels import _build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*[(<]")
    return tuple(f"void (anonymous namespace)::{name}"
                 for src in sorted(_build.CSRC.glob("*.cu"))
                 for name in pat.findall(src.read_text()))


def profiled(fn: Callable, trace_path=None, inference: bool = True):
    """(result, device busy ms, top kernels [(name, ms, count)]: the ten
    largest by device time and the port's own kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with _mode(inference):
            out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: Dict[str, List[float]] = {}
    for e in events:
        d = by_name.setdefault(e.name[:90], [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    if trace_path:
        prof.export_chrome_trace(trace_path)
    ranked = sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                    key=lambda r: -r[1])
    own = _own_kernels()       # the port's kernels, whatever their rank
    top = [r for i, r in enumerate(ranked)
           if i < 10 or r[0].startswith(own)]
    return out, busy_ms([(e.time_range.start, e.time_range.end)
                         for e in events]), top


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="rows (default 8; 16 with --train)")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize", choices=("w8", "w8a8"), default=None,
                    help="int8 decoder weights")
    ap.add_argument("--kv_quant", action="store_true",
                    help="int8 KV cache")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--train", action="store_true",
                    help="profile one full-width train step")
    ap.add_argument("--hybrid", action="store_true",
                    help="with --train: the hybrid SOT+CTC step with PCGrad")
    ap.add_argument("--family", choices=sorted(full_width.FAMILY),
                    default=None, help="a configuration of the bridge and "
                    "adapter family (full_width.FAMILY)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_path needs a CUDA device")
    if args.train:
        return train_profile(args)
    B = args.batch or 8
    cfg, model, tr = full_width.build(args.seed, "cuda", torch.bfloat16,
                                      quantize=args.quantize,
                                      kv_quant=args.kv_quant,
                                      family=args.family)
    wavs = full_width.waveforms(args.seed, 1, B)[0]
    batch = next(iter(tr._batches(tr._examples(wavs, ""), B)))
    wav = torch.from_numpy(batch.arrays["input_values"]).cuda()
    amask = torch.from_numpy(batch.arrays["audio_mask"]).cuda()
    gen = GenerationConfig(do_sample=False, kv_quant=args.kv_quant)
    ids, splice = engine.prompt_layout(cfg, B, None, wav.device)
    Lp = ids.shape[1]

    hooks = {}

    def encode(c=cfg):
        return engine.encode_maybe_chunked(model, c, wav, amask, None)

    def prefill(enc):
        S_max = Lp + enc.encoder_hidden_states.shape[1] + MAX_NEW
        hooks["cb"] = adapter_callback(model, cfg, enc, keep_kv=True)
        return engine._prefill(model, cfg, enc, ids, splice, S_max,
                               args.kv_quant, hooks["cb"])

    def decode(state, n, hook=True):
        cache, last, n_valid, total = state
        return engine._decode(model, cfg, cache, last, n_valid, Lp, total,
                              torch.bfloat16, gen, n + 1, None,
                              hooks["cb"] if hook else None)

    for _ in range(2):
        with torch.inference_mode():
            decode(prefill(encode()), 8)
    enc, w_enc = wall_ms(encode)
    state, w_pre = wall_ms(lambda: prefill(enc))
    out, w_dec = wall_ms(lambda: decode(state, args.steps))

    def trace(name):
        if not args.trace_dir:
            return None
        os.makedirs(args.trace_dir, exist_ok=True)
        return os.path.join(args.trace_dir, f"trace_{name}_B{B}.json")

    _, b_enc, k_enc = profiled(encode, trace("encode"))
    state2, b_pre, k_pre = profiled(lambda: prefill(enc), trace("prefill"))
    out2, b_dec, k_dec = profiled(lambda: decode(state2, args.steps),
                                  trace(f"decode{args.steps}"))
    if out.steps != args.steps or out2.steps != args.steps:
        raise SystemExit(f"decode ran {out.steps} / {out2.steps} steps, not "
                         f"{args.steps} (an eos ended it early)")
    record = {"batch": B, "decode_steps": args.steps,
              "quantize": args.quantize, "kv_quant": args.kv_quant,
              "family": args.family,
              "device": torch.cuda.get_device_name(0)}
    leg = f" {args.quantize or 'bf16'}{' kv8' if args.kv_quant else ''}"
    for name, wall, busy, top in (("encode", w_enc, b_enc, k_enc),
                                  ("prefill", w_pre, b_pre, k_pre),
                                  ("decode", w_dec, b_dec, k_dec)):
        _report(f"B={B}{leg} {name}", name, wall, busy, top, record)
    if args.family:
        family_parts(args, cfg, encode, prefill, decode, enc, b_enc, b_dec,
                     record)
    print(json.dumps(record), flush=True)


def family_parts(args, cfg, encode, prefill, decode, enc, b_enc, b_dec,
                 record) -> None:
    """The bridge's and the adapters' device ms (module docstring)."""
    off = dataclasses.replace(cfg, talker_ctc_refine=False, ctc_bridge=False,
                              decoder_cross_attention=False)
    _, b_enc0, _ = profiled(lambda: encode(off))
    state, _, _ = profiled(lambda: prefill(enc))
    out, b_dec0, _ = profiled(lambda: decode(state, args.steps, hook=False))
    if out.steps != args.steps:
        raise SystemExit(f"decode without adapters ran {out.steps} steps")
    bridge, adapters = b_enc - b_enc0, b_dec - b_dec0
    record["family"] = {
        "leg": args.family, "bridge_ms": bridge,
        "bridge_share_of_encode": bridge / b_enc,
        "adapters_ms": adapters, "adapters_ms_per_step": adapters / args.steps,
        "adapters_share_of_decode": adapters / b_dec}
    print(f"== family {args.family}: bridge {bridge:.3f} ms a batch "
          f"({bridge / b_enc:.3f} of encode device time), adapters "
          f"{adapters / args.steps:.4f} ms a decode step "
          f"({adapters / b_dec:.3f} of decode device time)", flush=True)


def _report(title, name, wall, busy, top, record):
    print(f"== {title}: wall {wall:.3f} ms (no profiler), device busy "
          f"{busy:.3f} ms (kernel-interval union, profiled run), idle share "
          f"{1 - busy / wall:.3f}", flush=True)
    for kname, ms, n in top:
        print(f"   {ms:9.3f} ms x{n:5d}  {kname}", flush=True)
    record[name] = {"wall_ms": wall, "busy_ms": busy,
                    "idle_share": 1 - busy / wall}


def train_profile(args) -> None:
    from mtasr_tpu_torch.config import DataConfig, TrainingConfig
    from mtasr_tpu_torch.train.loop import Trainer, step_generator
    B = args.batch or 16
    hybrid = args.hybrid or args.family is not None
    cfg, model = full_width.build_train(args.seed, "cuda", torch.bfloat16,
                                        hybrid=hybrid, family=args.family)
    tc = TrainingConfig(learning_rate=1e-4, warmup_steps=2, max_steps=1000,
                        pcgrad=hybrid)
    trainer = Trainer(cfg, tc, DataConfig(), model,
                      freeze_kwargs=dict(freeze_decoder=True))
    batch = full_width.train_batch(cfg, B, 10, args.seed)
    tensors = trainer._tensors(batch)
    step = trainer._train_step(batch.splice_index)
    count = iter(range(10 ** 6))

    def run():
        return step(model, tensors, step_generator(args.seed, next(count),
                                                   "cuda"))
    for _ in range(2):
        run()
    _, wall = wall_ms(run, inference=False)
    trace = (os.path.join(args.trace_dir, f"trace_train_B{B}.json")
             if args.trace_dir else None)
    if trace:
        os.makedirs(args.trace_dir, exist_ok=True)
    _, busy, top = profiled(run, trace, inference=False)
    record = {"batch": B, "train": True, "hybrid": hybrid,
              "family": args.family,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "device": torch.cuda.get_device_name(0)}
    _report(f"B={B} {'hybrid ' if hybrid else ''}"
            f"{'family ' + args.family + ' ' if args.family else ''}train "
            "step",
            "train_step", wall, busy, top, record)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
