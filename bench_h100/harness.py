"""One run of one cell:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (`setup_s`, from the process's start to the first timed call):
import the port, build or load its CUDA libraries (all at once, into
`mtasr_tpu_torch/csrc/build/` inside the checkout), make the cell's
weights on the device from the seed and load them through the port's
load path (`utils/convert.py::load_flat`), make the traffic, and warm up
with one call of the cell's own batch and lengths (the mix's `warmup`
arguments overriding its `call` ones: an SOT call decodes 2 new tokens,
which runs every kernel and GEMM shape of the full call). The window
then drives the cell's entry (`ENTRIES`) call after call and closes at
the end of the first call that ends after `--seconds`; a rate (`RATES`,
by the metric's unit) is all the audio or recordings of the window's
calls over its whole wall time. With `--trace 1` the same run puts the
benchmark's ranges around the program's functions (`spans.py`) and
profiles the window's first calls (at least `TRACED_S` of them) with
`torch.profiler`; the per-layer metrics are read from those records.

Once the window has closed, the peak device memory is read, the
program's state is freed, and the judge (`judge.py`) holds a sample of
the window's served outputs against the plain reference: `correct`.

The last line on standard output is the result, one JSON object; the
numbers compared, each with its limit, are the last lines on standard
error and the last key of the result. Test-only switches: `--cpu-tiny`
runs a tiny geometry on the CPU (device tagged "cpu", no device metric);
`--readings N` reads the judged number of the program and of its
lower-precision control on N seeds in one process, one call a seed
(how the limits were set).

What a configuration file chooses besides its sizes: its decoder family
(`"family"`, `cells.FAMILY` without it), which names the reference the
judge holds the served tokens against (`bench_h100.reference.<family>`)
and the count behind `mfu.sot` (`bench_h100.counts.<family>`); and the
family's own tiny cut (`"tiny": {"decoder": {...}}`, applied after
`TINY_DECODER`)."""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from typing import List

from bench_h100 import cells, traffic
from bench_h100.cells import Cell

TRACED_S = 2.0           # the traced span covers at least this long
FORBIDDEN = ("jax", "jaxlib", "flax", "mtasr_tpu")
# a mix's `entry`: the `api.Transcriber` method a call goes through, with
# the mix's `call` arguments (`warmup` overriding them in the warm-up call)
# and the batch size; its `generation` arguments go to the Transcriber's
# `GenerationConfig`
ENTRIES = {"transcribe": "transcribe", "transcribe_ctc": "transcribe_ctc"}
# an end-to-end rate, by its unit: the window's sum of that quantity over
# the window's wall seconds
RATES = {"audio_s/s": "audio_s", "samples/s": "recordings"}
# the test-only tiny geometry (`--cpu-tiny`): widths and depths cut, the
# traffic cut to a few short recordings
TINY_ENCODER = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64, conv_dim=[32] * 7,
                    num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4, num_buckets=32,
                    max_bucket_distance=64)
TINY_DECODER = dict(hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, head_dim=16)
TINY_MIX = dict(batch=3, lengths_s=[0.5, 0.9], distinct_calls=2,
                judge_rows=3)
TINY_CALL = dict(max_new_tokens=6)


class Phases:
    """Set-up's phases on standard error: where `setup_s` goes."""

    def __init__(self, t_start: float):
        self.last, self.start, self.parts = t_start, t_start, []

    def __call__(self, name: str):
        now = time.perf_counter()
        self.parts.append((name, now - self.last))
        self.last = now

    def report(self):
        print("setup: " + ", ".join(f"{n} {s:.3f} s" for n, s in self.parts),
              file=sys.stderr)


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-tiny", action="store_true",
                    help="test only: a tiny geometry on the CPU")
    ap.add_argument("--readings", type=int, default=0,
                    help="test only: judged readings of the program and "
                    "its control on this many seeds from --seed")
    return ap.parse_args(argv)


def geometry(cell: Cell, tiny: bool):
    """(encoder, decoder, composite, mix) dicts, cut to the tiny test
    geometry with `tiny` (the configuration's own `tiny` decoder keys
    last)."""
    conf = cell.config
    enc, dec = dict(conf["encoder"]), dict(conf["decoder"])
    comp, mix = dict(conf["composite"]), dict(cell.mix)
    if tiny:
        enc.update(TINY_ENCODER)
        heads = 4
        ratio = dec["num_attention_heads"] // dec["num_key_value_heads"]
        dec.update(TINY_DECODER, num_attention_heads=heads,
                   num_key_value_heads=max(1, heads // ratio))
        dec.update(conf.get("tiny", {}).get("decoder", {}))
        comp["separator_hidden"] = 32
        mix.update(TINY_MIX)
        mix["call"] = {k: TINY_CALL.get(k, v)
                       for k, v in mix.get("call", {}).items()}
    return enc, dec, comp, mix


def port_config(enc: dict, dec: dict, comp: dict):
    """The port's config of the cell's model, and its tokenizer's ids."""
    from mtasr_tpu_torch.config import (
        LlamaConfig, SpeechEncoderDecoderConfig, WavLMConfig,
    )
    from mtasr_tpu_torch.data.tokenizer import CharTokenizer
    tok = CharTokenizer()
    sp = tok.add_special_tokens(instruct=False)
    e = {k: tuple(v) if isinstance(v, list) else v for k, v in enc.items()}
    cfg = SpeechEncoderDecoderConfig(
        encoder=WavLMConfig(**e),
        decoder=LlamaConfig(**dec, bos_token_id=sp.bos_token_id,
                            eos_token_id=sp.eos_token_id),
        pad_token_id=sp.pad_token_id, sc_token_id=sp.sc_token_id,
        bos_token_id=sp.bos_token_id, eos_token_id=sp.eos_token_id,
        decoder_start_token_id=sp.bos_token_id, **comp)
    ids = {"bos": sp.bos_token_id, "eos": sp.eos_token_id,
           "pad": sp.pad_token_id, "blank": cfg.ctc_blank_id}
    return cfg, tok, ids


def build(cfg, precision: str, seed: int, device, dtype=None):
    """(weights, model): the weights made from the seed, loaded into the
    program's model through its load path."""
    import torch
    from mtasr_tpu_torch.models.speech_encoder_decoder import (
        SpeechEncoderDecoderModel,
    )
    from mtasr_tpu_torch.utils.convert import load_flat
    from bench_h100 import weights
    with torch.device("meta"):
        shapes = [(n, tuple(p.shape)) for n, p in
                  SpeechEncoderDecoderModel(cfg).named_parameters()]
        model = SpeechEncoderDecoderModel(cfg)
    flat = weights.make(shapes, precision, seed, device,
                        dtype or torch.bfloat16)
    load_flat(model, flat)
    return flat, model.eval()


def transcriber(cfg, model, tok, kv_int8: bool, mix: dict):
    from mtasr_tpu_torch.api import Transcriber
    from mtasr_tpu_torch.config import GenerationConfig
    gen = dict(do_sample=False, kv_quant=kv_int8)
    gen.update(mix.get("generation", {}))
    return Transcriber(cfg, model, tok, gen=GenerationConfig(**gen))


def entry(mix: dict, tr, warm: bool = False):
    """The cell's call: one call of recordings through the Transcriber's
    method that the mix names, with the mix's arguments."""
    if mix["entry"] not in ENTRIES:
        raise SystemExit(f"unknown entry {mix['entry']!r}")
    method = getattr(tr, ENTRIES[mix["entry"]])
    kw = dict(mix.get("call", {}), batch_size=mix["batch"])
    if warm:
        kw.update(mix.get("warmup", {}))
    return lambda call: method(call.wavs, **kw)


def card(torch, tiny: bool) -> dict:
    if tiny:
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 and smi.stdout.strip() else "unknown"}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def served_rows(calls: List[List[dict]], eos: int, talkers: int):
    """Per window call, on the host: row index -> (served row, padded
    samples of its batch, its audio mask's length, its CTC length cap).
    A served row is an SOT token array, or one CTC transcript a talker."""
    from bench_h100.judge import served_tokens
    out = []
    for batches in calls:
        rows = {}
        for b in batches:
            lengths = b["lengths"].cpu().numpy()
            if "tokens" in b:
                toks = b["tokens"].cpu().numpy()
                served = [served_tokens(t, eos) for t in toks]
                cap = 0
            else:
                trans = b["ctc"].cpu().numpy()
                lens = b["ctc_lens"].cpu().numpy()
                cap = trans.shape[1] // talkers
                served = [[trans[i, k * cap:k * cap + lens[k, i]]
                           for k in range(talkers)]
                          for i in range(len(trans))]
            for i, r in enumerate(b["rows"]):
                rows[r] = (served[i], b["padded"], int(lengths[i]), cap)
        out.append(rows)
    return out


def batches_of(calls: List[List[dict]]) -> List[dict]:
    """The recorded batches' sizes, for the per-layer arithmetic."""
    return [{"lengths": [int(n) for n in b["lengths"].cpu()],
             "padded": b["padded"], "steps": int(b["steps"])}
            for batches in calls for b in batches]


def picked(mix, pool, served, seed):
    """The judged sample, drawn from the seed: (wav, served row, padded
    samples, CTC length cap) each, or None where a recording of a call
    went unanswered or a row's mask length is not its recording's
    (served out of place)."""
    from bench_h100 import judge as J
    P = len(pool)
    if any(sorted(rows) != list(range(len(pool[c % P].wavs)))
           for c, rows in enumerate(served)):
        return None
    lengths = {(c, r): len(pool[c % P].wavs[r])
               for c, rows in enumerate(served) for r in rows}
    picks = J.pick_rows(list(lengths), mix["judge_rows"], seed, lengths)
    if any(served[c][r][2] != lengths[(c, r)] for c, r in picks):
        return None
    return [(pool[c % P].wavs[r], *served[c][r][:2], served[c][r][3])
            for c, r in picks]


def judge(cell: Cell, w, enc, dec, comp, ids, sample, device,
          control_bits=None, control_logits=None) -> dict:
    """The judged numbers of a sample (`picked`) against the reference
    (the decoder's: the configuration's family's), batch by padded length;
    every compared number INF where there is no sample."""
    from bench_h100 import judge as J
    if not sample:
        return {"program": {**{k: J.INF for k in cell.limits["compared"]},
                            "tokens": 0}}
    decoder = importlib.import_module(
        f"bench_h100.reference.{cells.family(cell.config)}")
    groups = {}
    for i, (_, _, padded, _) in enumerate(sample):
        groups.setdefault(padded, []).append(i)
    parts = []
    for padded, idx in sorted(groups.items()):
        wavs = [sample[i][0] for i in idx]
        rows = [sample[i][1] for i in idx]
        if sample[idx[0]][3] == 0:
            ctrl = None if control_logits is None else \
                [control_logits[i] for i in idx]
            parts.append(J.sot_readings(w, enc, dec, ids, wavs, rows, padded,
                                        device, decoder, control_bits, ctrl))
        else:
            parts.append(J.ctc_readings(w, enc, comp["talker_numbers"], ids,
                                        wavs, rows, padded, sample[idx[0]][3],
                                        device, control_bits))
    return {k: J.merge([p[k] for p in parts]) for k in parts[0]}


def traced_records(prof, window_s, bounds_ns, spans, traced_calls, enc,
                   dec, comp, mix, precision, family):
    from bench_h100 import devtrace
    rec = devtrace.collect(prof, window_s, spans.intervals, bounds_ns)
    batches = batches_of(traced_calls)
    rec.counts = {"calls": len(traced_calls),
                  "steps": float(sum(b["steps"] for b in batches))}
    rec.geometry = {"encoder": enc, "decoder": dec, "composite": comp,
                    "mix": mix, "precision": precision, "family": family,
                    "batches": batches}
    return rec


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = cells.load_cell(args.workload)
    import torch
    tiny = args.cpu_tiny
    if not tiny and (not torch.cuda.is_available()
                     or torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cpu" if tiny else "cuda")
    # the tiny CPU geometry computes in float32, where the program and the
    # reference agree to rounding: its tests see the judge part sound runs
    # from broken ones, not bf16 rounding at widths of 32
    dtype = torch.float32 if tiny else torch.bfloat16
    phases = Phases(t_start)
    from concurrent.futures import ThreadPoolExecutor
    pool_exec = ThreadPoolExecutor(1)
    built = None
    if not tiny:
        from mtasr_tpu_torch.ops import kernels
        built = pool_exec.submit(kernels.build_all)
    pool_exec.shutdown(wait=False)      # the build runs on; no more work
    enc, dec, comp, mix = geometry(cell, tiny)
    conf = cell.config
    precision, kv_int8 = conf["precision"], conf["kv_cache"] == "int8"
    cfg, tok, ids = port_config(enc, dec, comp)
    if args.readings:
        return readings(args, cell, cfg, tok, ids, enc, dec, comp, mix,
                        precision, kv_int8, device, built, dtype)
    phases("import")
    w, model = build(cfg, precision, args.seed, device, dtype)
    phases("weights")
    pool = traffic.serve_calls(mix, args.seed, device)
    phases("traffic")
    if built is not None:
        built.result()
        phases("kernel libraries")
    from bench_h100.spans import Recorder, Spans
    rec = Recorder().install()
    spans = Spans().install() if args.trace else None
    tr = transcriber(cfg, model, tok, kv_int8, mix)
    call_fn = entry(mix, tr)
    entry(mix, tr, warm=True)(pool[0])                 # warm-up
    rec.end_call()
    rec.take()
    phases("warm-up call")
    if spans is not None:
        spans.clear()
    if not tiny:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    phases.report()
    window = {"audio_s": 0.0, "recordings": 0}
    n, prof, traced, walls = 0, None, None, []
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU if tiny
                                   else ProfilerActivity.CUDA])
        prof.__enter__()
        tp0, tp0_ns = time.perf_counter(), time.time_ns()
    last = t0
    while True:
        call = pool[n % len(pool)]
        call_fn(call)
        rec.end_call()
        n += 1
        window["audio_s"] += call.audio_s
        window["recordings"] += len(call.wavs)
        now = time.perf_counter()
        walls.append(now - last)
        last = now
        if prof is not None and traced is None and now - tp0 >= TRACED_S:
            if not tiny:
                torch.cuda.synchronize()
            traced = (n, time.perf_counter() - tp0, (tp0_ns, time.time_ns()))
            prof.__exit__(None, None, None)
            spans.undo()                   # the rest of the window bare
            last = time.perf_counter()     # the profiler's read-out apart
        if now - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    print("calls: " + " ".join(f"{x:.3f}" for x in walls), file=sys.stderr)
    if prof is not None and traced is None:
        if not tiny:
            torch.cuda.synchronize()
        traced = (n, time.perf_counter() - tp0, (tp0_ns, time.time_ns()))
        prof.__exit__(None, None, None)
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX package loaded: {found}", file=sys.stderr)
        return 4
    peak = int(torch.cuda.max_memory_allocated()) if not tiny else 0
    calls = rec.take()
    served = served_rows(calls, ids["eos"], comp.get("talker_numbers", 2))
    rec.undo()
    metrics = {}
    breakdown = None
    dev = card(torch, tiny)
    if args.trace:
        from bench_h100 import devtrace
        records = traced_records(prof, traced[1], traced[2], spans,
                                 calls[:traced[0]], enc, dec, comp, mix,
                                 precision, cells.family(conf))
        spans.undo()
        if not tiny:
            for name, read in cells.readers(cell).items():
                m = next(x for x in cell.per_layer if x["name"] == name)
                value = read(records)
                if value is not None:
                    metrics[name] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = records.busy_s()
            dev["window_s"] = records.window_s
            breakdown = devtrace.breakdown(records)
        del records, prof
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else \
                window[RATES[m["unit"]]] / window_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev["memory_peak_bytes"] = peak
    del tr, model, call_fn, calls
    gc.collect()
    if not tiny:
        torch.cuda.empty_cache()
    read = judge(cell, w, enc, dec, comp, ids,
                 picked(mix, pool, served, args.seed), device)
    checks = {name: {"value": read["program"][name], "limit": limit}
              for name, limit in cell.limits["compared"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    print(f"judged: {json.dumps(read['program'])}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    result = {"correct": correct, "attempted": window["recordings"],
              "failed": 0, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


def readings(args, cell, cfg, tok, ids, enc, dec, comp, mix, precision,
             kv_int8, device, built, dtype) -> int:
    """For each of `args.readings` seeds: one call served and judged, with
    the control's numbers on the same sample (the program's own
    lower-precision path, where the cell's limits file names one:
    teacher-forced for SOT (`control.py`), served again for CTC; else the
    reference in the lower precision), one JSON line each. The program's
    path is the LLaMA family's alone; another family's limits file names
    `reference_bits`."""
    import torch
    from bench_h100.spans import Recorder
    control = cell.limits["control"]
    bits = control.get("reference_bits")
    family = cells.family(cell.config)
    if not bits and family != cells.FAMILY:
        raise SystemExit(
            f"limits/{cell.name}.json: control.program is the LLaMA "
            f"family's own w8a8 path (control.py, weights.INT8); the "
            f"decoder family {family!r} takes control.reference_bits, its "
            f"reference in the precision below, which every family's "
            f"reference computes")
    talkers = comp.get("talker_numbers", 2)
    rec = Recorder().install()
    if built is not None:
        built.result()

    def serve(tr, call):
        entry(mix, tr)(call)
        rec.end_call()
        return served_rows(rec.take(), ids["eos"], talkers)

    for s in range(args.seed, args.seed + args.readings):
        w, model = build(cfg, precision, s, device, dtype)
        pool = traffic.serve_calls(mix, s, device)
        tr = transcriber(cfg, model, tok, kv_int8, mix)
        sample = picked(mix, pool, serve(tr, pool[0]), s)
        forced, ctrl = None, None
        if not bits:
            from mtasr_tpu_torch.utils.quantize import quantize_for_serving
            quantize_for_serving(model, control["program"],
                                 control.get("scope", "decoder"))
            if sample and sample[0][3] == 0:
                from bench_h100.control import forced_logits
                forced = forced_logits(tr, [x[0] for x in sample],
                                       [x[1] for x in sample], kv_int8=True)
            else:
                ctrl = judge(cell, w, enc, dec, comp, ids,
                             picked(mix, pool, serve(tr, pool[0]), s),
                             device)
        read = judge(cell, w, enc, dec, comp, ids, sample, device, bits,
                     forced)
        if ctrl is not None:
            read["control"] = ctrl["program"]
        print(json.dumps({"seed": s, **read}), flush=True)
        del w, model, tr, pool
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    rec.undo()
    return 0
