"""Batched inference over a Kaldi data directory (counterpart of
`mtasr_tpu/cli/inference_asr.py`): greedy or sampled SOT decoding, beam
search (`--num_beams`, `--length_penalty`), speculative greedy decoding
drafted by the CTC heads (`--speculative ctc`, `--spec_k`), or the
one-shot CTC decode (`--ctc_decoding`); int8 serving through the streamed
load (`--quantize`, `--quantize_scope`, `--kv_quant`), or, with
`--pipelined`, greedy or sampled decoding of each run of consecutive
batches of one shape as one stream (`generate/pipelined.py`: the encode of
a batch under the decode of the one before; the same tokens). Writes
`label.<i>` and `decod.<i>` (utterance id + text) for shard i of
`--num_shards`, and
with one shard, or `--merge` afterwards, the merged `label`, `decod` and
the `wer` report.

    python -m mtasr_tpu_torch.cli.inference_asr --model_name_or_path DIR \\
        --data_dir DATA --output_dir OUT [--device cpu] ...
"""
from __future__ import annotations

import argparse
import itertools
import logging
import os

import torch

from mtasr_tpu_torch.api import load_for_serving, resolve_tokenizer
from mtasr_tpu_torch.cli.args import (
    add_data_args, add_device_arg, add_generation_args, add_model_args,
    setup_distributed,
)
from mtasr_tpu_torch.config import DataConfig, GenerationConfig
from mtasr_tpu_torch.data.audio import load_kaldi_dir
from mtasr_tpu_torch.data.pipeline import (
    batches_from_examples, prepare_examples,
)
from mtasr_tpu_torch.generate.beam import beam_generate
from mtasr_tpu_torch.generate.engine import generate, generate_ctc
from mtasr_tpu_torch.generate.pipelined import generate_pipelined
from mtasr_tpu_torch.parallel import multihost
from mtasr_tpu_torch.parallel.mesh import shard_model
from mtasr_tpu_torch.utils.wer import Calculator, clean_decoded_text

logger = logging.getLogger("mtasr_tpu_torch.inference")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("inference_asr")
    add_model_args(p)
    add_data_args(p)
    add_generation_args(p)
    p.add_argument("--tokenizer_name", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--dp_size", type=int, default=-1)
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--merge", action="store_true",
                   help="merge per-shard decod files and score")
    p.add_argument("--char_mode", action="store_true")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "w8", "w8a8"],
                   help="decoder weight quantization for serving")
    p.add_argument("--kv_quant", action="store_true",
                   help="int8 KV cache")
    p.add_argument("--encode_chunk", type=int, default=None,
                   help="encode the batch in chunks of this many rows")
    p.add_argument("--speculative", type=str, default=None, choices=["ctc"])
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--pipelined", action="store_true")
    p.add_argument("--quantize_scope", type=str, default="decoder",
                   choices=["decoder", "all"])
    add_device_arg(p)
    return p


def merge_and_score(args) -> str:
    """Merge the shards' `label.<i>` / `decod.<i>` into `label` / `decod`
    (sorted by utterance id) and write the `wer` report; returns it."""
    labels, decods = {}, {}
    for i in range(args.num_shards):
        for name, store in (("label", labels), ("decod", decods)):
            path = os.path.join(args.output_dir, f"{name}.{i}")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for line in f:
                    parts = line.rstrip("\n").split(None, 1)
                    store[parts[0]] = parts[1] if len(parts) > 1 else ""
    for name, store in (("label", labels), ("decod", decods)):
        with open(os.path.join(args.output_dir, name), "w") as f:
            for k in sorted(store):
                f.write(f"{k} {store[k]}\n")
    calc = Calculator(char_mode=args.char_mode)
    for k in sorted(labels):
        calc.calculate(k, labels[k], decods.get(k, ""))
    report = calc.summary()
    with open(os.path.join(args.output_dir, "wer"), "w") as f:
        f.write(report + "\n")
    return report


def check_flags(args) -> None:
    """The JAX CLI's refusal of incompatible decode flags, before any
    load."""
    if args.pipelined and (args.ctc_decoding or args.num_beams > 1
                           or args.speculative):
        raise SystemExit("--pipelined applies to plain (greedy/sampled) "
                         "decoding only")
    if args.num_beams > 1 and args.speculative:
        raise SystemExit("--speculative drafts plain greedy decoding; it "
                         "does not compose with --num_beams > 1")
    if args.num_beams > 1 and args.do_sample:
        raise SystemExit("beam search here is deterministic (HF "
                         "do_sample=False semantics); drop --do_sample or "
                         "--num_beams")


_FEED = ("input_values", "audio_mask", "prompt_ids")


def pipelined_runs(model, cfg, batches, gen, generator):
    """(utterance ids, sequences) for every batch: each run of consecutive
    batches whose decode inputs have one shape is one `generate_pipelined`
    stream (a change of shape ends the run, as in the JAX CLI). A run is
    read lazily, batch by batch, so the stream holds two batches' audio at
    a time, not the run's."""
    def shapes(b):
        return tuple((k, b.arrays[k].shape) for k in _FEED if k in b.arrays)
    for _, run in itertools.groupby(batches, key=shapes):
        ids = []

        def feeds(run=run, ids=ids):
            for b in run:
                ids.append(b.utt_ids)
                yield {k: torch.from_numpy(b.arrays[k]) for k in _FEED
                       if k in b.arrays}
        outs = generate_pipelined(model, cfg, feeds(), gen=gen,
                                  generator=generator)
        for utt_ids, out in zip(ids, outs):
            yield utt_ids, out.sequences


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    check_flags(args)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.merge:
        print(merge_and_score(args))
        return

    device, mesh = setup_distributed(args)
    cfg, model = load_for_serving(args.model_name_or_path, args.quantize,
                                  args.quantize_scope, device=device)
    if args.instruct:
        cfg.instruct = True
    shard_model(model, cfg, mesh)
    writer = multihost.process_index() == 0
    tokenizer = resolve_tokenizer(args.model_name_or_path,
                                  args.tokenizer_name, cfg)

    dc = DataConfig(max_duration_in_seconds=args.max_duration_in_seconds,
                    min_duration_in_seconds=args.min_duration_in_seconds,
                    do_lower_case=args.do_lower_case)
    utts = load_kaldi_dir(args.data_dir, prompt=args.prompt)
    if args.max_eval_samples:
        utts = utts[:args.max_eval_samples]
    examples = prepare_examples(
        utts, tokenizer, dc, cfg.instruct, lazy=not args.eager_audio,
        num_proc=args.preprocessing_num_workers)
    refs = {u.utt_id: (u.text.lower() if dc.do_lower_case else u.text)
            for u in utts}
    gen = GenerationConfig(max_length=args.max_length,
                           do_sample=args.do_sample,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, kv_quant=args.kv_quant,
                           encode_chunk=args.encode_chunk,
                           speculative=args.speculative, spec_k=args.spec_k)
    sampler = None
    if args.do_sample:
        sampler = torch.Generator(device=device)
        sampler.manual_seed(0)

    n_done = 0
    out_dir = args.output_dir if writer else os.devnull
    label_path = os.path.join(out_dir, f"label.{args.shard_index}")
    decod_path = os.path.join(out_dir, f"decod.{args.shard_index}")
    if not writer:
        label_path = decod_path = os.devnull

    def decode(batch):
        wav = torch.from_numpy(batch.arrays["input_values"]).to(device)
        amask = torch.from_numpy(batch.arrays["audio_mask"]).to(device)
        pr = batch.arrays.get("prompt_ids")
        pr = None if pr is None else torch.from_numpy(pr)
        if args.ctc_decoding:
            return generate_ctc(model, cfg, wav, amask,
                                max_out_len=args.max_length)[0]
        if args.num_beams > 1:
            return beam_generate(
                model, cfg, wav, amask, prompt_ids=pr,
                num_beams=args.num_beams, max_new_tokens=args.max_length,
                length_penalty=args.length_penalty, kv_quant=args.kv_quant,
                encode_chunk=args.encode_chunk).sequences[:, 0]
        return generate(model, cfg, wav, amask, prompt_ids=pr, gen=gen,
                        generator=sampler).sequences

    batches = batches_from_examples(
        examples, cfg, dc, args.batch_size, training=False, shuffle=False,
        drop_last=False, shard_index=args.shard_index,
        num_shards=args.num_shards)
    decoded = (pipelined_runs(model, cfg, batches, gen, sampler)
               if args.pipelined
               else ((b.utt_ids, decode(b)) for b in batches))
    with open(label_path, "w") as label_f, open(decod_path, "w") as decod_f:
        for utt_ids, seqs in decoded:
            seqs = seqs.cpu().numpy()
            for i, utt_id in enumerate(utt_ids):
                # <sc> is kept as a token in both streams
                hyp = clean_decoded_text(
                    tokenizer.decode(seqs[i], skip_special_tokens=False))
                label_f.write(f"{utt_id} {clean_decoded_text(refs[utt_id])}\n")
                decod_f.write(f"{utt_id} {hyp}\n")
            n_done += len(utt_ids)
            logger.info("decoded %d utts", n_done)

    if args.num_shards == 1 and writer:
        print(merge_and_score(args))
    multihost.barrier("decoded")


if __name__ == "__main__":
    main()
