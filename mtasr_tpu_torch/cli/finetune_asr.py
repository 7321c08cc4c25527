"""Fine-tune a model directory on a Kaldi data directory (counterpart of
`mtasr_tpu/cli/finetune_asr.py`): resume-or-raise, load, the flag
overrides onto the config, an optional separator / CTC-head graft
(`--pretrain_separator_path`), freeze and an optional decoder LoRA, the
Kaldi splits, `Trainer` with checkpoints and resume, then the final model
(the LoRA merged; the unmerged one in `model_unmerge/`) in `final/`.

    python -m mtasr_tpu_torch.cli.finetune_asr --model_name_or_path DIR \\
        --data_dir DATA --output_dir EXP [--device cpu] ...
    python -m mtasr_tpu_torch.cli.finetune_asr flags.json
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch

from mtasr_tpu_torch.api import resolve_tokenizer
from mtasr_tpu_torch.cli.args import (
    add_data_args, add_device_arg, add_generation_args, add_model_args,
    add_training_args, csv, setup_distributed,
)
from mtasr_tpu_torch.config import (
    DataConfig, GenerationConfig, TrainingConfig,
)
from mtasr_tpu_torch.data.audio import build_file_paths, load_kaldi_dir
from mtasr_tpu_torch.data.pipeline import (
    batches_from_examples, prepare_examples,
)
from mtasr_tpu_torch.data.tokenizer import CharTokenizer
from mtasr_tpu_torch.parallel import multihost
from mtasr_tpu_torch.parallel.mesh import gather_state_dict
from mtasr_tpu_torch.train.checkpoint import load_partial, resume_or_raise
from mtasr_tpu_torch.train.lora import init_decoder_lora, merge_decoder_lora
from mtasr_tpu_torch.train.loop import Trainer
from mtasr_tpu_torch.utils import model_io

logger = logging.getLogger("mtasr_tpu_torch.finetune")

# flags written onto the loaded config (the reference's config surgery)
CONFIG_FLAGS = ("talker_ctc", "talker_ctc_refine", "talker_numbers",
                "separator_hidden", "ctc_bridge", "ctc_bridge_type",
                "train_mode", "ctc_alpha", "decoder_cross_attention",
                "decoder_cross_attention_type",
                "decoder_cross_attention_feature", "r_max", "lora_alpha",
                "instruct")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("finetune_asr")
    add_model_args(p)
    add_data_args(p)
    add_training_args(p)
    add_generation_args(p)
    p.add_argument("--tokenizer_name", type=str, default=None)
    add_device_arg(p)
    return p


def json_argv(argv):
    """One `.json` file of flag values as an argument list (a true bool is
    its bare flag, a false one is left out)."""
    if len(argv) == 1 and argv[0].endswith(".json"):
        with open(argv[0]) as f:
            flags = json.load(f)
        argv = []
        for k, v in flags.items():
            if isinstance(v, bool):
                argv += [f"--{k}"] if v else []
            else:
                argv += [f"--{k}", str(v)]
    return argv


def data_splits(args) -> dict:
    """The train / validation / test directories: LibriMix layout under
    `--data_dir` for `--dataset_name`; one flat Kaldi directory for all
    three; else its train / dev / test subdirectories."""
    if args.dataset_name is not None:
        return build_file_paths(args.data_dir or ".", args.dataset_name)
    if os.path.exists(os.path.join(args.data_dir, "wav.scp")):
        return dict.fromkeys(("train", "validation", "test"), args.data_dir)
    return {"train": os.path.join(args.data_dir, "train"),
            "validation": os.path.join(args.data_dir, "dev"),
            "test": os.path.join(args.data_dir, "test")}


def main(argv=None):
    argv = json_argv(argv if argv is not None else sys.argv[1:])
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device, mesh = setup_distributed(args)

    resume_or_raise(args.output_dir, overwrite=args.overwrite_output_dir)

    cfg, model = model_io.load_model(args.model_name_or_path, device,
                                     model_io.serving_dtype(device),
                                     training=True)
    for name in CONFIG_FLAGS:
        if getattr(args, name, None) is not None:
            setattr(cfg, name, getattr(args, name))
    cfg.encoder.attention_impl = args.attention_impl
    if args.gradient_checkpointing:
        cfg.encoder.remat = cfg.decoder.remat = True

    if args.pretrain_separator_path:
        donor = model_io.read_flat(args.pretrain_separator_path)
        flat = load_partial(model.state_dict(), donor,
                            ("separator", "serialized_ctc"))
        model.load_state_dict(flat, strict=True)

    if args.use_lora:
        g = torch.Generator(device=device)
        g.manual_seed(0)
        init_decoder_lora(model, g, r=16, alpha=32.0)
        cfg.lora_dropout = args.lora_dropout

    tokenizer = resolve_tokenizer(args.model_name_or_path,
                                  args.tokenizer_name, cfg)
    dc = DataConfig(max_duration_in_seconds=args.max_duration_in_seconds,
                    min_duration_in_seconds=args.min_duration_in_seconds,
                    do_lower_case=args.do_lower_case)
    tc = TrainingConfig(
        output_dir=args.output_dir, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, max_steps=args.max_steps,
        num_train_epochs=args.num_train_epochs,
        per_device_train_batch_size=args.per_device_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_grad_norm=args.max_grad_norm, logging_steps=args.logging_steps,
        eval_steps=args.eval_steps, save_steps=args.save_steps,
        save_total_limit=args.save_total_limit, seed=args.seed,
        bf16=args.bf16, pcgrad=args.pcgrad, dp_size=mesh.dp,
        tp_size=mesh.tp)

    splits = data_splits(args)
    train_utts = load_kaldi_dir(splits["train"], prompt=args.prompt)
    eval_utts = load_kaldi_dir(splits["validation"], prompt=args.prompt)
    if args.max_train_samples:
        train_utts = train_utts[:args.max_train_samples]
    if args.max_eval_samples:
        eval_utts = eval_utts[:args.max_eval_samples]
    lazy = not args.eager_audio
    train_ex = prepare_examples(
        train_utts, tokenizer, dc, cfg.instruct, lazy=lazy,
        num_proc=args.preprocessing_num_workers,
        cache_path=args.preprocessing_cache)
    eval_ex = prepare_examples(
        eval_utts, tokenizer, dc, cfg.instruct, lazy=lazy,
        num_proc=args.preprocessing_num_workers)
    logger.info("examples: train=%d eval=%d (lazy=%s)", len(train_ex),
                len(eval_ex), lazy)

    freeze_kwargs = dict(
        freeze_feature_encoder=args.freeze_feature_encoder,
        freeze_encoder=args.freeze_encoder,
        freeze_decoder=args.freeze_decoder,
        partial_encoder_unfreeze=csv(args.partial_encoder_unfreeze),
        partial_decoder_unfreeze=csv(args.partial_decoder_unfreeze),
        partial_others_unfreeze=csv(args.partial_others_unfreeze))
    # the global batch (`finetune_asr.py:160` of the JAX CLI); every rank
    # assembles it and keeps its rows
    batch = tc.per_device_train_batch_size * mesh.dp
    steps_per_epoch = max(1, -(-len(train_ex) // batch))
    total_steps = (tc.max_steps if tc.max_steps > 0
                   else int(steps_per_epoch * tc.num_train_epochs))
    trainer = Trainer(cfg, tc, dc, model, tokenizer=tokenizer,
                      freeze_kwargs=freeze_kwargs,
                      gen_cfg=GenerationConfig(max_length=args.max_length),
                      total_steps=total_steps,
                      mesh=mesh)
    trainer.maybe_resume()

    eval_refs = {u.utt_id: (u.text.lower() if dc.do_lower_case else u.text)
                 for u in eval_utts}

    def train_iter(epoch: int = 0):
        # the shuffle is a function of (seed, epoch), not of the resume
        # step, so a resumed run replays the interrupted epoch's order
        return batches_from_examples(train_ex, cfg, dc, batch,
                                     training=True, pad_partial=True,
                                     seed=tc.seed + epoch)

    def eval_iter():
        return batches_from_examples(
            eval_ex, cfg, dc, args.per_device_eval_batch_size,
            training=False, shuffle=False, drop_last=False)

    trainer.train(train_iter, eval_iter if eval_ex else None, eval_refs)

    writer = multihost.process_index() == 0

    def save_whole(path: str) -> None:
        # every rank gathers its tp slices; rank 0 writes
        flat = gather_state_dict(model_io.flat_state(model), model)
        if writer:
            model_io.save_model(path, cfg, flat)

    if getattr(model, "decoder_lora", None) is not None:
        save_whole(os.path.join(args.output_dir, "model_unmerge"))
        merge_decoder_lora(model)
    final_dir = os.path.join(args.output_dir, "final")
    save_whole(final_dir)
    if writer and isinstance(tokenizer, CharTokenizer):
        tokenizer.save(os.path.join(final_dir, "char_tokenizer.json"))
    multihost.barrier("saved")
    logger.info("saved final model to %s", final_dir)
    return trainer


if __name__ == "__main__":
    main()
