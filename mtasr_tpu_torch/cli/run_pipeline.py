"""The experiment's stages in order (counterpart of
`mtasr_tpu/cli/run_pipeline.py`), each through the port's CLIs:

  stage 1  the Kaldi data directory has wav.scp and text
  stage 2  model assembly (create_from_pretrained)
  stage 3  fine-tuning (finetune_asr)
  stage 4  decode and score the data directory (inference_asr)
  stage 5  decode and score another evaluation set
  stage 6  decode in `--num_shards` shards one after another, then merge
           and score

    python -m mtasr_tpu_torch.cli.run_pipeline --root exp --data_dir DATA \\
        --init_random tiny [--stage 1 --stop_stage 6] [--device cpu]

The run directory's name encodes the configuration (`encode_run_name`).
With `--dp_size` x `--tp_size` above one process (`--dp_size -1`: one dp
index), stages 3-6 run their CLI on that many ranks, through
`python -m torch.distributed.run --standalone --nproc_per_node N`; the
other stages, and the merge of stage 6, run in this process.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from mtasr_tpu_torch.cli.args import add_device_arg


def encode_run_name(args) -> str:
    """The run directory's name: dataset, mode and the switches that
    change the model, then the learning rate."""
    parts = [args.dataset_name or "data", args.train_mode]
    if args.talker_ctc:
        parts.append(f"ctc{args.talker_numbers}")
    if args.ctc_bridge:
        parts.append(f"bridge-{args.ctc_bridge_type}")
    if args.decoder_cross_attention:
        parts.append(f"xattn-{args.decoder_cross_attention_type}")
    if args.instruct:
        parts.append("instruct")
    parts.append(f"lr{args.learning_rate}")
    return "_".join(str(p) for p in parts)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_pipeline")
    p.add_argument("--stage", type=int, default=1)
    p.add_argument("--stop_stage", type=int, default=6)
    p.add_argument("--root", type=str, required=True,
                   help="experiment root dir")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--eval_data_dir", type=str, default=None)
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--encoder_dir", type=str, default=None)
    p.add_argument("--decoder_dir", type=str, default=None)
    p.add_argument("--init_random", type=str, default=None)
    p.add_argument("--tokenizer_name", type=str, default=None)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--train_mode", type=str, default="attention")
    p.add_argument("--talker_ctc", action="store_true")
    p.add_argument("--talker_numbers", type=int, default=2)
    p.add_argument("--ctc_bridge", action="store_true")
    p.add_argument("--ctc_bridge_type", type=str, default="raw")
    p.add_argument("--decoder_cross_attention", action="store_true")
    p.add_argument("--decoder_cross_attention_type", type=str, default="tiny")
    p.add_argument("--instruct", action="store_true")
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--per_device_train_batch_size", type=int, default=12)
    p.add_argument("--dp_size", type=int, default=-1)
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--max_length", type=int, default=150)
    p.add_argument("--num_beams", type=int, default=1)
    add_device_arg(p)
    return p


def n_ranks(args) -> int:
    """The processes a parallel stage runs on: dp x tp (dp -1 counts as
    one)."""
    return max(1, args.dp_size) * max(1, args.tp_size)


def run_cli(module: str, flags, nproc: int) -> None:
    """`module`'s main(flags) in this process, or, on more than one rank,
    under `torch.distributed.run` (a failed rank fails the stage)."""
    if nproc == 1:
        import importlib
        importlib.import_module(module).main(flags)
        return
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", module] + list(flags)
    subprocess.run(cmd, check=True)


def run_stage(args, stage: int, model_dir: str, exp_dir: str) -> None:
    common = ["--device", args.device]
    nproc = n_ranks(args)
    if args.talker_ctc:
        common.append("--talker_ctc")
    if args.instruct:
        common.append("--instruct")
    xattn = (["--decoder_cross_attention", "--decoder_cross_attention_type",
              args.decoder_cross_attention_type]
             if args.decoder_cross_attention else [])
    tok = (["--tokenizer_name", args.tokenizer_name]
           if args.tokenizer_name else [])

    if stage == 1:
        for sub in ("wav.scp", "text"):
            path = os.path.join(args.data_dir, sub)
            if not os.path.exists(path):
                path = os.path.join(args.data_dir, "train", sub)
            if not os.path.exists(path):
                sys.exit(f"stage 1: missing {sub} under {args.data_dir}")
        print("stage 1: dataset OK")

    elif stage == 2:
        from mtasr_tpu_torch.cli.create_from_pretrained import main as m
        flags = ["--output_dir", model_dir, "--train_mode", args.train_mode,
                 "--talker_numbers", str(args.talker_numbers),
                 "--check_generate"] + common + xattn + tok
        if args.init_random:
            flags += ["--init_random", args.init_random]
        else:
            flags += ["--encoder_dir", args.encoder_dir,
                      "--decoder_dir", args.decoder_dir]
        m(flags)

    elif stage == 3:
        flags = ["--model_name_or_path", model_dir,
                 "--data_dir", args.data_dir, "--output_dir", exp_dir,
                 "--train_mode", args.train_mode,
                 "--talker_numbers", str(args.talker_numbers),
                 "--learning_rate", str(args.learning_rate),
                 "--max_steps", str(args.max_steps),
                 "--per_device_train_batch_size",
                 str(args.per_device_train_batch_size),
                 "--dp_size", str(args.dp_size),
                 "--tp_size", str(args.tp_size)] + common
        if args.ctc_bridge:
            flags += ["--ctc_bridge", "--ctc_bridge_type",
                      args.ctc_bridge_type]
        run_cli("mtasr_tpu_torch.cli.finetune_asr", flags + xattn + tok,
                nproc)

    elif stage in (4, 5, 6):
        from mtasr_tpu_torch.cli.inference_asr import main as m
        infer = "mtasr_tpu_torch.cli.inference_asr"
        data = (args.eval_data_dir if stage == 5 and args.eval_data_dir
                else args.data_dir)
        dec_dir = os.path.join(exp_dir, f"decode_stage{stage}")
        base = ["--model_name_or_path", os.path.join(exp_dir, "final"),
                "--data_dir", data, "--output_dir", dec_dir,
                "--max_length", str(args.max_length),
                "--dp_size", str(args.dp_size),
                "--tp_size", str(args.tp_size),
                "--num_beams", str(args.num_beams)] + common + tok
        if stage == 6 and args.num_shards > 1:
            for shard in range(args.num_shards):
                run_cli(infer, base + ["--shard_index", str(shard),
                                       "--num_shards", str(args.num_shards)],
                        nproc)
            m(base + ["--num_shards", str(args.num_shards), "--merge"])
        else:
            run_cli(infer, base, nproc)
        wer_path = os.path.join(dec_dir, "wer")
        if os.path.exists(wer_path):
            with open(wer_path) as f:
                print(f.read())


def main(argv=None):
    args = build_argparser().parse_args(argv)
    run_name = encode_run_name(args)
    model_dir = os.path.join(args.root, "models", run_name)
    exp_dir = os.path.join(args.root, "exp", run_name)
    for stage in range(args.stage, args.stop_stage + 1):
        print(f"===== stage {stage} =====")
        run_stage(args, stage, model_dir, exp_dir)


if __name__ == "__main__":
    main()
