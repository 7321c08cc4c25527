"""Small model-directory and scoring tools (counterpart of
`mtasr_tpu/cli/tools.py`):

  extract      -- keep the tensors under some top-level names
  merge-lora   -- fold a decoder LoRA into the decoder's weights
  compute-wer  -- score a hypothesis file against a reference file
  check-keys   -- every tensor's name, shape and dtype

    python -m mtasr_tpu_torch.cli.tools check-keys --model_dir DIR

`extract` and `check-keys` read and write files alone; `merge-lora` folds
on `--device` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import argparse
import sys

from mtasr_tpu_torch.cli.args import add_device_arg


def cmd_extract(argv):
    p = argparse.ArgumentParser("tools extract")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--prefixes", default="separator,serialized_ctc")
    args = p.parse_args(argv)
    from mtasr_tpu_torch.train.checkpoint import extract_by_prefix
    from mtasr_tpu_torch.utils.model_io import (
        read_config, read_flat, save_model,
    )
    sub = extract_by_prefix(read_flat(args.model_dir),
                            tuple(args.prefixes.split(",")))
    save_model(args.output_dir, read_config(args.model_dir), sub)
    tops = list(dict.fromkeys(k.split(".", 1)[0] for k in sub))
    print(f"extracted {tops} -> {args.output_dir}")


def cmd_merge_lora(argv):
    p = argparse.ArgumentParser("tools merge-lora")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--output_dir", required=True)
    add_device_arg(p)
    args = p.parse_args(argv)
    from mtasr_tpu_torch.train.lora import merge_decoder_lora
    from mtasr_tpu_torch.utils.model_io import load_model, save_model
    cfg, model = load_model(args.model_dir, args.device)
    save_model(args.output_dir, cfg, merge_decoder_lora(model))
    print(f"merged -> {args.output_dir}")


def cmd_compute_wer(argv):
    p = argparse.ArgumentParser("tools compute-wer")
    p.add_argument("ref")
    p.add_argument("hyp")
    p.add_argument("--char", type=int, default=0)
    p.add_argument("--cs", type=int, default=0)
    p.add_argument("--v", type=int, default=1)
    args = p.parse_args(argv)
    from mtasr_tpu_torch.utils.wer import score_files
    print(score_files(args.ref, args.hyp, char_mode=bool(args.char),
                      case_sensitive=bool(args.cs), verbose=bool(args.v)))


def cmd_check_keys(argv):
    p = argparse.ArgumentParser("tools check-keys")
    p.add_argument("--model_dir", required=True)
    args = p.parse_args(argv)
    from mtasr_tpu_torch.utils.model_io import read_flat
    for k, t in sorted(read_flat(args.model_dir).items()):
        print(f"{k}\t{tuple(t.shape)}\t{str(t.dtype).removeprefix('torch.')}")


COMMANDS = {"extract": cmd_extract, "merge-lora": cmd_merge_lora,
            "compute-wer": cmd_compute_wer, "check-keys": cmd_check_keys}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: tools.py {{{','.join(COMMANDS)}}} ...")
        sys.exit(2)
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
