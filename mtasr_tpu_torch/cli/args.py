"""The argument groups of the CLIs (counterpart of `mtasr_tpu/cli/args.py`:
the same flags, defaults and types), plus `--device`.
`setup_distributed` joins a `torch.distributed.run` launch and lays its
ranks out as `--dp_size` x `--tp_size`."""
from __future__ import annotations

import argparse
import os

import torch

from mtasr_tpu_torch.parallel import multihost
from mtasr_tpu_torch.parallel.mesh import Mesh, make_mesh

def setup_distributed(args: argparse.Namespace):
    """(device, mesh) of this process. Under `torch.distributed.run`
    (`LOCAL_RANK` set) `--device cuda` means `cuda:LOCAL_RANK` (an index
    past the cards fails loudly) and the process group is joined, NCCL on
    the card and gloo with `--device cpu`; the mesh is `--dp_size` x
    `--tp_size` over its ranks (`--dp_size -1`: world // tp), and one
    that does not cover the ranks raises."""
    device = torch.device(args.device)
    local = os.environ.get("LOCAL_RANK")
    if local is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(local))
    multihost.initialize(device=device)
    mesh: Mesh = make_mesh(args.dp_size, args.tp_size)
    return str(device), mesh


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (the card by default; "
                        "`cpu` runs the kernels' plain versions)")


def add_model_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("model")
    g.add_argument("--model_name_or_path", type=str, default=None,
                   help="composite checkpoint dir (config.json + weights)")
    g.add_argument("--talker_ctc", action="store_true")
    g.add_argument("--talker_ctc_refine", action="store_true")
    g.add_argument("--talker_numbers", type=int, default=2)
    g.add_argument("--separator_hidden", type=int, default=896)
    g.add_argument("--ctc_bridge", action="store_true")
    g.add_argument("--ctc_bridge_type", type=str, default="raw",
                   choices=["raw", "softmax", "ctcprompt"])
    g.add_argument("--decoder_cross_attention", action="store_true")
    g.add_argument("--decoder_cross_attention_type", type=str, default="tiny",
                   choices=["tiny", "gatetiny", "ctcaware", "adapgatetiny"])
    g.add_argument("--decoder_cross_attention_feature", type=str,
                   default="raw", choices=["raw", "mix", "sep", "ctctoken"])
    g.add_argument("--r_max", type=int, default=16)
    g.add_argument("--lora_alpha", type=int, default=16)
    g.add_argument("--train_mode", type=str, default="attention",
                   choices=["ctc", "attention", "hybrid"])
    g.add_argument("--ctc_alpha", type=float, default=0.7)
    g.add_argument("--ctc_decoding", action="store_true")
    g.add_argument("--instruct", action="store_true")
    g.add_argument("--freeze_feature_encoder", type=lambda s: s != "false",
                   default=True)
    g.add_argument("--freeze_encoder", action="store_true")
    g.add_argument("--freeze_decoder", action="store_true")
    g.add_argument("--partial_encoder_unfreeze", type=str,
                   default="masked_spec_embed")
    g.add_argument("--partial_decoder_unfreeze", type=str,
                   default="lm_head,embed_tokens")
    g.add_argument("--partial_others_unfreeze", type=str,
                   default="enc_to_dec_proj,ctc")
    g.add_argument("--pretrain_separator_path", type=str, default=None)
    g.add_argument("--apply_spec_augment", action="store_true")
    g.add_argument("--use_lora", action="store_true",
                   help="insert decoder LoRA adapters (PEFT-equivalent)")
    g.add_argument("--lora_dropout", type=float, default=0.1,
                   help="LoRA-branch input dropout")
    g.add_argument("--attention_impl", type=str, default="auto",
                   choices=["auto", "xla", "flash"],
                   help="the JAX package's encoder attention selector, "
                        "recorded in the config; the port runs its kernel "
                        "on the card and the plain version on the CPU")
    g.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute encoder and decoder layers in backward")


def add_data_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("data")
    g.add_argument("--dataset_name", type=str, default=None)
    g.add_argument("--data_dir", type=str, default=None,
                   help="Kaldi-style dir with wav.scp + text")
    g.add_argument("--max_duration_in_seconds", type=float, default=20.0)
    g.add_argument("--min_duration_in_seconds", type=float, default=0.0)
    g.add_argument("--do_lower_case", type=lambda s: s != "false",
                   default=True)
    g.add_argument("--max_train_samples", type=int, default=None)
    g.add_argument("--max_eval_samples", type=int, default=None)
    g.add_argument("--preprocessing_num_workers", type=int, default=1,
                   help="parallel preprocessing workers")
    g.add_argument("--eager_audio", action="store_true",
                   help="read all waveforms up front instead of at collate "
                        "time")
    g.add_argument("--preprocessing_cache", type=str, default=None,
                   help="JSONL cache of tokenized, duration-probed examples")
    g.add_argument("--prompt", type=str,
                   default="Transcribe the speech to text")


def add_training_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("training")
    g.add_argument("--output_dir", type=str, required=True)
    g.add_argument("--learning_rate", type=float, default=3e-5)
    g.add_argument("--warmup_steps", type=int, default=400)
    g.add_argument("--max_steps", type=int, default=100000)
    g.add_argument("--num_train_epochs", type=float, default=30)
    g.add_argument("--per_device_train_batch_size", type=int, default=12)
    g.add_argument("--per_device_eval_batch_size", type=int, default=12)
    g.add_argument("--gradient_accumulation_steps", type=int, default=1)
    g.add_argument("--max_grad_norm", type=float, default=1.0)
    g.add_argument("--logging_steps", type=int, default=25)
    g.add_argument("--eval_steps", type=int, default=1600)
    g.add_argument("--save_steps", type=int, default=1600)
    g.add_argument("--save_total_limit", type=int, default=5)
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--bf16", type=lambda s: s != "false", default=True)
    g.add_argument("--pcgrad", type=lambda s: s != "false", default=True)
    g.add_argument("--dp_size", type=int, default=-1)
    g.add_argument("--tp_size", type=int, default=1)
    g.add_argument("--overwrite_output_dir", action="store_true")


def add_generation_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("generation")
    g.add_argument("--max_length", type=int, default=150)
    g.add_argument("--num_beams", type=int, default=1)
    g.add_argument("--length_penalty", type=float, default=1.0,
                   help="beam-search length penalty (only with "
                        "--num_beams > 1)")
    g.add_argument("--do_sample", action="store_true")
    g.add_argument("--temperature", type=float, default=1.0)
    g.add_argument("--top_k", type=int, default=0)
    g.add_argument("--top_p", type=float, default=1.0)


def csv(s: str):
    return [x for x in s.split(",") if x]
