"""Assemble a composite model directory (counterpart of
`mtasr_tpu/cli/create_from_pretrained.py`): an HF WavLM directory and an HF
LLaMA directory, special tokens wired and the embedding grown to the
tokenizer, or with `--init_random` random weights of a named geometry.

    python -m mtasr_tpu_torch.cli.create_from_pretrained \\
        --init_random tiny --output_dir exp/model0 [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from mtasr_tpu_torch.cli.args import add_device_arg
from mtasr_tpu_torch.data.tokenizer import CharTokenizer, HFTokenizer
from mtasr_tpu_torch.utils import model_io

logger = logging.getLogger("mtasr_tpu_torch.create")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("create_from_pretrained")
    p.add_argument("--encoder_dir", type=str, default=None)
    p.add_argument("--decoder_dir", type=str, default=None)
    p.add_argument("--tokenizer_name", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--instruct", action="store_true")
    p.add_argument("--talker_ctc", action="store_true")
    p.add_argument("--talker_numbers", type=int, default=2)
    p.add_argument("--separator_hidden", type=int, default=896)
    p.add_argument("--train_mode", type=str, default="attention")
    p.add_argument("--decoder_cross_attention", action="store_true")
    p.add_argument("--decoder_cross_attention_type", type=str, default="tiny")
    p.add_argument("--init_random", type=str, default=None,
                   choices=[None, "base-1b", "large-1b", "large-3b",
                            "large-8b", "tiny"],
                   help="skip pretrained dirs; random weights of a geometry")
    p.add_argument("--check_generate", action="store_true")
    add_device_arg(p)
    return p


def random_config(geo: str, tokenizer, sp):
    """The encoder and decoder configs of an `--init_random` geometry."""
    from mtasr_tpu_torch import config as C
    if geo == "tiny":
        enc = C.WavLMConfig(hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=128,
                            do_stable_layer_norm=True,
                            feat_extract_norm="layer", conv_bias=True)
        dec = C.LlamaConfig(vocab_size=len(tokenizer), hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            head_dim=16, bos_token_id=sp.bos_token_id,
                            eos_token_id=sp.eos_token_id)
        return enc, dec
    enc = (C.wavlm_base_config() if geo.startswith("base")
           else C.wavlm_large_config())
    dec = {"1b": C.llama_1b_config, "3b": C.llama_3b_config,
           "8b": C.llama_8b_config}[geo.split("-")[1]]()
    dec.vocab_size = max(dec.vocab_size, len(tokenizer))
    return enc, dec


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    tokenizer = (HFTokenizer(args.tokenizer_name) if args.tokenizer_name
                 else CharTokenizer())
    sp = tokenizer.add_special_tokens(instruct=args.instruct)
    special_ids = {"pad_token_id": sp.pad_token_id,
                   "sc_token_id": sp.sc_token_id, "instruct": args.instruct}
    if args.instruct:
        for k in ("bosp", "eosp", "boss", "eoss", "bosr", "eosr"):
            special_ids[f"{k}_token_id"] = getattr(sp, f"{k}_token_id")
    overrides = dict(
        talker_ctc=args.talker_ctc, talker_numbers=args.talker_numbers,
        separator_hidden=args.separator_hidden, train_mode=args.train_mode,
        decoder_cross_attention=args.decoder_cross_attention,
        decoder_cross_attention_type=args.decoder_cross_attention_type)

    if args.init_random:
        from mtasr_tpu_torch.config import SpeechEncoderDecoderConfig
        from mtasr_tpu_torch.utils.convert import init_random
        enc, dec = random_config(args.init_random, tokenizer, sp)
        cfg = SpeechEncoderDecoderConfig(encoder=enc, decoder=dec,
                                         **overrides)
        cfg.decoder_start_token_id = dec.bos_token_id
        cfg.bos_token_id = dec.bos_token_id
        cfg.eos_token_id = dec.eos_token_id
        for k, v in special_ids.items():
            setattr(cfg, k, v)
        g = torch.Generator(device=args.device)
        g.manual_seed(0)
        model = init_random(cfg, g, args.device,
                            model_io.serving_dtype(args.device)
                            or torch.float32)
    else:
        cfg, model = model_io.create_from_pretrained(
            args.encoder_dir, args.decoder_dir,
            tokenizer_len=len(tokenizer), special_ids=special_ids,
            model_overrides=overrides, device=args.device)

    model_io.save_model(args.output_dir, cfg, model)
    if isinstance(tokenizer, CharTokenizer):
        tokenizer.save(os.path.join(args.output_dir, "char_tokenizer.json"))

    if args.check_generate:
        # a dummy decode of the directory as written, loaded as a server
        # loads it (bf16 on the card)
        from mtasr_tpu_torch.generate.engine import generate
        del model
        cfg, model = model_io.load_model(
            args.output_dir, args.device, model_io.serving_dtype(args.device))
        wav = torch.ones((1, 2000), device=args.device)
        prompt = None
        if args.instruct:
            prompt = torch.tensor([[sp.bosp_token_id, sp.eosp_token_id,
                                    sp.boss_token_id, sp.eoss_token_id,
                                    sp.bosr_token_id]])
        out = generate(model, cfg, wav, None, prompt_ids=prompt,
                       max_new_tokens=4)
        logger.info("check_generate OK: %s", out.sequences[0].tolist())
    logger.info("saved composite model to %s", args.output_dir)


if __name__ == "__main__":
    main()
