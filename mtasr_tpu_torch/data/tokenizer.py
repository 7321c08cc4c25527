"""Tokenizers with the SOT special tokens (counterpart of
`mtasr_tpu/data/tokenizer.py`).

`CharTokenizer` needs no model files. Layout: 0 `<unk>`, 1 `<bos>`, 2
`<eos>`, 3 space, then the alphabet; then `add_special_tokens` appends
`<pad>`, `<sc>` and, in instruct mode, the six prompt / speech / response
delimiters, in that order. An id outside the vocabulary decodes to "". It
saves to and loads from the JAX package's `char_tokenizer.json`.

`HFTokenizer` wraps a local HF tokenizer (LLaMA's); it imports
`transformers` when it is built, and raises saying so where that package
is missing.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

INSTRUCT_SPECIALS = ("<bos_prompt>", "<eos_prompt>", "<bos_speech>",
                     "<eos_speech>", "<bos_response>", "<eos_response>")
_INSTRUCT_NAMES = ("bosp", "eosp", "boss", "eoss", "bosr", "eosr")


@dataclass
class SpecialTokens:
    pad_token_id: int
    sc_token_id: int
    bos_token_id: int
    eos_token_id: int
    bosp_token_id: Optional[int] = None
    eosp_token_id: Optional[int] = None
    boss_token_id: Optional[int] = None
    eoss_token_id: Optional[int] = None
    bosr_token_id: Optional[int] = None
    eosr_token_id: Optional[int] = None


class CharTokenizer:
    def __init__(self,
                 alphabet: str = "abcdefghijklmnopqrstuvwxyz'0123456789"):
        self.vocab: Dict[str, int] = {"<unk>": 0, "<bos>": 1, "<eos>": 2,
                                      " ": 3}
        for ch in alphabet:
            self.vocab[ch] = len(self.vocab)
        self.inv = {v: k for k, v in self.vocab.items()}
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id: Optional[int] = None
        self.specials: Dict[str, int] = {}

    def __len__(self):
        return len(self.vocab)

    def add_special_tokens(self, instruct: bool = False) -> SpecialTokens:
        def add(tok):
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
                self.inv[self.vocab[tok]] = tok
                self.specials[tok] = self.vocab[tok]
            return self.vocab[tok]
        pad, sc = add("<pad>"), add("<sc>")
        self.pad_token_id = pad
        ids = {}
        if instruct:
            ids = {f"{name}_token_id": add(tok)
                   for name, tok in zip(_INSTRUCT_NAMES, INSTRUCT_SPECIALS)}
        return SpecialTokens(pad_token_id=pad, sc_token_id=sc,
                             bos_token_id=self.bos_token_id,
                             eos_token_id=self.eos_token_id, **ids)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        """Characters to ids; a `<...>` token in the vocabulary is one id,
        an unknown character is `<unk>`."""
        ids = [self.bos_token_id] if add_bos else []
        i = 0
        while i < len(text):
            j = text.find(">", i) if text[i] == "<" else -1
            if j >= 0 and text[i:j + 1] in self.vocab:
                ids.append(self.vocab[text[i:j + 1]])
                i = j + 1
                continue
            ids.append(self.vocab.get(text[i], 0))
            i += 1
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        skip = (set(self.specials.values()) | {0, 1, 2}
                if skip_special_tokens else set())
        return "".join(self.inv.get(int(t), "") for t in ids
                       if int(t) not in skip)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": "char", "vocab": self.vocab,
                       "specials": self.specials,
                       "pad_token_id": self.pad_token_id}, f)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        with open(path) as f:
            d = json.load(f)
        tok = cls.__new__(cls)
        tok.vocab = d["vocab"]
        tok.inv = {v: k for k, v in tok.vocab.items()}
        tok.specials = d["specials"]
        tok.bos_token_id, tok.eos_token_id = 1, 2
        tok.pad_token_id = d["pad_token_id"]
        return tok


class HFTokenizer:
    """A local HF tokenizer directory (no hub access). Needs the
    `transformers` package."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                f"HFTokenizer({path!r}) needs the transformers package, "
                "which is not installed; use a char_tokenizer.json") from e
        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_token_id = self.tok.bos_token_id
        self.eos_token_id = self.tok.eos_token_id
        self.pad_token_id = self.tok.pad_token_id

    def __len__(self):
        return len(self.tok)

    def add_special_tokens(self, instruct: bool = False) -> SpecialTokens:
        toks = ["<sc>"] + (list(INSTRUCT_SPECIALS) if instruct else [])
        self.tok.add_special_tokens({"pad_token": "<pad>",
                                     "additional_special_tokens": toks})
        self.pad_token_id = self.tok.pad_token_id
        get = self.tok.convert_tokens_to_ids
        ids = {}
        if instruct:
            ids = {f"{name}_token_id": get(tok)
                   for name, tok in zip(_INSTRUCT_NAMES, INSTRUCT_SPECIALS)}
        return SpecialTokens(pad_token_id=get("<pad>"),
                             sc_token_id=get("<sc>"),
                             bos_token_id=self.bos_token_id,
                             eos_token_id=self.eos_token_id, **ids)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self.tok(text).input_ids
        if not add_bos and ids and ids[0] == self.bos_token_id:
            ids = ids[1:]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tok.decode([int(i) for i in ids],
                               skip_special_tokens=skip_special_tokens)


def load_tokenizer(model_dir_or_name: str):
    """A model directory's `char_tokenizer.json`, a char tokenizer's JSON
    file, else an HF tokenizer directory."""
    char_path = os.path.join(model_dir_or_name, "char_tokenizer.json")
    if os.path.exists(char_path):
        return CharTokenizer.load(char_path)
    if os.path.isfile(model_dir_or_name) and \
            model_dir_or_name.endswith(".json"):
        return CharTokenizer.load(model_dir_or_name)
    return HFTokenizer(model_dir_or_name)


def build_prompt_and_input(prompt: str, response: str):
    """The instruct template: the prompt string (ending with the speech
    slot and `<bos_response>`) and the response string."""
    prompt_str = (f"<bos_prompt>{prompt}<eos_prompt><bos_speech>"
                  f"<eos_speech><bos_response>")
    return prompt_str, f"{response}<eos_response>"
