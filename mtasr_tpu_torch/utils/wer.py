"""Transcript clean-up and word error rate (counterpart of
`mtasr_tpu/utils/wer.py`: `clean_decoded_text`, and the word-mode
`Calculator` that the trainer's `evaluate` scores with).

The alignment is the reference scorer's: Levenshtein with cor 0 and sub /
del / ins 1, and at equal cost the traceback prefers del, then ins, then
the diagonal. Tokens are split on whitespace, upper-cased and stripped of
`<...>` tags before they are aligned. Character mode, the ignore list and
the alignment strings of the JAX module are not ported: the port's trainer
does not use them.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence

ALLOWED_SPECIAL_TOKENS = ("<sc>", "<bos_prompt>", "<eos_prompt>",
                          "<bos_speech>", "<eos_speech>", "<bos_response>",
                          "<eos_response>")


def clean_decoded_text(text: str) -> str:
    """Keep the task's special tokens (`<sc>` is scored as a token), drop
    every other `<...>` token, and join the rest with single spaces."""
    tokens = re.findall(r"<[^>]+>|[^<>\s]+", text)
    return " ".join(t for t in tokens
                    if t in ALLOWED_SPECIAL_TOKENS
                    or not (t.startswith("<") and t.endswith(">")))


def _strip_tags(x: str) -> str:
    chars, i = [], 0
    while i < len(x):
        if x[i] == "<":
            while i < len(x) and x[i] != ">":
                i += 1
            i += 1
        else:
            chars.append(x[i])
            i += 1
    return "".join(chars)


def _tokens(text: str) -> List[str]:
    return [t for t in (_strip_tags(w.upper()) for w in text.split()) if t]


@dataclass
class EditStats:
    all: int = 0
    cor: int = 0
    sub: int = 0
    dele: int = 0
    ins: int = 0

    @property
    def errors(self) -> int:
        return self.sub + self.dele + self.ins

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.all, 1)

    def add(self, other: "EditStats") -> None:
        self.all += other.all
        self.cor += other.cor
        self.sub += other.sub
        self.dele += other.dele
        self.ins += other.ins


def align(lab: Sequence[str], rec: Sequence[str]) -> EditStats:
    n, m = len(lab), len(rec)
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    op = [["non"] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dist[i][0], op[i][0] = i, "del"
    for j in range(1, m + 1):
        dist[0][j], op[0][j] = j, "ins"
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            best, best_op = dist[i - 1][j] + 1, "del"
            if dist[i][j - 1] + 1 < best:
                best, best_op = dist[i][j - 1] + 1, "ins"
            same = lab[i - 1] == rec[j - 1]
            d = dist[i - 1][j - 1] + (0 if same else 1)
            if d < best:
                best, best_op = d, "cor" if same else "sub"
            dist[i][j], op[i][j] = best, best_op
    stats, i, j = EditStats(), n, m
    while i or j:
        e = op[i][j]
        if e in ("cor", "sub"):
            stats.all += 1
            setattr(stats, e, getattr(stats, e) + 1)
            i, j = i - 1, j - 1
        elif e == "del":
            stats.all += 1
            stats.dele += 1
            i -= 1
        else:
            stats.ins += 1
            j -= 1
    return stats


class Calculator:
    """Accumulates word-level edit statistics over utterances."""

    def __init__(self):
        self.total = EditStats()
        self.per_utt: Dict[str, EditStats] = {}

    def calculate(self, utt_id: str, lab_text: str,
                  rec_text: str) -> EditStats:
        stats = align(_tokens(lab_text), _tokens(rec_text))
        self.per_utt[utt_id] = stats
        self.total.add(stats)
        return stats

    def overall(self) -> EditStats:
        return self.total
