"""Transcript clean-up and word error rate (counterpart of
`mtasr_tpu/utils/wer.py`: `clean_decoded_text`, the `Calculator` that the
trainer's `evaluate` and the inference CLI's report score with, cpWER and
`score_files`, the `compute-wer` tool's report).

The alignment is the reference scorer's: Levenshtein with cor 0 and sub /
del / ins 1, and at equal cost the traceback prefers del, then ins, then
the diagonal. Tokens are split on whitespace (or, in char mode, into CJK
characters and runs of other characters, punctuation dropped, `<tags>`
whole), upper-cased unless case-sensitive, and stripped of `<...>` tags
before they are aligned. `summary()` is the reference report's line.
The `Calculator` (with `use_native`, the default) and `cpwer` align in the
native C++ of `utils/native.py` where it is built, as the JAX module does,
and in Python otherwise: the same counts and alignments. The JAX
`Calculator`'s ignore list, which no caller sets, is not ported.
"""
from __future__ import annotations

import re
import unicodedata
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from mtasr_tpu_torch.data.audio import read_scp
from mtasr_tpu_torch.utils import native

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


PUNCTS = set("!,?、。！，；？：「」︰『』《》")
SPACELIST = {" ", "\t", "\r", "\n"}


def characterize(string: str) -> List[str]:
    """Char-mode units (compute-wer.py's `characterize`)."""
    res: List[str] = []
    i = 0
    while i < len(string):
        char = string[i]
        if char in PUNCTS:
            i += 1
            continue
        cat = unicodedata.category(char)
        if cat in ("Zs", "Cn") or char in SPACELIST:
            i += 1
        elif cat == "Lo":
            res.append(char)
            i += 1
        else:
            sep = ">" if char == "<" else " "
            j = i + 1
            while j < len(string):
                c = string[j]
                if ord(c) >= 128 or c in SPACELIST or c == sep:
                    break
                j += 1
            if j < len(string) and string[j] == ">":
                j += 1
            res.append(string[i:j])
            i = j
    return res


def _tokens(text: str, char_mode: bool = False,
            case_sensitive: bool = False) -> List[str]:
    words = characterize(text) if char_mode else text.split()
    if not case_sensitive:
        words = [w.upper() for w in words]
    return [t for t in map(_strip_tags, words) if t]


@dataclass
class EditStats:
    all: int = 0
    cor: int = 0
    sub: int = 0
    dele: int = 0
    ins: int = 0
    lab_align: List[str] = field(default_factory=list)   # "" where inserted
    rec_align: List[str] = field(default_factory=list)   # "" where deleted

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
            stats.lab_align.append(lab[i - 1])
            stats.rec_align.append(rec[j - 1])
            i, j = i - 1, j - 1
        elif e == "del":
            stats.all += 1
            stats.dele += 1
            stats.lab_align.append(lab[i - 1])
            stats.rec_align.append("")
            i -= 1
        else:
            stats.ins += 1
            stats.lab_align.append("")
            stats.rec_align.append(rec[j - 1])
            j -= 1
    stats.lab_align.reverse()
    stats.rec_align.reverse()
    return stats


def _from_ops(counts: Sequence[int], ops, lab: Sequence[str],
              rec: Sequence[str]) -> EditStats:
    """EditStats from the native counts and traceback (1 cor, 2 sub,
    3 del, 4 ins, left to right), the alignment rebuilt on the host."""
    stats = EditStats(*counts[:5])
    i = j = 0
    for op in ops:
        if op in (1, 2):
            stats.lab_align.append(lab[i])
            stats.rec_align.append(rec[j])
            i, j = i + 1, j + 1
        elif op == 3:
            stats.lab_align.append(lab[i])
            stats.rec_align.append("")
            i += 1
        else:
            stats.lab_align.append("")
            stats.rec_align.append(rec[j])
            j += 1
    return stats


class Calculator:
    """Accumulates edit statistics over utterances, word by word (or, with
    `char_mode`, unit by unit). With `use_native` the alignment runs in
    `utils/native.py`'s C++ where it is built, over ids this calculator
    gives the tokens."""

    def __init__(self, char_mode: bool = False,
                 case_sensitive: bool = False, use_native: bool = True):
        self.char_mode, self.case_sensitive = char_mode, case_sensitive
        self.use_native = use_native
        self.total = EditStats()
        self.per_utt: Dict[str, EditStats] = {}
        self._vocab: Dict[str, int] = {}

    def _ids(self, tokens: Sequence[str]) -> List[int]:
        return [self._vocab.setdefault(t, len(self._vocab)) for t in tokens]

    def calculate(self, utt_id: str, lab_text: str, rec_text: str,
                  need_alignment: bool = False) -> EditStats:
        """The utterance's counts, added to the total; the alignment
        (`lab_align` / `rec_align`) is filled with `need_alignment`, and
        always on the Python path."""
        lab = _tokens(lab_text, self.char_mode, self.case_sensitive)
        rec = _tokens(rec_text, self.char_mode, self.case_sensitive)
        stats = None
        if self.use_native and need_alignment:
            res = native.wer_align_ops_native(self._ids(lab), self._ids(rec))
            if res is not None:
                stats = _from_ops(res[0], res[1], lab, rec)
        elif self.use_native:
            counts = native.wer_align_native(self._ids(lab), self._ids(rec))
            if counts is not None:
                stats = EditStats(*counts)
        if stats is None:
            stats = align(lab, rec)
        self.per_utt[utt_id] = stats
        self.total.add(stats)
        return stats

    def overall(self) -> EditStats:
        return self.total

    def summary(self) -> str:
        t = self.total
        return (f"Overall -> {t.wer:.2f} % N={t.all} C={t.cor} S={t.sub} "
                f"D={t.dele} I={t.ins}")


def wer(lab_text: str, rec_text: str, char_mode: bool = False,
        case_sensitive: bool = False) -> float:
    """The WER (%) of one hypothesis against its reference
    (`mtasr_tpu/utils/wer.py::wer`)."""
    return Calculator(char_mode, case_sensitive).calculate(
        "utt", lab_text, rec_text).wer


def cpwer(ref_streams: Sequence[str], hyp_streams: Sequence[str],
          char_mode: bool = False, case_sensitive: bool = False
          ) -> Tuple[float, Tuple[int, ...]]:
    """Concatenated minimum-permutation WER over K speaker streams: every
    assignment of hypothesis streams to reference streams is scored, the
    first best (in `itertools.permutations` order) wins, natively where the
    library is built (the same order). Returns (WER %,
    the permutation: reference i is scored against hypothesis perm[i]).
    Stream lists of unequal length are padded with empty strings."""
    K = max(len(ref_streams), len(hyp_streams))
    refs = [_tokens(r, char_mode, case_sensitive) for r in
            list(ref_streams) + [""] * (K - len(ref_streams))]
    hyps = [_tokens(h, char_mode, case_sensitive) for h in
            list(hyp_streams) + [""] * (K - len(hyp_streams))]
    vocab: Dict[str, int] = {}

    def ids(toks):
        return [vocab.setdefault(t, len(vocab)) for t in toks]
    res = native.cpwer_native([ids(r) for r in refs], [ids(h) for h in hyps])
    if res is not None:
        return res
    best, best_perm = None, None
    for perm in itertools.permutations(range(K)):
        pairs = [align(refs[i], hyps[j]) for i, j in enumerate(perm)]
        w = 100.0 * sum(s.errors for s in pairs) / max(
            sum(s.all for s in pairs), 1)
        if best is None or w < best:
            best, best_perm = w, perm
    return best, best_perm


def score_files(ref_path: str, hyp_path: str, char_mode: bool = False,
                case_sensitive: bool = False, verbose: bool = False) -> str:
    """Kaldi-style `utt_id text` files -> the report: with `verbose`, each
    utterance's alignment and line, then the `Overall` line. An utterance
    missing from the hypotheses is scored against nothing."""
    refs, hyps = read_scp(ref_path), read_scp(hyp_path)
    calc = Calculator(char_mode, case_sensitive)
    lines = []
    for utt_id, ref in refs.items():
        s = calc.calculate(utt_id, ref, hyps.get(utt_id, ""),
                           need_alignment=verbose)
        if verbose:
            lines += [f"utt: {utt_id}", "lab: " + " ".join(s.lab_align),
                      "rec: " + " ".join(s.rec_align),
                      f"WER: {s.wer:.2f} % N={s.all} C={s.cor} S={s.sub} "
                      f"D={s.dele} I={s.ins}", ""]
    lines.append(calc.summary())
    return "\n".join(lines)
