"""How `correct` is decided: the program's served output, sampled from the
seed once the window has closed, against the plain reference
(`bench_h100/reference/`, float32, TF32 off) over the same inputs and the
same weights.

A served SOT token is judged by how far its reference logit lies below
the reference's best at that position, in units of the standard deviation
of the reference's logits there (`gap_sd`): 0 where the program chose
the reference's argmax, a small multiple of the rounding where a near tie
went the other way, several units for a token the reference would not
consider. Two numbers come of it: the widest gap over every judged token
(`max_gap_sd`) and the mean (`mean_gap_sd`). The widest gap grows with
the rounding error about linearly (it is one near tie's), the mean about
with its square (how often a tie flips times how far), so the mean parts
a bf16 program from its int8 control where the widest gap does not; a
cell's limits file says which numbers it compares.

A CTC transcript is judged the same way frame by frame, through the
collapse: the widest gap of the best frame path whose greedy collapse
(blanks and pads dropped, repeats merged across blanks, cut at the
output length) gives the served transcript, minimised over all such paths
by a min-max pass over the lattice."""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench_h100.reference import separator as ref_sep
from bench_h100.reference import wavlm as ref_wavlm
from bench_h100.reference.common import float32_exact, linear

INF = float("inf")


def pick_rows(done: Sequence[Tuple[int, int]], n: int, seed: int,
              lengths: Dict[Tuple[int, int], int]) -> List[Tuple[int, int]]:
    """`n` of the finished (call, row) pairs, drawn from the seed, the
    longest recording among them."""
    rng = np.random.default_rng(int(seed) + 7919)
    done = list(done)
    longest = max(done, key=lambda cr: lengths[cr])
    rest = [cr for cr in done if cr != longest]
    idx = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(idx)]


def gap_sd(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logits [N, V] float32, tokens [N]: (best - logit of the token) /
    std of the row's logits."""
    best = logits.max(-1).values
    own = logits.gather(-1, tokens[:, None].long())[:, 0]
    return (best - own) / logits.std(-1)


def _numbers(gaps: List[torch.Tensor]) -> dict:
    g = torch.cat(gaps)
    return {"max_gap_sd": float(g.max()), "mean_gap_sd": float(g.mean()),
            "msq_gap_sd": float((g * g).mean()), "tokens": int(g.numel())}


def merge(parts: List[dict]) -> dict:
    """The numbers of several judged groups as one: the widest gap, and
    the means weighted by the groups' tokens."""
    n = sum(p["tokens"] for p in parts)
    out = {"max_gap_sd": max(p["max_gap_sd"] for p in parts)}
    for key in ("mean_gap_sd", "msq_gap_sd"):
        out[key] = sum(p[key] * p["tokens"] for p in parts) / max(n, 1)
    out["tokens"] = n
    return out


def served_tokens(row: np.ndarray, eos_id: int) -> np.ndarray:
    """A served row up to and including its eos (the pads after it are
    the loop's filler, not tokens)."""
    hit = np.nonzero(row == eos_id)[0]
    return row[:hit[0] + 1] if len(hit) else row


def sot_readings(w, enc: dict, dec: dict, ids: dict, wavs: List[np.ndarray],
                 tokens: List[np.ndarray], n_samples: int, device,
                 decoder: ModuleType, control_bits: Optional[int] = None,
                 control_logits: Optional[List[torch.Tensor]] = None) -> dict:
    """{"program": numbers} over the served `tokens` of `wavs`: the widest
    and the mean `gap_sd` of a served token against `decoder`, the
    decoder family's reference module (`reference/<family>.py`: its
    `served_logits(w, dec, speech, tokens, bos_id, quant=None)` gives per
    row the logits that predict each served token); with `control_bits`
    also {"control": numbers}, the same reference in that precision put
    in the program's place: the gaps of the tokens it ranks first at each
    position, teacher-forced on the same tokens; with `control_logits`
    (the program's own lower-precision path, teacher-forced:
    `control.py`) the same of the tokens those rank first."""
    out = {}
    with float32_exact():
        readings = {"program": None}
        if control_bits:
            readings["control"] = control_bits
        for key, bits in readings.items():
            mixed, _, speech, mask8 = ref_wavlm.encode_rows(
                w, enc, wavs, n_samples, device, quant=bits)
            if "enc_to_dec_proj.weight" in w:
                speech = linear(w, "enc_to_dec_proj", speech, bits)
            rows = [speech[i, :int(mask8[i].sum())] for i in range(len(wavs))]
            toks = [torch.as_tensor(t, device=device) for t in tokens]
            logits = decoder.served_logits(w, dec, rows, toks, ids["bos"],
                                           quant=bits)
            if key == "program":
                ref = logits
                gaps = [gap_sd(z, t) for z, t in zip(ref, toks)]
            else:
                gaps = [gap_sd(z, c.argmax(-1)) for z, c in zip(ref, logits)]
            out[key] = _numbers(gaps)
        if control_logits is not None:
            out["control"] = _numbers([gap_sd(z, c.to(z.device).argmax(-1))
                                       for z, c in zip(ref, control_logits)])
    return out


# -- CTC ----------------------------------------------------------------------
def collapse(path: np.ndarray, blank: int, pad: int, max_len: int
             ) -> np.ndarray:
    """Greedy CTC collapse as served: blanks and pads dropped, a token
    equal to the previous kept one dropped (across blanks), cut at
    `max_len`."""
    out, prev = [], None
    for tok in path:
        if tok in (blank, pad):
            continue
        if tok != prev:
            out.append(tok)
        prev = tok
    return np.asarray(out[:max_len], dtype=np.int64)


def ctc_path_gap(cost: torch.Tensor, y: np.ndarray, blank: int, pad: int,
                 max_len: int) -> Tuple[float, float, float]:
    """cost [T, V] (gap_sd of each class at each valid frame); y the
    served transcript. Over the frame paths that collapse to y: the least
    largest cost on a path, and the least summed cost and summed squared
    cost of a path, per token of y (INF if no path does)."""
    n = len(y)
    if any(t in (blank, pad) for t in y) or any(
            y[j] == y[j - 1] for j in range(1, n)) or (
            n and (y.min() < 0 or y.max() >= cost.shape[1])):
        return INF, INF, INF
    truncated = n == max_len
    stay_free = torch.minimum(cost[:, blank], cost[:, pad]).cpu().numpy()
    on_y = cost[:, torch.as_tensor(y, device=cost.device)].cpu().numpy()
    dp = np.full(n + 1, INF)
    dp[0] = 0.0
    tot, sq = dp.copy(), dp.copy()
    for t in range(len(cost)):
        stay = np.empty(n + 1)
        stay[0] = stay_free[t]
        stay[1:] = np.minimum(stay_free[t], on_y[t])
        if truncated:
            stay[n] = 0.0
        new = np.maximum(dp, stay)
        new[1:] = np.minimum(new[1:], np.maximum(dp[:-1], on_y[t]))
        dp = new
        new = tot + stay
        new[1:] = np.minimum(new[1:], tot[:-1] + on_y[t])
        tot = new
        new = sq + stay * stay
        new[1:] = np.minimum(new[1:], sq[:-1] + on_y[t] ** 2)
        sq = new
    return float(dp[n]), float(tot[n]) / max(n, 1), float(sq[n]) / max(n, 1)


def ctc_readings(w, enc: dict, talkers: int, ids: dict,
                 wavs: List[np.ndarray], served: List[List[np.ndarray]],
                 n_samples: int, max_len: int, device,
                 control_bits: Optional[int] = None) -> dict:
    """served[i][k]: talker k's transcript of recording i. {"program":
    numbers} over every served transcript: the widest gap of its best
    path, and its least summed gap per token, averaged over the tokens;
    with `control_bits` also {"control": numbers}, those of the
    transcripts the reference computes in that precision."""
    blank, pad = ids["blank"], ids["pad"]
    out = {}
    with float32_exact():
        mixed, mask0, _, _ = ref_wavlm.encode_rows(w, enc, wavs, n_samples,
                                                   device)
        heads = ref_sep.head_logits(w, talkers, mixed)
        ctrl = None
        if control_bits:
            cm, _, _, _ = ref_wavlm.encode_rows(w, enc, wavs, n_samples,
                                                device, quant=control_bits)
            ctrl = ref_sep.head_logits(w, talkers, cm, quant=control_bits)
        found = {"program": [], "control": []}
        for i in range(len(wavs)):
            Tv = int(mask0[i].sum())
            for k in range(talkers):
                z = heads[k][i, :Tv]
                cost = ((z.max(-1, keepdim=True).values - z)
                        / z.std(-1, keepdim=True))
                y = np.asarray(served[i][k])
                found["program"].append(
                    (*ctc_path_gap(cost, y, blank, pad, max_len), len(y)))
                if ctrl is not None:
                    y = collapse(ctrl[k][i, :Tv].argmax(-1).cpu().numpy(),
                                 blank, pad, max_len)
                    found["control"].append(
                        (*ctc_path_gap(cost, y, blank, pad, max_len), len(y)))
        for key, rows in found.items():
            if rows:
                n = sum(r[3] for r in rows)
                out[key] = {"max_gap_sd": max(r[0] for r in rows),
                            "mean_gap_sd": sum(r[1] * r[3] for r in rows)
                            / max(n, 1),
                            "msq_gap_sd": sum(r[2] * r[3] for r in rows)
                            / max(n, 1), "tokens": n}
    return out
