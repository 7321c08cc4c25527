"""Device times of the CTC kernels #11 (alpha) and #12 (beta + log-posterior)
on random lattices, each call captured 20 times in one CUDA graph
(`timing.graph_ms`), with the time a step (graph ms / T, in ns):

* the hybrid path's shape, B = 16, T = 499, S = 21 (10 labels), and B = 32
  (both CTC heads' rows in one launch);
* longer labels at T = 499: S = 71 (35 labels, about what a 10 s talker's
  LLaMA-3 tokens give), S = 201 (full lengths and the ragged rows of
  `chip_smoke.py`) and S = 1023, the largest lattice a launch takes;
* a T sweep at S = 21 (T = 125, 250, 499, 1000) whose least-squares slope
  is the time a step;
* with `--routes`, each route the wrapper can launch for the lattice
  (`ctc.ctc_routes`: K positions a lane, and past one warp the halo lanes
  a warp, which set the warps a row) forced in turn.

Beside each time: the largest error against the plain version, whether it
is within the smoke's rtol 1e-5 + atol 1e-4, and whether a second launch
(and a forced route) gives the default route's bits. With `--ptxas`, first
the registers and spills of every kernel of `csrc/ctc.cu` as `nvcc -Xptxas
-v` reports them.

    python -m mtasr_tpu_torch.tools.ctc_probe [--ptxas] [--routes]

Prints one JSON line; needs a CUDA device."""
from __future__ import annotations

import argparse
import contextlib
import json

import torch

from mtasr_tpu_torch.ops.kernels import ctc as kc
from mtasr_tpu_torch.tools.flash_bwd_probe import ptxas_report
from mtasr_tpu_torch.tools.timing import graph_ms

RTOL, ATOL = 1e-5, 1e-4
V = 64          # vocabulary of the random log-probs
# (name, B, T, labels, ragged)
CASES = (("S21", 16, 499, 10, False), ("S21_B32", 32, 499, 10, False),
         ("S71", 16, 499, 35, False), ("S201", 16, 499, 100, False),
         ("S201_ragged", 16, 499, 100, True), ("S1023", 16, 499, 511, False))
T_SWEEP = (125, 250, 499, 1000)


def lattice_inputs(g, B, T, L, ragged):
    """(emit [B, T, 2L+1] f32, ilen, llen int32 [B], allow [B, 2L+1]) from
    random log-probs; ragged: input lengths from T down to 1, label lengths
    from L down to 0, a row of one repeated id and an impossible row."""
    lp = torch.log_softmax(
        torch.randn((B, T, V), generator=g, device="cuda") * 2, -1)
    labels = torch.randint(1, V, (B, L), generator=g, device="cuda")
    ilen = torch.full((B,), T, dtype=torch.int32, device="cuda")
    llen = torch.full((B,), L, dtype=torch.int32, device="cuda")
    if ragged:
        ilen.copy_(torch.linspace(T, 1, B, device="cuda").int())
        llen.copy_(torch.linspace(L, 0, B, device="cuda").int())
        labels[1] = labels[1, 0]
        ilen[2], llen[2] = L // 2, L
    ext, allow = kc.lattice(labels, 0, V)
    emit = lp.gather(2, ext[:, None].expand(-1, T, -1)).contiguous()
    return emit, ilen, llen, allow


def run_both(emit, ilen, llen, allow):
    alpha, final = kc.ctc_alpha(emit, ilen, llen, allow)
    return alpha, final, kc.ctc_beta_post(emit, alpha, ilen, llen, allow)


def errors(outs, refs):
    """(largest |out - ref| over the three outputs, all within tolerance)."""
    err, ok = 0.0, True
    for o, r in zip(outs, refs):
        d = (o - r).abs()
        err = max(err, float(d.max()))
        ok = ok and not bool((d > ATOL + RTOL * r.abs()).any())
    return err, ok


def times(emit, ilen, llen, allow, alpha):
    T = emit.shape[1]
    a_ms = graph_ms(lambda: kc.ctc_alpha(emit, ilen, llen, allow))
    b_ms = graph_ms(lambda: kc.ctc_beta_post(emit, alpha, ilen, llen, allow))
    return {"alpha_graph_ms": a_ms, "beta_post_graph_ms": b_ms,
            "alpha_ns_step": 1e6 * a_ms / T,
            "beta_post_ns_step": 1e6 * b_ms / T}


@contextlib.contextmanager
def forced(K, H):
    """The wrapper launches route (K, halo H) inside."""
    plan = kc.ctc_plan
    kc.ctc_plan = lambda S, T: kc.plan_for(S, T, K, H)
    try:
        yield
    finally:
        kc.ctc_plan = plan


def probe_case(g, B, T, L, ragged, routes: bool):
    emit, ilen, llen, allow = lattice_inputs(g, B, T, L, ragged)
    outs = run_both(emit, ilen, llen, allow)
    a_ref, f_ref = kc.ctc_alpha_plain(emit, ilen, llen, allow)
    p_ref = kc.ctc_beta_post_plain(emit, outs[0], ilen, llen, allow)
    err, ok = errors(outs, (a_ref, f_ref, p_ref))
    again = run_both(emit, ilen, llen, allow)
    row = {"B": B, "T": T, "S": emit.shape[2], "ragged": ragged,
           "max_abs_err": err, "within_tol": ok,
           "same_bits_twice": all(torch.equal(x, y)
                                  for x, y in zip(outs, again))}
    row["plan"] = list(kc.ctc_plan(emit.shape[2], T))
    row.update(times(emit, ilen, llen, allow, outs[0]))
    if routes:
        for K, H in kc.ctc_routes(emit.shape[2]):
            with forced(K, H):
                o = run_both(emit, ilen, llen, allow)
                r = {"same_bits_as_default": all(
                    torch.equal(x, y) for x, y in zip(o, outs))}
                r.update(times(emit, ilen, llen, allow, outs[0]))
            r["warps"] = kc.plan_for(emit.shape[2], T, K, H).warps
            row[f"K{K}_H{H}"] = r
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--routes", action="store_true",
                    help="time every route the lattice can take")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.ptxas:
        print(ptxas_report("ctc"), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0)}
    for name, B, T, L, ragged in CASES:
        out[name] = probe_case(g, B, T, L, ragged, args.routes)
    sweep = {}
    for T in T_SWEEP:
        emit, ilen, llen, allow = lattice_inputs(g, 16, T, 10, False)
        alpha, _ = kc.ctc_alpha(emit, ilen, llen, allow)
        sweep[T] = times(emit, ilen, llen, allow, alpha)
    out["T_sweep"] = sweep
    for k in ("alpha", "beta_post"):
        ts = [float(t) for t in T_SWEEP]
        ms = [sweep[t][f"{k}_graph_ms"] for t in T_SWEEP]
        mt, mm = sum(ts) / len(ts), sum(ms) / len(ms)
        slope = sum((t - mt) * (m - mm) for t, m in zip(ts, ms)) / \
            sum((t - mt) ** 2 for t in ts)
        out[f"{k}_ns_step_slope"] = 1e6 * slope
        out[f"{k}_intercept_ms"] = mm - slope * mt
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
