#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`mtasr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only-family    # phases 1, 2 and 14 alone; its
                                           # last line {"ok": true, "only":
                                           # "family"}

Phases, one line each, any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi); no CUDA device
   is a failure, nothing falls back to the CPU;
2. build: compile the seven kernel libraries of `mtasr_tpu_torch/csrc/`,
   one `nvcc` each, all started together;
3. kernels: each kernel against its plain PyTorch version at the served
   paths' shapes (B = 8, 10 s audio, WavLM-Large + LLaMA-3.2-1B; the chunk
   kernels at L = 8 and 16 over a full cache), with the error against a
   stated tolerance and both times; the decode kernels (#4, #6) also at
   B = 64 (#4 beside SDPA), and the cluster size each launched at each
   batch; #7 also at B = 64, L = 16 over S = 1000 slots;
4. serve (bf16): three `Transcriber.transcribe` calls of 8 padded 6-10 s
   waveforms each, at full width with random bf16 weights from a seeded
   generator, up to 150 new tokens; the kernels' launch counts, set to 0
   just before and read just after, prove the run went through them; then
   the encode / prefill / decode breakdown and the RTFx;
5. model (bf16): the whole model with kernels against the whole model with
   the plain versions, on one batch: the logits of the prefill and of the
   first decode steps (the plain run fed the kernel run's tokens) within a
   bf16 tolerance, and the greedy-token agreement;
6. short prefill (bf16): one request of 8 waveforms of about 1 s in a 1 s
   bucket, a prefill of 8 positions at cache offset 0, which runs the chunk
   kernel (#5); the kernel held against its plain version on the inputs
   that prefill gave it (copied at each call), which the JSON reports, and
   the model's logits gated kernels vs plain on that batch;
7. int8 serve: the same model quantized w8a8 (decoder) with an int8 KV
   cache, two calls of 8 padded 6-10 s waveforms through the int8 decode
   kernel (#6), the breakdown and the RTFx beside bf16's; the int8 logits
   against bf16's; the decoder's int8 kernels against their plain versions
   (prefill and 8 decode steps, the encoder's kernels on both sides); the
   short-prefill request of phase 6 through the int8 chunk kernel (#7);
8. train kernels: the flash backward kernels #8-#10 against
   `flash_attention_bwd_plain` at the training path's shapes (B = 16,
   T = S = 499, 16 heads of 64, one short row, WavLM's row-padded table)
   and against their own second launch, bit for bit, beside two
   yardsticks: `torch.autograd.grad` of SDPA with the materialised bias,
   forward and backward, and its backward alone;
9. train: WavLM-Large + LLaMA-3.2-1B from seed 0 with the reference
   recipe's trainability (decoder frozen with LoRA r 16 / alpha 32 on
   q/k/v/o, the encoder training but its conv feature extractor,
   enc_to_dec_proj, masked AdamW with linear warmup 2) through `Trainer`:
   the encoder's gradients with kernels against the plain versions on one
   deterministic step, then one untimed step and TRAIN_STEPS timed ones on
   a fixed batch of 16 x 10 s (SpecAugment 0.05, default dropouts), with
   the launch counts, samples/s, ms/step, peak memory and a falling loss;
10. CTC kernels: #11 (alpha) and #12 (beta + log-posterior) against their
    plain versions and their own second launch at the hybrid path's
    lattice (B = 16, T = 499, S = 21), at 35-id labels (S = 71) and on a
    ragged long-label one (S = 201; there every route of the kernels, and
    chunks of 1-2 steps with the L2 cache flushed, against the plan's
    bits), each with its CUDA-graph time and its time a step, beside the
    yardstick `F.ctc_loss` (forward for #11, forward and backward for #12)
    on the same log-probs over the CTC head's 128265 outputs;
11. hybrid train: the JAX bench's flagship recipe through `Trainer`
    (hybrid SOT+CTC at ctc_alpha 0.7, the separator, two CTC heads of
    128265 outputs, PCGrad, the decoder frozen with LoRA): the encoder,
    separator and CTC-head gradients with kernels against the plain
    versions on one deterministic step, then 1 untimed and TRAIN_STEPS
    timed steps on the fixed batch with the exact launch counts, ms/step,
    samples/s, peak memory, falling loss, loss_attn and loss_ctc, and the
    per-head gradient norms;
12. CTC serve: `Transcriber.transcribe_ctc` (the one-shot CTC decode) at
    full width on 8 padded 6-10 s waveforms, two calls, with the launch
    counts; the CTC heads' logits with kernels against the plain versions
    within the bf16 whole-model gate; K strings per input;
13. model dirs, at full width (bf16, seed 0) in a temporary directory,
    each leg with the launch counts set to 0 just before it and read just
    after: (1) `save_model`, then `Transcriber.from_pretrained` on the
    card: the parameters bit-equal and the greedy tokens of 8 padded 6-10
    s waveforms identical to the in-memory model's (#1-#4 launch), with
    the save and load GB/s; (3) HF-layout WavLM and LLaMA directories
    (LLaMA-3.2-1B's 128256 rows, tied head) from the same weights,
    assembled by the create CLI's `create_from_pretrained`: every grafted
    tensor bit-equal to its source, the 8 grown rows equal to the mean
    row; (2) `from_pretrained(quantize="w8a8", kv_quant=True)`, the
    streamed load: int8 weights and scales bit-equal to the in-memory
    model after `quantize_for_serving`, tokens identical, the peak device
    memory inside the final footprint plus the largest tensor, beside
    load-then-quantize's (#6 launches); (4) `cli.finetune_asr` on a Kaldi
    directory of 8 generated 10 s waveforms (LoRA, decoder frozen, B = 4):
    4 steps straight, and 2 steps resumed to 4, on deterministic
    algorithms: the trainable tensors and AdamW moments of checkpoint-4
    bit-equal (within RESUME_TOL by rel-L2 where an op has no
    deterministic implementation), the checkpoint's size and write time
    (#8-#10 launch); (5) `cli.inference_asr --quantize w8a8 --kv_quant` and
    `--ctc_decoding` on a hybrid model directory over the same Kaldi
    directory: `label`, `decod` and `wer` written, the greedy hypotheses
    equal to `Transcriber.transcribe`'s; the phase's wall time;
14. the bridge and adapter family (`full_width.FAMILY`), on the hybrid
    model at full width, each leg with the launch counts set to 0 just
    before it and read just after: (A, bf16) the refiner, the CTC prompt
    and ctcaware adapters over CTC-token memory: two `transcribe` calls
    (#1-#4), the RTFx beside phase 4's without the family, the logits of
    the prefill and 8 decode steps kernels vs plain within LOGITS_TOL, and
    with the decoder's kernels alone (both sides read one encode, the CTC
    prompt's argmax ids included) within LOGITS_TOL_DECODER;
    (B) the raw bridge and adapgatetiny adapters (LoRA r 16) over the
    separated streams: one w8a8 + int8 KV `transcribe` call (#6; the
    family stays in bf16), then `Trainer` with PCGrad, decoder frozen with
    LoRA, B = 16 x 10 s: the encoder, separator and CTC-head gradients of
    one deterministic step kernels vs plain within HYBRID_GRAD_TOL and the
    family's own within FAMILY_GRAD_TOL, then 1 untimed and
    FAMILY_TRAIN_STEPS timed steps with their launch counts (#1-#3,
    #8-#12), ms/step, peak memory and a falling loss; (C, bf16) the
    softmax bridge and gatetiny adapters over the 50 Hz features: one
    `transcribe` call, the logits kernels vs plain within LOGITS_TOL.

Every kernel's record carries its error, its time, its plain version's
time, the least time the card could take (`bound_ms`, from the bytes the
function must move and the operations it must do at the H100's published
peaks) and, where one PyTorch call computes the same function, that call's
time (`library_ms`; the port never calls it). Every record also carries
`graph_ms` and `library_graph_ms`: the time a call of 20 captured in one
CUDA graph and replayed, on the device alone, where a short kernel's `ms`
is its wrapper's host time (`F.ctc_loss`, which a graph cannot hold, is
recorded in words); the backward kernels' records add SDPA's backward alone
(`library_bwd_ms`, `library_bwd_graph_ms`). The line before the last is
the kernels' JSON record; the last line is `{"ok": true, "device":
{...}}`. Imports nothing of JAX or of the JAX package `mtasr_tpu`: both
are blocked before anything is imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

SR = 16000
BATCH = 8
AUDIO_S = 10
MAX_NEW = 150
SEED = 0
GATE_STEPS = 8        # decode steps whose logits are held kernels vs plain
LOGITS_TOL = 0.05     # rel-L2 of bf16 logits, kernels vs plain versions
# the same, int8 leg, the decoder's kernels alone: sound kernels read 0
# (the w8a8 activation rounding absorbs their last-bit differences), #6 or
# #7 ignoring its mask 0.146 and 1.08 at the worst step
LOGITS_TOL_INT8 = 0.02
# the same, bf16, the decoder's kernels alone (phase 14, leg A: the CTC
# prompt's argmax ids flip with the encoder's rounding, so the whole-model
# gate reads the decoder on other inputs): sound kernels read 0-0.0091, #4
# ignoring its mask 0.0545 at the worst step (PERF.md, Findings)
LOGITS_TOL_DECODER = 0.02
SHORT_S = (0.8, 1.0)  # short-prefill waveforms, in a 1 s bucket
TRAIN_BATCH = 16
TRAIN_STEPS = 5       # timed steps, after one untimed
TRAIN_LR = 1e-4       # the JAX bench's training learning rate
# rel-L2 of the trainable encoder gradients, kernels vs plain versions,
# over all of them at once (one deterministic step): 2x the 0.0072-0.0074
# that sound kernels read at full width; #9 with p 1 % high read 0.0186
# (PERF.md, Findings)
GRAD_TOL = 0.015
# the same for the hybrid step's encoder, separator and CTC-head gradients
# (PCGrad's projected sum on the shared ones), kernels vs plain: about 2x
# the 0.0100-0.0135 that sound kernels read at full width (the plain side's
# cuDNN convolutions vary between runs); #11 or #12 ignoring the skip
# transition read 1.69 and 0.96 (PERF.md, Findings)
HYBRID_GRAD_TOL = 0.03
# the bridge and adapter family's own gradients (phase 14, leg B: the
# adapters), kernels vs plain, rel-L2 over all of them at once
FAMILY_GRAD_TOL = 0.03
FAMILY_TRAIN_STEPS = 2  # timed steps of phase 14's train leg, after one
# the parameter groups the hybrid gradient gates read: HYBRID_GRAD_TOL the
# first, FAMILY_GRAD_TOL the family's
GATE_TOPS = ("encoder", "separator", "serialized_ctc")
FAMILY_TOPS = ("cross_att_adap", "serilized_refine", "ctc_extractor_concat")
# kernels #11 / #12 against their plain versions: both run the same f32
# operations in the same order; the card's exp / log and ATen's differ in
# the last bit, which the T-step recursion carries
CTC_RTOL, CTC_ATOL = 1e-5, 1e-4
# the backward kernels against their plain version, in bf16 ulps at
# max|ref|: sound kernels read at most 0.5 at the training shapes, #9 with
# p 1 % high 3 (PERF.md, Findings)
BWD_ULPS = 2

# H100 SXM published peaks (dense): bf16 tensor cores, int8 tensor cores,
# f32 outside the tensor cores; HBM bandwidth
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def ulps_tol(ref, n_ulps: int) -> float:
    """n bf16 ulps (8-bit mantissa) at the largest magnitude of `ref`."""
    top = float(ref.abs().max())
    return n_ulps * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def device_phase(torch) -> str:
    if not torch.cuda.is_available():
        fail("no CUDA device (this smoke run needs an NVIDIA GPU)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    say(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def fmt_ms(t) -> str:
    return "none" if t is None else t if isinstance(t, str) else \
        f"{t:.4f} ms"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, n_ops: float, kind: str):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_S
    t_ops = 1e3 * n_ops / PEAK_OPS[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_err(torch, name, out, ref, n_ulps, step=0.0):
    """max |out - ref|, failing past n bf16 ulps at max|ref| plus `step`
    (the int8 kernels: one int8 step of p, which another order of the
    softmax's sums may round the other way). Returns (err, tol)."""
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        fail(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    err = float((out.float() - ref.float()).abs().max())
    tol = ulps_tol(ref.float(), n_ulps) + step
    if not math.isfinite(err) or err > tol:
        fail(f"{name}: max_abs_err {err} over tolerance {tol} at shape "
             f"{tuple(out.shape)}")
    return err, tol


def record(torch, card, records, name, source, replaces, err, why,
           run_kernel, run_plain, bound_ms, library=None, shape=(),
           library_no_graph=None, library_bwd=None):
    """Time the kernel, its plain version and the library call (median of
    5), and keep the record of `name` (the first one); then the kernel's
    and the library call's device time from a CUDA graph (`graph_ms`,
    `library_graph_ms`, or `library_no_graph`: in words, why the library
    call is not captured). `library_bwd` (fn, its forward's stream): a second
    yardstick, `library_bwd_ms` and `library_bwd_graph_ms`."""
    from mtasr_tpu_torch.tools.timing import cuda_ms, graph_ms
    ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
    lib_ms = None if library is None else cuda_ms(library)
    say(f"kernel {name}: max_abs_err {err:.6g} ({why}) kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms library {fmt_ms(lib_ms)} bound "
        f"{bound_ms[0]:.4f} ms ({bound_ms[1]}) shape {shape} [{card}]")
    g_ms = graph_ms(run_kernel)
    lib_g = None if library is None else \
        library_no_graph or graph_ms(library)
    records[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms[0],
                     "bound_by": bound_ms[1], "library_ms": lib_ms,
                     "graph_ms": g_ms, "library_graph_ms": lib_g}
    say(f"kernel {name}: in a CUDA graph kernel {fmt_ms(g_ms)} "
        f"({bound_ms[0] / g_ms:.3f} of its bound) "
        f"library {fmt_ms(lib_g)} [{card}]")
    if library_bwd is not None:
        fn, stream = library_bwd
        b_ms, b_g = cuda_ms(fn), graph_ms(fn, stream=stream)
        records[name].update(library_bwd_ms=b_ms, library_bwd_graph_ms=b_g)
        say(f"kernel {name}: library backward alone {fmt_ms(b_ms)}, in a "
            f"CUDA graph {fmt_ms(b_g)} [{card}]")


def compare(torch, card, records, name, source, replaces, run_kernel,
            run_plain, n_ulps, step=0.0, why="", keep=True, bound_ms=None,
            library=None):
    """Within n bf16 ulps at max|ref|, plus `step`. With `keep`, the error,
    the times (CUDA-graph times too) and `bound_ms` go into `records` (the
    first call of a name is kept). Returns the error."""
    out = run_kernel()
    err, tol = check_err(torch, name, out, run_plain(), n_ulps, step)
    if keep and name not in records:
        record(torch, card, records, name, source, replaces, err,
               f"tol {tol:.6g} = {n_ulps} bf16 ulp at max|ref|{why}",
               run_kernel, run_plain, bound_ms, library, tuple(out.shape))
    else:
        say(f"kernel {name}: max_abs_err {err:.6g} (tol {tol:.6g}) shape "
            f"{tuple(out.shape)}")
    return err


def sdpa_bias(torch, pos_bias, gate, kv_lens, S):
    """The gated bias [B, H, T, S] materialised in bf16, -inf past
    kv_len: what SDPA needs to compute the flash kernels' function."""
    valid = torch.arange(S, device=gate.device)[None] < kv_lens[:, None]
    bias = gate[..., None].float() * pos_bias[None].float()
    return bias.masked_fill(~valid[:, None, None, :], float("-inf")) \
        .to(torch.bfloat16)


def attention_ops(D, n_query_key_pairs):
    """q.k and p.v of every (query, head, valid key): 4 D operations."""
    return 4 * D * n_query_key_pairs


INT8_WHY = " + one int8 step of p, 127 * max sp"


def p_step(di, q, k8, v8, kvs, mask) -> float:
    """127 * the largest p scale of the int8 function on these inputs: one
    int8 step of p at most moves an output element by that much."""
    _, sp = di.int8_cache_attention(q, k8, v8, kvs, mask)
    return 127 * float(sp.max())


CHUNK_SOURCE = "mtasr_tpu_torch/csrc/decode_attention_chunk.cu"
INT8_SOURCE = "mtasr_tpu_torch/csrc/decode_attention_int8.cu"


def kernel_phase(torch, card: str, records):
    """Each kernel against its plain version at the served paths' shapes;
    the chunk kernels also at L = 8 and 16 over a full cache (the short
    prefill's own inputs are held in `captured_phase`)."""
    import torch.nn.functional as F
    from mtasr_tpu_torch.ops.kernels import conv_frontend as cf
    from mtasr_tpu_torch.ops.kernels import decode_attention as da
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    from mtasr_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    dev, bf = "cuda", torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def check(*args, **kw):
        return compare(torch, card, records, *args, **kw)

    # conv layer 0: 10 s of audio -> [8, 31999, 512]
    S = SR * AUDIO_S
    wave = randn(BATCH, S)
    w = randn(512, 1, 10, scale=10 ** -0.5)
    b, gm, bt = randn(512, scale=0.02), 1 + randn(512, scale=0.1), \
        randn(512, scale=0.05)
    T0 = (S - 10) // 5 + 1
    check("conv0_fused", "mtasr_tpu_torch/csrc/conv_frontend.cu",
          "mtasr_tpu/ops/pallas/conv_frontend.py:172",
          lambda: cf.conv0_fused(wave, w, b, gm, bt, stride=5),
          lambda: cf.conv0_plain(wave, w, b, gm, bt, stride=5), 1,
          bound_ms=bound(nbytes(wave, w, b, gm, bt) + BATCH * T0 * 512 * 2,
                         2 * BATCH * T0 * 512 * 10, "f32"))

    # encoder attention: T = S = 499 frames, 16 heads of 64, one short row
    T, H, D = 499, 16, 64
    q, k, v = randn(BATCH, T, H, D), randn(BATCH, T, H, D), \
        randn(BATCH, T, H, D)
    # the table as WavLM builds it once a forward: rows padded to 16 bytes
    pos_bias = fa.padded_bias(randn(H, T, T, scale=0.5))
    gate = (1 + torch.rand((BATCH, H, T), generator=g, device=dev)).to(bf)
    kv_lens = torch.full((BATCH,), T, dtype=torch.int32, device=dev)
    kv_lens[-1] = 300
    bias = sdpa_bias(torch, pos_bias, gate, kv_lens, T)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    check("flash_attention", "mtasr_tpu_torch/csrc/flash_attention.cu",
          "mtasr_tpu/ops/pallas/flash_attention.py:266",
          lambda: fa.flash_attention(q, k, v, kv_lens=kv_lens,
                                     pos_bias=pos_bias, gate=gate),
          lambda: fa.flash_attention_plain(q, k, v, kv_lens=kv_lens,
                                           pos_bias=pos_bias, gate=gate),
          4, bound_ms=bound(
              nbytes(q, k, v, pos_bias, gate, kv_lens, q),
              attention_ops(D, H * T * int(kv_lens.sum())), "bf16"),
          library=lambda: F.scaled_dot_product_attention(
              qh, kh, vh, attn_mask=bias))

    # decode step: LLaMA-1B heads, S_max = 1 + 63 + 150 = 214, one short row
    Hq, Hkv, S_max = 32, 8, 214
    qd = randn(BATCH, Hq, D)
    kc, vc = randn(BATCH, S_max, Hkv * D), randn(BATCH, S_max, Hkv * D)
    mask = torch.ones((BATCH, S_max), dtype=torch.bool, device=dev)
    mask[-1, 150:] = False
    kch, vch = (t.view(BATCH, S_max, Hkv, D).transpose(1, 2)
                for t in (kc, vc))
    check("decode_attention", "mtasr_tpu_torch/csrc/decode_attention.cu",
          "mtasr_tpu/ops/pallas/decode_attention.py:117",
          lambda: da.decode_attention(qd, kc, vc, mask),
          lambda: da.decode_attention_plain(qd, kc, vc, mask), 4,
          bound_ms=bound(nbytes(qd, kc, vc, mask, qd),
                         attention_ops(D, Hq * int(mask.sum())), "bf16"),
          library=lambda: F.scaled_dot_product_attention(
              qd[:, :, None], kch, vch, attn_mask=mask[:, None, None],
              enable_gqa=True))
    # the cluster size the wrapper passed to the last of those launches
    records["decode_attention"]["cluster"] = da.decode_attention.last_cluster
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"kernel decode_attention: a cluster of "
        f"{records['decode_attention']['cluster']} blocks a (b, kv head) at "
        f"B = {BATCH} on {sms} SMs [{card}]")
    decode_at_batch(torch, card, 64, Hq, Hkv, S_max, D, randn)

    # the int8 cache of the same K / V, quantized as the decoder writes it
    k8, v8, kvs = int8_kv(torch, kc, vc, Hkv, D)
    check("decode_attention_int8", INT8_SOURCE,
          "mtasr_tpu/ops/pallas/decode_attention.py:354",
          lambda: di.decode_attention_int8(qd, k8, v8, kvs, mask),
          lambda: di.decode_attention_int8_plain(qd, k8, v8, kvs, mask), 1,
          p_step(di, qd[:, None], k8, v8, kvs, mask[:, None]), INT8_WHY,
          bound_ms=bound(nbytes(qd, k8, v8, kvs, mask, qd),
                         attention_ops(D, Hq * int(mask.sum())), "int8"))
    records["decode_attention_int8"]["cluster"] = \
        di.decode_attention_int8.last_cluster
    say(f"kernel decode_attention_int8: a cluster of "
        f"{records['decode_attention_int8']['cluster']} blocks a (b, kv "
        f"head) at B = {BATCH} on {sms} SMs [{card}]")

    # chunks of L positions at the end of a full cache, causal
    for L in (8, 16):
        qc = randn(BATCH, L, Hq, D)
        mc = mask[:, None].repeat(1, L, 1)
        for pos in range(L):
            mc[:, pos, S_max - L + pos + 1:] = False
        check("decode_attention_chunk", CHUNK_SOURCE,
              "mtasr_tpu/ops/pallas/decode_attention.py:223",
              lambda: dc.decode_attention_chunk(qc, kc, vc, mc),
              lambda: dc.decode_attention_chunk_plain(qc, kc, vc, mc), 4,
              keep=False)
        check("decode_attention_int8_chunk", CHUNK_SOURCE,
              "mtasr_tpu/ops/pallas/decode_attention.py:443",
              lambda: dc.decode_attention_int8_chunk(qc, k8, v8, kvs, mc),
              lambda: dc.decode_attention_int8_chunk_plain(qc, k8, v8, kvs,
                                                           mc),
              1, p_step(di, qc, k8, v8, kvs, mc), INT8_WHY, keep=False)
    chunk_int8_at(torch, card, 64, 16, Hq, Hkv, 1000, D, randn)


def chunk_int8_at(torch, card: str, B, L, Hq, Hkv, S, D, randn):
    """#7 at a headline batch over a long cache (all S staged at once, the
    scores in registers): its error against its plain version, the same
    bits on a second launch, its device time in a CUDA graph and its
    bound; printed, not kept."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    from mtasr_tpu_torch.tools.timing import graph_ms
    q = randn(B, L, Hq, D)
    k8, v8, kvs = int8_kv(torch, randn(B, S, Hkv * D), randn(B, S, Hkv * D),
                          Hkv, D)
    mask = torch.ones((B, L, S), dtype=torch.bool, device=q.device)
    for pos in range(L):
        mask[:, pos, S - L + pos + 1:] = False
    mask[-1, :, S // 2:S - L] = False

    def run():
        return dc.decode_attention_int8_chunk(q, k8, v8, kvs, mask)
    out = run()
    err, tol = check_err(
        torch, "decode_attention_int8_chunk", out,
        dc.decode_attention_int8_chunk_plain(q, k8, v8, kvs, mask), 1,
        p_step(di, q, k8, v8, kvs, mask))
    if not torch.equal(run(), out):
        fail(f"decode_attention_int8_chunk at B = {B}, S = {S}: a second "
             "launch gave other bits")
    b_ms, b_by = bound(nbytes(q, k8, v8, kvs, mask, q),
                       attention_ops(D, Hq * int(mask.sum())), "int8")
    g_k = graph_ms(run)
    say(f"kernel decode_attention_int8_chunk at B = {B}, S = {S}: plan "
        f"{tuple(dc.chunk_int8_plan(L, S, D, Hq // Hkv))} max_abs_err "
        f"{err:.6g} (tol {tol:.6g}{INT8_WHY}) in a CUDA graph kernel "
        f"{fmt_ms(g_k)} library none bound {b_ms:.4f} ms ({b_by}; "
        f"{b_ms / g_k:.3f} of it) shape {(B, L, Hq, S, D)} [{card}]")


def int8_kv(torch, kc, vc, Hkv, D):
    """The int8 cache of bf16 K / V [B, S, Hkv * D], quantized by the
    decoder's own KV quantizer, with the k / v scale rows interleaved per
    kv head as the decoder writes them."""
    from mtasr_tpu_torch.models.llama import _quantize_kv
    B, S = kc.shape[:2]
    k8, ks = _quantize_kv(kc.reshape(B, S, Hkv, D))
    v8, vs = _quantize_kv(vc.reshape(B, S, Hkv, D))
    kvs = torch.stack([ks, vs], -1).reshape(B, S, 2 * Hkv) \
        .transpose(1, 2).contiguous()
    return k8.reshape(kc.shape), v8.reshape(vc.shape), kvs


def decode_at_batch(torch, card: str, B, Hq, Hkv, S, D, randn):
    """#4 and #6 at a headline batch (a cluster of fewer blocks a (b, kv
    head)): each one's error against its plain version, its device time in
    a CUDA graph (#4 beside SDPA's on the same inputs), its bound and the
    cluster size it launched; printed, not kept."""
    import torch.nn.functional as F
    from mtasr_tpu_torch.ops.kernels import decode_attention as da
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    from mtasr_tpu_torch.tools.timing import graph_ms
    q = randn(B, Hq, D)
    kc, vc = randn(B, S, Hkv * D), randn(B, S, Hkv * D)
    mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    mask[-1, 150:] = False
    kh, vh = (t.view(B, S, Hkv, D).transpose(1, 2) for t in (kc, vc))
    out = da.decode_attention(q, kc, vc, mask)
    C = da.decode_attention.last_cluster
    err, tol = check_err(torch, "decode_attention", out,
                         da.decode_attention_plain(q, kc, vc, mask), 4)
    g_k = graph_ms(lambda: da.decode_attention(q, kc, vc, mask))
    g_l = graph_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kh, vh, attn_mask=mask[:, None, None],
        enable_gqa=True))
    b_ms, b_by = bound(nbytes(q, kc, vc, mask, q),
                       attention_ops(D, Hq * int(mask.sum())), "bf16")
    say(f"kernel decode_attention at B = {B}: cluster "
        f"{C} max_abs_err {err:.6g} (tol "
        f"{tol:.6g}) in a CUDA graph kernel {fmt_ms(g_k)} library (SDPA) "
        f"{fmt_ms(g_l)} bound {b_ms:.4f} ms ({b_by}; {b_ms / g_k:.3f} of "
        f"it) shape {(B, Hq, S, D)} [{card}]")
    k8, v8, kvs = int8_kv(torch, kc, vc, Hkv, D)
    out = di.decode_attention_int8(q, k8, v8, kvs, mask)
    C = di.decode_attention_int8.last_cluster
    err, tol = check_err(
        torch, "decode_attention_int8", out,
        di.decode_attention_int8_plain(q, k8, v8, kvs, mask), 1,
        p_step(di, q[:, None], k8, v8, kvs, mask[:, None]))
    g_k = graph_ms(lambda: di.decode_attention_int8(q, k8, v8, kvs, mask))
    b_ms, b_by = bound(nbytes(q, k8, v8, kvs, mask, q),
                       attention_ops(D, Hq * int(mask.sum())), "int8")
    say(f"kernel decode_attention_int8 at B = {B}: cluster {C} "
        f"max_abs_err {err:.6g} (tol {tol:.6g}{INT8_WHY}) in a CUDA graph "
        f"kernel {fmt_ms(g_k)} library none bound {b_ms:.4f} ms ({b_by}; "
        f"{b_ms / g_k:.3f} of it) shape {(B, Hq, S, D)} [{card}]")


def captured_phase(torch, card: str, records, calls) -> None:
    """The chunk kernels against their plain versions on the very inputs
    that the served short prefill passed them (every decoder layer's q,
    cache, scales and mask, copied at the call); the JSON takes these."""
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    if not calls:
        fail("the short prefill made no chunk-kernel call to check")
    import torch.nn.functional as F
    for name, args in calls:
        q = args[0]
        B, L, Hq, D = q.shape
        mc = args[-1]
        ops = attention_ops(D, Hq * int(mc.sum()))
        if name == "decode_attention_chunk":
            q, kc, vc, mc = args
            S_max, Hkv = kc.shape[1], kc.shape[2] // D
            kch, vch = (t.view(B, S_max, Hkv, D).transpose(1, 2)
                        for t in (kc, vc))
            err = compare(
                torch, card, records, name, CHUNK_SOURCE,
                "mtasr_tpu/ops/pallas/decode_attention.py:223",
                lambda: dc.decode_attention_chunk(q, kc, vc, mc),
                lambda: dc.decode_attention_chunk_plain(q, kc, vc, mc), 4,
                bound_ms=bound(nbytes(q, kc, vc, mc, q), ops, "bf16"),
                library=lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kch, vch, attn_mask=mc[:, None],
                    enable_gqa=True))
        else:
            q, k8, v8, kvs, mc = args
            err = compare(
                torch, card, records, name, CHUNK_SOURCE,
                "mtasr_tpu/ops/pallas/decode_attention.py:443",
                lambda: dc.decode_attention_int8_chunk(q, k8, v8, kvs, mc),
                lambda: dc.decode_attention_int8_chunk_plain(q, k8, v8, kvs,
                                                             mc),
                1, p_step(di, q, k8, v8, kvs, mc), INT8_WHY,
                bound_ms=bound(nbytes(q, k8, v8, kvs, mc, q), ops, "int8"))
            if not torch.equal(
                    dc.decode_attention_int8_chunk(q, k8, v8, kvs, mc),
                    dc.decode_attention_int8_chunk(q, k8, v8, kvs, mc)):
                fail(f"{name}: a second launch gave other bits")
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           err)
    say(f"captured: {len(calls)} chunk-kernel calls of the served short "
        f"prefill held against their plain versions (S_max "
        f"{calls[0][1][1].shape[1]}, chunk at cache offset 0)")


def expected_counts(cfg, steps, short: bool, int8: bool):
    """Launches of each kernel for `len(steps)` generate calls of `steps`
    decode steps each: conv0 once and flash once per encoder layer per
    call; a decode kernel per decoder layer per step; a chunk kernel per
    decoder layer per prefill of at most 16 positions."""
    from mtasr_tpu_torch.ops import kernels
    L_enc = cfg.encoder.num_hidden_layers
    L_dec = cfg.decoder.num_hidden_layers
    out = dict.fromkeys(kernels.WRAPPERS, 0)
    out["conv0_fused"] = len(steps)
    out["flash_attention"] = L_enc * len(steps)
    out["decode_attention_int8" if int8 else "decode_attention"] = \
        L_dec * sum(steps)
    if short:
        out["decode_attention_int8_chunk" if int8 else
            "decode_attention_chunk"] = L_dec * len(steps)
    return out


def serve_phase(torch, card: str, cfg, transcriber, requests, tag: str,
                short: bool = False, captured=None):
    """`transcriber.transcribe` on each request, with the launch counts set
    to 0 just before and read just after; fails unless each kernel of the
    path launched exactly as often as the path needs. With `captured` (a
    list), every chunk-kernel call appends (name, copies of its inputs).
    Returns (counts, RTFx over the calls after the first)."""
    from unittest import mock

    import mtasr_tpu_torch.api as api_mod
    import mtasr_tpu_torch.models.llama as llama_mod
    from mtasr_tpu_torch.ops import kernels

    steps = []
    real_generate = api_mod.generate
    stack = contextlib.ExitStack()
    for name in (("decode_attention_chunk", "decode_attention_int8_chunk")
                 if captured is not None else ()):
        def recording(*args, _name=name, _fn=getattr(llama_mod, name)):
            captured.append((_name, [a.clone() for a in args]))
            return _fn(*args)
        stack.enter_context(mock.patch.object(llama_mod, name, recording))

    def recording_generate(*a, **kw):
        out = real_generate(*a, **kw)
        if out.sequences.shape[1] != MAX_NEW:
            fail(f"sequences {tuple(out.sequences.shape)}")
        steps.append(out.steps)
        return out

    walls, audio_s = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with stack, mock.patch.object(api_mod, "generate", recording_generate):
        for wavs in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts = transcriber.transcribe(wavs, batch_size=BATCH,
                                           max_new_tokens=MAX_NEW)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            audio_s.append(sum(len(w) for w in wavs) / SR)
            if len(texts) != BATCH or not all(isinstance(t, str)
                                              for t in texts):
                fail(f"{tag}: transcribe returned a malformed result")
    counts = kernels.launch_counts()
    expect = expected_counts(cfg, steps, short,
                             transcriber.gen.kv_quant)
    say(f"serve[{tag}]: {len(requests)} requests x {BATCH} waveforms, walls "
        f"{[round(x, 3) for x in walls]} s, audio "
        f"{[round(a, 2) for a in audio_s]} s, decode steps {steps}, launches "
        f"{counts}")
    if counts != expect or sum(steps) == 0:
        fail(f"{tag}: launch counts {counts} != expected {expect}")
    warm = slice(1, None) if len(walls) > 1 else slice(None)
    rtfx = sum(audio_s[warm]) / sum(walls[warm])
    say(f"serve[{tag}]: RTFx {rtfx:.2f} (calls after the first; call 1 "
        f"{audio_s[0] / walls[0]:.2f}) B={BATCH} [{card}]")
    return counts, rtfx


@contextlib.contextmanager
def plain_versions(enabled: bool = True, decoder_only: bool = False):
    """While enabled, the model calls the kernels' plain versions (with
    decoder_only, the decoder's alone: the encoder keeps its kernels)."""
    from unittest import mock

    import mtasr_tpu_torch.models.llama as llama_mod
    import mtasr_tpu_torch.models.wavlm as wavlm_mod
    import mtasr_tpu_torch.ops.ctc_fused as ctc_fused
    from mtasr_tpu_torch.ops.kernels import (
        conv_frontend as cf, ctc as kc, decode_attention as da,
        decode_attention_chunk as dc, decode_attention_int8 as di,
        flash_attention as fa,
    )
    if not enabled:
        yield
        return
    patches = [] if decoder_only else [
        (wavlm_mod, "conv0_fused", cf.conv0_plain),
        (wavlm_mod, "flash_attention", fa.flash_attention_plain),
        (ctc_fused, "ctc_alpha", kc.ctc_alpha_plain),
        (kc, "ctc_alpha", kc.ctc_alpha_plain),
        (kc, "ctc_beta_post", kc.ctc_beta_post_plain)]
    patches += [(llama_mod, "decode_attention", da.decode_attention_plain),
               (llama_mod, "decode_attention_int8",
                di.decode_attention_int8_plain),
               (llama_mod, "decode_attention_chunk",
                dc.decode_attention_chunk_plain),
               (llama_mod, "decode_attention_int8_chunk",
                dc.decode_attention_int8_chunk_plain)]
    with contextlib.ExitStack() as stack:
        for mod, name, fn in patches:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def one_batch(torch, transcriber, wavs):
    batch = next(iter(transcriber._batches(
        transcriber._examples(wavs, ""), BATCH)))
    return (torch.from_numpy(batch.arrays["input_values"]).cuda(),
            torch.from_numpy(batch.arrays["audio_mask"]).cuda())


def breakdown_phase(torch, card: str, cfg, model, transcriber,
                    wavs, plain=False):
    """Encode / prefill / decode of one batch, each timed to a synchronize.
    With plain=True the model runs the kernels' plain versions."""
    from mtasr_tpu_torch.generate import engine

    wav, amask = one_batch(torch, transcriber, wavs)
    gen = transcriber.gen
    with plain_versions(plain), torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = engine.encode_maybe_chunked(model, cfg, wav, amask, None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ids, splice = engine.prompt_layout(cfg, BATCH, None, wav.device)
        S_max = ids.shape[1] + enc.encoder_hidden_states.shape[1] + MAX_NEW
        cache, last, n_valid, total = engine._prefill(
            model, cfg, enc, ids, splice, S_max, gen.kv_quant)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = engine._decode(model, cfg, cache, last.clone(), n_valid,
                             ids.shape[1], total,
                             enc.encoder_hidden_states.dtype, gen, MAX_NEW,
                             None)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    speech = enc.encoder_hidden_states
    if not (torch.isfinite(speech).all() and torch.isfinite(last).all()):
        fail("non-finite encoder output or logits")
    T8 = cfg.encoder.adapter_output_length(
        cfg.encoder.conv_output_length(wav.shape[1]))
    if tuple(speech.shape) != (BATCH, T8, cfg.decoder.hidden_size) or \
            tuple(last.shape) != (BATCH, cfg.decoder.vocab_size):
        fail(f"shapes: speech {tuple(speech.shape)} logits "
             f"{tuple(last.shape)}")
    lengths = out.lengths.cpu().numpy()
    if not ((lengths >= 1) & (lengths <= MAX_NEW)).all():
        fail(f"lengths {lengths}")
    audio = float(amask.sum()) / SR
    wall = t3 - t0
    tag = ("int8 " if gen.kv_quant else "") + ("plain" if plain else
                                               "kernels")
    say(f"breakdown[{tag}]: encode {t1 - t0:.4f} s, prefill {t2 - t1:.4f} s,"
        f" decode {1000 * (t3 - t2) / max(out.steps, 1):.3f} ms/step over "
        f"{out.steps} steps, RTFx {audio / wall:.2f} ({audio:.2f} s audio "
        f"in {wall:.3f} s) B={BATCH} [{card}]")
    return speech.float(), last.float(), out.sequences


def step_logits(torch, cfg, model, gen, wav, amask, tokens=None,
                plain=False, decoder_only=False):
    """Logits [1 + GATE_STEPS, B, V] of the prefill and the first decode
    steps of `generate`, and the tokens it chose. With `tokens` given, step
    t is fed tokens[:, t] (teacher forcing), so that a second run can be
    compared with the first step by step."""
    from unittest import mock

    from mtasr_tpu_torch.generate import engine
    seen = []

    def sample(logits, gen, generator):
        seen.append(logits.float())
        t = len(seen) - 1
        return logits.argmax(-1) if tokens is None else tokens[:, t]

    with plain_versions(plain, decoder_only), \
            mock.patch.object(engine, "_sample_token", sample):
        out = engine.generate(model, cfg, wav, amask, gen=gen,
                              max_new_tokens=GATE_STEPS + 1)
    return torch.stack(seen), out.sequences


def logits_phase(torch, cfg, model, transcriber, wavs, tag: str,
                 decoder_too: bool = False) -> None:
    """The model with kernels against the model with the plain versions:
    rel-L2 of the logits at the prefill and at each of the first GATE_STEPS
    decode steps, each within the gate. bf16: the whole model, within
    LOGITS_TOL, and with decoder_too also the decoder's kernels alone,
    within LOGITS_TOL_DECODER. int8: the decoder's kernels alone (both
    sides run the encoder's kernels, so its bf16 differences, which w8a8
    amplifies, do not enter), within LOGITS_TOL_INT8. Every reading is
    printed before any is gated. Fails unless the kernel run launched the
    leg's decode kernel and each plain run none of the kernels it
    replaced."""
    from mtasr_tpu_torch.ops import kernels
    wav, amask = one_batch(torch, transcriber, wavs)
    gen = transcriber.gen
    int8 = gen.kv_quant
    n0 = kernels.launch_counts()
    lk, toks = step_logits(torch, cfg, model, gen, wav, amask)
    n1 = kernels.launch_counts()
    step_kernel = "decode_attention_int8" if int8 else "decode_attention"
    if n1[step_kernel] == n0[step_kernel] or lk.shape[0] != GATE_STEPS + 1 \
            or not bool(torch.isfinite(lk).all()):
        fail(f"{tag}: the kernel run took the wrong route (launches {n0} -> "
             f"{n1}) or gave {tuple(lk.shape)} logits or non-finite values")
    legs = [(True, LOGITS_TOL_INT8)] if int8 else [(False, LOGITS_TOL)]
    if decoder_too and not int8:
        legs.append((True, LOGITS_TOL_DECODER))
    over = []
    for decoder_only, tol in legs:
        n1 = kernels.launch_counts()
        lp, _ = step_logits(torch, cfg, model, gen, wav, amask, tokens=toks,
                            plain=True, decoder_only=decoder_only)
        n2 = kernels.launch_counts()
        torch.cuda.synchronize()
        replaced = [n for n in kernels.WRAPPERS
                    if not decoder_only or "decode" in n]
        if any(n2[n] != n1[n] for n in replaced) or lk.shape != lp.shape:
            fail(f"{tag}: the plain run took the wrong route (launches {n1}"
                 f" -> {n2}) or gave {tuple(lp.shape)} logits")
        rel = [float((lk[t] - lp[t]).norm() / lp[t].norm())
               for t in range(lk.shape[0])]
        what = "decoder kernels" if decoder_only else "kernels"
        say(f"model[{tag}]: {what} vs plain, logits rel_l2 at prefill and "
            f"decode steps 1-{GATE_STEPS}: {[round(r, 5) for r in rel]} (tol"
            f" {tol} each)")
        if not all(math.isfinite(r) and r <= tol for r in rel):
            over.append(f"{what} {max(rel)} over {tol}")
    if over:
        fail(f"{tag}: step logits rel_l2 " + ", ".join(over))


def short_requests(seed: int):
    """One request of BATCH waveforms of SHORT_S seconds."""
    from mtasr_tpu_torch.tools import full_width
    return full_width.waveforms(seed, 1, BATCH, SHORT_S)


def short_transcriber(transcriber):
    """The same model and settings with a 1 s first bucket, so that a short
    batch is padded to 1 s: 7 speech frames, a prefill of 8 positions."""
    import dataclasses

    from mtasr_tpu_torch.api import Transcriber
    dc = dataclasses.replace(transcriber.dc,
                             bucket_boundaries_seconds=(1.0, AUDIO_S))
    return Transcriber(transcriber.cfg, transcriber.model,
                       transcriber.tokenizer, gen=transcriber.gen, dc=dc)


def short_prefill_phase(torch, card: str, cfg, transcriber, records,
                        launches, leg: str) -> None:
    """A request of short waveforms in a 1 s bucket: its prefill of 8
    positions runs the chunk kernel of the leg (#5 or #7) once a decoder
    layer. The launches are counted; the kernel is then held against its
    plain version on the inputs the prefill gave it, and the model with
    kernels against the plain versions on the same batch."""
    tr = short_transcriber(transcriber)
    wavs = short_requests(SEED + 1)
    captured = []
    counts, _ = serve_phase(torch, card, cfg, tr, wavs,
                            f"{leg} short prefill", short=True,
                            captured=captured)
    for name, n in counts.items():
        launches[name] += n
    captured_phase(torch, card, records, captured)
    logits_phase(torch, cfg, transcriber.model, tr, wavs[0],
                 f"{leg} short prefill")
    torch.cuda.synchronize()


BWD_SOURCE = "mtasr_tpu_torch/csrc/flash_attention_bwd.cu"
BWD_REPLACES = {"flash_attention_bwd_dq":
                "mtasr_tpu/ops/pallas/flash_attention.py:640",
                "flash_attention_bwd_dkv":
                "mtasr_tpu/ops/pallas/flash_attention.py:664",
                "flash_attention_bwd_dpb":
                "mtasr_tpu/ops/pallas/flash_attention.py:711"}


def train_kernel_phase(torch, card: str, records) -> None:
    """#8, #9 and #10 against `flash_attention_bwd_plain` at the training
    path's shapes (B = 16, T = S = 499, 16 heads of 64, a gated bias in
    WavLM's row-padded table, one row of 300 keys), fed the same forward
    output and lse; the forward kernel and its lse at B = 16 as well.
    Beside them the yardsticks: one `torch.autograd.grad` of SDPA (forward
    and backward) with the gated bias materialised [B, H, T, S] in bf16,
    which gives dq, dk, dv and the whole bias gradient; and that backward
    alone, from one forward kept with `retain_graph`."""
    import torch.nn.functional as F

    from mtasr_tpu_torch.ops.kernels import flash_attention as fa
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    bf = torch.bfloat16
    B, T, H, D = TRAIN_BATCH, 499, 16, 64

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    q, k, v, dout = (randn(B, T, H, D) for _ in range(4))
    # the table as WavLM builds it once a forward: rows padded to 16 bytes
    pos_bias = fa.padded_bias(randn(H, T, T, scale=0.5))
    gate = (1 + torch.rand((B, H, T), generator=g, device="cuda")).to(bf)
    kv_lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    kv_lens[-1] = 300
    kw = dict(kv_lens=kv_lens, pos_bias=pos_bias, gate=gate)
    out_k, lse_k = fa._forward(q, k, v, kv_lens, pos_bias, gate, D ** -0.5,
                               True)
    out = fa.flash_attention_plain(q, k, v, **kw)
    lse = fa.flash_attention_lse_plain(q, k, kv_lens, pos_bias, gate)
    err, tol = check_err(torch, "flash_attention", out_k, out, 4)
    say(f"kernel flash_attention (train shape): max_abs_err {err:.6g} (tol "
        f"{tol:.6g}), lse max_abs_err "
        f"{float((lse_k - lse).abs().max()):.6g} shape {tuple(out.shape)}")
    args = (q, k, v, kv_lens, pos_bias, gate, out, lse, dout)
    delta = fa._delta(dout, out)
    ref = fa.flash_attention_bwd_plain(*args)
    dq, dg = fa.flash_attention_bwd_dq(*args, delta=delta)
    dk, dv = fa.flash_attention_bwd_dkv(*args, delta=delta)
    dpb = fa.flash_attention_bwd_dpb(*args, delta=delta)
    errs = {name: check_err(torch, name, got, want, BWD_ULPS)
            for name, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1]),
                                    ("dv", dv, ref[2]), ("dpb", dpb, ref[3]),
                                    ("dg", dg, ref[4]))}
    say("kernel flash backward vs plain: " + ", ".join(
        f"{n} {e:.6g} (tol {t:.6g})" for n, (e, t) in errs.items())
        + f" ({BWD_ULPS} bf16 ulps at max|ref|)")
    again = (*fa.flash_attention_bwd_dq(*args, delta=delta),
             *fa.flash_attention_bwd_dkv(*args, delta=delta),
             fa.flash_attention_bwd_dpb(*args, delta=delta))
    for name, first, second in zip(("dq", "dg", "dk", "dv", "dpb"),
                                   (dq, dg, dk, dv, dpb), again):
        if not torch.equal(first, second):
            fail(f"flash backward {name}: a second launch on the same "
                 "inputs gave other bits")
    say("kernel flash backward: a second launch gave the same bits")

    # the yardstick: SDPA forward + backward with the bias materialised
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    bias = sdpa_bias(torch, pos_bias, gate, kv_lens, T).requires_grad_(True)
    dout_h = dout.transpose(1, 2)

    def library():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        return torch.autograd.grad(o, leaves + [bias], dout_h)

    # the backward alone: its ops run on the forward's stream, where the
    # graph is captured
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o_kept = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
    torch.cuda.current_stream().wait_stream(side)

    def library_bwd():
        return torch.autograd.grad(o_kept, leaves + [bias], dout_h,
                                   retain_graph=True)

    n_keys = H * T * int(kv_lens.sum())      # valid (query, head, key)
    in_bytes = nbytes(q, k, v, pos_bias, gate, kv_lens, lse, delta, dout)
    plain = lambda: fa.flash_attention_bwd_plain(*args)  # noqa: E731
    for name, kern, n_ops, out_bytes, e in (
            ("flash_attention_bwd_dq",
             lambda: fa.flash_attention_bwd_dq(*args, delta=delta),
             6 * D * n_keys, nbytes(dq, dg), max(errs["dq"][0],
                                                 errs["dg"][0])),
            ("flash_attention_bwd_dkv",
             lambda: fa.flash_attention_bwd_dkv(*args, delta=delta),
             8 * D * n_keys, nbytes(dk, dv), max(errs["dk"][0],
                                                 errs["dv"][0])),
            ("flash_attention_bwd_dpb",
             lambda: fa.flash_attention_bwd_dpb(*args, delta=delta),
             4 * D * n_keys, nbytes(dpb), errs["dpb"][0])):
        record(torch, card, records, name, BWD_SOURCE, BWD_REPLACES[name],
               e, f"tol {BWD_ULPS} bf16 ulps at max|ref| each; plain = all "
               "five gradients",
               kern, plain, bound(in_bytes + out_bytes, n_ops, "bf16"),
               library, (B, T, H, D), library_bwd=(library_bwd, side))
    del leaves, bias, o_kept
    torch.cuda.synchronize()


def encoder_grads(torch, cfg, model, t, plain: bool):
    """(loss, {name: f32 gradient}) of the trainable encoder parameters
    for one deterministic step (no dropout, the batch's SpecAugment mask),
    with the kernels or their plain versions; launch counts (before,
    after)."""
    from mtasr_tpu_torch.models.speech_encoder_decoder import model_forward
    from mtasr_tpu_torch.ops import kernels
    model.zero_grad(set_to_none=True)
    n0 = kernels.launch_counts()
    with plain_versions(plain):
        out = model_forward(model, cfg, t["input_values"], t["audio_mask"],
                            t["decoder_input_ids"], splice_index=1,
                            ce_labels=t["ce_labels"],
                            mask_time_indices=t["mask_time_indices"],
                            deterministic=True)
        out.loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()
             if n.startswith("encoder.") and p.requires_grad}
    missing = [n for n, p in model.named_parameters()
               if n.startswith("encoder.") and p.requires_grad
               and p.grad is None]
    model.zero_grad(set_to_none=True)
    return float(out.loss.detach()), grads, missing, \
        (n0, kernels.launch_counts())


def train_phase(torch, card: str, launches) -> None:
    """Full-width attention-mode training through `Trainer` (see the
    module's docstring, phase 9). Fails on a non-finite loss, a last loss
    on the fixed batch not below the first, launch counts other than one
    conv0 and 24 of each flash kernel a step, encoder gradients (kernels
    vs plain) over GRAD_TOL, or an encoder attention parameter without a
    gradient."""
    import numpy as np

    from mtasr_tpu_torch.config import DataConfig, TrainingConfig
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.train.freeze import freeze_summary
    from mtasr_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg, model = full_width.build_train(SEED, "cuda", torch.bfloat16)
    batch = full_width.train_batch(cfg, TRAIN_BATCH, AUDIO_S, SEED)
    out_dir = tempfile.mkdtemp(prefix="train_smoke_")
    tc = TrainingConfig(output_dir=out_dir, learning_rate=TRAIN_LR,
                        warmup_steps=2, max_steps=1000, logging_steps=1,
                        pcgrad=False)
    trainer = Trainer(cfg, tc, DataConfig(), model,
                      freeze_kwargs=dict(freeze_decoder=True))
    # the step timing leaves out the checkpoint `train` writes at its end
    # (phase 13 measures checkpoints)
    trainer.save = lambda *a, **kw: None
    summ = freeze_summary(model, trainer.mask)
    torch.cuda.synchronize()
    say(f"train: WavLM-Large + LLaMA-3.2-1B bf16 (+ LoRA r 16 f32), "
        f"{summ['trainable']} of {summ['total']} parameters train, batch "
        f"{TRAIN_BATCH} x {AUDIO_S} s, labels "
        f"{batch.arrays['ce_labels'].shape}"
        f", SpecAugment frames {int(batch.arrays['mask_time_indices'].sum())}"
        f", built {time.perf_counter() - t0:.2f} s")

    t = trainer._tensors(batch)
    loss_k, gk, missing, (a0, a1) = encoder_grads(torch, cfg, model, t, False)
    loss_p, gp, _, (b0, b1) = encoder_grads(torch, cfg, model, t, True)
    L_enc = cfg.encoder.num_hidden_layers
    bwd = [n for n in kernels.WRAPPERS if n.startswith("flash_attention")]
    if any(a1[n] - a0[n] != L_enc for n in bwd) or \
            any(b1[n] != b0[n] for n in bwd):
        fail(f"gradient check took the wrong route: {a0} -> {a1} -> {b1}")
    num = math.sqrt(sum(float((gk[n] - gp[n]).pow(2).sum()) for n in gk))
    den = math.sqrt(sum(float(gp[n].pow(2).sum()) for n in gp))
    rel = num / den
    # a key bias shifts every score of a query by one constant, which the
    # softmax removes: its gradient is 0 but for rounding, and is left out
    # of the per-tensor report and of the no-gradient check
    per = sorted(((float((gk[n] - gp[n]).norm() / gp[n].norm()), n)
                  for n in gk if float(gp[n].norm()) > 0
                  and not n.endswith("k_proj.bias")), reverse=True)
    attn = [n for n in gk if ".attention." in n
            and not n.endswith("k_proj.bias")]
    dead = [n for n in attn if not bool(gk[n].abs().max() > 0)]
    say(f"train: encoder gradients kernels vs plain, one deterministic step:"
        f" loss {loss_k:.6f} vs {loss_p:.6f}, rel_l2 {rel:.5g} over "
        f"{len(gk)} tensors (tol {GRAD_TOL}), worst tensors "
        f"{[(n, round(r, 5)) for r, n in per[:3]]}; {len(attn)} attention "
        f"tensors, none without a gradient: {not missing and not dead}")
    if missing or dead:
        fail(f"encoder parameters without a gradient: {missing + dead}")
    if not math.isfinite(rel) or rel > GRAD_TOL:
        fail(f"encoder gradients rel_l2 {rel} over {GRAD_TOL}")
    del gk, gp

    t0 = time.perf_counter()
    trainer.train(lambda: [batch], max_steps=1)       # untimed first step
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train(lambda: [batch] * TRAIN_STEPS, max_steps=1 + TRAIN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect = dict.fromkeys(kernels.WRAPPERS, 0)
    expect["conv0_fused"] = TRAIN_STEPS
    for n in bwd:
        expect[n] = L_enc * TRAIN_STEPS
    for name, n in counts.items():
        launches[name] += n
    losses = [m["loss"] for m in trainer.metrics_log]
    say(f"train: {TRAIN_STEPS} timed steps after 1 untimed ({first_s:.3f} "
        f"s): {1e3 * dt / TRAIN_STEPS:.2f} ms/step, "
        f"{TRAIN_BATCH * TRAIN_STEPS / dt:.3f} samples/s, peak memory "
        f"{peak:.2f} GiB (max_memory_allocated), launches {counts} "
        f"B={TRAIN_BATCH} [{card}]")
    say(f"train: losses {[round(x, 5) for x in losses]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in trainer.metrics_log]}")
    if counts != expect:
        fail(f"train launch counts {counts} != expected {expect}")
    if not all(np.isfinite(losses)) or len(losses) != 1 + TRAIN_STEPS:
        fail(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on the fixed batch: {losses}")
    del trainer, model
    torch.cuda.empty_cache()


CTC_SOURCE = "mtasr_tpu_torch/csrc/ctc.cu"
CTC_REPLACES = {"ctc_alpha": "mtasr_tpu/ops/pallas/ctc_kernel.py:206",
                "ctc_beta_post": "mtasr_tpu/ops/pallas/ctc_kernel.py:271"}
# F.ctc_loss reads the lengths on the host (a synchronisation), which a
# CUDA graph cannot hold
CTC_NO_GRAPH = "not captured: F.ctc_loss reads its lengths on the host"


def ctc_inputs(torch, g, B, T, V, L, ragged):
    """log-probs [B, T, V] f32, int32 lengths and labels of L ids. ragged:
    input lengths from T down to 1, label lengths from L down to 0, a row
    of one repeated id (every skip refused), one impossible row, and two
    rows whose last step (ilen - 1) is the first and the last step of a
    time chunk of the kernels' shared-memory ring."""
    from mtasr_tpu_torch.ops.kernels import ctc as kc
    lp = torch.log_softmax(torch.randn((B, T, V), generator=g,
                                       device="cuda") * 2, -1)
    labels = torch.randint(3, 40, (B, L), generator=g, device="cuda")
    ilen = torch.full((B,), T, dtype=torch.int32, device="cuda")
    llen = torch.full((B,), L, dtype=torch.int32, device="cuda")
    if ragged:
        ilen.copy_(torch.linspace(T, 1, B, device="cuda").int())
        llen.copy_(torch.linspace(L, 0, B, device="cuda").int())
        labels[1] = labels[1, 0]
        ilen[2], llen[2] = L // 2, L
        tc = kc.ctc_plan(2 * L + 1, T).Tc
        mid = max(T // tc // 2, 1) * tc
        ilen[3], ilen[4] = min(mid + 1, T), min(mid, T)
    return lp, ilen, labels, llen


def ctc_routes_check(torch, kc, emit, ilen, llen, allow, want) -> None:
    """Every other route the CTC kernels take for this lattice (one or two
    positions a lane, each halo width), and the plan's route with a chunk
    of one and of two steps, give the plan's bits. The short chunks run 4
    times each with the L2 cache flushed and other values left in shared
    memory: every step then reads a chunk staged a step or two before from
    device memory, and a read of the ring before its copy has landed (a
    cp.async wait one group short) shows (PERF.md, Findings)."""
    B, T, S = emit.shape
    plan = kc.ctc_plan
    mine = plan(S, T)
    forced = [(K, H, 0, 1) for K, H in kc.ctc_routes(S)] + \
        [(mine.K, mine.halo, 1, 4), (mine.K, mine.halo, 2, 4)]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    try:
        for K, H, Tc, reps in forced:
            kc.ctc_plan = lambda S_, T_, K=K, H=H, Tc=Tc: \
                kc.plan_for(S_, T_, K, H, Tc)
            for _ in range(reps):
                kc.ctc_alpha(emit - 1, ilen, llen, allow)
                flush.add_(1)
                a_r, f_r = kc.ctc_alpha(emit, ilen, llen, allow)
                flush.add_(1)
                p_r = kc.ctc_beta_post(emit, want[0], ilen, llen, allow)
                if not all(torch.equal(x, y)
                           for x, y in zip((a_r, f_r, p_r), want)):
                    fail(f"ctc kernels (S = {S}): route K = {K}, halo {H}, "
                         f"Tc {Tc or 'planned'} gave other bits than the "
                         "plan's")
    finally:
        kc.ctc_plan = plan
    del flush
    say(f"kernel ctc (S = {S}, ragged): routes (positions a lane, halo "
        f"lanes, Tc, runs) {forced} give the plan's bits")


def ctc_kernel_phase(torch, card: str, records, cfg, batch) -> None:
    """#11 and #12 against their plain versions at the hybrid path's
    lattice (the train batch's talker streams: B = 16, T = 499, S = 21), at
    35-id labels (S = 71, about a 10 s talker's LLaMA-3 tokens) and on a
    ragged lattice of 100-id labels (S = 201); the log-probs span the CTC
    head's outputs. Each kernel's CUDA-graph time and time a step (graph
    ms / T) at each lattice. Yardsticks: `F.ctc_loss` (reduction 'none',
    zero_infinity) forward for #11, forward and backward for #12, on the
    same log-probs; the port's gather + #11 is timed beside the first."""
    import torch.nn.functional as F

    from mtasr_tpu_torch.ops.kernels import ctc as kc
    from mtasr_tpu_torch.tools.timing import cuda_ms, graph_ms
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    B, T, V = TRAIN_BATCH, cfg.encoder.conv_output_length(SR * AUDIO_S), \
        cfg.ctc_odim
    L = batch.arrays["label_spks"].shape[2]
    for ragged, L_case in ((False, L), (False, 35), (True, 100)):
        lp, ilen, labels, llen = ctc_inputs(torch, g, B, T, V, L_case, ragged)
        ext, allow = kc.lattice(labels, cfg.ctc_blank_id, V)
        S = ext.shape[1]

        def gather():
            return lp.gather(2, ext[:, None].expand(-1, T, -1)).contiguous()
        emit = gather()
        # a launch on other emissions first: shared memory then holds other
        # values, so a chunk read before it has landed cannot pass
        decoy = kc.ctc_alpha(emit - 1, ilen, llen, allow)[0]
        kc.ctc_beta_post(emit - 1, decoy, ilen, llen, allow)
        alpha, final = kc.ctc_alpha(emit, ilen, llen, allow)
        log_post = kc.ctc_beta_post(emit, alpha, ilen, llen, allow)
        a_ref, f_ref = kc.ctc_alpha_plain(emit, ilen, llen, allow)
        p_ref = kc.ctc_beta_post_plain(emit, alpha, ilen, llen, allow)
        torch.cuda.synchronize()
        errs = {}
        for name, out, ref in (("alpha", alpha, a_ref), ("final", final,
                                                           f_ref),
                               ("log_post", log_post, p_ref)):
            err = float((out - ref).abs().max())
            bad = (out - ref).abs() > CTC_ATOL + CTC_RTOL * ref.abs()
            if not math.isfinite(err) or bool(bad.any()):
                fail(f"ctc {name} (S = {S}): max_abs_err {err} over "
                     f"rtol {CTC_RTOL} + atol {CTC_ATOL}")
            errs[name] = err
        again = kc.ctc_alpha(emit, ilen, llen, allow)
        if not (torch.equal(again[0], alpha) and torch.equal(again[1], final)
                and torch.equal(kc.ctc_beta_post(emit, alpha, ilen, llen,
                                                 allow), log_post)):
            fail(f"ctc kernels (S = {S}): a second launch gave other bits")
        if ragged:
            ctc_routes_check(torch, kc, emit, ilen, llen, allow,
                             (alpha, final, log_post))
        loss = kc.zero_infinity_loss(kc.final_ll(final, llen))
        lp_t = lp.transpose(0, 1)
        ref_loss = F.ctc_loss(lp_t, labels, ilen, llen,
                              blank=cfg.ctc_blank_id, reduction="none",
                              zero_infinity=True)
        loss_err = float((loss - ref_loss).abs().max())
        say(f"kernel ctc (S = {S}{', ragged' if ragged else ''}): "
            f"max_abs_err alpha {errs['alpha']:.6g} final "
            f"{errs['final']:.6g} log_post {errs['log_post']:.6g} (rtol "
            f"{CTC_RTOL} + atol {CTC_ATOL}), a second launch the same bits; "
            f"loss vs F.ctc_loss max_abs_err {loss_err:.6g} (losses up to "
            f"{float(ref_loss.max()):.1f}); route {tuple(kc.ctc_plan(S, T))}")
        if not loss_err <= 1e-3 * max(1.0, float(ref_loss.abs().max())):
            fail(f"ctc loss against F.ctc_loss: {loss_err}")
        if ragged or L_case != L:
            g11 = graph_ms(lambda: kc.ctc_alpha(emit, ilen, llen, allow))
            g12 = graph_ms(lambda: kc.ctc_beta_post(emit, alpha, ilen, llen,
                                                    allow))
            say(f"kernel ctc (S = {S}{', ragged' if ragged else ''}): in a "
                f"CUDA graph ctc_alpha {g11:.4f} ms ({1e6 * g11 / T:.1f} ns "
                f"a step) ctc_beta_post {g12:.4f} ms ({1e6 * g12 / T:.1f} "
                f"ns a step) [{card}]")
            continue
        lp_g = lp_t.detach().requires_grad_(True)

        def library_bwd():
            out = F.ctc_loss(lp_g, labels, ilen, llen,
                             blank=cfg.ctc_blank_id, reduction="none",
                             zero_infinity=True)
            return torch.autograd.grad(out.sum(), lp_g)
        small = nbytes(allow, ilen, llen)
        # a few exp / log a lattice cell and step: negligible next to the
        # bytes; counted as 10 f32 operations a cell
        ops = 10 * B * T * S
        record(torch, card, records, "ctc_alpha", CTC_SOURCE,
               CTC_REPLACES["ctc_alpha"],
               max(errs["alpha"], errs["final"]),
               f"rtol {CTC_RTOL} + atol {CTC_ATOL}; library = F.ctc_loss "
               "forward",
               lambda: kc.ctc_alpha(emit, ilen, llen, allow),
               lambda: kc.ctc_alpha_plain(emit, ilen, llen, allow),
               bound(nbytes(emit, alpha, final) + small, ops, "f32"),
               lambda: F.ctc_loss(lp_t, labels, ilen, llen,
                                  blank=cfg.ctc_blank_id, reduction="none",
                                  zero_infinity=True), (B, T, S),
               CTC_NO_GRAPH)
        with_gather = cuda_ms(lambda: kc.ctc_alpha(gather(), ilen, llen,
                                                   allow))
        say(f"kernel ctc_alpha with its gather from [{B}, {T}, {V}] "
            f"log-probs: {with_gather:.4f} ms")
        record(torch, card, records, "ctc_beta_post", CTC_SOURCE,
               CTC_REPLACES["ctc_beta_post"], errs["log_post"],
               f"rtol {CTC_RTOL} + atol {CTC_ATOL}; library = F.ctc_loss "
               "forward and backward",
               lambda: kc.ctc_beta_post(emit, alpha, ilen, llen, allow),
               lambda: kc.ctc_beta_post_plain(emit, alpha, ilen, llen,
                                              allow),
               bound(nbytes(emit, alpha, log_post) + small, ops, "f32"),
               library_bwd, (B, T, S), CTC_NO_GRAPH)
        say("kernel ctc (S = {}): a step in a CUDA graph ctc_alpha {:.1f} "
            "ns ctc_beta_post {:.1f} ns [{}]".format(
                S, 1e6 * records["ctc_alpha"]["graph_ms"] / T,
                1e6 * records["ctc_beta_post"]["graph_ms"] / T, card))
        del lp_g
    del lp, emit, alpha, log_post
    torch.cuda.empty_cache()


def hybrid_grads(torch, cfg, model, t, plain: bool):
    """(loss, {name: f32 gradient}) of the encoder, separator and CTC-head
    parameters for one deterministic PCGrad step (no dropout, the batch's
    SpecAugment mask): the projected head gradients on the shared ones,
    the total loss's on the heads; launch counts (before, after)."""
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.train import train_step as ts
    shared, rest = ts._split_params(model)
    n0 = kernels.launch_counts()
    with plain_versions(plain):
        out, head_grads, g_rest = ts._three_stage(model, cfg, t, 1, None,
                                                  shared, rest)
        g_shared = ts.pcgrad_project(head_grads)
    torch.cuda.synchronize()
    ids = {id(p): n for n, p in model.named_parameters()}
    grads = {ids[id(p)]: g.detach().float()
             for p, g in list(zip(shared, g_shared)) + list(zip(rest, g_rest))
             if ids[id(p)].split(".")[0] in GATE_TOPS + FAMILY_TOPS}
    return float(out.loss.detach()), grads, (n0, kernels.launch_counts())


def rel_l2(got, ref, names) -> float:
    num = sum(float((got[n] - ref[n]).pow(2).sum()) for n in names)
    den = sum(float(ref[n].pow(2).sum()) for n in names)
    return math.sqrt(num / den)


def hybrid_gradient_gate(torch, cfg, model, t) -> float:
    """The encoder, separator and CTC-head gradients of one deterministic
    PCGrad step, kernels against plain versions: their global rel-L2, and
    by part; with the bridge and adapter family, its own gradients'
    rel-L2 too. Fails over HYBRID_GRAD_TOL (FAMILY_GRAD_TOL for the
    family's), or if the kernel run missed a kernel of the path or the
    plain run launched one."""
    from mtasr_tpu_torch.ops import kernels
    loss_k, gk, (a0, a1) = hybrid_grads(torch, cfg, model, t, False)
    loss_p, gp, (b0, b1) = hybrid_grads(torch, cfg, model, t, True)
    routed = [n for n in kernels.WRAPPERS if n.startswith("flash_attention")
              or n.startswith("ctc_") or n == "conv0_fused"]
    if any(a1[n] == a0[n] for n in routed) or \
            any(b1[n] != b0[n] for n in routed):
        fail(f"hybrid gradient check took the wrong route: {a0} -> {a1} -> "
             f"{b1}")
    gated = [n for n in gk if n.split(".")[0] in GATE_TOPS]
    parts = {}
    for top in GATE_TOPS:
        names = [n for n in gated if n.startswith(top + ".")]
        parts[top] = (rel_l2(gk, gp, names), len(names))
    rel = rel_l2(gk, gp, gated)
    say(f"hybrid: gradients kernels vs plain, one deterministic PCGrad step: "
        f"loss {loss_k:.6f} vs {loss_p:.6f}, rel_l2 {rel:.5g} over "
        f"{len(gated)} tensors (tol {HYBRID_GRAD_TOL}); by part "
        f"{ {k: (round(v[0], 6), v[1]) for k, v in parts.items()} }")
    if not math.isfinite(rel) or rel > HYBRID_GRAD_TOL:
        fail(f"hybrid gradients rel_l2 {rel} over {HYBRID_GRAD_TOL}")
    fam = [n for n in gk if n.split(".")[0] in FAMILY_TOPS]
    if fam:
        rel_f = rel_l2(gk, gp, fam)
        say(f"hybrid: the family's own gradients kernels vs plain, rel_l2 "
            f"{rel_f:.5g} over {len(fam)} tensors (tol {FAMILY_GRAD_TOL}), "
            f"norm {math.sqrt(sum(float(gp[n].pow(2).sum())for n in fam)):.5g}")
        if not math.isfinite(rel_f) or rel_f > FAMILY_GRAD_TOL:
            fail(f"family gradients rel_l2 {rel_f} over {FAMILY_GRAD_TOL}")
    del gk, gp
    torch.cuda.empty_cache()
    return rel


def hybrid_train_phase(torch, card: str, launches, family=None,
                       steps: int = TRAIN_STEPS) -> None:
    """Full-width hybrid SOT+CTC training with PCGrad through `Trainer`
    (module docstring, phase 11; with `family`, a configuration of the
    bridge and adapter family on it: phase 14's leg B). Fails on a
    non-finite loss, a last loss or loss_ctc on the fixed batch not below
    the first, launch counts other than a step's 1 conv0, 24 flash
    forward, 2 x 24 of each flash backward kernel and 4 of each CTC
    kernel, or gradients (kernels vs plain) over HYBRID_GRAD_TOL (the
    family's over FAMILY_GRAD_TOL)."""
    import numpy as np

    from mtasr_tpu_torch.config import DataConfig, TrainingConfig
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.train.freeze import freeze_summary
    from mtasr_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg, model = full_width.build_train(SEED, "cuda", torch.bfloat16,
                                        hybrid=True, family=family)
    tag = "hybrid" if family is None else f"family {family} train"
    batch = full_width.train_batch(cfg, TRAIN_BATCH, AUDIO_S, SEED)
    tc = TrainingConfig(output_dir=tempfile.mkdtemp(prefix="hybrid_smoke_"),
                        learning_rate=TRAIN_LR, warmup_steps=2,
                        max_steps=1000, logging_steps=1, pcgrad=True)
    trainer = Trainer(cfg, tc, DataConfig(), model,
                      freeze_kwargs=dict(freeze_decoder=True))
    trainer.save = lambda *a, **kw: None     # as in train_phase
    summ = freeze_summary(model, trainer.mask)
    torch.cuda.synchronize()
    say(f"{tag}: WavLM-Large + separator ({cfg.separator_hidden}) + "
        f"{cfg.talker_numbers} CTC heads of {cfg.ctc_odim} + LLaMA-3.2-1B "
        f"bf16 (+ LoRA r 16 f32), ctc_alpha {cfg.ctc_alpha}, PCGrad, "
        f"{summ['trainable']} of {summ['total']} parameters train, batch "
        f"{TRAIN_BATCH} x {AUDIO_S} s, talker labels "
        f"{batch.arrays['label_spks'].shape} lengths "
        f"{sorted(set(batch.arrays['label_spk_lens'].ravel().tolist()))}, "
        f"built {time.perf_counter() - t0:.2f} s")

    t = trainer._tensors(batch)
    hybrid_gradient_gate(torch, cfg, model, t)

    t0 = time.perf_counter()
    trainer.train(lambda: [batch], max_steps=1)       # untimed first step
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train(lambda: [batch] * steps, max_steps=1 + steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    K, L_enc = cfg.talker_numbers, cfg.encoder.num_hidden_layers
    ctc_names = ("ctc_alpha", "ctc_beta_post")
    expect = dict.fromkeys(kernels.WRAPPERS, 0)
    expect["conv0_fused"] = steps
    expect["flash_attention"] = L_enc * steps
    for n in kernels.WRAPPERS:
        if n.startswith("flash_attention_bwd"):
            expect[n] = K * L_enc * steps      # K encoder backwards
    for n in ctc_names:       # the loss's and the per-head pass's, per head
        expect[n] = 2 * K * steps
    for name, n in counts.items():
        launches[name] += n
    log = trainer.metrics_log
    say(f"{tag}: {steps} timed steps after 1 untimed ({first_s:.3f} "
        f"s): {1e3 * dt / steps:.2f} ms/step, "
        f"{TRAIN_BATCH * steps / dt:.3f} samples/s, peak memory "
        f"{peak:.2f} GiB (max_memory_allocated), launches {counts} "
        f"B={TRAIN_BATCH} [{card}]")
    for key in ("loss", "loss_attn", "loss_ctc", "grad_norm"):
        say(f"{tag}: {key} {[round(m[key], 5) for m in log]}")
    say(f"{tag}: ctc_head_grad_norms "
        f"{[[round(x, 4) for x in m['ctc_head_grad_norms']] for m in log]}")
    if counts != expect:
        fail(f"{tag} launch counts {counts} != expected {expect}")
    losses = [m["loss"] for m in log]
    ctc = [m["loss_ctc"] for m in log]
    if not all(np.isfinite(losses + ctc)) or len(losses) != 1 + steps:
        fail(f"hybrid losses {losses} / {ctc}")
    if not (losses[-1] < losses[0] and ctc[-1] < ctc[0]):
        fail(f"the {tag} loss or loss_ctc did not fall: {losses} / {ctc}")
    del trainer, model, t
    torch.cuda.empty_cache()


def ctc_serve_phase(torch, card: str, launches) -> None:
    """`Transcriber.transcribe_ctc` at full width (module docstring, phase
    12): two calls of 8 padded 6-10 s waveforms, launch counts exact (1
    conv0 and 24 flash a call, no CTC kernel: the decode computes no
    loss), K strings an input; the CTC heads' logits with kernels against
    plain within LOGITS_TOL."""
    from unittest import mock

    import mtasr_tpu_torch.api as api_mod
    from mtasr_tpu_torch.models.ctc_head import ctc_logits
    from mtasr_tpu_torch.models.speech_encoder_decoder import (
        ctc_heads, encode_feats,
    )
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.tools import full_width

    cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16,
                                      hybrid=True)
    requests = full_width.waveforms(SEED + 7, 2, BATCH, (6.0, 10.0))
    calls = []
    real = api_mod.generate_ctc

    def counting(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[1].cpu())          # lengths [K, B]
        return out
    walls = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with mock.patch.object(api_mod, "generate_ctc", counting):
        for wavs in requests:
            t0 = time.perf_counter()
            out = tr.transcribe_ctc(wavs, batch_size=BATCH)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if len(out) != BATCH or not all(
                    len(s) == cfg.talker_numbers and
                    all(isinstance(x, str) for x in s) for s in out):
                fail(f"transcribe_ctc returned a malformed result: {out}")
    counts = kernels.launch_counts()
    expect = dict.fromkeys(kernels.WRAPPERS, 0)
    expect["conv0_fused"] = len(calls)
    expect["flash_attention"] = cfg.encoder.num_hidden_layers * len(calls)
    audio = sum(len(w) for w in requests[-1]) / SR
    say(f"ctc serve: {len(requests)} transcribe_ctc calls x {BATCH} "
        f"waveforms, walls {[round(w, 3) for w in walls]} s, RTFx "
        f"{audio / walls[-1]:.2f} (the second call), launches {counts}, "
        f"collapsed CTC tokens a stream (last call) "
        f"{calls[-1].tolist()} [{card}]")
    if counts != expect:
        fail(f"ctc serve launch counts {counts} != expected {expect}")
    for name, n in counts.items():
        launches[name] += n

    wav, amask = one_batch(torch, tr, requests[-1])
    logits = {}
    for plain in (False, True):
        with plain_versions(plain), torch.inference_mode():
            feats = encode_feats(model, cfg, wav, amask)
            logits[plain] = [ctc_logits(h, x).float() for h, x in
                             zip(ctc_heads(model, cfg), feats.sep_hidden)]
    rel = [float((k - p).norm() / p.norm())
           for k, p in zip(logits[False], logits[True])]
    say(f"ctc serve: CTC-head logits kernels vs plain rel_l2 "
        f"{[round(r, 5) for r in rel]} (tol {LOGITS_TOL} each), shape "
        f"{tuple(logits[False][0].shape)}")
    if not all(math.isfinite(r) and r <= LOGITS_TOL for r in rel):
        fail(f"CTC-head logits rel_l2 {rel} over {LOGITS_TOL}")
    del model, tr, logits
    torch.cuda.empty_cache()


# -- phase 13: model directories, checkpoints and the CLIs -------------------
# the fine-tune resume gate: the trainable tensors and AdamW moments of the
# run resumed at step 2 against the run that went straight to step 4, on
# deterministic algorithms: bit-equal; where an op warned that it has no
# deterministic implementation, within the attention-mode gradient gate
# (GRAD_TOL) by rel-L2 over all trainable tensors
RESUME_TOL = GRAD_TOL
LLAMA_VOCAB = 128256        # LLaMA-3.2-1B's own rows; the SOT specials grow it
FT_STEPS, FT_SAVE, FT_BATCH = 4, 2, 4


def gbps(n_bytes: int, seconds: float) -> str:
    return f"{n_bytes / 1e9:.3f} GB in {seconds:.2f} s ({n_bytes / 1e9 / seconds:.2f} GB/s)"


def synced(torch):
    torch.cuda.synchronize()
    return time.perf_counter()


def greedy_tokens(torch, model, cfg, wav, amask, kv_quant=False):
    from mtasr_tpu_torch.config import GenerationConfig
    from mtasr_tpu_torch.generate.engine import generate
    out = generate(model, cfg, wav, amask, max_new_tokens=MAX_NEW,
                   gen=GenerationConfig(do_sample=False, kv_quant=kv_quant))
    return out.sequences.cpu()


def kernels_ran(names, counts, leg: str) -> None:
    """Each kernel of `names` launched at least once in the counts of a
    leg, which were set to 0 just before it."""
    missing = [n for n in names if counts[n] == 0]
    if missing:
        fail(f"model dirs {leg}: kernels {missing} did not launch: {counts}")


def hf_dirs_from(torch, cfg, model, root):
    """HF-layout directories of the model's WavLM (with its adapter) and of
    its LLaMA cut to LLaMA-3.2-1B's 128256 rows (tied head: no lm_head), as
    `save_pretrained` lays them out: config.json + model.safetensors.
    Returns (encoder dir, decoder dir, bytes written)."""
    from mtasr_tpu_torch.utils import model_io
    state = model.state_dict()
    n = 0
    dirs = []
    for part, sub in (("encoder", cfg.encoder), ("decoder", cfg.decoder)):
        d = os.path.join(root, f"hf_{part}")
        os.makedirs(d)
        flat = {k[len(part) + 1:]: v for k, v in state.items()
                if k.startswith(part + ".")}
        conf = dataclasses.asdict(sub)
        if part == "decoder":
            key = "model.embed_tokens.weight"
            flat[key] = flat[key][:LLAMA_VOCAB]
            conf["vocab_size"] = LLAMA_VOCAB
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(conf, f)
        n += model_io.save_flat(os.path.join(d, "model.safetensors"), flat)
        dirs.append(d)
    return dirs[0], dirs[1], n


def kaldi_dir(root, n: int, seconds: float, seed: int):
    """A Kaldi directory of `n` generated waveforms (noise x 0.1) with SOT
    texts of two talkers; returns (dir, wav paths)."""
    import numpy as np

    from mtasr_tpu_torch.data.audio import write_wav
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "kaldi")
    os.makedirs(d)
    words = ["hello", "world", "good", "day", "one", "two", "three"]
    paths = []
    with open(os.path.join(d, "wav.scp"), "w") as fw, \
            open(os.path.join(d, "text"), "w") as ft:
        for i in range(n):
            p = os.path.join(d, f"utt{i}.wav")
            write_wav(p, rng.standard_normal(int(seconds * SR)) * 0.1)
            text = (" ".join(rng.choice(words, 3)) + " <sc> "
                    + " ".join(rng.choice(words, 3)))
            fw.write(f"utt{i} {p}\n")
            ft.write(f"utt{i} {text}\n")
            paths.append(p)
    return d, paths


def model_dirs_phase(torch, card: str, launches) -> None:
    """Phase 13 (module docstring): the model-directory, checkpoint and CLI
    layer at full width, in a temporary directory."""
    import shutil
    from unittest import mock

    from mtasr_tpu_torch.api import Transcriber
    from mtasr_tpu_torch.cli import finetune_asr, inference_asr
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.train import loop as loop_mod
    from mtasr_tpu_torch.utils import model_io
    from mtasr_tpu_torch.utils.quantize import quantize_for_serving

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="model_dirs_")
    free = shutil.disk_usage(root).free
    say(f"model dirs: {root}, {free / 1e9:.1f} GB free [{card}]")

    def count(fn):
        """fn() with the launch counts set to 0 just before and read just
        after (added to `launches`)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for name, n in counts.items():
            launches[name] += n
        return out, counts

    cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16)
    wavs = full_width.waveforms(SEED + 11, 1, BATCH, (6.0, 10.0))[0]
    wav, amask = one_batch(torch, tr, wavs)
    ref = greedy_tokens(torch, model, cfg, wav, amask)

    # 1. save_model, then Transcriber.from_pretrained on the card
    d1 = os.path.join(root, "bf16")
    t0 = synced(torch)
    n_model = model_io.save_model(d1, cfg, model)
    dt_save = time.perf_counter() - t0
    tr.tokenizer.save(os.path.join(d1, "char_tokenizer.json"))
    t0 = synced(torch)
    tr1 = Transcriber.from_pretrained(d1)
    dt_load = synced(torch) - t0
    loaded = tr1.model.state_dict()
    same = all(torch.equal(v, loaded[k]) for k, v in model.state_dict().items())
    got, counts = count(lambda: greedy_tokens(torch, tr1.model, tr1.cfg,
                                                   wav, amask))
    say(f"model dirs 1: save_model {gbps(n_model, dt_save)}; "
        f"from_pretrained on the card {gbps(n_model, dt_load)} (from the "
        f"page cache); parameters bit-equal {same}; greedy tokens of "
        f"{BATCH} padded 6-10 s waveforms identical to the in-memory "
        f"model's {torch.equal(got, ref)} ({tuple(got.shape)}); launches "
        f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    if not same or not torch.equal(got, ref):
        fail("model dirs 1: the saved directory does not serve the in-memory "
             "model's tokens")
    kernels_ran(("conv0_fused", "flash_attention", "decode_attention"),
                counts, "1")
    del tr1, loaded
    torch.cuda.empty_cache()

    # 3. HF-layout directories -> the create CLI's assembly
    t0 = synced(torch)
    enc_dir, dec_dir, n_hf = hf_dirs_from(torch, cfg, model, root)
    dt_hf = time.perf_counter() - t0
    special = {"pad_token_id": cfg.pad_token_id,
               "sc_token_id": cfg.sc_token_id, "instruct": False}
    t0 = synced(torch)
    ccfg, created = model_io.create_from_pretrained(
        enc_dir, dec_dir, tokenizer_len=full_width.VOCAB_SIZE,
        special_ids=special, device="cuda")
    dt_create = synced(torch) - t0
    n_bad, grafted = 0, set()
    params = dict(created.named_parameters())
    for prefix, d in (("encoder.", enc_dir), ("decoder.", dec_dir)):
        for k, v in model_io.read_flat(d).items():
            if prefix + k in params:
                grafted.add(prefix + k)
                p = params[prefix + k]
                if k == "model.embed_tokens.weight":
                    p = p[:LLAMA_VOCAB]
                n_bad += not torch.equal(p.cpu(), v)
    n_graft = len(grafted)
    src = model_io.read_flat(dec_dir)["model.embed_tokens.weight"]
    grown = params["decoder.model.embed_tokens.weight"][LLAMA_VOCAB:].cpu()
    mean = model_io.mean_row(src)          # on the host, in the stored dtype
    rows_ok = bool((grown == mean).all())
    fresh = sorted(set(params) - grafted)
    d3 = os.path.join(root, "created")
    t0 = synced(torch)
    n_created = model_io.save_model(d3, ccfg, created)
    dt_csave = time.perf_counter() - t0
    say(f"model dirs 3: HF-layout WavLM + LLaMA dirs written "
        f"{gbps(n_hf, dt_hf)}; create_from_pretrained {dt_create:.2f} s "
        f"(fresh f32 init on the card, graft, vocabulary {LLAMA_VOCAB} -> "
        f"{ccfg.decoder.vocab_size}); {n_graft} grafted tensors, "
        f"{n_graft - n_bad} bit-equal to their source; the "
        f"{grown.shape[0]} grown rows equal to the mean row {rows_ok}; fresh "
        f"{fresh}; saved {gbps(n_created, dt_csave)} [{card}]")
    if n_bad or not rows_ok or not n_graft:
        fail("model dirs 3: create_from_pretrained did not graft the "
             "pretrained tensors as they are")
    del created, params, src
    shutil.rmtree(enc_dir), shutil.rmtree(dec_dir), shutil.rmtree(d3)
    torch.cuda.empty_cache()

    # 2. the streamed w8a8 load, int8 KV cache
    largest = max(v.numel() * v.element_size()
                  for v in model.state_dict().values())
    quantize_for_serving(model, "w8a8")
    ref8 = greedy_tokens(torch, model, cfg, wav, amask, kv_quant=True)
    torch.cuda.synchronize()
    peaks = {}
    for how in ("streamed", "load then quantize"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = synced(torch)
        if how == "streamed":
            tr8 = Transcriber.from_pretrained(d1, quantize="w8a8",
                                              kv_quant=True)
            held = tr8.model
        else:
            _, held = model_io.load_model(d1, "cuda", torch.bfloat16)
            quantize_for_serving(held, "w8a8")
        dt = synced(torch) - t0
        peaks[how] = (torch.cuda.max_memory_allocated() - base,
                      torch.cuda.memory_allocated() - base, dt)
        if how != "streamed":
            del held
    peak, final, dt8 = peaks["streamed"]
    s8, m8 = tr8.model.state_dict(), model.state_dict()
    q_same = set(s8) == set(m8) and all(torch.equal(s8[k], m8[k])
                                        for k in m8)
    got8, counts = count(lambda: greedy_tokens(
        torch, tr8.model, tr8.cfg, wav, amask, kv_quant=True))
    gib = 2 ** 30
    say(f"model dirs 2: from_pretrained(quantize=w8a8, kv_quant) streamed "
        f"in {dt8:.2f} s: peak device memory {peak / gib:.3f} GiB against "
        f"its final footprint {final / gib:.3f} GiB + the largest tensor "
        f"{largest / gib:.3f} GiB; load then quantize peaked at "
        f"{peaks['load then quantize'][0] / gib:.3f} GiB "
        f"({peaks['load then quantize'][2]:.2f} s); int8 weights, scales "
        f"and every other tensor bit-equal to the in-memory model after "
        f"quantize_for_serving {q_same}; greedy tokens identical "
        f"{torch.equal(got8, ref8)}; launches "
        f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    if not q_same or not torch.equal(got8, ref8):
        fail("model dirs 2: the streamed int8 load differs from "
             "quantize_for_serving of the in-memory model")
    if peak > final + largest:
        fail(f"model dirs 2: streamed-load peak {peak} over the final "
             f"footprint {final} + the largest tensor {largest}")
    kernels_ran(("conv0_fused", "flash_attention", "decode_attention_int8"),
                counts, "2")
    del tr8, s8, m8, model, tr
    torch.cuda.empty_cache()

    # 4. the fine-tune CLI: 4 steps straight, and 2 steps resumed to 4
    data, paths = kaldi_dir(root, 8, float(AUDIO_S), SEED + 12)
    saves = []
    real_save = loop_mod.save_checkpoint

    def timed_save(*a, **kw):
        t0 = synced(torch)
        path = real_save(*a, **kw)
        dt = time.perf_counter() - t0
        saves.append((sum(os.path.getsize(os.path.join(dp, f))
                          for dp, _, fs in os.walk(path) for f in fs), dt))
        return path

    def finetune(exp, steps):
        return finetune_asr.main([
            "--model_name_or_path", d1, "--data_dir", data,
            "--output_dir", exp, "--use_lora", "--freeze_decoder",
            "--partial_decoder_unfreeze", "",
            "--per_device_train_batch_size", str(FT_BATCH),
            "--max_duration_in_seconds", "20", "--learning_rate",
            str(TRAIN_LR), "--warmup_steps", "2", "--logging_steps", "1",
            "--eval_steps", "1000", "--save_steps", str(FT_SAVE),
            "--save_total_limit", "1", "--max_steps", str(steps)])

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    exp_a, exp_b = os.path.join(root, "exp_a"), os.path.join(root, "exp_b")
    walls = []
    try:
        with mock.patch.object(loop_mod, "save_checkpoint", timed_save), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for exp, steps in ((exp_a, FT_STEPS), (exp_b, FT_SAVE),
                               (exp_b, FT_STEPS)):
                t0 = synced(torch)
                trainer, counts = count(lambda: finetune(exp, steps))
                walls.append(time.perf_counter() - t0)
                kernels_ran(("conv0_fused", "flash_attention",
                             "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv",
                             "flash_attention_bwd_dpb"), counts, "4")
                losses = [round(m["loss"], 5) for m in trainer.metrics_log]
                del trainer
                torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    last = f"checkpoint-{FT_STEPS}"
    a = model_io.read_flat(os.path.join(exp_a, last))
    b = model_io.read_flat(os.path.join(exp_b, last))
    opt_a = model_io.read_flat(os.path.join(exp_a, last, "optimizer"))
    opt_b = model_io.read_flat(os.path.join(exp_b, last, "optimizer"))
    names = sorted(k[3:] for k in opt_a if k.startswith("mu."))
    num = sum(float((a[n].float() - b[n].float()).pow(2).sum()) for n in names)
    den = sum(float(a[n].float().pow(2).sum()) for n in names)
    rel = math.sqrt(num / den)
    n_equal = sum(torch.equal(a[n], b[n]) for n in names)
    moments = all(torch.equal(opt_a[k], opt_b[k]) for k in opt_a)
    frozen = all(torch.equal(a[k], b[k]) for k in a if k not in names)
    nondet = sorted({str(w.message)[:100] for w in caught
                     if "deterministic" in str(w.message)})
    size, dt_ck = saves[-1]
    say(f"model dirs 4: finetune_asr --use_lora --freeze_decoder B="
        f"{FT_BATCH} on 8 x {AUDIO_S} s: {FT_STEPS} steps straight, "
        f"{FT_SAVE} then resumed to {FT_STEPS}, walls "
        f"{[round(w, 2) for w in walls]} s; last losses {losses}; a "
        f"checkpoint {gbps(size, dt_ck)} (parameters, AdamW moments, trainer "
        f"state); resumed vs straight over {len(names)} trainable tensors: "
        f"rel_l2 {rel:.6g}, {n_equal} bit-equal, moments bit-equal "
        f"{moments}, frozen tensors equal {frozen}; ops without a "
        f"deterministic implementation {nondet} [{card}]")
    exact = n_equal == len(names) and moments
    if not frozen or not math.isfinite(rel) or \
            (not exact and (not nondet or rel > RESUME_TOL)):
        fail(f"model dirs 4: the resumed fine-tune differs from the straight "
             f"one: rel_l2 {rel}, {len(names) - n_equal} tensors not "
             f"bit-equal (gate: bit-equal, or rel_l2 {RESUME_TOL} where an op "
             f"has no deterministic implementation)")
    del a, b, opt_a, opt_b
    shutil.rmtree(exp_a), shutil.rmtree(exp_b), shutil.rmtree(d1)

    # 5. the inference CLI on a hybrid model directory
    hcfg, hmodel, htr = full_width.build(SEED, "cuda", torch.bfloat16,
                                         hybrid=True)
    d5 = os.path.join(root, "hybrid")
    model_io.save_model(d5, hcfg, hmodel)
    htr.tokenizer.save(os.path.join(d5, "char_tokenizer.json"))
    del hmodel, htr
    torch.cuda.empty_cache()
    outs, seqs = {}, {"w8a8": [], "ctc": [], "transcribe": []}

    @contextlib.contextmanager
    def recording(mod, name, into):
        """`mod.name` (a generate) keeps the token ids it returns."""
        real = getattr(mod, name)

        def keep(*a, **kw):
            out = real(*a, **kw)
            into.append(out.sequences.cpu())
            return out
        with mock.patch.object(mod, name, keep):
            yield

    for tag, extra, names in (
            ("w8a8", ["--quantize", "w8a8", "--kv_quant"],
             ("conv0_fused", "flash_attention", "decode_attention_int8")),
            ("ctc", ["--ctc_decoding"], ("conv0_fused", "flash_attention"))):
        out = os.path.join(root, f"decode_{tag}")
        t0 = synced(torch)
        with recording(inference_asr, "generate", seqs[tag]):
            _, counts = count(lambda: inference_asr.main([
                "--model_name_or_path", d5, "--data_dir", data,
                "--output_dir", out, "--batch_size", str(BATCH),
                "--max_length", str(MAX_NEW), *extra]))
        dt = time.perf_counter() - t0
        kernels_ran(names, counts, "5")
        files = sorted(os.listdir(out))
        if not {"label", "decod", "wer"} <= set(files):
            fail(f"model dirs 5: {tag} left {files}")
        with open(os.path.join(out, "decod")) as f:
            outs[tag] = dict(line.rstrip("\n").split(" ", 1)
                             if " " in line else (line.strip(), "")
                             for line in f)
        with open(os.path.join(out, "wer")) as f:
            report = f.read().strip()
        say(f"model dirs 5: inference_asr {' '.join(extra)}: {dt:.2f} s for "
            f"{len(outs[tag])} x {AUDIO_S} s, files {files}, {report}; "
            f"launches {counts} [{card}]")
    import mtasr_tpu_torch.api as api_mod
    tr5 = Transcriber.from_pretrained(d5, quantize="w8a8", kv_quant=True)
    with recording(api_mod, "generate", seqs["transcribe"]):
        hyps = tr5.transcribe(paths, batch_size=BATCH,
                              max_new_tokens=MAX_NEW)
    cli = [outs["w8a8"][f"utt{i}"] for i in range(len(paths))]
    # the texts of random weights are mostly ids outside the character
    # tokenizer's, which decode to nothing: the token ids are compared too
    a, b = torch.cat(seqs["w8a8"]), torch.cat(seqs["transcribe"])
    same = cli == hyps and a.shape == b.shape and torch.equal(a, b)
    say(f"model dirs 5: the CLI's w8a8 greedy hypotheses equal "
        f"Transcriber.transcribe's on the same waveforms {same}: token ids "
        f"{tuple(a.shape)}, {int((a == b).sum()) if a.shape == b.shape else 0}"
        f" equal, {len(set(a.flatten().tolist()))} distinct; texts equal "
        f"{cli == hyps} [{card}]")
    if not same:
        fail("model dirs 5: inference_asr and Transcriber.transcribe differ")
    del tr5
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    say(f"model dirs: phase wall {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")


# -- phase 14: the bridge and adapter family -----------------------------------
def family_phase(torch, card: str, launches, rtfx_bf16: float) -> None:
    """The bridge and adapter family at full width (module docstring,
    phase 14)."""
    from mtasr_tpu_torch.generate import engine
    from mtasr_tpu_torch.models.layers import QuantLinear
    from mtasr_tpu_torch.tools import full_width

    t_phase = time.perf_counter()
    requests = full_width.waveforms(SEED + 14, 2, BATCH, (6.0, 10.0))

    def serve(leg, reqs, **kw):
        t0 = time.perf_counter()
        cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16,
                                          family=leg, **kw)
        n_fam = sum(p.numel() for n, p in model.named_parameters()
                    if n.split(".")[0] in FAMILY_TOPS)
        torch.cuda.synchronize()
        say(f"family {leg}: {full_width.FAMILY[leg]}, {n_fam} family "
            f"parameters, built {time.perf_counter() - t0:.2f} s")
        tag = f"family {leg} " + ("int8" if kw else "bf16")
        counts, rtfx = serve_phase(torch, card, cfg, tr, reqs, tag)
        for name, n in counts.items():
            launches[name] += n
        # the decoder memory and the adapters' (the CTC prompt and the
        # token memory may hit their cap, or be all padding, with random
        # heads), finite
        wav, amask = one_batch(torch, tr, reqs[-1])
        with torch.inference_mode():
            enc = engine.encode_maybe_chunked(model, cfg, wav, amask, None)
        mem = enc.acoustic_mem
        if not (bool(torch.isfinite(enc.encoder_hidden_states).all())
                and (mem is None or bool(torch.isfinite(mem).all()))):
            fail(f"family {leg}: non-finite decoder or adapter memory")
        say(f"family {leg}: decoder memory "
            f"{tuple(enc.encoder_hidden_states.shape)}, valid a row "
            f"{enc.encoder_attention_mask.sum(1).tolist()}; adapter memory "
            f"{None if mem is None else tuple(mem.shape)}, valid slots a row "
            f"{None if mem is None else (~enc.acoustic_pad_mask).sum(1).tolist()}")
        return cfg, model, tr, rtfx

    cfg, model, tr, rtfx = serve("A", requests)
    say(f"family A: RTFx {rtfx:.2f} against phase 4's bf16 {rtfx_bf16:.2f} "
        f"without the family B={BATCH} [{card}]")
    logits_phase(torch, cfg, model, tr, requests[-1], "family A bf16",
                 decoder_too=True)
    del cfg, model, tr
    torch.cuda.empty_cache()

    cfg, model, tr, _ = serve("B", requests[:1], quantize="w8a8",
                              kv_quant=True)
    if any(isinstance(m, QuantLinear) for m in model.cross_att_adap.modules()):
        fail("family B: an adapter was quantized (the decoder scope leaves "
             "the family in bf16)")
    del cfg, model, tr
    torch.cuda.empty_cache()
    hybrid_train_phase(torch, card, launches, family="B",
                       steps=FAMILY_TRAIN_STEPS)

    cfg, model, tr, _ = serve("C", requests[:1])
    logits_phase(torch, cfg, model, tr, requests[0], "family C bf16")
    del cfg, model, tr
    torch.cuda.empty_cache()
    say(f"family: phase wall {time.perf_counter() - t_phase:.1f} s [{card}]")


def main() -> None:
    # the port stands alone: importing JAX or the JAX package now fails
    sys.modules["jax"] = None
    sys.modules["mtasr_tpu"] = None
    import torch
    card = device_phase(torch)

    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.ops.kernels import _build
    from mtasr_tpu_torch.tools import full_width

    # full-precision f32 references: no TF32 in convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.build_all()
    torch.cuda.synchronize()
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc, in parallel "
        f"{ {k: round(v, 2) for k, v in _build.build_seconds.items()} })")

    if "--only-family" in sys.argv[1:]:
        # phase 14 alone, beside a bf16 serve of the model without the
        # family on the same requests (in place of phase 4's RTFx)
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        cfg, model, transcriber = full_width.build(SEED, "cuda",
                                                   torch.bfloat16)
        _, rtfx_bf16 = serve_phase(
            torch, card, cfg, transcriber,
            full_width.waveforms(SEED + 14, 2, BATCH, (6.0, 10.0)), "bf16")
        del cfg, model, transcriber
        torch.cuda.empty_cache()
        family_phase(torch, card, launches, rtfx_bf16)
        say(f"family: launches {launches} (phase 14 alone: no kernels "
            "record)")
        print(json.dumps({"ok": True, "only": "family"}), flush=True)
        return

    records = {}
    kernel_phase(torch, card, records)
    torch.cuda.synchronize()
    launches = dict.fromkeys(kernels.WRAPPERS, 0)

    # -- bf16 ------------------------------------------------------------
    t0 = time.perf_counter()
    cfg, model, transcriber = full_width.build(SEED, "cuda", torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    say(f"model: WavLM-Large + LLaMA-3.2-1B, {n_params} parameters bf16, "
        f"random init {time.perf_counter() - t0:.2f} s")

    requests = full_width.waveforms(SEED, 3, BATCH, (6.0, 10.0))
    counts, rtfx_bf16 = serve_phase(torch, card, cfg, transcriber, requests,
                                    "bf16")
    for name, n in counts.items():
        launches[name] += n

    sp_k, lg_k, seq_k = breakdown_phase(torch, card, cfg, model,
                                        transcriber, requests[-1])
    torch.cuda.synchronize()
    sp_p, lg_p, seq_p = breakdown_phase(torch, card, cfg, model,
                                        transcriber, requests[-1],
                                        plain=True)
    torch.cuda.synchronize()
    rel = float((lg_k - lg_p).norm() / lg_p.norm())
    rel_enc = float((sp_k - sp_p).norm() / sp_p.norm())
    agree = float((seq_k == seq_p).float().mean())
    say(f"model: kernels vs plain at full width: prefill logits max_abs_err "
        f"{float((lg_k - lg_p).abs().max()):.5g} rel_l2 {rel:.5g} (tol "
        f"{LOGITS_TOL})"
        f", speech features rel_l2 {rel_enc:.5g}, greedy tokens agree "
        f"{agree:.4f}, argmax of first token agree "
        f"{float((lg_k.argmax(-1) == lg_p.argmax(-1)).float().mean()):.3f}")
    if not math.isfinite(rel) or rel > LOGITS_TOL:
        fail(f"full-width logits rel_l2 {rel} over {LOGITS_TOL}")
    logits_phase(torch, cfg, model, transcriber, requests[-1], "bf16")
    torch.cuda.synchronize()
    short_prefill_phase(torch, card, cfg, transcriber, records, launches,
                        "bf16")

    # -- int8: w8a8 decoder + int8 KV cache --------------------------------
    t0 = time.perf_counter()
    cfg8, model8, tr8 = full_width.build(SEED, "cuda", torch.bfloat16,
                                         quantize="w8a8", kv_quant=True)
    torch.cuda.synchronize()
    n_q = sum(b.numel() for n, b in model8.named_buffers()
              if n.endswith("weight_q8a8"))
    say(f"model: int8 leg, {n_q} int8 decoder weights (w8a8, tied head "
        f"materialised), int8 KV cache, built {time.perf_counter() - t0:.2f} "
        "s")
    counts, rtfx_int8 = serve_phase(torch, card, cfg8, tr8, requests[1:],
                                    "int8")
    for name, n in counts.items():
        launches[name] += n
    say(f"serve: RTFx int8 {rtfx_int8:.2f} vs bf16 {rtfx_bf16:.2f} (calls "
        f"after the first of each leg) B={BATCH} [{card}]")

    _, lg_8, _ = breakdown_phase(torch, card, cfg8, model8, tr8,
                                 requests[-1])
    torch.cuda.synchronize()
    breakdown_phase(torch, card, cfg8, model8, tr8, requests[-1], plain=True)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(lg_8).all()):
        fail("int8 prefill logits not finite")
    say(f"model: int8 vs bf16 prefill logits rel_l2 "
        f"{float((lg_8 - lg_k).norm() / lg_k.norm()):.5g} (w8a8 + int8 KV "
        "against bf16, same weights; reported, not gated), first-token "
        f"argmax agree {float((lg_8.argmax(-1) == lg_k.argmax(-1)).float().mean()):.3f}")
    logits_phase(torch, cfg8, model8, tr8, requests[-1], "int8")
    torch.cuda.synchronize()
    short_prefill_phase(torch, card, cfg8, tr8, records, launches, "int8")

    # -- training: the flash backward kernels, then Trainer at full width
    train_kernel_phase(torch, card, records)
    del model, transcriber, model8, tr8
    torch.cuda.empty_cache()
    train_phase(torch, card, launches)

    # -- hybrid SOT+CTC: the CTC kernels, PCGrad training, the CTC decode
    cfg_h, _ = full_width.config(hybrid=True)
    ctc_kernel_phase(torch, card, records, cfg_h, full_width.train_batch(
        cfg_h, TRAIN_BATCH, AUDIO_S, SEED))
    hybrid_train_phase(torch, card, launches)
    ctc_serve_phase(torch, card, launches)

    # -- model directories, training checkpoints and the CLIs -------------
    model_dirs_phase(torch, card, launches)

    # -- the bridge and adapter family -------------------------------------
    family_phase(torch, card, launches, rtfx_bf16)

    records = list(records.values())
    for r in records:
        r["launches"] = launches[r["name"]]
    if len(records) != len(kernels.WRAPPERS) or \
            not all(r["launches"] > 0 for r in records):
        fail(f"kernels not all launched on the served paths: {launches}")
    say(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
