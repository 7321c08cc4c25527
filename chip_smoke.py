#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`mtasr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only-family    # phases 1, 2 and 14 alone; its
                                           # last line {"ok": true, "only":
                                           # "family"}
    python3 chip_smoke.py --only-decoding  # phases 1, 2 and 15 alone; its
                                           # last line {"ok": true, "only":
                                           # "decoding"}
    python3 chip_smoke.py --only-parallel  # phases 1, 2 and 16 alone; its
                                           # last line {"ok": true, "only":
                                           # "parallel"}
    python3 chip_smoke.py --only-pipelined # phases 1, 2 and 17 alone; its
                                           # last line {"ok": true, "only":
                                           # "pipelined"}
    python3 chip_smoke.py --only-8b        # phases 1, 2 and 18 alone; its
                                           # last line {"ok": true, "only":
                                           # "8b"}
    python3 chip_smoke.py --only-moonlight # phases 1, 2, phase 3's #13
                                           # and 19 alone; its last line
                                           # {"ok": true, "only":
                                           # "moonlight"}
    python3 chip_smoke.py --only-w8a8      # phases 1, 2, phase 3's w8a8
                                           # kernels and phase 7's int8
                                           # serve and logits gate; its
                                           # last line {"ok": true,
                                           # "only": "w8a8"}

Phases, one line each, any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi); no CUDA device
   is a failure, nothing falls back to the CPU;
2. build: compile the nine kernel libraries of `mtasr_tpu_torch/csrc/`,
   one `nvcc` each, all started together;
3. kernels: each kernel against its plain PyTorch version at the served
   paths' shapes (B = 8, 10 s audio, WavLM-Large + LLaMA-3.2-1B; the chunk
   kernels at L = 8 and 16 over a full cache), with the error against a
   stated tolerance and both times; the decode kernels (#4, #6) also at
   B = 64 (#4 beside SDPA), and the cluster size each launched at each
   batch; #7 also at B = 64, L = 16 over S = 1000 slots; #13 (the routed
   experts' grouped SwiGLU, no TPU counterpart) at Moonlight-16B-A3B's
   widths (H 2048, I 1408, 64 experts, top 6) and the benchmark cell's
   two shapes, a decode step of B 256 and its prefill of 16384 tokens,
   routed by random scores, beside `torch._grouped_mm` over the sorted
   rows; the w8a8 linear's quantize and rescale kernels (no TPU
   counterpart) bit-equal to their plain versions at the Mistral-7B
   cell's shapes (M 256, 16384 and 8; K 4096 / 14336; N up to 32776) and
   WavLM-Large's biased ones, on rows with the quantizer's edges (zeros,
   exact ties, +-127, the 1e-12 floor), and `linear` on a w8a8
   `QuantLinear` with both;
4. serve (bf16): three `Transcriber.transcribe` calls of 8 padded 6-10 s
   waveforms each, at full width with random bf16 weights from a seeded
   generator, up to 150 new tokens; the kernels' launch counts, set to 0
   just before and read just after, prove the run went through them, and
   one more call under a CUDA-activity profiler counts the decode step's
   kernel on the card (the greedy step replays from a CUDA graph after
   step 2, so its wrapper runs only at step 1 and at the capture); then
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
   kernel (#6) and the w8a8 kernels (the program's counters of a traced
   call: every w8a8 linear through both), the breakdown and the RTFx
   beside bf16's; the int8 logits
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
    deterministic implementation), the checkpoint's size, the time
    `save_checkpoint` took to return (the host copy) and the time until its
    background write committed (#8-#10 launch); (5) `cli.inference_asr
    --quantize w8a8 --kv_quant` and `--ctc_decoding` on a hybrid model
    directory over the same Kaldi
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
    `transcribe` call, the logits kernels vs plain within LOGITS_TOL;
15. the decoding variants, at full width on 8 padded 6-10 s waveforms,
    150 new tokens, each leg with the launch counts set to 0 just before
    it and read just after, every reading printed before any is gated:
    (A) beam search, bf16, phase 4's model: two `transcribe(num_beams=4)`
    calls (#4 exactly 16 x steps), the RTFx beside greedy's, W = 1
    bit-identical to greedy on the same batch, the log-probs of the
    prefill and the first GATE_STEPS steps kernels vs plain (the plain run
    teacher-forced) within LOGITS_TOL, and over 150 tokens the two runs'
    candidates parting only at a near tie (TIE_TOL), rows that never part
    giving the same best beam; (B) beam search, w8a8 + int8 KV, one call
    (#6 exactly 16 x steps), finite scores, W = 1 equal to int8 greedy;
    (C) speculative decoding (spec_k 4), bf16, on the hybrid model, from
    the CTC heads' drafts (through `Transcriber` with
    `GenerationConfig(speculative="ctc")`), oracle drafts (greedy's own
    tokens) and mixed drafts (oracle in even rows, pads in odd ones,
    `spec_cache_factor` 1.0: holes and the fallback): #5 exactly 16 x
    verify steps and #4 16 x fallback steps, #5 held against its plain
    version on every verify call's own inputs, the tokens equal to
    greedy's up to the first near tie, the ms an emitted token against
    greedy's; (D) the same, w8a8 + int8 KV, oracle and mixed drafts
    through #7 and #6; then #5 (beside SDPA) and #7 in a CUDA graph on a
    verify call's inputs; the phase's wall time;
16. data and tensor parallelism: the single-process references first
    (phase 15's serve batch in bf16 and w8a8 + int8 KV: tokens, top-2
    gaps, the logits of the prefill and GATE_STEPS steps, RTFx; one
    deterministic attention-mode step of phase 9's model at 16 x 10 s,
    warmup 0: the encoder's gradients, the parameters after it, ms/step,
    and the kernels-vs-plain gradients as a rounding yardstick), then
    PAR_WORLD = 2 ranks (`chip_smoke.py --rank`) on cuda:0 over gloo with
    CUDA tensors (NCCL refuses two ranks on one device), started after
    the build and joined with a timeout: (a) tp = 2 serve, bf16 and int8,
    (b) dp = 2 serve (4 + 4 rows), (c) one step at tp = 2 and one at dp =
    2, each against the references: tokens parting only at a top-2 gap
    under TIE_TOL, logits within LOGITS_TOL, gradients and the updated
    parameters within GRAD_TOL, the rel-pos table's gradient within
    REL_POS_TOL; on each rank #2 and #4 (or #6) held against their plain
    versions on the inputs its run gave them; RTFx or ms/step beside one
    process's and the share of a clocked call or step spent in the
    collectives (`CollectiveClock`); the ranks' launch counts go into the
    kernels record; (d) the inference CLI under `torch.distributed.run
    --nproc_per_node 1` (NCCL, world size 1) writes the `decod` of the
    same CLI in this process;
17. the pipelined stream, the native host library and tracing, at full
    width (seed 0): (a, bf16) a stream of PIPE_BATCHES = 3 batches of 8
    padded 6-10 s waveforms (one 10 s bucket, 150 new tokens) through
    `generate_pipelined` against `engine.generate` on each batch: the
    tokens (parting only at a near tie, TIE_TOL), each batch's encoder
    output against the sequential encode's (max abs difference printed),
    the launch counts, set to 0 before each run and read after it (#1
    once a batch, #2 24 times a batch, #4 as the sequential run gives
    them), the RTFx of each; then SHORT_ROUNDS rounds in turns of the
    same batches at SHORT_NEW tokens, and the device idle share of two
    batches at PROFILE_NEW tokens each way (`tools/profile_path.py`'s
    busy-interval union); (b) the same model quantized w8a8 in place with
    an int8 KV cache (#6), a stream of PIPE_BATCHES_INT8 = 2 batches (its
    decode step is 3-4x bf16's), the stream timed first; (c) the port's
    native host library on a Kaldi directory of 16 generated 10 s WAVs:
    built, every row status 0, `collate` native against Python within
    NATIVE_TOL, host ms a batch of 8 both ways, `Calculator` native
    against Python, and `cli.inference_asr --pipelined` (CLI_NEW tokens,
    2 batches) writing the `decod` and `wer` of the same CLI without it
    (the tokens too; every lazy row loaded natively);
    (d) `profiling.trace` around a short stream names its three regions,
    and `device_memory_stats()` reads non-zero. Every reading is printed
    before any is gated;
18. LLaMA-3.1-8B (`full_width.build_8b`: WavLM-Large + 32 layers of
    hidden 4096, 32 q / 8 kv heads of 128, llama3 rope, an untied head of
    128264), every earlier model freed first, each leg with the launch
    counts set to 0 just before each run and read just after: (int8) the
    w8a8 decoder initialised directly in int8 (`init_quantized_llama`), its
    init seconds and peak device memory within INIT_PEAK_TOL of its
    footprint, two `transcribe` calls of 8 padded 6-10 s waveforms at 150
    new tokens with an int8 KV cache (#1, #2, #6 exactly as
    `expected_counts` at 32 layers), the RTFx and the wall a decode step,
    the decoder's logits kernels vs plain (prefill and GATE_STEPS steps)
    within LOGITS_TOL_INT8_8B beside its yardstick (#6 against its plain
    version on every call, and the logits with #6 at layer 0 alone), the
    short prefill (#7 held against its plain version on its served
    inputs, then the logits), #6 at the served decode shape against its
    plain version; (bf16) `init_random`'s bf16 model,
    one call (#1, #2, #4), the whole model's logits within LOGITS_TOL, the
    short prefill (#5), #4 at the served shape; the phase's wall time.
    At 32 layers the w8a8 roundings amplify a sound kernel's last-bit
    differences, so the int8 legs have their own logits gate;
19. Moonlight-16B-A3B's blocks (DeepSeek-V3: latent attention over the
    576-wide cache, 64 sigmoid-routed experts and 2 shared), WavLM-Large
    and MOONLIGHT_LAYERS decoder layers at the published widths (layer 0
    dense, the rest experts), bf16, random weights from seed 0: two
    `transcribe` calls of 8 padded 6-10 s waveforms at 150 new tokens
    with the launch counts set to 0 just before and read just after (#1,
    #2, and #13 once an expert layer a forward at the prefill, step 1 and
    the capture), one more call under a CUDA-activity profiler (every step
    after the first replayed, #13's gate / up kernel on the card once an
    expert layer a forward), the RTFx; then #13 held against its plain
    loop on the inputs the served prefill and step 1 gave it.

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
import gc
import json
import math
import os
import shutil
import statistics
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
# the same, int8 leg, the decoder's kernels alone: sound kernels read
# 0-0.0142 (a last-bit difference that flips a w8a8 activation rounding
# carries to the logits), #6 or #7 ignoring its mask 0.146 and 1.08 at the
# worst step
LOGITS_TOL_INT8 = 0.02
# the same at LLaMA-3.1-8B (phase 18): there one bf16 ulp of one element of
# a sound #6's output at layer 0 (the kernel's own tolerance) flips w8a8
# roundings through 31 more layers and reads 0.035 alone; sound kernels
# read 0-0.050 (long request) and 0.024-0.085 (short prefill), #6 or #7
# ignoring its mask 0.389-0.495 and 1.068-1.259 (PERF.md, Findings)
LOGITS_TOL_INT8_8B = 0.2
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
# phase 16: rel-L2 of the rel-pos table's gradient alone (#10's output,
# summed over the batch, the heads' bias positions and 24 layers), one
# step on ranks vs one process. A sum of B T^2 terms a bucket that cancel
# heavily: sound steps read 0.0129 (dp = 2) and 0.0263 (tp = 2), the
# aggregate 0.0044 / 0.0090 of GRAD_TOL; the table entering tp without
# `copy_to_tp` (each rank's gradient covers its heads alone) reads about
# 0.7 (PERF.md, Findings)
REL_POS_TOL = 0.05
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

# phase 3's #13 and phase 19: Moonlight-16B-A3B's expert widths
MOE_H, MOE_I, MOE_E, MOE_K = 2048, 1408, 64, 6
MOE_SOURCE = "mtasr_tpu_torch/csrc/moe_experts.cu"
# #13 against its plain loop, in bf16 ulps at max|ref|: both round gate,
# up, silu, the product and y to bf16; the sums run in another order,
# which can flip one rounding of an intermediate
MOE_ULPS = 4
MOONLIGHT_LAYERS = 3  # phase 19: layer 0 (dense) and 2 expert layers
W8A8_SOURCE = "mtasr_tpu_torch/csrc/w8a8_rows.cu"
# phase 3's w8a8 kernels at the benchmark cell's widths (Mistral-7B-v0.3:
# hidden 4096, MLP 14336, 8 kv heads of 128, the vocabulary grown by 8)
# and WavLM-Large's 1024 (with its biases): (M, K, [N, ...], bias); a decode
# step's M 256 first, whose K 4096 -> N 4096 records are kept
W8A8_SHAPES = ((256, 4096, (4096, 1024, 14336, 32776), False),
               (256, 14336, (4096,), False),
               (16384, 4096, (4096, 14336), False),
               (16384, 14336, (4096,), False),
               (8, 4096, (4096, 32776), False),
               (256 * 499, 1024, (1024, 4096), True))
W8A8_LINEARS = "mtasr.int8.w8a8_linears"    # the program's counters
W8A8_KERNELS = "mtasr.int8.w8a8_kernels"
PROFILE_MARGIN_S = 0.5  # the CUDA profiler's window past a traced call

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
    moe_kernel_phase(torch, card, records)
    w8a8_kernel_phase(torch, card, records)


def moe_kernel_phase(torch, card: str, records) -> None:
    """#13 against its plain loop over experts at the benchmark cell's two
    shapes (a decode step of B 256: 1536 pairs, about 24 an expert; its
    prefill: 16384 tokens, about 1536 an expert), routed by random scores;
    the step's record is kept, the prefill's under its `prefill` key. The
    bound: the weights of each expert with pairs once, each pair's input
    and output row, or the operations at the bf16 peak."""
    import torch.nn.functional as F
    from mtasr_tpu_torch.models import moe
    from mtasr_tpu_torch.ops.kernels import moe_experts as mk

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 13)
    H, I, E, k = MOE_H, MOE_I, MOE_E, MOE_K

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    w_gu = randn(E * 2 * I, H, scale=H ** -0.5)
    w_d = randn(E * H, I, scale=I ** -0.5)
    b_gu = w_gu.reshape(E, 2 * I, H).transpose(1, 2)
    b_d = w_d.reshape(E, H, I).transpose(1, 2)
    for T, into in ((256, records), (16384, {})):
        x = randn(T, H)
        top = torch.topk(torch.rand((T, E), generator=g, device="cuda"), k,
                         dim=-1).indices
        _, rows, offsets, counts = moe.dispatch(top, E)
        P = T * k
        read = int((counts > 0).sum())
        xs, ends = x[rows.long()], offsets[1:].contiguous()

        def library(xs=xs, ends=ends):
            gu = torch._grouped_mm(xs, b_gu, offs=ends)
            return torch._grouped_mm(F.silu(gu[:, :I]) * gu[:, I:], b_d,
                                     offs=ends)
        compare(torch, card, into, "moe_experts", MOE_SOURCE,
                "none: no TPU counterpart",
                lambda: mk.moe_experts(x, rows, offsets, counts, w_gu, w_d),
                lambda: mk.moe_experts_plain(x, rows, offsets, w_gu, w_d),
                MOE_ULPS, why=f", {T} tokens, {read} experts read",
                bound_ms=bound(read * 3 * H * I * 2 + 2 * P * H * 2,
                               2 * P * 3 * H * I, "bf16"),
                library=library)
        if into is not records:
            records["moe_experts"]["prefill"] = into["moe_experts"]


def w8a8_rows(torch, g, M, K):
    """x [M, K] bf16 at N(0, 1), its first rows the quantizer's edges: all
    zero (the 1e-12 floor); max|x| 127, so the scale is exactly 1 and
    k + 0.5 ties and +-127 fill the row; max|x| 254 with odd integers
    (ties at a scale of 2); values of 1e-11 (the floor, nonzero q)."""
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    if M < 4:
        return x
    k = torch.arange(K, device="cuda")
    x[0] = 0
    x[1] = ((k % 254) - 127 + 0.5).clamp(-127, 127)
    x[1, :2] = torch.tensor([127.0, -127.0])
    x[2] = ((k % 254) * 2 - 253).float()
    x[2, 0] = 254.0
    x[3] = 1e-11 * ((k % 7) - 3).float()
    return x


def w8a8_kernel_phase(torch, card: str, records) -> None:
    """The w8a8 linear's quantize and rescale kernels (no TPU counterpart)
    against their plain versions, bit for bit (`torch.equal`), at the
    `W8A8_SHAPES` (the Mistral-7B cell's decode step and prefill, M 8
    under the GEMM's pad of M <= 16, WavLM-Large's biased linears over a
    call's frames): the quantize on `w8a8_rows`' edge rows and on random
    rows, the rescale on the int32 products of the random rows' q with
    random int8 weights; then `linear` on a w8a8 `QuantLinear` bit-equal
    with the kernels and with the plain versions. Each shape's graph times
    (kernel and plain, on the random rows) and bound; the first shape's
    records kept. The bound: x read once and q written (quantize), the
    product read once and y written (rescale), at 3.35 TB/s."""
    from unittest import mock

    import mtasr_tpu_torch.models.layers as layers_mod
    from mtasr_tpu_torch.ops.kernels import w8a8_rows as wr
    from mtasr_tpu_torch.tools.timing import graph_ms
    from mtasr_tpu_torch.utils.quantize import quantize_linear

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 23)
    why = "bit-equal (torch.equal) to the plain version"

    def same(name, shape, out, ref):
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            if o.shape != r.shape or not torch.equal(o, r):
                diff = int((o != r).sum()) if o.shape == r.shape else -1
                fail(f"{name} at {shape}: not bit-equal to its plain "
                     f"version ({diff} elements differ)")

    def timed(name, shape, run, plain, b):
        if name not in records:
            record(torch, card, records, name, W8A8_SOURCE,
                   "none: no TPU counterpart", 0.0, why, run, plain, b,
                   shape=shape)
            records[name]["plain_graph_ms"] = graph_ms(plain)
            return
        k, p = graph_ms(run), graph_ms(plain)
        say(f"kernel {name}: {why}, in a CUDA graph kernel {fmt_ms(k)} "
            f"plain {fmt_ms(p)} bound {b[0]:.4f} ms ({b[1]}; "
            f"{b[0] / k:.3f} of it) shape {shape} [{card}]")

    for M, K, Ns, with_bias in W8A8_SHAPES:
        edges = w8a8_rows(torch, g, M, K)
        same("w8a8_quantize", (M, K, "edge rows"), wr.w8a8_quantize(edges),
             wr.w8a8_quantize_plain(edges))
        # timed on random rows: a zero takes the division's slow path, and
        # served activations hold few
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        q, sx = wr.w8a8_quantize(x)
        same("w8a8_quantize", (M, K), (q, sx), wr.w8a8_quantize_plain(x))
        timed("w8a8_quantize", (M, K), lambda: wr.w8a8_quantize(x),
              lambda: wr.w8a8_quantize_plain(x),
              bound(nbytes(x, q, sx), 0, "f32"))
        for N in Ns:
            w = torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                              dtype=torch.int8)
            acc = layers_mod._int8_matmul(q, w)
            scale = torch.rand((N,), generator=g, device="cuda") * 1e-3
            bias = (torch.randn((N,), generator=g, device="cuda")
                    .to(torch.bfloat16) if with_bias else None)
            dt = torch.bfloat16

            def run(acc=acc, scale=scale, bias=bias):
                return wr.w8a8_rescale(acc, sx, scale, bias, dt)

            def plain(acc=acc, scale=scale, bias=bias):
                return wr.w8a8_rescale_plain(acc, sx, scale, bias, dt)
            y = run()
            same("w8a8_rescale", (M, K, N), (y,), (plain(),))
            timed("w8a8_rescale", (M, N), run, plain,
                  bound(nbytes(acc, sx, scale, bias, y), 0, "f32"))
            del acc, w

    # the linear itself: kernels against the plain lines, bit for bit
    M, K, N = 256, 4096, 14336
    lin = quantize_linear(
        torch.randn((N, K), generator=g, device="cuda").to(torch.bfloat16)
        * 0.02, torch.randn((N,), generator=g, device="cuda")
        .to(torch.bfloat16), "w8a8")
    x = w8a8_rows(torch, g, M, K)
    y = layers_mod.linear(lin, x)
    with mock.patch.object(layers_mod, "w8a8_quantize",
                           wr.w8a8_quantize_plain), \
            mock.patch.object(layers_mod, "w8a8_rescale",
                              wr.w8a8_rescale_plain):
        ref = layers_mod.linear(lin, x)
    same("linear (w8a8, biased)", (M, K, N), (y,), (ref,))
    say(f"kernel w8a8: `linear` on a biased w8a8 QuantLinear {(M, K, N)} "
        f"bit-equal with the kernels and with the plain lines [{card}]")


def w8a8_linears(model) -> int:
    """The w8a8 linears a decoder forward calls: each w8a8 `QuantLinear`
    of the decoder once (the encoder's, under scope "all", are not
    counted: no phase serves one)."""
    from mtasr_tpu_torch.models.layers import QuantLinear
    return sum(isinstance(m, QuantLinear) and m.mode == "w8a8"
               for m in model.decoder.modules())


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


def expected_counts(cfg, steps, short: bool, int8: bool, w8a8: int = 0):
    """Launches of each kernel for `len(steps)` generate calls of `steps`
    decode steps each: conv0 once and flash once per encoder layer per
    call; a decode kernel per decoder layer per step (none under latent
    attention, which is plain PyTorch); #13 per expert layer per forward
    (the prefill and each step); a chunk kernel per decoder layer per
    prefill of at most 16 positions; the w8a8 quantize and rescale once
    each of the decoder's `w8a8` linears per forward."""
    from mtasr_tpu_torch.ops import kernels
    L_enc = cfg.encoder.num_hidden_layers
    dec = cfg.decoder
    L_dec = dec.num_hidden_layers
    out = dict.fromkeys(kernels.WRAPPERS, 0)
    out["conv0_fused"] = len(steps)
    out["flash_attention"] = L_enc * len(steps)
    if dec.kv_lora_rank is None:
        out["decode_attention_int8" if int8 else "decode_attention"] = \
            L_dec * sum(steps)
    out["moe_experts"] = sum(dec.moe_layer(i) for i in range(L_dec)) * (
        len(steps) + sum(steps))
    if short:
        out["decode_attention_int8_chunk" if int8 else
            "decode_attention_chunk"] = L_dec * len(steps)
    out["w8a8_quantize"] = out["w8a8_rescale"] = w8a8 * (len(steps)
                                                         + sum(steps))
    return out


def serve_phase(torch, card: str, cfg, transcriber, requests, tag: str,
                short: bool = False, captured=None, timing=None):
    """`transcriber.transcribe` on each request, with the launch counts set
    to 0 just before and read just after; fails unless each kernel wrapper
    ran exactly as often as the path needs (the decode step's kernel at
    step 1 and at the capture of the replayed step), or unless one more
    call, under a CUDA-activity profiler, replayed every step after the
    first and ran the decode step's kernel on the card once a decoder
    layer a step (`device_step_kernels`: the replays included; within the
    1 % of records CUPTI may lose). With `captured` (a list), every chunk-kernel call
    appends (name, copies of its inputs); `timing` (a dict) receives each
    call's wall, audio seconds and decode steps. Returns (counts, RTFx over
    the calls after the first)."""
    from unittest import mock

    import mtasr_tpu_torch.api as api_mod
    import mtasr_tpu_torch.models.llama as llama_mod
    from mtasr_tpu_torch.generate.engine import REPLAYS
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
    if timing is not None:
        timing.update(walls=walls, audio=audio_s, steps=steps)
    # the step's Python runs at step 1 and at the capture; the replays run
    # the captured kernels without it
    n8 = w8a8_linears(transcriber.model)
    expect = expected_counts(cfg, [min(n, 2) for n in steps], short,
                             transcriber.gen.kv_quant, n8)
    say(f"serve[{tag}]: {len(requests)} requests x {BATCH} waveforms, walls "
        f"{[round(x, 3) for x in walls]} s, audio "
        f"{[round(a, 2) for a in audio_s]} s, decode steps {steps}, launches "
        f"{counts}")
    if counts != expect or sum(steps) == 0:
        fail(f"{tag}: launch counts {counts} != expected {expect}")
    name, per_forward = step_kernel_on_card(cfg, transcriber.gen.kv_quant)
    traced = []
    with mock.patch.object(api_mod, "generate",
                           lambda *a, **kw: traced.append(
                               real_generate(*a, **kw)) or traced[-1]):
        ran, counters = device_step_kernels(
            torch, name, lambda: transcriber.transcribe(
                requests[-1], batch_size=BATCH, max_new_tokens=MAX_NEW))
    n = traced[0].steps
    replays = counters.get(REPLAYS, 0)
    # the traced call's w8a8 linears where Python ran (the prefill, step 1,
    # the capture), each through both kernels
    w8 = (counters.get(W8A8_LINEARS, 0), counters.get(W8A8_KERNELS, 0))
    if w8 != (n8 * (1 + min(n, 2)),) * 2:
        fail(f"{tag}: the traced call counted {w8} w8a8 linears / calls "
             f"through the kernels, not {n8 * (1 + min(n, 2))} each")
    if n8:
        say(f"serve[{tag}]: the traced call's counters: {w8[0]} w8a8 "
            f"linears, {w8[1]} through the quantize and rescale kernels")
    # a decode kernel runs in the steps alone; #13 in the prefill as well
    want = per_forward * (n + (name == MOE_KERNEL))
    say(f"serve[{tag}]: a traced call of {n} decode steps, {replays} "
        f"replayed, ran {ran} {name} on the card ({want} wanted)")
    # CUPTI loses a few records of a large trace, replayed or not (on an
    # H100: up to 56 of a call's 105870, 17 of its 2384 decode kernels):
    # the card's count may fall short by 1 %; the replay counter is exact
    if not want - want // 100 <= ran <= want or replays != n - 1:
        fail(f"{tag}: {ran} {name} ran on the card, not {want}, or {replays}"
             f" of {n} steps replayed")
    warm = slice(1, None) if len(walls) > 1 else slice(None)
    rtfx = sum(audio_s[warm]) / sum(walls[warm])
    say(f"serve[{tag}]: RTFx {rtfx:.2f} (calls after the first; call 1 "
        f"{audio_s[0] / walls[0]:.2f}) B={BATCH} [{card}]")
    return counts, rtfx


MOE_KERNEL = "mtasr_moe_gate_up_kernel"   # #13's first launch, by name


def step_kernel_on_card(cfg, int8: bool):
    """(the card's name of the kernel a decode step launches, its launches
    a forward): #4 or #6 once a decoder layer; under latent attention with
    experts, #13's gate / up kernel once an expert layer."""
    dec = cfg.decoder
    if dec.kv_lora_rank is not None:
        return MOE_KERNEL, sum(dec.moe_layer(i)
                               for i in range(dec.num_hidden_layers))
    return ("decode_int8_kernel" if int8 else "decode_attn_kernel",
            dec.num_hidden_layers)


def device_step_kernels(torch, name: str, fn):
    """fn() under a CUDA-activity profiler: (the count of the card's kernel
    records whose name holds `name`, the program's counters: the decode
    steps replayed from a CUDA graph, `REPLAYS`, among them). CUPTI
    records each kernel of a replayed graph, correlated to its one graph
    launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mtasr_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    profiling.take()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # kineto drops the card's records stamped outside the profiler's
        # window ("out of range"), and the card's clock, converted to the
        # host's, can lie tens of ms off it (on an H100: 128-532 of a
        # call's 2384 decode kernels lost): the window opens and closes
        # PROFILE_MARGIN_S away from the call's first and last kernel
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    ran = sum(1 for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation() and name in e.name())
    return ran, profiling.take()[1]


@contextlib.contextmanager
def plain_versions(enabled: bool = True, decoder_only: bool = False):
    """While enabled, the model calls the kernels' plain versions (with
    decoder_only, the decoder's alone: the encoder keeps its kernels)."""
    from unittest import mock

    import mtasr_tpu_torch.models.layers as layers_mod
    import mtasr_tpu_torch.models.llama as llama_mod
    import mtasr_tpu_torch.models.wavlm as wavlm_mod
    import mtasr_tpu_torch.ops.ctc_fused as ctc_fused
    from mtasr_tpu_torch.ops.kernels import (
        conv_frontend as cf, ctc as kc, decode_attention as da,
        decode_attention_chunk as dc, decode_attention_int8 as di,
        flash_attention as fa, w8a8_rows as wr,
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
                dc.decode_attention_int8_chunk_plain),
               (layers_mod, "w8a8_quantize", wr.w8a8_quantize_plain),
               (layers_mod, "w8a8_rescale", wr.w8a8_rescale_plain)]
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
    compared with the first step by step. The loop runs eagerly, so that
    `sample` sees every step (a replayed graph runs it once, at capture)."""
    from unittest import mock

    from mtasr_tpu_torch.generate import engine
    seen = []

    def sample(logits, gen, generator):
        seen.append(logits.float())
        t = len(seen) - 1
        return logits.argmax(-1) if tokens is None else tokens[:, t]

    with plain_versions(plain, decoder_only), \
            mock.patch.object(engine, "_sample_token", sample), \
            mock.patch.object(engine, "_replayable", lambda *a: False):
        out = engine.generate(model, cfg, wav, amask, gen=gen,
                              max_new_tokens=GATE_STEPS + 1)
    return torch.stack(seen), out.sequences


def logits_phase(torch, cfg, model, transcriber, wavs, tag: str,
                 decoder_too: bool = False,
                 int8_tol: float = LOGITS_TOL_INT8) -> None:
    """The model with kernels against the model with the plain versions:
    rel-L2 of the logits at the prefill and at each of the first GATE_STEPS
    decode steps, each within the gate. bf16: the whole model, within
    LOGITS_TOL, and with decoder_too also the decoder's kernels alone,
    within LOGITS_TOL_DECODER. int8: the decoder's kernels alone (both
    sides run the encoder's kernels, so its bf16 differences, which w8a8
    amplifies, do not enter), within `int8_tol`. Every reading is
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
    legs = [(True, int8_tol)] if int8 else [(False, LOGITS_TOL)]
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
                    if not decoder_only or "decode" in n or "w8a8" in n]
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
                        launches, leg: str,
                        int8_tol: float = LOGITS_TOL_INT8) -> None:
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
                 f"{leg} short prefill", int8_tol=int8_tol)
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
    from mtasr_tpu_torch.train import checkpoint as ckpt_mod
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
        """The save's return (the host copy; the step waits this long) and
        its commit (`wait_for_pending_saves`), both from the call."""
        t0 = synced(torch)
        path = real_save(*a, **kw)
        t_ret = time.perf_counter() - t0
        ckpt_mod.wait_for_pending_saves()
        t_commit = time.perf_counter() - t0
        saves.append((sum(os.path.getsize(os.path.join(dp, f))
                          for dp, _, fs in os.walk(path) for f in fs),
                      t_ret, t_commit))
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
    size, dt_ret, dt_ck = saves[-1]
    say(f"model dirs 4: finetune_asr --use_lora --freeze_decoder B="
        f"{FT_BATCH} on 8 x {AUDIO_S} s: {FT_STEPS} steps straight, "
        f"{FT_SAVE} then resumed to {FT_STEPS}, walls "
        f"{[round(w, 2) for w in walls]} s; last losses {losses}; a "
        f"checkpoint {gbps(size, dt_ck)} (parameters, AdamW moments, trainer "
        f"state; written in the background: save_checkpoint returned after "
        f"{dt_ret:.3f} s, the write committed after {dt_ck:.3f} s); resumed "
        f"vs straight over {len(names)} trainable tensors: "
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


# -- phase 15: the decoding variants ---------------------------------------------
BEAMS = 4          # beam width of phase 15's beam legs
SPEC_K = 4         # draft tokens a verify step (the GenerationConfig default)
# a near tie: where two decodes of the same batch part, greedy's top-1 minus
# top-2 logit at that step (for beam search, the smallest gap between
# neighbours of the top 2W + 1 joint candidate scores) below this. Sound
# kernels part only there; #5 taking invalid slots as valid parts elsewhere
# (PERF.md, Findings)
TIE_TOL = 0.125


def decoding_requests():
    """Phase 15's two requests of BATCH padded 6-10 s waveforms."""
    from mtasr_tpu_torch.tools import full_width
    return full_width.waveforms(SEED + 15, 2, BATCH, (6.0, 10.0))


def counted(torch, fn):
    """(fn(), launch counts, wall s) with the counts set to 0 just before
    and read just after."""
    from mtasr_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts(), time.perf_counter() - t0


def greedy_with_gaps(torch, model, cfg, wav, amask, kv_quant):
    """Greedy tokens [B, MAX_NEW] (CPU), the top-1 minus top-2 logit of
    each step [B, MAX_NEW] (CPU), ms per emitted token, emitted tokens;
    the eager loop, whose every step `sample` sees."""
    from unittest import mock

    from mtasr_tpu_torch.config import GenerationConfig
    from mtasr_tpu_torch.generate import engine
    gaps = []

    def sample(logits, gen, generator):
        top = logits.float().topk(2, -1).values
        gaps.append(top[:, 0] - top[:, 1])
        return logits.argmax(-1)
    with mock.patch.object(engine, "_sample_token", sample), \
            mock.patch.object(engine, "_replayable", lambda *a: False):
        out, _, wall = counted(torch, lambda: engine.generate(
            model, cfg, wav, amask, max_new_tokens=MAX_NEW,
            gen=GenerationConfig(do_sample=False, kv_quant=kv_quant)))
    gap = torch.full(out.sequences.shape, float("inf"))
    gap[:, :len(gaps)] = torch.stack(gaps, 1).cpu()
    n = int(out.lengths.sum())
    return out.sequences.cpu(), gap, 1e3 * wall / n, n


def parted(torch, got, ref, gap):
    """Each row's first position where `got` and `ref` differ and the gap
    there: (rows that part, the largest gap where one parts)."""
    rows, worst = 0, 0.0
    for r in range(ref.shape[0]):
        diff = (got[r] != ref[r]).nonzero()
        if len(diff):
            rows += 1
            worst = max(worst, float(gap[r, int(diff[0])]))
    return rows, worst


@contextlib.contextmanager
def checked_chunks(torch, name, seen):
    """Every call of the chunk kernel `name` from the decoder is held
    against its plain version on the same inputs, in the call; `seen`
    gets the worst error over its tolerance, the calls, the calls over,
    and the last call's arguments (copies, for the graph timing)."""
    from unittest import mock

    import mtasr_tpu_torch.models.llama as llama_mod
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    real = getattr(llama_mod, name)
    plain = getattr(dc, name + "_plain")
    seen.update(calls=0, over=0, err=0.0, tol=0.0, ratio=0.0, args=None)

    def check(*args):
        out = real(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        if name == "decode_attention_chunk":
            tol = ulps_tol(ref.float(), 4)
        else:
            tol = ulps_tol(ref.float(), 1) + p_step(di, *args)
        err = float((out.float() - ref.float()).abs().max())
        seen["calls"] += 1
        if not math.isfinite(err) or err > tol:
            seen["over"] += 1
        if not math.isfinite(err) or err / tol >= seen["ratio"]:
            seen.update(err=err, tol=tol, ratio=err / tol)
        seen["args"] = args
        return out
    with mock.patch.object(llama_mod, name, check):
        yield
    seen["args"] = [a.clone() for a in seen["args"]] if seen["args"] \
        else None


def spec_leg(torch, card, cfg, model, tr, wavs, wav, amask, source,
             kv_quant, greedy, launches, over, verify):
    """Speculative decoding of one batch from `source` drafts (module
    docstring, phase 15), first with every chunk-kernel call checked and
    the launches counted, then timed alone."""
    from unittest import mock

    from mtasr_tpu_torch.api import Transcriber
    from mtasr_tpu_torch.config import GenerationConfig
    from mtasr_tpu_torch.generate import speculative
    seqs, gap, greedy_ms, _ = greedy
    int8 = "int8" if kv_quant else "bf16"
    chunk = "decode_attention_int8_chunk" if kv_quant else \
        "decode_attention_chunk"
    gen = GenerationConfig(do_sample=False, speculative="ctc", spec_k=SPEC_K,
                           kv_quant=kv_quant,
                           spec_cache_factor=1.0 if source == "mixed" else 2.0)
    draft = None
    if source != "ctc":
        draft = seqs.clone().cuda()
        if source == "mixed":
            draft[1::2] = cfg.pad_token_id
    got = []
    real = speculative.generate_speculative

    def run():
        if source != "ctc":
            return real(model, cfg, wav, amask, gen=gen,
                        max_new_tokens=MAX_NEW, draft_tokens=draft)
        # the CTC drafts through the user's entry point: a Transcriber
        # whose generation config asks for them (its batch is `wav`)
        with mock.patch.object(speculative, "generate_speculative",
                               lambda *a, **kw: got.append(real(*a, **kw))
                               or got[-1]):
            texts = Transcriber(cfg, model, tr.tokenizer, gen=gen,
                                dc=tr.dc).transcribe(
                wavs, batch_size=BATCH, max_new_tokens=MAX_NEW)
        if len(texts) != BATCH:
            fail(f"spec {source}: transcribe returned {len(texts)} texts")
        return got[-1]

    seen = {}
    with checked_chunks(torch, chunk, seen):
        (out, st), counts, _ = counted(torch, run)
    for name, n in counts.items():
        launches[name] += n
    # the prefill of 64 positions takes plain attention
    n8 = w8a8_linears(model)
    expect = expected_counts(cfg, [st.fallback_steps], False, kv_quant, n8)
    expect[chunk] = cfg.decoder.num_hidden_layers * st.spec_steps
    for name in ("w8a8_quantize", "w8a8_rescale"):   # the verify forwards
        expect[name] += n8 * st.spec_steps
    (out2, st2), _, wall = counted(torch, run)
    toks = out.sequences.cpu()
    rows, worst = parted(torch, toks, seqs, gap)
    n = int(out2.lengths.sum())
    say(f"spec[{int8} {source}]: {st.spec_steps} verify + "
        f"{st.fallback_steps} fallback steps, {st.accepted_drafts} accepted "
        f"drafts of {int(st.emitted.sum())} tokens "
        f"({st.accepted_drafts / max(int(st.emitted.sum()), 1):.3f}; "
        f"{int(st.emitted.sum()) / BATCH / max(st.spec_steps, 1):.2f} "
        f"tokens a row a verify step), launches {counts}")
    say(f"spec[{int8} {source}]: {chunk} against its plain version on its "
        f"{seen['calls']} verify calls: worst max_abs_err {seen['err']:.6g} "
        f"(tol {seen['tol']:.6g}), {seen['over']} over")
    say(f"spec[{int8} {source}]: tokens against greedy: {rows} of "
        f"{toks.shape[0]} rows part, the largest top-1 minus top-2 gap where "
        f"one parts {worst:.5g} (TIE_TOL {TIE_TOL}); {1e3 * wall / n:.3f} "
        f"ms an emitted token ({n} in {wall:.3f} s) against greedy's "
        f"{greedy_ms:.3f} B={BATCH} [{card}]")
    if counts != expect:
        over.append(f"spec {int8} {source}: launches {counts} != {expect}")
    if seen["over"] or seen["calls"] != cfg.decoder.num_hidden_layers * \
            st.spec_steps:
        over.append(f"spec {int8} {source}: {chunk} {seen['over']} of "
                    f"{seen['calls']} calls over tolerance")
    if worst >= TIE_TOL:
        over.append(f"spec {int8} {source}: tokens part from greedy at a "
                    f"gap of {worst} >= TIE_TOL {TIE_TOL}")
    if st2.spec_steps != st.spec_steps or not torch.equal(
            out2.sequences.cpu(), toks):
        over.append(f"spec {int8} {source}: a second run gave other steps "
                    "or tokens")
    if source == "mixed" and not st.fallback_steps:
        over.append(f"spec {int8} mixed: no fallback step")
    if seen["args"] is not None and source != "ctc":
        verify.setdefault(chunk, seen["args"])


def verify_times(torch, card, verify, records) -> None:
    """#5 and #7 in a CUDA graph on a verify call's own inputs, #5 beside
    SDPA on them; into the kernels' records (`verify_*`) when kept."""
    import torch.nn.functional as F
    from mtasr_tpu_torch.ops.kernels import decode_attention_chunk as dc
    from mtasr_tpu_torch.tools.timing import graph_ms
    for name, args in verify.items():
        q, mc = args[0], args[-1]
        B, L, Hq, D = q.shape
        kind = "int8" if name.endswith("int8_chunk") else "bf16"
        b_ms, b_by = bound(nbytes(*args, q), attention_ops(
            D, Hq * int(mc.sum())), kind)
        g = graph_ms(lambda: getattr(dc, name)(*args))
        plain = graph_ms(lambda: getattr(dc, name + "_plain")(*args))
        lib = None
        if kind == "bf16":
            kc, vc = args[1], args[2]
            S, Hkv = kc.shape[1], kc.shape[2] // D
            kh, vh = (t.view(B, S, Hkv, D).transpose(1, 2) for t in (kc, vc))
            lib = graph_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kh, vh, attn_mask=mc[:, None],
                enable_gqa=True))
        say(f"kernel {name} at the verify's shape {tuple(q.shape)} S_max "
            f"{mc.shape[-1]}: in a CUDA graph kernel {fmt_ms(g)} plain "
            f"{fmt_ms(plain)} library (SDPA) {fmt_ms(lib)} bound "
            f"{b_ms:.4f} ms ({b_by}; {b_ms / g:.3f} of it) [{card}]")
        if records is not None and name in records:
            records[name].update(verify_graph_ms=g, verify_plain_graph_ms=plain,
                                 verify_library_graph_ms=lib,
                                 verify_bound_ms=b_ms,
                                 verify_shape=list(q.shape) + [mc.shape[-1]])


def recorded_beam(torch, model, cfg, wav, amask, kv_quant, plain=False,
                  forced=None, max_new=MAX_NEW):
    """beam_generate at BEAMS beams, recording each step's log-probs less
    their row mean (the prefill and the first GATE_STEPS steps), each
    step's top 2W + 1 joint candidates and the bookkeeping's states. With
    `forced` (another run's record) the bookkeeping returns that run's
    states: the run follows its tokens. `plain`: the kernels' plain
    versions."""
    from unittest import mock

    from mtasr_tpu_torch.generate import beam
    rec = {"logp": [], "top": [], "state": []}
    real_init, real_step = beam.beam_state_init, beam.beam_state_step

    def note(logp, flat):
        if len(rec["logp"]) <= GATE_STEPS:
            lp = logp.reshape(-1, logp.shape[-1])
            rec["logp"].append(lp - lp.mean(-1, keepdim=True))
        v, i = flat.topk(2 * BEAMS + 1, -1)
        rec["top"].append((v.cpu(), i.cpu()))

    def init(logp0, *a):
        note(logp0, logp0)
        out = real_init(logp0, *a)
        rec["state"].append(out)
        return forced["state"][0] if forced else out

    def step(t, logp, state, *a):
        note(logp, (state[1][:, :, None] + logp).reshape(logp.shape[0], -1))
        out = real_step(t, logp, state, *a)
        rec["state"].append(out)
        return forced["state"][t] if forced else out
    with plain_versions(plain), \
            mock.patch.object(beam, "beam_state_init", init), \
            mock.patch.object(beam, "beam_state_step", step):
        out = beam.beam_generate(model, cfg, wav, amask, num_beams=BEAMS,
                                 max_new_tokens=max_new, kv_quant=kv_quant)
    return out, rec


def beam_parted(torch, k_out, k_rec, p_out, p_rec):
    """Rows whose candidates (the top 2W joint scores' order) part between
    two beam runs, and the largest smallest-neighbour gap of the top
    2W + 1 scores at the step where one parts; a row that never parts must
    give the same best beam."""
    rows, worst, same = 0, 0.0, True
    W2 = 2 * BEAMS
    for r in range(k_out.sequences.shape[0]):
        for (kv, ki), (_, pi) in zip(k_rec["top"], p_rec["top"]):
            if not torch.equal(ki[r, :W2], pi[r, :W2]):
                rows += 1
                worst = max(worst, float((kv[r, :-1] - kv[r, 1:]).min()))
                break
        else:
            same &= torch.equal(k_out.sequences[r, 0], p_out.sequences[r, 0])
    return rows, worst, same


def beam_legs(torch, card, cfg, model, tr, requests, wav, amask, greedy,
              kv_quant, rtfx_bf16, launches, over):
    """(A) or (B) of phase 15 (module docstring)."""
    from unittest import mock

    import mtasr_tpu_torch.api as api_mod
    from mtasr_tpu_torch.generate import beam
    leg = "int8" if kv_quant else "bf16"
    outs, walls, audio = [], [], []
    real = api_mod.beam_generate

    def calls():
        for wavs in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts = tr.transcribe(wavs, batch_size=BATCH,
                                  max_new_tokens=MAX_NEW, num_beams=BEAMS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            audio.append(sum(len(w) for w in wavs) / SR)
            if len(texts) != BATCH or not all(isinstance(t, str)
                                              for t in texts):
                fail(f"beam {leg}: transcribe returned a malformed result")
    with mock.patch.object(api_mod, "beam_generate",
                           lambda *a, **kw: outs.append(real(*a, **kw))
                           or outs[-1]):
        _, counts, _ = counted(torch, calls)
    for name, n in counts.items():
        launches[name] += n
    steps = [o.steps for o in outs]
    expect = expected_counts(cfg, steps, False, kv_quant,
                             w8a8_linears(model))
    finite = all(bool(torch.isfinite(o.scores).all()) for o in outs)
    rtfx = audio[-1] / walls[-1]
    say(f"beam[{leg}]: {len(requests)} transcribe calls x {BATCH} "
        f"waveforms at W = {BEAMS}, walls {[round(w, 3) for w in walls]} s, "
        f"steps {steps}, launches {counts}, scores finite {finite}; RTFx "
        f"{rtfx:.2f} (the last call) against greedy's {rtfx_bf16:.2f} "
        f"B={BATCH} [{card}]")
    if counts != expect:
        over.append(f"beam {leg}: launches {counts} != {expect}")
    if not finite:
        over.append(f"beam {leg}: non-finite scores")

    one, _, _ = counted(torch, lambda: beam.beam_generate(
        model, cfg, wav, amask, num_beams=1, max_new_tokens=MAX_NEW,
        kv_quant=kv_quant))
    same = torch.equal(one.sequences[:, 0].cpu(), greedy[0])
    say(f"beam[{leg}]: W = 1 against greedy on the same batch: "
        f"{'bit-identical' if same else 'DIFFERENT'} tokens")
    if not same:
        over.append(f"beam {leg}: W = 1 tokens differ from greedy's")
    if kv_quant:
        return

    # kernels against plain: the first steps' log-probs, teacher-forced
    k_out, k_rec = recorded_beam(torch, model, cfg, wav, amask, kv_quant,
                                 max_new=GATE_STEPS + 1)
    _, p_rec = recorded_beam(torch, model, cfg, wav, amask, kv_quant,
                             plain=True, forced=k_rec,
                             max_new=GATE_STEPS + 1)
    rel = [float((a.float() - b.float()).norm() / b.float().norm())
           for a, b in zip(k_rec["logp"], p_rec["logp"])]
    say(f"beam[bf16]: kernels vs plain, log-probs less their row mean, "
        f"rel_l2 at the prefill and steps 1-{GATE_STEPS} (plain run "
        f"teacher-forced): {[round(x, 5) for x in rel]} (tol {LOGITS_TOL})")
    if len(rel) != GATE_STEPS + 1 or not all(
            math.isfinite(x) and x <= LOGITS_TOL for x in rel):
        over.append(f"beam bf16: log-probs rel_l2 {rel} over {LOGITS_TOL}")
    # and free: the best beam's tokens equal up to the first near tie
    k_out, k_rec = recorded_beam(torch, model, cfg, wav, amask, kv_quant)
    p_out, p_rec = recorded_beam(torch, model, cfg, wav, amask, kv_quant,
                                 plain=True)
    rows, worst, same = beam_parted(torch, k_out, k_rec, p_out, p_rec)
    say(f"beam[bf16]: kernels vs plain over {MAX_NEW} tokens: candidates "
        f"part in {rows} of {BATCH} rows, the largest neighbour gap where "
        f"they part {worst:.5g} (TIE_TOL {TIE_TOL}); rows that never part "
        f"give the same best beam: {same}")
    if worst >= TIE_TOL or not same:
        over.append(f"beam bf16: kernels vs plain part at a gap of {worst} "
                    f"(TIE_TOL {TIE_TOL}) or a row that never parts gave "
                    "another best beam")


def decoding_phase(torch, card: str, launches, records, rtfx_bf16,
                   bf16=None) -> None:
    """Phase 15 (module docstring): beam search and speculative decoding
    at full width, each leg with the launch counts set to 0 just before it
    and read just after; every reading printed before any is gated.
    `bf16`: a list holding phase 4's (config, model, Transcriber), if
    still built (taken out of it, so that it is freed after leg A)."""
    from mtasr_tpu_torch.tools import full_width
    t_phase = time.perf_counter()
    requests = decoding_requests()
    wavs = requests[-1]
    over, verify = [], {}

    # (A) beam, bf16, phase 4's model
    cfg, model, tr = bf16.pop() if bf16 else \
        full_width.build(SEED, "cuda", torch.bfloat16)
    wav, amask = one_batch(torch, tr, wavs)
    greedy = greedy_with_gaps(torch, model, cfg, wav, amask, False)
    beam_legs(torch, card, cfg, model, tr, requests, wav, amask, greedy,
              False, rtfx_bf16, launches, over)
    del cfg, model, tr
    torch.cuda.empty_cache()

    # (B) beam and (D) speculative, int8: w8a8 decoder + int8 KV cache
    cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16,
                                      quantize="w8a8", kv_quant=True)
    greedy = greedy_with_gaps(torch, model, cfg, wav, amask, True)
    beam_legs(torch, card, cfg, model, tr, requests[:1], wav, amask, greedy,
              True, rtfx_bf16, launches, over)
    for source in ("oracle", "mixed"):
        spec_leg(torch, card, cfg, model, tr, wavs, wav, amask, source, True,
                 greedy, launches, over, verify)
    del cfg, model, tr
    torch.cuda.empty_cache()

    # (C) speculative, bf16, the hybrid model (its CTC heads draft)
    cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16,
                                      hybrid=True)
    greedy = greedy_with_gaps(torch, model, cfg, wav, amask, False)
    say(f"spec[bf16]: greedy on the hybrid model {greedy[2]:.3f} ms an "
        f"emitted token ({greedy[3]} tokens) B={BATCH} [{card}]")
    for source in ("ctc", "oracle", "mixed"):
        spec_leg(torch, card, cfg, model, tr, wavs, wav, amask, source,
                 False, greedy, launches, over, verify)
    del cfg, model, tr
    torch.cuda.empty_cache()

    verify_times(torch, card, verify, records)
    say(f"decoding: phase wall {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    if over:
        fail("decoding variants: " + "; ".join(over))


# -- phase 16: data and tensor parallelism ----------------------------------
PAR_WORLD = 2           # ranks of each leg, all on cuda:0 (gloo)
PAR_TIMEOUT = 900       # seconds a launch of the ranks may take
PAR_SEED = SEED + 16    # the serve legs' waveforms


def first_inputs(torch, mod, name, into):
    """While active, `mod.name`'s first call keeps a copy of its arguments
    in `into[name]` (the inputs the kernel received on the served path)."""
    from unittest import mock
    real = getattr(mod, name)

    def keep(*a, **kw):
        if name not in into:
            into[name] = tuple(x.clone() if torch.is_tensor(x) else x
                               for x in a), \
                {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in kw.items()}
        return real(*a, **kw)
    return mock.patch.object(mod, name, keep)


def captured_checks(torch, seen) -> dict:
    """Each captured kernel against its plain version on its own inputs
    (phase 3's tolerances): {name: (max_abs_err, tol, the inputs'
    shapes)}; past its tolerance the rank fails."""
    from mtasr_tpu_torch.ops.kernels import (
        decode_attention as da, decode_attention_int8 as di,
        flash_attention as fa,
    )
    pairs = {"flash_attention": (fa.flash_attention, fa.flash_attention_plain,
                                 4),
             "decode_attention": (da.decode_attention,
                                  da.decode_attention_plain, 4),
             "decode_attention_int8": (di.decode_attention_int8,
                                       di.decode_attention_int8_plain, 1)}
    out = {}
    for name, (a, kw) in seen.items():
        kernel, plain, n_ulps = pairs[name]
        step = 0.0
        if name == "decode_attention_int8":
            q, k8, v8, kvs, mask = a
            step = p_step(di, q[:, None], k8, v8, kvs, mask[:, None])
        err, tol = check_err(torch, name, kernel(*a, **kw),
                             plain(*a, **kw), n_ulps, step)
        out[name] = (err, tol, [tuple(x.shape) for x in a
                                if torch.is_tensor(x)])
    return out


def serve_leg(torch, mesh, quant, ref=None) -> dict:
    """One serve leg on the model of `full_width.build` (bf16, or w8a8 +
    int8 KV with `quant`), sharded over `mesh` (None: one process, the
    reference): a transcribe call of phase 16's batch (its tokens, launch
    counts, and the #2 / #4 or #6 inputs it gave, held against the plain
    versions), the logits of the prefill and GATE_STEPS steps (teacher-fed
    `ref`'s tokens), a timed call (RTFx) and one timed with the collective
    clock on (the share of its wall in collectives)."""
    from unittest import mock

    import mtasr_tpu_torch.api as api_mod
    import mtasr_tpu_torch.models.llama as llama_mod
    import mtasr_tpu_torch.models.wavlm as wavlm_mod
    from mtasr_tpu_torch.parallel.collectives import CollectiveClock
    from mtasr_tpu_torch.parallel.mesh import dp_rows, gather_rows
    from mtasr_tpu_torch.tools import full_width
    q = "w8a8" if quant else None
    cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16,
                                      quantize=q, kv_quant=bool(quant))
    if mesh is not None:
        from mtasr_tpu_torch.parallel.mesh import shard_model
        shard_model(model, cfg, mesh)
    wavs = full_width.waveforms(PAR_SEED, 1, BATCH, (6.0, 10.0))[0]
    audio_s = sum(len(w) for w in wavs) / SR
    kw = dict(batch_size=BATCH, max_new_tokens=MAX_NEW)
    seen, tokens = {}, []
    real = api_mod.generate

    def keep(*a, **k):
        out = real(*a, **k)
        tokens.append(out.sequences.cpu())
        return out
    decode = "decode_attention_int8" if quant else "decode_attention"
    with first_inputs(torch, wavlm_mod, "flash_attention", seen), \
            first_inputs(torch, llama_mod, decode, seen), \
            mock.patch.object(api_mod, "generate", keep):
        _, counts, _ = counted(torch, lambda: tr.transcribe(wavs, **kw))
    checks = captured_checks(torch, seen)
    wav, amask = one_batch(torch, tr, wavs)
    rows = dp_rows(mesh, BATCH)
    fed = None if ref is None else ref["tokens"].cuda()
    if fed is not None and rows is not None:
        fed = fed[rows]
    logits, _ = step_logits(torch, cfg, model, tr.gen, wav, amask,
                            tokens=fed)
    logits = gather_rows(logits, mesh, rows, dim=1).cpu()
    _, _, wall = counted(torch, lambda: tr.transcribe(wavs, **kw))
    CollectiveClock.on, CollectiveClock.seconds = True, 0.0
    _, _, wall_c = counted(torch, lambda: tr.transcribe(wavs, **kw))
    CollectiveClock.on = False
    out = {"tokens": tokens[0], "logits": logits, "rtfx": audio_s / wall,
           "wall": wall, "collective_share": CollectiveClock.seconds / wall_c,
           "counts": counts, "checks": checks}
    if mesh is None:
        out["gap"] = greedy_with_gaps(torch, model, cfg, wav, amask,
                                      bool(quant))[1]
    del cfg, model, tr
    torch.cuda.empty_cache()
    return out


def train_leg(torch, mesh) -> dict:
    """One deterministic attention-mode step of phase 9's model (global
    B = TRAIN_BATCH x AUDIO_S s, SpecAugment mask, no dropout, warmup 0)
    through `Trainer`, sharded over `mesh` (None: one process): the loss,
    the grad norm, the encoder's gradients (dp-summed, gathered whole) and
    every trainable parameter after it (gathered whole), on the host; then
    a timed step (ms/step) and one with the collective clock on."""
    from mtasr_tpu_torch.config import DataConfig, TrainingConfig
    from mtasr_tpu_torch.parallel.collectives import CollectiveClock
    from mtasr_tpu_torch.parallel.mesh import gather_state_dict
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.train.loop import Trainer
    cfg, model = full_width.build_train(SEED, "cuda", torch.bfloat16)
    batch = full_width.train_batch(cfg, TRAIN_BATCH, AUDIO_S, SEED)
    out_dir = tempfile.mkdtemp(prefix="parallel_train_")
    tc = TrainingConfig(output_dir=out_dir, learning_rate=TRAIN_LR,
                        warmup_steps=0, max_steps=1000, pcgrad=False)
    trainer = Trainer(cfg, tc, DataConfig(), model, mesh=mesh,
                      freeze_kwargs=dict(freeze_decoder=True))
    opt, grads = trainer.optimizer, {}
    real = opt._update

    def keep(gs):
        grads.update({n: g.detach().float().clone()
                      for n, g in zip(opt.names, gs)
                      if n.startswith("encoder.")})
        real(gs)
    opt._update = keep
    step = trainer._train_step(batch.splice_index)
    t = trainer._tensors(batch, rows=True)
    before = yardstick = None
    if mesh is None:
        before = {n: p.detach().to("cpu", torch.float32, copy=True)
                  for n, p in model.named_parameters() if p.requires_grad}
        # the rounding yardstick: this step's encoder gradients with the
        # kernels against the plain versions (phase 9's comparison)
        _, gk, _, _ = encoder_grads(torch, cfg, model, t, False)
        _, gp, _, _ = encoder_grads(torch, cfg, model, t, True)
        table = [n for n in gk if "rel_attn_embed" in n]
        yardstick = (rel_l2_dicts(gk, gp), rel_l2_dicts(
            {n: gk[n] for n in table}, {n: gp[n] for n in table}))
        del gk, gp
    torch.cuda.reset_peak_memory_stats()
    m, counts, _ = counted(torch, lambda: step(model, t, None))
    opt._update = real
    trained = {n: p.detach() for n, p in model.named_parameters()
               if p.requires_grad}
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "grads": {k: v.cpu() for k, v in
                     gather_state_dict(grads, model).items()},
           "params": {k: v.to("cpu", torch.float32, copy=True) for k, v in
                      gather_state_dict(trained, model).items()},
           "counts": counts, "before": before, "yardstick": yardstick}
    grads.clear()
    _, _, wall = counted(torch, lambda: step(model, t, None))
    CollectiveClock.on, CollectiveClock.seconds = True, 0.0
    _, _, wall_c = counted(torch, lambda: step(model, t, None))
    CollectiveClock.on = False
    out.update(ms=1e3 * wall, collective_share=CollectiveClock.seconds
               / wall_c, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    shutil.rmtree(out_dir, ignore_errors=True)
    del cfg, model, trainer, opt, step, t
    torch.cuda.empty_cache()
    return out


def rel_l2_dicts(got, ref) -> float:
    num = math.sqrt(sum(float((got[n].float() - ref[n].float()).pow(2)
                              .sum()) for n in ref))
    den = math.sqrt(sum(float(ref[n].float().pow(2).sum()) for n in ref))
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def rank_main(argv) -> None:
    """One rank of phase 16 (`python3 chip_smoke.py --rank R WORLD PORT
    DIR`): gloo on cuda:0; the tp legs (bf16, int8 serve; train) on a 1 x 2
    mesh, then the dp legs (bf16 serve; train) on 2 x 1; every reading
    against the references in DIR/ref.pt, saved to DIR/rank<R>.pt."""
    rank, world, port, root = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.modules["jax"] = None
    sys.modules["mtasr_tpu"] = None
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    from mtasr_tpu_torch.parallel import multihost
    from mtasr_tpu_torch.parallel.mesh import make_mesh
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo",
                         device="cuda:0")
    ref = torch.load(os.path.join(root, "ref.pt"), weights_only=False)
    train_ref = None
    out = {}
    for axis, shape in (("tp", (1, world)), ("dp", (world, 1))):
        mesh = make_mesh(*shape)
        for quant in ((False, True) if axis == "tp" else (False,)):
            tag = f"{axis} {'int8' if quant else 'bf16'}"
            r = ref["serve"][quant]
            got = serve_leg(torch, mesh, quant, r)
            parts, worst = parted(torch, got["tokens"], r["tokens"],
                                  r["gap"])
            out[tag] = {
                "parted_rows": parts, "worst_gap": worst,
                "logits_rel_l2": float((got["logits"] - r["logits"]).norm()
                                       / r["logits"].norm()),
                "finite": bool(torch.isfinite(got["logits"]).all()),
                **{k: got[k] for k in ("rtfx", "wall", "collective_share",
                                       "counts", "checks")}}
        got = train_leg(torch, mesh)
        if rank == 0:
            if train_ref is None:
                train_ref = torch.load(os.path.join(root, "train_ref.pt"),
                                       weights_only=False)
            table = [n for n in train_ref["grads"] if "rel_attn_embed" in n]
            out[f"{axis} train"] = {
                "grads_rel_l2": rel_l2_dicts(got["grads"],
                                             train_ref["grads"]),
                "rel_pos_table_rel_l2": rel_l2_dicts(
                    {n: got["grads"][n] for n in table},
                    {n: train_ref["grads"][n] for n in table}),
                "params_rel_l2": rel_l2_dicts(got["params"],
                                              train_ref["params"]),
                "update_rel_l2": rel_l2_dicts(
                    {n: got["params"][n] - train_ref["before"][n]
                     for n in train_ref["before"]},
                    {n: train_ref["params"][n] - train_ref["before"][n]
                     for n in train_ref["before"]}),
                "same_names": sorted(got["params"]) == sorted(
                    train_ref["params"]),
                **{k: got[k] for k in ("loss", "grad_norm", "ms",
                                       "collective_share", "peak_gib",
                                       "counts")}}
        else:
            out[f"{axis} train"] = {k: got[k] for k in (
                "ms", "collective_share", "peak_gib", "counts")}
        del got
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def launch_ranks(torch, root: str) -> list:
    """Phase 16's ranks, started together and joined with PAR_TIMEOUT:
    any rank that fails, or does not end in time, fails the phase (the
    others are killed)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = [open(os.path.join(root, f"rank{r}.log"), "w+")
            for r in range(PAR_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         str(PAR_WORLD), str(port), root], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(PAR_WORLD)]
    deadline = time.monotonic() + PAR_TIMEOUT
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(
                p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            logs[r].seek(0)
            say(f"--- parallel rank {r} (exit {procs[r].returncode}) ---\n"
                + logs[r].read()[-4000:])
        fail(f"parallel: rank(s) {bad} failed or did not end within "
             f"{PAR_TIMEOUT} s")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(PAR_WORLD)]


def nccl_world1_leg(torch, card: str, root: str) -> None:
    """16d: the inference CLI under `torch.distributed.run
    --nproc_per_node 1` (NCCL, world size 1, cuda:LOCAL_RANK) on a saved
    full-width directory writes the `decod` of the same CLI in this
    process."""
    from mtasr_tpu_torch.cli import inference_asr
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.utils import model_io
    cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16)
    d = os.path.join(root, "model")
    model_io.save_model(d, cfg, model)
    tr.tokenizer.save(os.path.join(d, "char_tokenizer.json"))
    del cfg, model, tr
    torch.cuda.empty_cache()
    data, _ = kaldi_dir(root, BATCH, AUDIO_S, PAR_SEED)
    flags = ["--model_name_or_path", d, "--data_dir", data, "--batch_size",
             str(BATCH), "--max_length", str(MAX_NEW)]
    t0 = time.perf_counter()
    inference_asr.main(flags + ["--output_dir", os.path.join(root, "one")])
    dt_one = time.perf_counter() - t0
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "mtasr_tpu_torch.cli.inference_asr",
         *flags, "--output_dir", os.path.join(root, "nccl")],
        cwd=here, env=dict(os.environ, PYTHONPATH=here),
        capture_output=True, text=True, timeout=PAR_TIMEOUT)
    dt_run = time.perf_counter() - t0
    log = run.stdout + run.stderr
    files = {}
    for tag in ("one", "nccl"):
        path = os.path.join(root, tag, "decod")
        files[tag] = open(path).read() if os.path.exists(path) else None
    nccl = "(nccl)" in log
    say(f"parallel 16d: inference_asr under torch.distributed.run "
        f"--nproc_per_node 1: exit {run.returncode}, NCCL process group "
        f"{nccl}, {dt_run:.1f} s (one process {dt_one:.1f} s), decod equal "
        f"{files['one'] == files['nccl']} ({BATCH} x {AUDIO_S} s) [{card}]")
    if run.returncode != 0 or not nccl or files["one"] is None or \
            files["one"] != files["nccl"]:
        say(log[-4000:])
        fail("parallel 16d: the NCCL run of the inference CLI differs from "
             "one process")


def parallel_phase(torch, card: str, launches) -> None:
    """Phase 16 (module docstring): the single-process references, then
    PAR_WORLD ranks on cuda:0 over gloo (16a tp serve bf16 + int8, 16c tp
    train, 16b dp serve, 16c dp train), then 16d; every reading printed
    before any is gated. The ranks' launch counts go into `launches`."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="parallel_smoke_")
    ref = {"serve": {q: serve_leg(torch, None, q) for q in (False, True)}}
    torch.save(ref, os.path.join(root, "ref.pt"))
    train_ref = train_leg(torch, None)
    torch.save(train_ref, os.path.join(root, "train_ref.pt"))
    ms_one, yard = train_ref["ms"], train_ref["yardstick"]
    del train_ref
    torch.cuda.synchronize()
    ranks = launch_ranks(torch, root)
    over = []
    for tag, got in ranks[0].items():
        for r, res in enumerate(ranks):
            for name, n in res[tag]["counts"].items():
                launches[name] += n
        if tag.endswith("train"):
            g = got
            say(f"parallel {tag}: grads rel_l2 {g['grads_rel_l2']:.5g} "
                f"(rel-pos table {g['rel_pos_table_rel_l2']:.5g}, tol "
                f"{REL_POS_TOL}; one process's kernels vs plain "
                f"{yard[0]:.5g}, its table {yard[1]:.5g}), "
                f"parameters after the step rel_l2 {g['params_rel_l2']:.5g} "
                f"(the update alone {g['update_rel_l2']:.5g}, reported) vs "
                f"one process (tol {GRAD_TOL}); loss {g['loss']:.5f} grad "
                f"norm {g['grad_norm']:.5f}; {g['ms']:.1f} ms/step vs "
                f"{ms_one:.1f} one process, collectives "
                f"{g['collective_share']:.3f} of a clocked step; peak "
                f"{[round(res[tag]['peak_gib'], 2) for res in ranks]} GiB; "
                f"launches {[res[tag]['counts'] for res in ranks]} B="
                f"{TRAIN_BATCH} [{card}]")
            tols = {"grads_rel_l2": GRAD_TOL, "params_rel_l2": GRAD_TOL,
                    "rel_pos_table_rel_l2": REL_POS_TOL}
            bad = [k for k, tol in tols.items()
                   if not math.isfinite(g[k]) or g[k] > tol]
            if bad or not g["same_names"]:
                over.append(f"{tag}: " + ", ".join(
                    f"{k} {g[k]} over {tols[k]}" for k in bad))
            want = ("conv0_fused", "flash_attention", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", "flash_attention_bwd_dpb")
            if any(res[tag]["counts"].get(k, 0) == 0 for res in ranks
                   for k in want):
                over.append(f"{tag}: kernels not launched")
            continue
        rtfx_one = ref["serve"]["int8" in tag]["rtfx"]
        for r, res in enumerate(ranks):
            g = res[tag]
            say(f"parallel {tag} rank {r}: tokens part from one process's "
                f"in {g['parted_rows']} rows (largest top-2 gap there "
                f"{g['worst_gap']:.5f}, TIE_TOL {TIE_TOL}); logits of the "
                f"prefill + {GATE_STEPS} steps rel_l2 {g['logits_rel_l2']:.5g}"
                f" (tol {LOGITS_TOL}); kernels on their served inputs "
                f"{ {k: (round(e, 6), round(t, 6), s) for k, (e, t, s) in g['checks'].items()} }"
                f"; RTFx {g['rtfx']:.2f} vs {rtfx_one:.2f} one process, "
                f"collectives {g['collective_share']:.3f} of a clocked call; "
                f"launches {g['counts']} B={BATCH} [{card}]")
            if g["worst_gap"] > TIE_TOL or not g["finite"] or \
                    g["logits_rel_l2"] > LOGITS_TOL:
                over.append(f"{tag} rank {r}: gap {g['worst_gap']}, logits "
                            f"{g['logits_rel_l2']}")
            want = {"conv0_fused", "flash_attention",
                    "decode_attention_int8" if "int8" in tag
                    else "decode_attention"}
            if set(g["checks"]) != want - {"conv0_fused"} or \
                    any(g["counts"].get(k, 0) == 0 for k in want):
                over.append(f"{tag} rank {r}: kernels {g['counts']}")
    nccl_world1_leg(torch, card, root)
    shutil.rmtree(root, ignore_errors=True)
    say(f"parallel: phase wall {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    if over:
        fail("parallel: " + "; ".join(over))


# -- phase 17: pipelined stream decoding, the native host helpers, tracing
PIPE_SEED = SEED + 17    # the streams' waveforms and the Kaldi directory
PIPE_BATCHES = 3         # batches of the bf16 stream
PIPE_BATCHES_INT8 = 2    # of the int8 one (its decode step is 3-4x bf16's)
CLI_NEW = 32             # new tokens of 17c's CLI runs
NATIVE_TOL = 2e-4        # the native loader's normalisation against Python's
                         # (another rounding: `tests/test_native.py:158`)
HOST_REPS = 5            # collates timed a loader, the median kept
SHORT_NEW = 32           # new tokens of the short streams timed in turns
SHORT_ROUNDS = 2         # their rounds
PROFILE_NEW = 16         # new tokens of the profiled two-batch runs


def nonzero(counts) -> dict:
    return {k: n for k, n in counts.items() if n}


def stream_parted(torch, model, cfg, batches, outs, seq, kv_quant):
    """(rows whose stream tokens part from sequential generate's, the
    largest top-2 gap where one parts): the gaps read, by a greedy rerun,
    only for a batch that parts."""
    rows, worst = 0, 0.0
    for b, o, s in zip(batches, outs, seq):
        if torch.equal(o.sequences, s.sequences):
            continue
        ref, gap, _, _ = greedy_with_gaps(torch, model, cfg,
                                          b["input_values"],
                                          b["audio_mask"], kv_quant)
        r, w = parted(torch, o.sequences.cpu(), ref, gap)
        rows, worst = rows + r, max(worst, w)
    return rows, worst


def stream_leg(torch, card: str, launches, cfg, model, tr, quant: bool,
               root=None):
    """17a (bf16; with `root`, also 17d and the model directory of 17c) /
    17b (the model quantized w8a8, an int8 KV cache): a stream through
    `generate_pipelined` against `engine.generate` on each batch. Every
    reading is printed before any is gated; returns the failures."""
    import glob
    from unittest import mock

    from mtasr_tpu_torch.config import GenerationConfig
    from mtasr_tpu_torch.generate import engine, pipelined
    from mtasr_tpu_torch.models.speech_encoder_decoder import encode_speech
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.utils import model_io, profiling
    tag = "int8" if quant else "bf16"
    n_batches = PIPE_BATCHES_INT8 if quant else PIPE_BATCHES
    requests = full_width.waveforms(PIPE_SEED, n_batches, BATCH,
                                    (6.0, 10.0))
    batches = [dict(zip(("input_values", "audio_mask"),
                        one_batch(torch, tr, wavs))) for wavs in requests]
    audio_s = sum(len(w) for wavs in requests for w in wavs) / SR
    gen = GenerationConfig(do_sample=False, kv_quant=quant)

    def sequential():
        return [engine.generate(model, cfg, b["input_values"],
                                b["audio_mask"], gen=gen,
                                max_new_tokens=MAX_NEW) for b in batches]

    def stream(bs=batches, n=MAX_NEW):
        return pipelined.generate_pipelined(model, cfg, bs, gen=gen,
                                            max_new_tokens=n)
    # warm-up: a short stream (the second CUDA stream's handles)
    t_leg = time.perf_counter()
    stream(batches[:2], 4)
    torch.cuda.synchronize()
    encs = []
    real_post = pipelined._post_encode

    def keep(*a, **kw):
        enc = real_post(*a, **kw)
        encs.append(enc.encoder_hidden_states.clone())
        return enc
    # bf16 times the sequential loop first, int8 the stream first
    if quant:
        with mock.patch.object(pipelined, "_post_encode", keep):
            outs, counts, wall = counted(torch, stream)
    seq, seq_counts, seq_wall = counted(torch, sequential)
    if not quant:
        with mock.patch.object(pipelined, "_post_encode", keep):
            outs, counts, wall = counted(torch, stream)
    for name, n in counts.items():
        launches[name] += n
    with torch.inference_mode():
        ref_encs = [encode_speech(model, cfg, b["input_values"],
                                  b["audio_mask"]).encoder_hidden_states
                    for b in batches]
        t0 = synced(torch)
        encode_speech(model, cfg, batches[0]["input_values"],
                      batches[0]["audio_mask"])
        encode_ms = 1e3 * (synced(torch) - t0)
    enc_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(encs, ref_encs))
    rows, worst = stream_parted(torch, model, cfg, batches, outs, seq, quant)
    steps = [o.steps for o in outs]
    decode = "decode_attention_int8" if quant else "decode_attention"
    L_enc = cfg.encoder.num_hidden_layers
    saved = 1e3 * (seq_wall - wall) / (n_batches - 1)
    say(f"pipelined 17{'b' if quant else 'a'} [{tag}]: {n_batches} "
        f"batches x {BATCH} padded 6-10 s waveforms, {MAX_NEW} new tokens, "
        f"decode steps {steps}; tokens part from engine.generate's in {rows}"
        f" rows (largest top-2 gap there {worst:.5f}, TIE_TOL {TIE_TOL}); "
        f"encoder output against the sequential encode's max_abs_err "
        f"{enc_err:.5g}; launches {nonzero(counts)} (sequential "
        f"{nonzero(seq_counts)}); RTFx stream {audio_s / wall:.3f} vs "
        f"sequential {audio_s / seq_wall:.3f} (walls {wall:.4f} / "
        f"{seq_wall:.4f} s, one each, the "
        f"{'stream' if quant else 'sequential loop'} first); wall saved a "
        f"batch after "
        f"the first {saved:.2f} ms against a sequential encode of "
        f"{encode_ms:.2f} ms wall; leg wall so far "
        f"{time.perf_counter() - t_leg:.1f} s B={BATCH} [{card}]")
    bad = []
    if worst > TIE_TOL or not all(bool(torch.isfinite(e.float()).all())
                                  for e in encs):
        bad.append(f"17 {tag}: tokens part at a top-2 gap {worst}")
    want = dict(seq_counts)
    if counts != want or counts["conv0_fused"] != n_batches or \
            counts["flash_attention"] != L_enc * n_batches or \
            counts[decode] == 0:
        bad.append(f"17 {tag}: launches {counts} != sequential {want}")
    if root is not None:
        # short streams (SHORT_NEW tokens), where the encode is a larger
        # share: SHORT_ROUNDS rounds in turns; then the idle share of two
        # batches of PROFILE_NEW tokens each way under the profiler (its
        # post-processing of a long run takes minutes)
        from mtasr_tpu_torch.tools.profile_path import profiled

        def runs(bs, n):
            return {"sequential": lambda: [engine.generate(
                        model, cfg, b["input_values"], b["audio_mask"],
                        gen=gen, max_new_tokens=n) for b in bs],
                    "stream": lambda: stream(bs, n)}
        short = {name: [] for name in runs(batches, SHORT_NEW)}
        for _ in range(SHORT_ROUNDS):
            for name, fn in runs(batches, SHORT_NEW).items():
                short[name].append(counted(torch, fn)[2])
        for name, fn in runs(batches[:2], PROFILE_NEW).items():
            med = statistics.median(short[name])
            fn_wall = counted(torch, fn)[2]
            _, busy, top = profiled(fn)
            say(f"pipelined 17a: {name}, {n_batches} batches x "
                f"{SHORT_NEW} tokens: walls "
                f"{[round(1e3 * w, 1) for w in short[name]]} ms in turns "
                f"(median {1e3 * med:.1f}, RTFx {audio_s / med:.2f}); 2 "
                f"batches x {PROFILE_NEW} tokens: wall {1e3 * fn_wall:.1f} "
                f"ms, device busy {busy:.3f} ms (union of kernel intervals "
                f"under torch.profiler), idle share "
                f"{1 - busy / (1e3 * fn_wall):.3f}; largest device items "
                f"{[(n[:40], round(ms, 3), c) for n, ms, c in top[:4]]} "
                f"[{card}]")
            if busy > 1e3 * fn_wall:
                bad.append(f"17a: device busy {busy} ms past the wall")
        # 17d: a user's trace names the overlap; the card's memory
        logdir = os.path.join(root, "trace")
        with profiling.trace(logdir):
            stream(batches[:2], 4)
        files = glob.glob(os.path.join(logdir, "*.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        regions = [r for r in ("mtasr.pipelined.frontend",
                               "mtasr.pipelined.stage",
                               "mtasr.pipelined.post_encode") if r in text]
        mem = profiling.device_memory_stats()
        say(f"pipelined 17d: profiling.trace wrote {len(files)} file(s), "
            f"{len(text) / 1e6:.2f} MB, regions {regions}; "
            f"device_memory_stats {mem} [{card}]")
        if len(regions) != 3 or not (mem.get("bytes_in_use", 0) > 0
                                     and mem.get("peak_bytes_in_use", 0) > 0
                                     and mem.get("bytes_limit", 0) > 0):
            bad.append("17d: the trace or the memory stats are missing")
        model_io.save_model(os.path.join(root, "model"), cfg, model)
        tr.tokenizer.save(os.path.join(root, "model", "char_tokenizer.json"))
    del encs, ref_encs, outs, seq
    torch.cuda.empty_cache()
    return bad


def native_leg(torch, card: str, launches, root) -> list:
    """17c: the port's native host library on a Kaldi directory of
    generated 10 s WAVs: built and used on every row; `collate` native
    against Python; host ms a batch; `Calculator` native against Python;
    `cli.inference_asr --pipelined` against the same CLI without it, on the
    model directory 17a saved. Returns the failures."""
    from unittest import mock

    import numpy as np

    from mtasr_tpu_torch.cli import inference_asr
    from mtasr_tpu_torch.config import DataConfig
    from mtasr_tpu_torch.data import pipeline
    from mtasr_tpu_torch.data.audio import load_kaldi_dir
    from mtasr_tpu_torch.ops import kernels
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.utils import native, wer
    bad = []
    data, paths = kaldi_dir(root, 2 * BATCH, AUDIO_S, PIPE_SEED)
    t0 = time.perf_counter()
    built = {n: native.get_lib(n) is not None for n in native.SOURCES}
    build_s = time.perf_counter() - t0
    buf = np.zeros((len(paths), AUDIO_S * SR), np.float32)
    lens, status = native.wav_load_batch_native(paths, buf, SR) or (
        np.zeros(0), np.ones(len(paths)))
    cfg, tok = full_width.config()
    dc = DataConfig()
    exs = pipeline.prepare_examples(load_kaldi_dir(data), tok, dc,
                                    lazy=True)[:BATCH]

    def timed_collate():
        ms = []
        for _ in range(HOST_REPS):
            t0 = time.perf_counter()
            batch = pipeline.collate(exs, cfg, dc)
            ms.append(1e3 * (time.perf_counter() - t0))
        return batch, sorted(ms)[len(ms) // 2]
    nat, nat_ms = timed_collate()
    with mock.patch.object(pipeline, "wav_load_batch_native",
                           lambda *a, **k: None):
        py, py_ms = timed_collate()
    err = float(np.abs(nat.arrays["input_values"]
                       - py.arrays["input_values"]).max())
    masks = bool((nat.arrays["audio_mask"] == py.arrays["audio_mask"]).all())
    rng = np.random.default_rng(PIPE_SEED)
    words = ["hello", "world", "<sc>", "good", "day", "one", "two"]
    pairs = [(" ".join(rng.choice(words, rng.integers(0, 40))),
              " ".join(rng.choice(words, rng.integers(0, 40))))
             for _ in range(200)]
    calc_ms, calcs = {}, {}
    for use in (True, False):
        c = wer.Calculator(use_native=use)
        t0 = time.perf_counter()
        for i, (a, b) in enumerate(pairs):
            c.calculate(str(i), a, b)
        calc_ms[use] = 1e3 * (time.perf_counter() - t0)
        calcs[use] = c.summary()
    say(f"pipelined 17c: native libraries built {built} in {build_s:.2f} s; "
        f"{len(paths)} x {AUDIO_S} s WAVs, statuses "
        f"{sorted(set(status.tolist()))}, lengths "
        f"{sorted(set(lens.tolist()))}; collate of {BATCH} lazy rows "
        f"native vs Python max_abs_err {err:.3g} (tol {NATIVE_TOL}), masks "
        f"equal {masks}; host ms a batch of {BATCH} (median of {HOST_REPS}): "
        f"native {nat_ms:.2f}, Python {py_ms:.2f}; Calculator over "
        f"{len(pairs)} pairs native {calc_ms[True]:.2f} ms vs Python "
        f"{calc_ms[False]:.2f} ms, {calcs[True]} / {calcs[False]} [{card}]")
    if not all(built.values()) or len(status) != len(paths) or \
            set(status.tolist()) != {0} or err > NATIVE_TOL or not masks or \
            calcs[True] != calcs[False]:
        bad.append("17c: the native library or its results")
    # the inference CLI, with and without --pipelined
    seen, seqs, texts, cli_counts = [], {}, {}, {}
    real_load = pipeline.wav_load_batch_native

    def load(*a, **kw):
        res = real_load(*a, **kw)
        seen.append(None if res is None else res[1].tolist())
        return res
    for tag, extra in (("plain", []), ("pipelined", ["--pipelined"])):
        out = os.path.join(root, f"decode_{tag}")
        seqs[tag] = []
        fn = "generate_pipelined" if extra else "generate"
        real = getattr(inference_asr, fn)

        def keep(*a, _real=real, _tag=tag, **kw):
            res = _real(*a, **kw)
            for o in (res if isinstance(res, list) else [res]):
                seqs[_tag].append(o.sequences.cpu())
            return res
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(pipeline, "wav_load_batch_native", load), \
                mock.patch.object(inference_asr, fn, keep):
            inference_asr.main([
                "--model_name_or_path", os.path.join(root, "model"),
                "--data_dir", data, "--output_dir", out, "--batch_size",
                str(BATCH), "--max_length", str(CLI_NEW), *extra])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cli_counts[tag] = kernels.launch_counts()
        for name, n in cli_counts[tag].items():
            launches[name] += n
        texts[tag] = (open(os.path.join(out, "decod")).read(),
                      open(os.path.join(out, "wer")).read().strip())
        say(f"pipelined 17c: inference_asr {' '.join(extra) or '(plain)'}: "
            f"{dt:.2f} s for {len(paths)} x {AUDIO_S} s, {texts[tag][1]}; "
            f"launches {nonzero(cli_counts[tag])} [{card}]")
    a, b = torch.cat(seqs["plain"]), torch.cat(seqs["pipelined"])
    rows_ok = [s for s in seen if s is not None]
    same = texts["plain"] == texts["pipelined"] and a.shape == b.shape and \
        torch.equal(a, b)
    say(f"pipelined 17c: --pipelined decod and wer equal the plain CLI's "
        f"{same} (token ids {tuple(a.shape)}); native loads "
        f"{len(rows_ok)} batches, rows {sum(len(s) for s in rows_ok)}, "
        f"statuses {sorted({x for s in rows_ok for x in s})} [{card}]")
    if not same or len(rows_ok) != len(seen) or \
            sum(len(s) for s in rows_ok) != 2 * len(paths) or \
            {x for s in rows_ok for x in s} != {0} or \
            cli_counts["pipelined"]["conv0_fused"] != 2:
        bad.append("17c: the --pipelined CLI or its native loads")
    return bad


def pipelined_phase(torch, card: str, launches) -> None:
    """Phase 17 (module docstring)."""
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.utils.quantize import quantize_for_serving
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="pipelined_smoke_")
    cfg, model, tr = full_width.build(SEED, "cuda", torch.bfloat16)

    def int8_leg():
        quantize_for_serving(model, "w8a8")    # in place, as build does
        return stream_leg(torch, card, launches, cfg, model, tr, True)
    laps, bad = {}, []
    for leg, fn in (("17a+d", lambda: stream_leg(torch, card, launches, cfg,
                                                 model, tr, False, root)),
                    ("17b", int8_leg),
                    ("17c", lambda: native_leg(torch, card, launches,
                                               root))):
        t0 = time.perf_counter()
        bad += fn()
        laps[leg] = round(time.perf_counter() - t0, 1)
        if leg == "17b":
            del cfg, model, tr
            torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    say(f"pipelined: phase wall {time.perf_counter() - t_phase:.1f} s "
        f"({laps} s) [{card}]")
    if bad:
        fail("pipelined: " + "; ".join(bad))


EIGHT_B_SEED = SEED + 18   # phase 18's waveforms
INIT_PEAK_TOL = 0.05       # the direct int8 init's peak over its footprint


def int8_yardstick(torch, cfg, model, tr, wavs) -> None:
    """What the int8 logits gate reads at 32 layers, printed: #6 against
    its plain version on every call of a kernel run (prefill and
    GATE_STEPS steps), and the logits of a plain run with #6 at layer 0
    alone, teacher-forced, against the plain run: a sound kernel's
    last-bit differences at one layer through the w8a8 layers after it."""
    from unittest import mock

    import mtasr_tpu_torch.models.llama as llama_mod
    from mtasr_tpu_torch.ops.kernels import decode_attention_int8 as di
    wav, amask = one_batch(torch, tr, wavs)
    kernel, plain = di.decode_attention_int8, di.decode_attention_int8_plain
    calls = []

    def checked(*a):
        out, ref = kernel(*a), plain(*a)
        calls.append(float((out.float() - ref.float()).abs().max() /
                           ulps_tol(ref.float(), 1)))
        return out
    with mock.patch.object(llama_mod, "decode_attention_int8", checked):
        _, toks = step_logits(torch, cfg, model, tr.gen, wav, amask)
    lp, _ = step_logits(torch, cfg, model, tr.gen, wav, amask, tokens=toks,
                        plain=True, decoder_only=True)
    n = {"i": 0}

    def layer0(*a):
        n["i"] += 1
        return (kernel if n["i"] % cfg.decoder.num_hidden_layers == 1
                else plain)(*a)
    with plain_versions(True, decoder_only=True), \
            mock.patch.object(llama_mod, "decode_attention_int8", layer0):
        lo, _ = step_logits(torch, cfg, model, tr.gen, wav, amask,
                            tokens=toks)
    rel = [round(float((lo[t] - lp[t]).norm() / lp[t].norm()), 5)
           for t in range(lp.shape[0])]
    say(f"8b[int8]: #6 against its plain version on the {len(calls)} calls "
        f"of a kernel run: {sum(c > 0 for c in calls)} differ, by at most "
        f"{max(calls):.3g} bf16 ulp; #6 at layer 0 alone, plain elsewhere: "
        f"logits rel_l2 at prefill and decode steps 1-{GATE_STEPS} {rel}")


def eight_b_leg(torch, card: str, launches, records, quantize, requests
                ) -> None:
    """One leg of phase 18: `full_width.build_8b` on the card (the init
    seconds, its peak device memory against its footprint), then
    `transcribe` of `requests` with the exact launch counts, the RTFx and
    the wall a decode step (a call's wall over its steps, the encode and
    prefill included), the logits kernels vs plain (int8: the decoder's
    kernels alone within LOGITS_TOL_INT8_8B; bf16: the whole model within
    LOGITS_TOL), the short prefill (#7 or #5, held against its plain
    version on its served inputs) and #4 or #6 at the served decode shape
    against its plain version."""
    from mtasr_tpu_torch.generate import engine
    from mtasr_tpu_torch.tools import full_width
    int8 = quantize is not None
    leg = "int8" if int8 else "bf16"
    gib = 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = synced(torch)
    cfg, model, tr = full_width.build_8b(SEED, "cuda", quantize=quantize,
                                         kv_quant=int8)
    init_s = synced(torch) - t0
    peak = torch.cuda.max_memory_allocated() - base
    final = torch.cuda.memory_allocated() - base
    dec = cfg.decoder
    say(f"8b[{leg}]: WavLM-Large + LLaMA-3.1-8B ({dec.num_hidden_layers} "
        f"layers, head dim {dec.head_dim_}, untied head of "
        f"{dec.vocab_size}), "
        + ("w8a8 decoder initialised directly in int8, int8 KV cache"
           if int8 else "bf16") +
        f": init {init_s:.2f} s, max_memory_allocated {peak / gib:.3f} GiB "
        f"against the final footprint {final / gib:.3f} GiB [{card}]")
    if int8 and peak > (1 + INIT_PEAK_TOL) * final:
        fail(f"8b: the direct int8 init peaked at {peak} bytes, over "
             f"{1 + INIT_PEAK_TOL} x its footprint {final}")
    timing = {}
    counts, rtfx = serve_phase(torch, card, cfg, tr, requests, f"8b {leg}",
                               timing=timing)
    for name, n in counts.items():
        launches[name] += n
    per_step = [1000 * w / max(n, 1)
                for w, n in zip(timing["walls"], timing["steps"])]
    say(f"8b[{leg}]: RTFx {rtfx:.2f}, wall a decode step "
        f"{[round(x, 3) for x in per_step]} ms (a call's wall over its "
        f"steps); max_memory_allocated while serving "
        f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB, allocated at "
        f"the end {torch.cuda.memory_allocated() / gib:.3f} GiB B={BATCH} "
        f"[{card}]")
    logits_phase(torch, cfg, model, tr, requests[-1], f"8b {leg}",
                 int8_tol=LOGITS_TOL_INT8_8B)
    if int8:
        int8_yardstick(torch, cfg, model, tr, requests[-1])
    torch.cuda.synchronize()
    short_prefill_phase(torch, card, cfg, tr, records, launches, f"8b {leg}",
                        int8_tol=LOGITS_TOL_INT8_8B)
    g = torch.Generator(device="cuda")
    g.manual_seed(EIGHT_B_SEED)
    ids, _ = engine.prompt_layout(cfg, BATCH, None, "cpu")
    S = ids.shape[1] + cfg.encoder.adapter_output_length(
        cfg.encoder.conv_output_length(SR * AUDIO_S)) + MAX_NEW
    decode_at_batch(torch, card, BATCH, dec.num_attention_heads,
                    dec.num_key_value_heads, S, dec.head_dim_,
                    lambda *sh: torch.randn(sh, generator=g, device="cuda",
                                            dtype=torch.bfloat16))
    del model, tr
    gc.collect()
    torch.cuda.empty_cache()


def eight_b_phase(torch, card: str, launches, records) -> None:
    """Phase 18: WavLM-Large + LLaMA-3.1-8B served at full width, int8
    (w8a8 from the direct int8 init, int8 KV: #1, #2, #6, #7) then bf16
    (#1, #2, #4, #5); every earlier model freed first."""
    from mtasr_tpu_torch.tools import full_width
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"8b: device memory allocated at the start "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    requests = full_width.waveforms(EIGHT_B_SEED, 2, BATCH, (6.0, 10.0))
    eight_b_leg(torch, card, launches, records, "w8a8", requests)
    eight_b_leg(torch, card, launches, records, None, requests[:1])
    say(f"8b: phase 18 wall {time.perf_counter() - t0:.1f} s [{card}]")


# -- phase 19: Moonlight-16B-A3B's blocks ------------------------------------
def moonlight_phase(torch, card: str, launches) -> None:
    """WavLM-Large and Moonlight-16B-A3B's decoder, MOONLIGHT_LAYERS deep,
    served (module docstring, phase 19)."""
    from unittest import mock

    from mtasr_tpu_torch.api import Transcriber
    from mtasr_tpu_torch.config import (
        GenerationConfig, moonlight_16b_a3b_config,
    )
    from mtasr_tpu_torch.models import moe as moe_mod
    from mtasr_tpu_torch.ops.kernels import moe_experts as mk
    from mtasr_tpu_torch.tools import full_width
    from mtasr_tpu_torch.utils.convert import init_random

    t_phase = time.perf_counter()
    cfg, tok = full_width.config(
        decoder=lambda **k: moonlight_16b_a3b_config(
            num_hidden_layers=MOONLIGHT_LAYERS, **k), mask_time_prob=0.0)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    model = init_random(cfg, g, "cuda", torch.bfloat16)
    tr = Transcriber(cfg, model, tok, gen=GenerationConfig(do_sample=False))
    n_dec = sum(p.numel() for p in model.decoder.parameters())
    torch.cuda.synchronize()
    say(f"moonlight: WavLM-Large + {MOONLIGHT_LAYERS} Moonlight-16B-A3B "
        f"layers ({n_dec} decoder parameters bf16), built "
        f"{time.perf_counter() - t_phase:.2f} s")
    requests = full_width.waveforms(SEED + 19, 2, BATCH, (6.0, 10.0))
    counts, rtfx = serve_phase(torch, card, cfg, tr, requests, "moonlight")
    for name, n in counts.items():
        launches[name] += n

    # the inputs the served prefill and step 1 (eager; the capture after
    # it runs nothing) gave #13
    seen, real = {}, moe_mod.moe_experts

    def keep(*a):
        key = "step" if a[0].shape[0] == BATCH else "prefill"
        if key not in seen:
            seen[key] = tuple(t.clone() for t in a)
        return real(*a)
    with mock.patch.object(moe_mod, "moe_experts", keep):
        breakdown_phase(torch, card, cfg, model, tr, requests[-1])
    if sorted(seen) != ["prefill", "step"]:
        fail(f"moonlight: #13 saw {sorted(seen)}, not the prefill and a step")
    for key, (x, rows, offsets, counts, w_gu, w_d) in sorted(seen.items()):
        out = mk.moe_experts(x, rows, offsets, counts, w_gu, w_d)
        ref = mk.moe_experts_plain(x, rows, offsets, w_gu, w_d)
        err, tol = check_err(torch, f"moe_experts ({key})", out, ref,
                             MOE_ULPS)
        say(f"moonlight: #13 on the served {key}'s inputs ({x.shape[0]} "
            f"tokens, {int((counts > 0).sum())} experts read) against its "
            f"plain loop: max_abs_err {err:.6g} (tol {tol:.6g})")
    say(f"moonlight: RTFx {rtfx:.2f} B={BATCH}, phase wall "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    del model, tr, seen
    torch.cuda.empty_cache()


def main() -> None:
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])      # one rank of phase 16
        return
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

    if "--only-decoding" in sys.argv[1:]:
        # phase 15 alone, on the model of a bf16 serve of its requests (in
        # place of phase 4's RTFx)
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        bf16 = [full_width.build(SEED, "cuda", torch.bfloat16)]
        _, rtfx_bf16 = serve_phase(torch, card, bf16[0][0], bf16[0][2],
                                   decoding_requests(), "bf16")
        decoding_phase(torch, card, launches, None, rtfx_bf16, bf16)
        say(f"decoding: launches {launches} (phase 15 alone: no kernels "
            "record)")
        print(json.dumps({"ok": True, "only": "decoding"}), flush=True)
        return

    if "--only-parallel" in sys.argv[1:]:
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        parallel_phase(torch, card, launches)
        say(f"parallel: launches {launches} (phase 16 alone: no kernels "
            "record)")
        print(json.dumps({"ok": True, "only": "parallel"}), flush=True)
        return

    if "--only-pipelined" in sys.argv[1:]:
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        pipelined_phase(torch, card, launches)
        say(f"pipelined: launches {launches} (phase 17 alone: no kernels "
            "record)")
        print(json.dumps({"ok": True, "only": "pipelined"}), flush=True)
        return

    if "--only-8b" in sys.argv[1:]:
        launches = dict.fromkeys(kernels.WRAPPERS, 0)
        eight_b_phase(torch, card, launches, {})
        say(f"8b: launches {launches} (phase 18 alone: no kernels record)")
        print(json.dumps({"ok": True, "only": "8b"}), flush=True)
        return

    if "--only-moonlight" in sys.argv[1:]:
        records, launches = {}, dict.fromkeys(kernels.WRAPPERS, 0)
        moe_kernel_phase(torch, card, records)
        moonlight_phase(torch, card, launches)
        say(json.dumps({"kernels": [{**records["moe_experts"],
                                     "launches": launches["moe_experts"]}]}))
        print(json.dumps({"ok": True, "only": "moonlight"}), flush=True)
        return

    if "--only-w8a8" in sys.argv[1:]:
        # phase 3's w8a8 kernels, then phase 7's int8 serve and its logits
        # gate (kernels against the plain versions)
        records = {}
        w8a8_kernel_phase(torch, card, records)
        cfg8, model8, tr8 = full_width.build(SEED, "cuda", torch.bfloat16,
                                             quantize="w8a8", kv_quant=True)
        requests = full_width.waveforms(SEED, 3, BATCH, (6.0, 10.0))
        counts, _ = serve_phase(torch, card, cfg8, tr8, requests[1:], "int8")
        logits_phase(torch, cfg8, model8, tr8, requests[-1], "int8")
        say(json.dumps({"kernels": [{**records[n], "launches": counts[n]}
                                    for n in ("w8a8_quantize",
                                              "w8a8_rescale")]}))
        print(json.dumps({"ok": True, "only": "w8a8"}), flush=True)
        return

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

    # -- beam search and speculative decoding ------------------------------
    decoding_phase(torch, card, launches, records, rtfx_bf16)

    # -- data and tensor parallelism -----------------------------------------
    parallel_phase(torch, card, launches)

    # -- pipelined stream decoding, the native host helpers, tracing --------
    pipelined_phase(torch, card, launches)

    # -- LLaMA-3.1-8B, int8 from the direct init and bf16 ---------------------
    eight_b_phase(torch, card, launches, records)

    # -- Moonlight-16B-A3B's blocks: latent attention and the experts --------
    moonlight_phase(torch, card, launches)

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
