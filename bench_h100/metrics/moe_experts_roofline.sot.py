"""The routed experts' grouped kernel (`mtasr_moe_gate_up_kernel` and
`mtasr_moe_down_kernel`, one launch of each a layer and forward): its
roofline bound over every forward of the traced calls, the prefill and
the decode steps alike, as a share of its device time. A forward of T
positions routes P = T k pairs through each expert layer; its operations
are 2 P x 3 H I, its bytes the weights of each expert that has pairs
(3 H I in bf16) and each pair's input and output row (H in bf16 each).
The experts read are counted by the program (`mtasr.decoder.moe.
experts_read`, over layers and forwards): under skewed routing a decode
step leaves many experts unread. A prefill (16384 tokens) is bound by its
operations, taken with every expert read; the steps are bound by bytes,
taken over all of them with the experts read less the prefills' (each
bound the larger of bytes at the card's rate and operations at the bf16
peak). A program without the kernel or the counter gives nothing."""
from bench_h100 import program
from bench_h100 import roofline as R

KERNELS = ("mtasr_moe_gate_up_kernel", "mtasr_moe_down_kernel")
EXPERTS_READ = "mtasr.decoder.moe.experts_read"


def read(rec):
    t = rec.device_s_having(*KERNELS)
    v = program.view(rec)
    g = rec.geometry
    dec = g["decoder"]
    if not t or not v or EXPERTS_READ not in v.counts:
        return None
    enc = g["encoder"]
    H, I, E = dec["hidden_size"], dec["moe_intermediate_size"], \
        dec["n_routed_experts"]
    k = dec["num_experts_per_tok"]
    layers = dec["num_hidden_layers"] - dec["first_k_dense_replace"]
    expert_bytes = 3 * H * I * 2
    sec = 0.0
    step_pairs = 0
    for batch in g["batches"]:
        B = len(batch["lengths"])
        T8 = R.adapter_lens(enc, R.conv_len(enc, batch["padded"]))[-1]
        P = B * (1 + T8) * k
        sec += layers * R.bound(E * expert_bytes + 2 * P * H * 2,
                                2 * P * 3 * H * I, "bf16")[0]
        step_pairs += layers * batch["steps"] * B * k
    step_experts = v.counts[EXPERTS_READ] - layers * E * len(g["batches"])
    sec += R.bound(step_experts * expert_bytes + 2 * step_pairs * H * 2,
                   2 * step_pairs * 3 * H * I, "bf16")[0]
    return 100.0 * sec / t
