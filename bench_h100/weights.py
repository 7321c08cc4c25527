"""The cell's weights, made on the device from the seed in a few large
calls, in the types they are served in: one bf16 buffer drawn N(0, 1) for
every matrix (each then scaled to N(0, 1/fan_in)), one drawn N(0,
TOKEN_STD^2) for the token embedding, one N(0, 0.02^2) for the biases and
the other tables (the rel-pos bias, SpecAugment's embedding), ones for the
norms' scales and the rel-pos gate constants, and for a w8a8 decoder one
int8 buffer drawn uniform in [-127, 127] for its linears, with a float32
scale a row that makes them N(0, 1/fan_in) as well. The flat names are the
program's parameter names; the same tensors go to the program (its load
path) and to the reference."""
from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

# the decoder linears that are served int8 under w8a8: the LLaMA family's
# attention and MLP projections and an untied output head
INT8 = re.compile(r"^decoder\.(model\.layers\.\d+\.(self_attn\.[qkvo]_proj"
                  r"|mlp\.(gate|up|down)_proj)|lm_head)\.weight$")
UNIFORM_INT8_STD = 73.3   # std of uniform integers in [-127, 127]
TOKEN_STD = 0.02          # the families' initializer_range (config.json)


def _kind(name: str, shape: Tuple[int, ...], int8: bool) -> str:
    if int8 and INT8.match(name):
        return "int8"
    if name.endswith("embed_tokens.weight"):
        return "token"
    table = "embed" in name and "pos_conv" not in name
    if len(shape) >= 2 and not table:
        return "matrix"
    if name.endswith("bias") or table:
        return "small"
    return "one"


def make(shapes: List[Tuple[str, Tuple[int, ...]]], precision: str, seed: int,
         device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """`shapes`: (name, shape) of every parameter, in the model's order."""
    int8 = precision == "w8a8"
    kinds = [(n, s, _kind(n, s, int8)) for n, s in shapes]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    sizes = {}
    for _, s, k in kinds:
        sizes[k] = sizes.get(k, 0) + math.prod(s)
    bufs = {}
    if sizes.get("matrix"):
        bufs["matrix"] = torch.empty(sizes["matrix"], dtype=dtype,
                                     device=device).normal_(generator=g)
    if sizes.get("token"):
        bufs["token"] = torch.empty(sizes["token"], dtype=dtype,
                                    device=device).normal_(0.0, TOKEN_STD,
                                                           generator=g)
    if sizes.get("small"):
        bufs["small"] = torch.empty(sizes["small"], dtype=dtype,
                                    device=device).normal_(0.0, 0.02,
                                                           generator=g)
    if sizes.get("int8"):
        bufs["int8"] = torch.empty(sizes["int8"], dtype=torch.int8,
                                   device=device).random_(-127, 128,
                                                          generator=g)
    if sizes.get("one"):
        bufs["one"] = torch.ones(sizes["one"], dtype=dtype, device=device)
    offset = dict.fromkeys(bufs, 0)
    flat: Dict[str, torch.Tensor] = {}
    for name, shape, kind in kinds:
        n = math.prod(shape)
        t = bufs[kind][offset[kind]:offset[kind] + n].view(shape)
        offset[kind] += n
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if kind == "matrix":
            flat[name] = t.mul_(fan_in ** -0.5)
        elif kind == "int8":
            stem = name[:-len(".weight")]
            flat[f"{stem}.weight_q8a8"] = t
            flat[f"{stem}.scale"] = torch.full(
                (shape[0],), 1.0 / (UNIFORM_INT8_STD * math.sqrt(fan_in)),
                dtype=torch.float32, device=device)
        else:
            flat[name] = t
    return flat
