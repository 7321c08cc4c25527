"""One-token GQA attention over the merged-lane KV cache (counterpart of
`mtasr_tpu/ops/pallas/decode_attention.py::decode_attention`).

`decode_attention` launches the CUDA kernel of `csrc/decode_attention.cu`
for CUDA tensors and takes `decode_attention_plain` for CPU tensors. The
kernel replaces the TPU kernel `decode_attention` (`decode_attention.py:117`,
body `_kernel` at `:43-75`); the .cu file's note says what bounds it on the
H100 and how the design answers that.
"""
from __future__ import annotations

import torch

from mtasr_tpu_torch.ops.kernels import _build

_ARGS = [_build.P] * 6 + [_build.I] * 6 + [_build.F, _build.P]
# scores a block keeps in shared memory (`kScoreFloats` of the .cu file); a
# longer slice keeps them in a global scratch the wrapper allocates
SCORE_FLOATS = 24576
SLOT_ELEMS = 4096         # bf16 elements of a ring slot (`kSlotElems`)
MAX_CLUSTER = 8           # blocks of a portable thread-block cluster
_sms = {}                 # device index -> SM count


def cluster_size(B: int, Hkv: int, S: int, sms: int = 132,
                 D: int = 64, tile: int = None) -> int:
    """The blocks one (batch row, kv head) is split over, one cluster: the
    fewest that let B * Hkv * C blocks cover the card's `sms` SMs, then the
    fewest from there whose slice of ceil(S / C) keys fits one ring tile
    of `tile` keys (default: the bf16 kernel's at head dim D), if one does
    (each tile costs a block a wait and two barriers: on the H100, C = 4
    measured faster than 3 at B = 8, S = 214); at most 8 (a portable
    cluster) and at most S (every block holds a key). 1 once
    B * Hkv >= sms."""
    blocks = B * Hkv
    if blocks >= sms:
        return 1
    top = min(MAX_CLUSTER, S)
    c = min(top, -(-sms // blocks))
    if tile is None:
        tile = SLOT_ELEMS // (-(-D // 8) * 8)     # keys a ring slot holds
    for more in range(c, top + 1):
        if -(-S // more) <= tile:
            return more
    return c


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (asked once per device)."""
    dev = device.index if device.index is not None else \
        torch.cuda.current_device()
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


def build():
    """The kernel's library, built from csrc/decode_attention.cu if needed."""
    return _build.load("decode_attention", "decode_attention_launch", _ARGS)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: f32 scores with a 0 / -1e9 mask
    bias and f32 softmax; p rounded to the value dtype before p @ v."""
    B, Hq, D = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2] // D
    k = k_cache.reshape(B, S, Hkv, D).float()
    v = v_cache.reshape(B, S, Hkv, D)
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k) * D ** -0.5
    bias = torch.where(mask, 0.0, -1e9).to(torch.float32)
    p = torch.softmax(scores + bias[:, None, None, :], dim=-1).to(v.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", p.float(), v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D] (RoPE applied); k_cache/v_cache [B, S, Hkv*D] with this
    step's K/V already written; mask [B, S] bool, True where a slot is
    attendable. Returns [B, Hq, D] in q's dtype.

    On CUDA: q and the caches bf16 and contiguous; Hq / Hkv in [1, 8];
    D even and at most 256."""
    if q.dim() != 3 or k_cache.dim() != 3 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention: q [B, Hq, D] and caches "
                         "[B, S, Hkv*D] expected")
    B, Hq, D = q.shape
    S, HD = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or HD % D or Hq % (HD // D):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree")
    if tuple(mask.shape) != (B, S) or mask.dtype != torch.bool:
        raise ValueError(f"decode_attention: mask must be bool [{B}, {S}]")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, mask)
    _build.require_cuda(q, "decode_attention")
    Hkv = HD // D
    if not 1 <= Hq // Hkv <= 8 or D % 2 or D > 256:
        raise ValueError(f"decode_attention: Hq/Hkv = {Hq // Hkv} (1..8), "
                         f"D = {D} (even, <= 256)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("mask", mask)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"on {q.device}")
    if {q.dtype, k_cache.dtype, v_cache.dtype} != {torch.bfloat16}:
        raise TypeError("decode_attention: q and caches must be bf16 (got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype})")
    out = torch.empty_like(q)
    C = cluster_size(B, Hkv, S, sm_count(q.device), D)
    G = Hq // Hkv
    scratch = (torch.empty((B, Hkv, G, S), dtype=torch.float32,
                           device=q.device)
               if G * -(-S // C) > SCORE_FLOATS else None)
    lib = build()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, S, Hq, Hkv,
            D, C, float(D ** -0.5), _build.stream_of(q))
    _build.check(lib, code, "decode_attention")
    decode_attention.launches += 1
    decode_attention.last_cluster = C
    return out


decode_attention.launches = 0
decode_attention.last_cluster = None   # the C of the last launch
