"""Attention of a few query tokens over the KV cache (counterparts of
`mtasr_tpu/ops/pallas/decode_attention.py::decode_attention_chunk` and
`::decode_attention_int8_chunk`), and `int8_cache_attention`, the int8
function in plain PyTorch that the one-token int8 kernel of
`decode_attention_int8.py` is also held against.

The decoder sends every cached forward of 1 < L <= 16 positions here: a
prefill that short (short audio) or a chunk. `decode_attention_chunk`
(bf16 cache) and `decode_attention_int8_chunk` (int8 cache) launch the
CUDA kernels of `csrc/decode_attention_chunk.cu` for CUDA tensors and
take their plain versions for CPU tensors. The kernels replace the TPU
kernels `decode_attention_chunk` (`decode_attention.py:223`, body
`_kernel_chunk` at `:138-185`) and `decode_attention_int8_chunk` (`:443`,
body `_kernel_int8_chunk` at `:377-417`). Both are tensor-core kernels of
one design: a block serves 16 query rows of one (batch row, kv head),
stages that head's K and V rows with `cp.async` and lets its warps split
the keys in tiles (`mma.sync`, bf16 m16n8k16 for #5, int8 m16n8k32 for
both products of #7); the int8 kernel's launch follows the pure
`chunk_int8_plan`. Neither needs a scratch buffer at any S. The head of
the `.cu` file says what bounds them on the H100 and how the designs
answer that.

The int8 function is not dequantized attention: q is quantized per (row,
query head), the k scale folds into the scores, the v scale into the
probabilities, which are quantized per query row before p @ v, and both
products are int8 x int8 in exact int32. `int8_cache_attention` is that
function in plain PyTorch for any chunk length L.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mtasr_tpu_torch.ops.int8 import INV127
from mtasr_tpu_torch.ops.kernels import _build

_ARGS = [_build.I] + [_build.P] * 6 + [_build.I] * 6 + [_build.F] + \
    [_build.I] * 3 + [_build.P]
MAX_L = 16
MAX_SMEM = 232448   # bytes of shared memory a block may use (227 KB)

# the int8 kernel's constants (`kRows`, `kTile8`, `kMaxWarps8`, `kLdRed`)
ROWS = 16           # query rows of a block: the m of one m16n8k32
TILE = 32           # keys of a warp's tile: the k of one m16n8k32
MAX_WARPS = 8
LD_RED = 68         # int32 a row of a warp's partial output (64 + 4 pad)
RESIDENT = (1, 2, 4)    # tiles a warp may keep in registers


def build():
    """The kernels' library, built from csrc/decode_attention_chunk.cu."""
    return _build.load("decode_attention_chunk",
                       "decode_attention_chunk_launch", _ARGS)


class ChunkInt8Plan(NamedTuple):
    row_blocks: int   # blocks a (batch row, kv head): 16 query rows each
    warps: int        # warps a block, each on its own key tiles
    keys_staged: int  # cache slots a block stages at once (a multiple of 32)
    scores_resident: int  # tiles a warp keeps in registers; 0: recomputed
    smem_bytes: int   # dynamic shared memory of a block


def int8_smem_bytes(L: int, keys: int, D: int, warps: int) -> int:
    """`Int8Smem` of `csrc/decode_attention_chunk.cu` with `warps` warps
    that take tiles: rows of DP + 16 bytes (DP = D rounded up to 32) for q8
    [16], K and V [keys]; the k and v scales [2 keys + 16] bytes each; the
    mask [L][keys + 16]; two f32 a row; each warp's row max, sum and max p
    and its [16][68] int32 partial output."""
    ld = -(-D // 32) * 32 + 16
    return (ROWS * ld + keys * (2 * ld + 4 + L) + 32 + 16 * L +
            2 * 4 * ROWS + 3 * 4 * warps * ROWS +
            4 * warps * ROWS * LD_RED)


def chunk_int8_plan(L: int, S: int, D: int, G: int) -> ChunkInt8Plan:
    """The int8 kernel's launch for L positions, S cache slots, head dim D
    and G query heads a kv head: ceil(G L / 16) blocks a (batch row, kv
    head); all S staged at once when they fit the shared memory, else the
    most 32-key tiles that do, streamed in chunks; a warp a staged tile,
    up to 8; the scores kept in registers across the passes when the cache
    is staged at once and a warp has at most 4 tiles (S <= 1024; on an
    H100 at S = 158 and 1000, recomputing them in each pass is 1.5x
    slower), else recomputed by each pass."""
    ld = -(-D // 32) * 32 + 16
    fixed = int8_smem_bytes(L, 0, D, MAX_WARPS)
    most = (MAX_SMEM - fixed) // (2 * ld + 4 + L) // TILE * TILE
    keys = min(-(-S // TILE) * TILE, most)
    warps = min(MAX_WARPS, keys // TILE)
    per_warp = -(-(keys // TILE) // warps)
    resident = next((n for n in RESIDENT if n >= per_warp), 0) \
        if keys >= S else 0
    return ChunkInt8Plan(-(-G * L // ROWS), warps, keys, resident,
                         int8_smem_bytes(L, keys, D, warps))


def int8_cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_scale: torch.Tensor,
                         mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, L, Hq, D]; int8 caches [B, S, Hkv*D]; kv_scale [B, 2*Hkv, S]
    (k scales of kv head h in row 2h, v scales in row 2h+1); mask
    [B, L, S]. Returns (out [B, L, Hq, D] f32, sp [B, Hkv, L, G, 1], the p
    scale of every query row: one int8 step of p moves an output element
    by at most 127 * sp). The integer products run in float64, exact for
    any |sum| < 2**53."""
    B, L, Hq, D = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2] // D
    G = Hq // Hkv
    qf = q.float().reshape(B, L, Hkv, G, D).permute(0, 2, 1, 3, 4)
    sq = (qf.abs().amax(-1, keepdim=True) * INV127).clamp_min(1e-12)
    q8 = torch.clamp(torch.round(qf / sq), -127, 127)
    k = k_cache.reshape(B, S, Hkv, D).double()
    v = v_cache.reshape(B, S, Hkv, D).double()
    acc = torch.einsum("bhlgd,bshd->bhlgs", q8.double(), k).float()
    kvs = kv_scale.float()
    ks = kvs[:, 0::2, None, None, :]                  # [B, Hkv, 1, 1, S]
    vs = kvs[:, 1::2, None, None, :]
    bias = torch.where(mask, 0.0, -1e9).float()[:, None, :, None, :]
    scores = acc * (sq * D ** -0.5) * ks + bias
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True) * vs
    sp = (p.amax(-1, keepdim=True) * INV127).clamp_min(1e-12)
    p8 = torch.clamp(torch.round(p / sp), -127, 127)
    out = torch.einsum("bhlgs,bshd->bhlgd", p8.double(), v).float() * sp
    return out.permute(0, 2, 1, 3, 4).reshape(B, L, Hq, D), sp


def check_cache_inputs(what: str, q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, kv_scale, mask: torch.Tensor
                       ) -> Tuple[int, int, int, int, int]:
    """Shapes common to the cache-attention wrappers: q [B, Hq, D] with
    mask [B, S], or q [B, L, Hq, D] with mask [B, L, S]; kv_scale None for
    a bf16 cache. Returns (B, S, Hq, Hkv, D)."""
    if k_cache.dim() != 3 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{what}: caches [B, S, Hkv*D] of one shape "
                         "expected")
    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    S, HD = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or HD % D or Hq % (HD // D):
        raise ValueError(f"{what}: q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} disagree")
    Hkv = HD // D
    if kv_scale is not None and tuple(kv_scale.shape) != (B, 2 * Hkv, S):
        raise ValueError(f"{what}: kv_scale must be [{B}, {2 * Hkv}, {S}]")
    want = (B, S) if q.dim() == 3 else (B, q.shape[1], S)
    if tuple(mask.shape) != want or mask.dtype != torch.bool:
        raise ValueError(f"{what}: mask must be bool {list(want)}")
    return B, S, Hq, Hkv, D


def decode_attention_chunk_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """The bf16-cache function in plain PyTorch: f32 scores with a 0 / -1e9
    mask bias and f32 softmax; p rounded to the value dtype before p @ v."""
    B, L, Hq, D = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2] // D
    k = k_cache.reshape(B, S, Hkv, D).float()
    v = v_cache.reshape(B, S, Hkv, D)
    qg = q.reshape(B, L, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("blhgd,bshd->bhgls", qg, k) * D ** -0.5
    bias = torch.where(mask, 0.0, -1e9).to(torch.float32)
    p = torch.softmax(scores + bias[:, None, None], dim=-1).to(v.dtype)
    out = torch.einsum("bhgls,bshd->blhgd", p.float(), v.float())
    return out.reshape(B, L, Hq, D).to(q.dtype)


def decode_attention_int8_chunk_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                      v_cache: torch.Tensor,
                                      kv_scale: torch.Tensor,
                                      mask: torch.Tensor) -> torch.Tensor:
    """The int8-cache function in plain PyTorch (`int8_cache_attention`)."""
    out, _ = int8_cache_attention(q, k_cache, v_cache, kv_scale, mask)
    return out.to(q.dtype)


def check_launch_inputs(what: str, int8: bool, q: torch.Tensor,
                        k_cache: torch.Tensor, v_cache: torch.Tensor,
                        kv_scale, mask: torch.Tensor, dims) -> None:
    """Raise unless the cache kernels take these CUDA tensors: contiguous
    on one device with 16-byte aligned data, bf16 q (and scales), caches
    int8 or bf16, Hq / Hkv in [1, 8], D a multiple of 4 up to 256."""
    _, _, Hq, Hkv, D = dims
    _build.require_cuda(q, what)
    G = Hq // Hkv
    if not 1 <= G <= 8 or D % 4 or not 4 <= D <= 256:
        raise ValueError(f"{what}: Hq/Hkv = {G} (1..8), D = {D} (a multiple "
                         "of 4 in 4..256)")
    cache = torch.int8 if int8 else torch.bfloat16
    checks = [("q", q, torch.bfloat16), ("k_cache", k_cache, cache),
              ("v_cache", v_cache, cache), ("mask", mask, torch.bool)]
    if int8:
        checks.append(("kv_scale", kv_scale, torch.bfloat16))
    for name, t, dtype in checks:
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.device != q.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             f"aligned on {q.device}")


def launch(what: str, int8: bool, q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, kv_scale, mask: torch.Tensor, L: int,
           dims) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q [B, L, Hq, D] with mask
    [B, L, S], or raise with the reason it does not take them
    (`check_launch_inputs`; 1 <= L <= 16); the int8 kernel on
    `chunk_int8_plan`. Returns an output shaped as q."""
    B, S, Hq, Hkv, D = dims
    if not 1 <= L <= MAX_L:
        raise ValueError(f"{what}: the chunk kernel takes 1..{MAX_L} "
                         f"positions, not {L}")
    check_launch_inputs(what, int8, q, k_cache, v_cache, kv_scale, mask,
                        dims)
    plan = chunk_int8_plan(L, S, D, Hq // Hkv) if int8 else None
    out = torch.empty_like(q)
    lib = build()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_chunk_launch(
            int(int8), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_scale.data_ptr() if int8 else None, mask.data_ptr(),
            out.data_ptr(), B, L, S, Hq, Hkv, D, float(D ** -0.5),
            *((plan.keys_staged, plan.warps, plan.scores_resident) if int8
              else (0, 0, 0)), _build.stream_of(q))
    _build.check(lib, code, what)
    return out


def decode_attention_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """q [B, L, Hq, D] (RoPE applied); k_cache/v_cache [B, S, Hkv*D] bf16
    with the chunk's K/V written; mask [B, L, S] bool, True where position
    l may attend slot s. Returns [B, L, Hq, D] in q's dtype.

    On CUDA: bf16, contiguous; 1 <= L <= 16; Hq / Hkv in [1, 8]; D a
    multiple of 4 up to 256; any S."""
    if q.dim() != 4:
        raise ValueError("decode_attention_chunk: q [B, L, Hq, D] expected")
    dims = check_cache_inputs("decode_attention_chunk", q, k_cache, v_cache,
                              None, mask)
    if q.device.type == "cpu":
        return decode_attention_chunk_plain(q, k_cache, v_cache, mask)
    out = launch("decode_attention_chunk", False, q, k_cache, v_cache, None,
                 mask, q.shape[1], dims)
    decode_attention_chunk.launches += 1
    return out


def decode_attention_int8_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, kv_scale: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """As `decode_attention_chunk` over the int8 cache, with kv_scale
    [B, 2*Hkv, S] bf16 (k / v rows interleaved)."""
    if q.dim() != 4:
        raise ValueError("decode_attention_int8_chunk: q [B, L, Hq, D] "
                         "expected")
    dims = check_cache_inputs("decode_attention_int8_chunk", q, k_cache,
                              v_cache, kv_scale, mask)
    if q.device.type == "cpu":
        return decode_attention_int8_chunk_plain(q, k_cache, v_cache,
                                                 kv_scale, mask)
    out = launch("decode_attention_int8_chunk", True, q, k_cache, v_cache,
                 kv_scale, mask, q.shape[1], dims)
    decode_attention_int8_chunk.launches += 1
    return out


decode_attention_chunk.launches = 0
decode_attention_int8_chunk.launches = 0
