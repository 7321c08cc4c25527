"""Cross-attention adapters from the decoder's hidden states to an
acoustic memory, one per decoder layer (counterpart of
`mtasr_tpu/models/adapters.py`).

Four kinds share one low-rank single-head cross-attention core and differ
in how they mix it back in:

* tiny: LN(hidden + context);
* gatetiny: hidden + sigmoid(gate_logit) * (LN(hidden + context) - hidden);
* ctcaware: the memory's CTC confidence biases the scores (conf_scale *
  log conf) and reweights the probabilities, LN(hidden + cross_gate *
  context);
* adapgatetiny: gatetiny with a LoRA on each projection whose ranks carry
  sigmoid gates (`rank_usage`, `prune_lora_ranks`).

`mem_mask` follows the reference: True = PADDING (the rest of the port
uses True = valid). The scores are float32 whatever the activations' dtype,
and padded columns get -1e30, so a memory that is all padding gives finite
output. Parameter names are the JAX tree's, the scalars 0-d parameters.

`SharedCore` / `shared_core_forward` are the JAX module's shared core (one
tiny adapter for every layer) behind per-layer residual MLPs; no config
wires them, in the JAX package or here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtasr_tpu_torch.models.layers import layer_norm, linear

KINDS = ("tiny", "gatetiny", "ctcaware", "adapgatetiny")
_LORA_NAMES = ("q_lora", "k_lora", "v_lora", "out_lora")


class _RankGatedLoRA(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, r: int):
        super().__init__()
        self.lora_A = nn.Parameter(torch.zeros(r, in_dim))
        self.lora_B = nn.Parameter(torch.zeros(out_dim, r))
        self.rank_logits = nn.Parameter(torch.zeros(r))


class CrossAttentionAdapter(nn.Module):
    """Parameters of one adapter of `kind` (`init_adapter_params`); the
    scalars hold the JAX init's values until a load replaces them."""

    def __init__(self, kind: str, hidden_size: int, mem_dim: int,
                 attn_dim: int = 512, r_max: int = 16,
                 lora_alpha: float = 16.0, init_rank_logit: float = 2.0):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"adapter kind {kind!r} not in {KINDS}")
        self.kind = kind
        self.q_proj = nn.Linear(hidden_size, attn_dim)
        self.k_proj = nn.Linear(mem_dim, attn_dim)
        self.v_proj = nn.Linear(mem_dim, attn_dim)
        self.out_proj = nn.Linear(attn_dim, hidden_size)
        self.ln_in = nn.LayerNorm(hidden_size)
        self.ln_out = nn.LayerNorm(hidden_size)
        if kind in ("gatetiny", "adapgatetiny"):
            # sigmoid(-2) ~= 0.12: the adapter barely perturbs early training
            self.gate_logit = nn.Parameter(torch.tensor(-2.0))
        if kind == "ctcaware":
            self.conf_scale = nn.Parameter(torch.tensor(1.0))
            self.cross_gate = nn.Parameter(torch.tensor(1.0))
        if kind == "adapgatetiny":
            dims = {"q_lora": (hidden_size, attn_dim),
                    "k_lora": (mem_dim, attn_dim),
                    "v_lora": (mem_dim, attn_dim),
                    "out_lora": (attn_dim, hidden_size)}
            for name, (i, o) in dims.items():
                lp = _RankGatedLoRA(i, o, r_max)
                with torch.no_grad():
                    lp.rank_logits.fill_(init_rank_logit)
                setattr(self, name, lp)
            self.lora_alpha = nn.Parameter(torch.tensor(float(lora_alpha)))
            self.lora_scale = nn.Parameter(
                torch.tensor(lora_alpha / max(1, r_max)))


@torch.no_grad()
def init_scalars(ad: CrossAttentionAdapter, r_max: int, lora_alpha: float,
                 init_rank_logit: float = 2.0) -> None:
    """Give the scalars, the rank gates and the LoRA B factors the JAX
    init's values (after a model was allocated without them)."""
    for name, value in (("gate_logit", -2.0), ("conf_scale", 1.0),
                        ("cross_gate", 1.0), ("lora_alpha", lora_alpha),
                        ("lora_scale", lora_alpha / max(1, r_max))):
        if hasattr(ad, name):
            getattr(ad, name).fill_(value)
    for name in _LORA_NAMES:
        if hasattr(ad, name):
            getattr(ad, name).rank_logits.fill_(init_rank_logit)
            getattr(ad, name).lora_B.zero_()


def _lora_delta(lp: _RankGatedLoRA, x: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    xa = x @ lp.lora_A.to(x.dtype).t()
    xa = xa * torch.sigmoid(lp.rank_logits).to(x.dtype)
    return scale.to(x.dtype) * (xa @ lp.lora_B.to(x.dtype).t())


def _proj(ad: CrossAttentionAdapter, name: str,
          x: torch.Tensor) -> torch.Tensor:
    y = linear(getattr(ad, f"{name}_proj"), x)
    if ad.kind == "adapgatetiny":
        y = y + _lora_delta(getattr(ad, f"{name}_lora"), x, ad.lora_scale)
    return y


def memory_kv(ad: CrossAttentionAdapter, mem: torch.Tensor,
              dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adapter's keys and values of the memory [B, Tm, attn_dim] in
    the decoder's activation dtype: they do not change from one decode
    step to the next, so a caller may compute them once."""
    m = mem.to(dtype)
    return _proj(ad, "k", m), _proj(ad, "v", m)


def adapter_forward(ad: CrossAttentionAdapter, hidden: torch.Tensor,
                    mem: Optional[torch.Tensor],
                    mem_mask: Optional[torch.Tensor] = None,
                    mem_conf: Optional[torch.Tensor] = None,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """hidden [B, Lq, H] attends to mem [B, Tm, D] (mem_mask [B, Tm] True =
    padding, mem_conf [B, Tm] in [0, 1] for ctcaware); `kv` is
    `memory_kv`'s result for this memory, when the caller kept it."""
    if mem is None:
        return hidden
    kind = ad.kind
    q = _proj(ad, "q", layer_norm(ad.ln_in, hidden))
    k, v = kv if kv is not None else memory_kv(ad, mem, hidden.dtype)
    # float32 scores from the activations' products (exact for bf16 inputs)
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores / math.sqrt(q.shape[-1])
    if mem_mask is not None:
        scores = torch.where(mem_mask[:, None, :], -1e30, scores)
    if kind == "ctcaware" and mem_conf is not None:
        conf = mem_conf.clamp_min(1e-6).float()
        scores = scores + ad.conf_scale * torch.log(conf)[:, None, :]
    weights = torch.softmax(scores, dim=-1)
    if kind == "ctcaware" and mem_conf is not None:
        conf = mem_conf.clamp_min(1e-6).to(weights.dtype)
        weights = weights * conf[:, None, :]
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    context_h = _proj(ad, "out", weights.to(hidden.dtype) @ v)
    if kind == "tiny":
        return layer_norm(ad.ln_out, hidden + context_h)
    if kind == "ctcaware":
        return layer_norm(ad.ln_out,
                          hidden + ad.cross_gate.to(hidden.dtype) * context_h)
    # gated: hidden + g * (LN(hidden + context) - hidden)
    out_base = layer_norm(ad.ln_out, hidden + context_h)
    g = torch.sigmoid(ad.gate_logit).to(hidden.dtype)
    return hidden + g * (out_base - hidden)


def rank_usage(ad: CrossAttentionAdapter) -> torch.Tensor:
    """The soft count of active LoRA ranks over all four projections
    (float32; 0 for a kind without LoRA)."""
    parts = [torch.sigmoid(getattr(ad, n).rank_logits.float()).sum()
             for n in _LORA_NAMES if hasattr(ad, n)]
    return sum(parts) if parts else torch.zeros((), dtype=torch.float32)


@torch.no_grad()
def prune_lora_ranks(ad: CrossAttentionAdapter, gate_threshold: float = 0.1,
                     keep_at_least: int = 1) -> int:
    """Drop the LoRA ranks whose gate is below `gate_threshold` (at least
    `keep_at_least` kept, the highest gates) in place, on the host as the
    JAX function does; `lora_scale` becomes lora_alpha / new r. Returns the
    q projection's new rank (0 for a kind without LoRA)."""
    new_r = None
    for name in _LORA_NAMES:
        if not hasattr(ad, name):
            continue
        lp = getattr(ad, name)
        logits = lp.rank_logits.detach().float().cpu().numpy()
        g = 1.0 / (1.0 + np.exp(-logits))
        keep = np.nonzero(g >= gate_threshold)[0]
        if keep.size < keep_at_least:
            keep = np.sort(np.argsort(-g)[:keep_at_least])
        idx = torch.from_numpy(keep).to(lp.lora_A.device)
        lp.lora_A = nn.Parameter(lp.lora_A[idx].clone())
        lp.lora_B = nn.Parameter(lp.lora_B[:, idx].clone())
        lp.rank_logits = nn.Parameter(lp.rank_logits[idx].clone())
        if name == "q_lora":
            new_r = int(keep.size)
    if new_r is not None and hasattr(ad, "lora_alpha"):
        ad.lora_scale.fill_(float(ad.lora_alpha) / max(1, new_r))
    return new_r or 0


class _MLP(nn.ModuleDict):
    def __init__(self, hidden_size: int, rank: int):
        super().__init__({"0": nn.Linear(hidden_size, rank),
                          "2": nn.Linear(rank, hidden_size)})


class _LayerWrapper(nn.Module):
    def __init__(self, hidden_size: int, rank: int, pre: bool, post: bool):
        super().__init__()
        if pre:
            self.pre_mlp = _MLP(hidden_size, rank)
        if post:
            self.post_mlp = _MLP(hidden_size, rank)


class SharedCore(nn.Module):
    """`init_shared_core_params`: one tiny adapter (`core`) shared by the
    layers, and each layer's residual SiLU MLPs of `mlp_rank` before
    (`use_pre_mlp`) and after (`use_post_mlp`) it."""

    def __init__(self, hidden_size: int, mem_dim: int, attn_dim: int = 512,
                 n_layers: int = 1, mlp_rank: int = 256,
                 use_pre_mlp: bool = True, use_post_mlp: bool = False):
        super().__init__()
        self.core = CrossAttentionAdapter("tiny", hidden_size, mem_dim,
                                          attn_dim)
        self.wrappers = nn.ModuleDict({
            str(i): _LayerWrapper(hidden_size, mlp_rank, use_pre_mlp,
                                  use_post_mlp) for i in range(n_layers)})


def _residual_mlp(m: _MLP, x: torch.Tensor) -> torch.Tensor:
    return x + linear(m["2"], F.silu(linear(m["0"], x)))


def shared_core_forward(p: SharedCore, layer_idx: int, hidden: torch.Tensor,
                        mem: Optional[torch.Tensor],
                        mem_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Layer `layer_idx`'s pre-MLP residual, the shared core's
    cross-attention onto mem (mem_mask True = padding), its post-MLP
    residual; hidden itself without a memory."""
    if mem is None:
        return hidden
    w = p.wrappers[str(layer_idx)]
    x = hidden
    if hasattr(w, "pre_mlp"):
        x = _residual_mlp(w.pre_mlp, x)
    x = adapter_forward(p.core, x, mem, mem_mask)
    if hasattr(w, "post_mlp"):
        x = _residual_mlp(w.post_mlp, x)
    return x
