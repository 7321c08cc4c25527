"""The dp x tp rank grid and the sharding rules (counterpart of
`mtasr_tpu/parallel/mesh.py`).

The port runs one process per device. `make_mesh(dp, tp)` lays the
`world_size` ranks out as JAX's `reshape(dp, tp)` lays out devices: rank
r sits at data index r // tp and model index r % tp, and every rank
builds its data-parallel group (the ranks of its model index) and its
tensor-parallel group (the ranks of its data index). The ranks of one tp
group make the same calls on the same rows; the groups of one dp index
differ only in their rows.

`RULES` is the JAX package's `DEFAULT_RULES` over the port's dotted
`state_dict` names, first match wins: a spec of ("model", None) shards
dim 0 over tp, (None, "model") dim 1, ("model",) a bias. `layout` turns
the table into what a rank holds, by whole units, and replicates a unit
where the port cannot run it sharded (`DEVIATIONS` says where and why):

* an attention block (the decoder's q/k/v/o, the encoder's q/k/v/out)
  goes by whole heads, only when its head counts (Hq and Hkv) divide by
  tp: JAX shards rows and XLA copes with a head split between devices,
  a rank's local attention cannot;
* an MLP / feed-forward pair goes whole, when its width divides by tp;
* the embedding, the head and the CTC heads' `ctc_lo` go by vocabulary
  rows, when the vocabulary divides by tp (the JAX fallback: a dim that
  does not divide is replicated; LLaMA-3's CTC head of 128265 rows is);
* an int8 linear (`weight_q8a8` / `weight_q8`, `scale`) matches no rule,
  as in JAX, so it is replicated, and the unit it belongs to with it: the
  int8 decoder runs its layers whole on every tp rank (its attention at
  all Hkv heads, #6 / #7 at the single-process shapes); only its float
  embedding is sharded. A w8a8 head is replicated.

`shard_state_dict` slices a full flat state dict to a rank's layout,
`shard_model` does that to a model in place and marks the sharded units
for the forward functions (`tp`: the group; `vocab_start`),
`gather_state_dict` is the inverse (for saving), and `shard_batch` takes
a dp index's contiguous rows.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from mtasr_tpu_torch.parallel.collectives import all_gather

Spec = Tuple[Optional[str], ...]

# (dotted-name regex, spec), first match wins: `DEFAULT_RULES`
# (`mesh.py:44-63`) with '/' read as '.'; the adapters' q/k/v lead with the
# one deviation of the table itself (DEVIATIONS)
RULES: List[Tuple[str, Spec]] = [
    (r"^cross_att_adap\.\d+\.(q|k|v)_proj\.(weight|bias)$", ()),
    # ---- LLaMA decoder TP ----
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$",
     ("model", None)),
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.bias$", ("model",)),
    (r".*(o_proj|down_proj)\.weight$", (None, "model")),
    (r".*embed_tokens\.weight$", ("model", None)),
    (r".*lm_head\.weight$", ("model", None)),
    # ---- WavLM encoder TP ----
    (r".*attention\.(out_proj)\.weight$", (None, "model")),
    (r".*attention\.(q|k|v)_proj\.weight$", ("model", None)),
    (r".*attention\.(q|k|v)_proj\.bias$", ("model",)),
    (r".*feed_forward\.intermediate_dense\.weight$", ("model", None)),
    (r".*feed_forward\.intermediate_dense\.bias$", ("model",)),
    (r".*feed_forward\.output_dense\.weight$", (None, "model")),
    # ---- CTC heads ----
    (r".*ctc_lo\.weight$", ("model", None)),
    (r".*ctc_lo\.bias$", ("model",)),
    (r".*", ()),
]

# where the port's table or layout leaves JAX's spec, and why
DEVIATIONS = {
    "cross_att_adap.*.{q,k,v}_proj":
        "replicated: JAX shards them (`mesh.py:46`) but keeps their "
        "out_proj replicated, so XLA gathers the heads again; a rank's "
        "local adapter attention needs whole heads, and the adapters are "
        "narrow (cross_attn_dim)",
    "attention unit whose heads do not divide by tp":
        "replicated: a rank's attention needs whole heads (JAX shards "
        "rows and lets XLA move a split head)",
    "unit holding an int8 linear":
        "replicated: the int8 weights match no rule in JAX either; the "
        "float projections beside them (k/v under 256 outputs) stay whole "
        "with their unit",
    "MLP / feed-forward whose width does not divide by tp":
        "replicated, as JAX's fallback replicates each such weight",
}


def spec_for_name(name: str) -> Spec:
    """The rule table's spec of a flat parameter name."""
    for pattern, spec in RULES:
        if re.match(pattern, name):
            return spec
    return ()


def _sharded_dim(spec: Spec) -> Optional[int]:
    for d, ax in enumerate(spec):
        if ax == "model":
            return d
    return None


@dataclass
class Mesh:
    """This rank's place in the dp x tp grid and its two groups (None
    where the group is this rank alone: no collective runs)."""
    dp: int
    tp: int
    rank: int
    dp_group: object = None
    tp_group: object = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp


def make_mesh(dp_size: int = -1, tp_size: int = 1) -> Mesh:
    """The grid over the process group's ranks (a single process when
    there is no group). dp_size -1 means world_size // tp_size; a grid
    that does not cover the world raises, as `mesh.py:34` asserts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    tp = max(1, tp_size)
    dp = dp_size if dp_size > 0 else max(1, world // tp)
    if dp * tp != world:
        raise ValueError(f"{dp}x{tp} != {world} ranks")
    mesh = Mesh(dp=dp, tp=tp, rank=rank)
    if world == 1:
        return mesh
    # every rank creates every group, in the same order
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            mesh.dp_group = g
    for d in range(dp):
        ranks = [d * tp + t for t in range(tp)]
        g = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            mesh.tp_group = g
    return mesh


# ---------------------------------------------------------------------------
# the layout: what a rank holds
# ---------------------------------------------------------------------------
_DEC_ATT = re.compile(r"^decoder\.model\.layers\.(\d+)\.self_attn\.")
_DEC_MLP = re.compile(r"^decoder\.model\.layers\.(\d+)\.mlp\.")
_ENC_ATT = re.compile(r"^encoder\.encoder\.layers\.(\d+)\.attention\."
                      r"(q|k|v|out)_proj\.")
_ENC_FF = re.compile(r"^encoder\.encoder\.layers\.(\d+)\.feed_forward\.")
_CTC = re.compile(r"^serialized_ctc\.(\d+)\.ctc_lo\.")


def _unit_of(name: str) -> Optional[str]:
    for pat, tag in ((_DEC_ATT, "dec_att"), (_DEC_MLP, "dec_mlp"),
                     (_ENC_ATT, "enc_att"), (_ENC_FF, "enc_ff"),
                     (_CTC, "ctc")):
        m = pat.match(name)
        if m:
            return f"{tag}.{m.group(1)}"
    if name in ("decoder.model.embed_tokens.weight",
                "decoder.lm_head.weight"):
        return name
    return None


def layout(shapes: Dict[str, Tuple[int, ...]], cfg, tp: int
           ) -> Dict[str, int]:
    """{flat name: the dim sharded over tp} for the names a rank holds a
    slice of (every other name is replicated), from the names and shapes
    of a full state dict and the model config `cfg`."""
    if tp <= 1:
        return {}
    if cfg.decoder.kv_lora_rank is not None or \
            cfg.decoder.n_routed_experts is not None:
        raise NotImplementedError(
            "tp over a DeepSeek-V3 decoder (latent attention, experts) is "
            "not implemented")
    units: Dict[str, List[str]] = {}
    for name in shapes:
        u = _unit_of(name)
        if u is not None:
            units.setdefault(u, []).append(name)
    dec, enc = cfg.decoder, cfg.encoder
    heads_ok = {
        "dec_att": (dec.num_attention_heads % tp == 0
                    and dec.num_key_value_heads % tp == 0),
        "enc_att": enc.num_attention_heads % tp == 0,
    }
    out: Dict[str, int] = {}
    for u, names in units.items():
        kind = u.split(".")[0]
        if not heads_ok.get(kind, True):
            continue
        if any(n.endswith(("weight_q8a8", "weight_q8", ".scale"))
               for n in names):
            continue                  # an int8 linear: the unit stays whole
        dims = {n: _sharded_dim(spec_for_name(n)) for n in names}
        if not all(shapes[n][d] % tp == 0 for n, d in dims.items()
                   if d is not None):
            continue
        out.update({n: d for n, d in dims.items() if d is not None})
    return out


def _local(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.tp_index * n, n).contiguous()


def shard_state_dict(flat: Dict[str, torch.Tensor], cfg,
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full flat state dict (replicated names as
    they are)."""
    lay = layout({k: tuple(v.shape) for k, v in flat.items()}, cfg, mesh.tp)
    return {k: (_local(v, lay[k], mesh) if k in lay else v)
            for k, v in flat.items()}


def _module(model: nn.Module, dotted: str) -> nn.Module:
    return model.get_submodule(dotted) if dotted else model


@torch.no_grad()
def shard_model(model: nn.Module, cfg, mesh: Mesh) -> nn.Module:
    """Slice `model`'s parameters to this rank's layout in place, record it
    (`model.tp_layout`: {name: dim}, `model.mesh`) and mark every sharded
    unit's module with `tp` (the tp group) for the forward functions. On
    a mesh of one rank no parameter changes."""
    model.mesh = mesh
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    lay = layout(shapes, cfg, mesh.tp)
    model.tp_layout = lay
    for name, dim in lay.items():
        mod_name, _, attr = name.rpartition(".")
        mod = _module(model, mod_name)
        old = getattr(mod, attr)
        new = nn.Parameter(_local(old.data, dim, mesh),
                           requires_grad=old.requires_grad)
        setattr(mod, attr, new)
        if isinstance(mod, nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
        if isinstance(mod, nn.Embedding):
            mod.num_embeddings = mod.weight.shape[0]
            mod.vocab_start = mesh.tp_index * mod.weight.shape[0]
        # the unit's container (self_attn, mlp, attention, feed_forward)
        # and a vocab-parallel module itself carry the group
        mod.tp = mesh.tp_group
        _module(model, mod_name.rpartition(".")[0]).tp = mesh.tp_group
    return model


def gather_state_dict(flat: Dict[str, torch.Tensor], model: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every tp rank's slices (`flat` holds this
    rank's, under `model.tp_layout`); every rank of the tp group must
    call it."""
    mesh = getattr(model, "mesh", None)
    lay = getattr(model, "tp_layout", {})
    if mesh is None or not lay:
        return flat
    return {k: (all_gather(v, mesh.tp_group, lay[k]) if k in lay else v)
            for k, v in flat.items()}


def tp_local(model: nn.Module, name: str, full: torch.Tensor
             ) -> torch.Tensor:
    """This rank's slice of a full tensor of parameter `name` (as is when
    the name is replicated)."""
    lay = getattr(model, "tp_layout", {})
    if name not in lay:
        return full
    return _local(full, lay[name], model.mesh)


def is_sharded(model: nn.Module, name: str) -> bool:
    return name in getattr(model, "tp_layout", {})


def _rows(a, mesh: Mesh, dim: int):
    B = a.shape[dim]
    if B % mesh.dp:
        return a                       # replicated, as `mesh.py:121-139`
    n = B // mesh.dp
    return a[(slice(None),) * dim
             + (slice(mesh.dp_index * n, (mesh.dp_index + 1) * n),)]


def batch_dim(key: str) -> int:
    """`label_spks` / `label_spk_lens` are [K, B, ...]: their batch is
    dim 1."""
    return 1 if key.startswith("label_spk") else 0


def shard_batch(batch: Dict[str, object], mesh: Optional[Mesh]):
    """This dp index's contiguous rows of every array of `batch` (numpy or
    torch); an array whose batch does not divide by dp is kept whole."""
    if mesh is None or mesh.dp == 1:
        return batch
    return {k: (_rows(v, mesh, batch_dim(k))
                if getattr(v, "ndim", 0) > batch_dim(k) else v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# decoding's data parallelism: a dp index's rows, gathered back in order
# ---------------------------------------------------------------------------
def dp_rows(mesh: Optional[Mesh], B: int) -> Optional[slice]:
    """The rows of a B-row batch this dp index decodes; None when the
    whole batch is decoded here (one dp index, or B not divisible by dp:
    every dp index then decodes all of it, as JAX replicates it)."""
    if mesh is None or mesh.dp == 1 or B % mesh.dp:
        return None
    n = B // mesh.dp
    return slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)


def take_rows(x, rows: Optional[slice], dim: int = 0):
    if x is None or rows is None:
        return x
    return x.narrow(dim, rows.start, rows.stop - rows.start)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                rows: Optional[slice], dim: int = 0,
                pad_value=0) -> torch.Tensor:
    """The dp indices' row blocks of x concatenated along `dim` in input
    order, every block first padded along its last dim to the longest
    (with `pad_value`). The identity when `rows` is None."""
    if rows is None:
        return x
    group = mesh.dp_group
    n = torch.tensor([x.shape[-1]], dtype=torch.int64, device=x.device)
    longest = int(all_gather(n, group, 0).max())
    if x.shape[-1] < longest:
        pad = list(x.shape)
        pad[-1] = longest - x.shape[-1]
        x = torch.cat([x, torch.full(pad, pad_value, dtype=x.dtype,
                                     device=x.device)], dim=-1)
    return all_gather(x, group, dim)
