"""Process-group setup and host-level data sharding (counterpart of
`mtasr_tpu/parallel/multihost.py`).

The port runs one process per device. `initialize` joins the process
group of a `torch.distributed.run` launch (its `MASTER_ADDR` /
`MASTER_PORT` / `RANK` / `WORLD_SIZE` environment) or of explicit
arguments; `process_shard`, `barrier` and `host_broadcast` are the JAX
package's host helpers over that group (numpy in, numpy out). With no
process group every helper is the single-process identity.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("mtasr_tpu_torch.multihost")

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device="cuda") -> None:
    """Join the process group once per process, before any collective.

    `coordinator_address` is `host:port` (or a full `tcp://` init
    method); without it the launcher's environment is read. No
    environment and no arguments, or `num_processes` <= 1: a single
    process, nothing to join. Explicit arguments that fail re-raise: a
    misconfigured launch must not quietly run alone. A second call is
    benign. `backend` defaults to `default_backend(device)`; NCCL is
    never swapped for gloo behind the caller's back."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        logger.info("torch.distributed already initialized")
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit and not all(k in os.environ for k in _ENV):
        logger.info("single-process run (no launcher environment)")
        return
    backend = backend or default_backend(device)
    kw = {}
    if explicit:
        init = coordinator_address or ""
        kw = dict(init_method=init if "://" in init else f"tcp://{init}",
                  world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend=backend, **kw)
    logger.info("distributed: rank %d/%d on %s (%s)", dist.get_rank(),
                dist.get_world_size(), device, backend)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_shard(n_items: int) -> slice:
    """This process's contiguous shard of a dataset (dataset.shard)."""
    pid, pcount = process_index(), process_count()
    per = (n_items + pcount - 1) // pcount
    return slice(min(pid * per, n_items), min((pid + 1) * per, n_items))


def barrier(name: str = "barrier") -> None:
    """Every process waits here (the reference's dist.barrier before the
    rank-0 merge)."""
    if process_count() > 1:
        dist.barrier()


def host_broadcast(x: np.ndarray) -> np.ndarray:
    """Process 0's array, on every process (the rank-0-decides pattern).
    Shapes and dtypes must agree across processes."""
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).clone()
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
