"""Rank code of the port's distributed CPU tests (`test_torch_parallel*.py`).

A test writes a job (`torch.save` of {"scenarios": {name: spec}}) and
starts `world` ranks of this script on gloo (`Ranks`); each rank runs every
scenario and saves {name: result} beside the job. The ranks import torch
and the port only: no JAX, no conftest (the tests hold the results
against JAX in the pytest process). Each rank pins one torch thread.

    python tests/_torch_parallel_worker.py RANK WORLD PORT JOB
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """`world` ranks of this script running `job` in the background;
    `results()` waits for them."""

    def __init__(self, job: str, world: int, timeout: float = 240.0):
        self.job, self.world = job, world
        self.deadline = time.monotonic() + timeout
        env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD)
        port = free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             str(port), job], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._results = None

    def results(self) -> list:
        """Every rank must exit 0 before the deadline (the others are
        killed when one fails); the ranks' results, in rank order."""
        if self._results is None:
            self._results = _wait(self.procs, self.deadline, self.job,
                                  self.world)
        return self._results


def _wait(procs, deadline, job, world) -> list:
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError("rank(s) %s failed:\n%s" % (
            bad, "\n".join(f"--- rank {r} ---\n{logs[r][-6000:]}"
                           for r in bad)))
    import torch
    return [torch.load(f"{job}.out.{r}", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# scenarios (run on every rank)
# ---------------------------------------------------------------------------
def _model(spec):
    import torch
    from mtasr_tpu_torch.models.speech_encoder_decoder import (
        SpeechEncoderDecoderModel,
    )
    from mtasr_tpu_torch.utils.convert import load_flat
    model = SpeechEncoderDecoderModel(spec["cfg"])
    load_flat(model, {k: torch.from_numpy(v.copy()) for k, v in
                      spec["flat"].items()},
              training=spec.get("training", False))
    return model


def _mesh(spec):
    from mtasr_tpu_torch.parallel.mesh import make_mesh
    dp, tp = spec.get("mesh", (1, 1))
    return make_mesh(dp, tp) if dp * tp > 1 else None


def run_serve(spec):
    import torch
    from mtasr_tpu_torch.generate import engine
    from mtasr_tpu_torch.generate.beam import beam_generate
    from mtasr_tpu_torch.generate.engine import generate, generate_ctc
    from mtasr_tpu_torch.parallel.mesh import dp_rows, gather_rows, \
        shard_model
    cfg, gen = spec["cfg"], spec.get("gen")
    model = _model(spec)
    mesh = _mesh(spec)
    if mesh is not None:
        shard_model(model, cfg, mesh)
    model.eval()
    wav = amask = None
    if "wav" in spec:
        wav = torch.from_numpy(spec["wav"])
        amask = torch.from_numpy(spec["amask"])
    prompt = spec.get("prompt")
    prompt = None if prompt is None else torch.from_numpy(prompt)
    out = {}
    route = spec["route"]
    steps = []
    if route == "greedy":
        real = engine._sample_token

        def record(logits, g, generator):
            steps.append(logits.float().clone())
            return real(logits, g, generator)
        engine._sample_token = record
        # sampling draws from a generator seeded alike on every rank
        sampler = None if spec.get("sample_seed") is None else \
            torch.Generator().manual_seed(spec["sample_seed"])
        try:
            o = generate(model, cfg, wav, amask, prompt_ids=prompt, gen=gen,
                         generator=sampler,
                         max_new_tokens=spec["max_new_tokens"])
        finally:
            engine._sample_token = real
        rows = dp_rows(mesh, wav.shape[0])
        n = spec.get("record_steps", 3)
        out["logits"] = [gather_rows(s, mesh, rows).numpy()
                         for s in steps[:n]]
        out["sequences"] = o.sequences.numpy()
    elif route == "beam":
        o = beam_generate(model, cfg, wav, amask, prompt_ids=prompt,
                          num_beams=spec["num_beams"],
                          max_new_tokens=spec["max_new_tokens"],
                          kv_quant=gen.kv_quant)
        out["sequences"] = o.sequences.numpy()
        out["scores"] = o.scores.numpy()
    elif route == "ctc":
        trans, lens = generate_ctc(model, cfg, wav, amask,
                                   max_out_len=spec["max_new_tokens"])
        out["sequences"], out["lengths"] = trans.numpy(), lens.numpy()
    elif route == "pipelined":
        from mtasr_tpu_torch.generate.pipelined import generate_pipelined
        sampler = None if spec.get("sample_seed") is None else \
            torch.Generator().manual_seed(spec["sample_seed"])
        outs = generate_pipelined(
            model, cfg, [{k: torch.from_numpy(v) for k, v in b.items()}
                         for b in spec["stream"]],
            gen=gen, max_new_tokens=spec["max_new_tokens"],
            generator=sampler)
        out["sequences"] = [o.sequences.numpy() for o in outs]
    else:
        raise ValueError(route)
    return out


def run_train(spec):
    """Trainer steps on `spec["batches"]` (the global batch each; the
    trainer keeps this rank's rows); returns each step's metrics and the
    trainable parameters after every step, gathered whole. With
    `save_at` the run saves a checkpoint after that step; with `resume` it
    first resumes from `tc.output_dir`'s newest."""
    from mtasr_tpu_torch.config import DataConfig
    from mtasr_tpu_torch.data.pipeline import Batch
    from mtasr_tpu_torch.parallel.mesh import gather_state_dict
    from mtasr_tpu_torch.train.loop import Trainer
    cfg, tc = spec["cfg"], spec["tc"]
    model = _model(spec)
    mesh = _mesh(spec)
    trainer = Trainer(cfg, tc, DataConfig(), model,
                      freeze_kwargs=spec.get("freeze"), mesh=mesh)
    if spec.get("resume"):
        assert trainer.maybe_resume()
    batches = [Batch(utt_ids=[f"u{i}" for i in range(
        b["input_values"].shape[0])], arrays=b,
        splice_index=spec.get("splice_index", 1)) for b in spec["batches"]]
    out = {"metrics": [], "params": []}
    for b in batches[trainer.state.step:spec.get("steps", len(batches))]:
        m = trainer._train_step(b.splice_index)(
            model, trainer._tensors(b, rows=True), None)
        trainer.state.step += 1
        trainer.state.batch_in_epoch += 1
        out["metrics"].append({k: v.detach().numpy() for k, v in m.items()})
        if spec.get("save_at") == trainer.state.step:
            trainer.save()
        flat = {n: p.detach() for n, p in model.named_parameters()
                if p.requires_grad}
        out["params"].append({k: v.numpy().copy() for k, v in
                              gather_state_dict(flat, model).items()})
    return out


def run_collectives(spec):
    """Each region operator's forward and its input's gradient, on this
    rank; the test rebuilds them in one process."""
    import torch
    import torch.distributed as dist
    from mtasr_tpu_torch.parallel import collectives as C
    group = dist.group.WORLD
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.from_numpy(spec["x"]).clone()          # [n*2, 3], replicated
    w = torch.from_numpy(spec["w"]).clone()          # [n*2, 3]
    out = {}
    # copy: y = copy(x) * w_r (this rank's rows), loss = sum over ranks
    xa = x.clone().requires_grad_(True)
    y = C.copy_to_tp(xa, group) * w[2 * r:2 * r + 2].repeat(n, 1)
    y.sum().backward()
    out["copy_fwd"], out["copy_grad"] = y.detach().numpy(), xa.grad.numpy()
    # reduce: y = reduce(x * (r + 1)), loss = sum(y * w)
    xa = x.clone().requires_grad_(True)
    y = C.reduce_from_tp(xa * (r + 1), group)
    (y * w).sum().backward()
    out["reduce_fwd"], out["reduce_grad"] = y.detach().numpy(), \
        xa.grad.numpy()
    # gather: this rank's rows -> all, loss = sum(y * w)
    xa = x[2 * r:2 * r + 2].clone().requires_grad_(True)
    y = C.gather_from_tp(xa, group, dim=0)
    (y * w).sum().backward()
    out["gather_fwd"], out["gather_grad"] = y.detach().numpy(), \
        xa.grad.numpy()
    # scatter: x -> this rank's rows, loss = sum(y * w_rows) summed
    xa = x.clone().requires_grad_(True)
    y = C.scatter_to_tp(xa, group, dim=0)
    (y * w[2 * r:2 * r + 2]).sum().backward()
    out["scatter_fwd"], out["scatter_grad"] = y.detach().numpy(), \
        xa.grad.numpy()
    xb = x.to(torch.bfloat16)
    out["allreduce_bf16"] = C.all_reduce(xb * (r + 1), group).float().numpy()
    out["broadcast"] = C.broadcast(x * (r + 1), group, 1).numpy()
    return out


def run_multihost(spec):
    """The two-process flow of `tests/_multihost_worker.py`: process_shard,
    host_broadcast, the stage-6 shard files, barrier, rank-0 merge."""
    import numpy as np
    from argparse import Namespace
    from mtasr_tpu_torch.parallel import multihost
    pid, nproc = multihost.process_index(), multihost.process_count()
    # a second initialize is benign
    multihost.initialize(device="cpu")
    n_items = 11
    mine = list(range(n_items))[multihost.process_shard(n_items)]
    x = (np.arange(4.0) + 1.0) if pid == 0 else np.zeros(4)
    y = multihost.host_broadcast(x)
    outdir = spec["outdir"]
    for name in ("decod", "label"):
        with open(os.path.join(outdir, f"{name}.{pid}"), "w") as f:
            for i in mine:
                f.write(f"utt{i:02d} hello from {i}\n")
    multihost.barrier("shards-written")
    report = None
    if pid == 0:
        from mtasr_tpu_torch.cli.inference_asr import merge_and_score
        report = merge_and_score(Namespace(num_shards=nproc,
                                           output_dir=outdir,
                                           char_mode=False))
    multihost.barrier("merged")
    return {"mine": mine, "broadcast": y, "report": report}


SCENARIOS = {"serve": run_serve, "train": run_train,
             "collectives": run_collectives, "multihost": run_multihost}


def main() -> None:
    rank, world, port, job = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    sys.modules["jax"] = None           # the ranks never load JAX
    sys.modules["mtasr_tpu"] = None
    import torch
    torch.set_num_threads(1)
    from mtasr_tpu_torch.parallel import multihost
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo",
                         device="cpu")
    spec = torch.load(job, weights_only=False)
    results = {}
    for name, sc in spec["scenarios"].items():
        if rank == 0:
            print(f"scenario {name}", flush=True)
        results[name] = SCENARIOS[sc["kind"]](sc)
    torch.save(results, f"{job}.out.{rank}")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
