"""Training from the command line, on one device or over ranks:

    python -m repro_torch.launch.train --arch granite-3-2b --reduced --device cpu
    python -m repro_torch.launch.train --arch granite-3-2b --steps 8 \\
        --batch 2 --microbatches 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch granite-3-2b --reduced --device cpu --model-parallel 2

The port of ``repro.launch.train``: the flags are the reference's,
``--reduced`` (off by default) swaps in the same-family CPU-scale config,
and ``--device`` picks the device (default: the CUDA card).  Fault
tolerance is on: a checkpoint every ``--ckpt-every`` steps, and a run
resumes from the latest intact one in ``--ckpt-dir``.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) every rank joins the
process group and trains through the sharded step on
``make_local_mesh(--model-parallel)``, a ("data", "model") mesh over the
ranks, each holding its blocks of the state; the ranks of "model" each
compute their block of the attention heads, MLP hidden units, experts,
Mamba heads and vocabulary, those of "data" their rows of the batch; rank
0 writes the checkpoints and prints.  The backend is NCCL when every local rank has a
card of its own, else gloo (ranks sharing a card, or the CPU).  Without
``torchrun`` it is one process on one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.training.fault_tolerance import run_resilient
from repro_torch.training.train_loop import (
    TrainConfig, init_train_state, make_train_step)


def batch_on(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def init_ranks(device: str | None):
    """Under torchrun, join the process group: (rank, device); None
    without torchrun.  gloo on the CPU or when the local ranks outnumber
    the cards (they share card 0), else NCCL with a card a rank."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    if dev.type == "cuda":
        own = torch.cuda.device_count() >= local_world
        dev = torch.device("cuda", local if own else 0)
        torch.cuda.set_device(dev)
        backend = "nccl" if own else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world,
                            device_id=dev if backend == "nccl" else None)
    print(f"rank {rank} of {world}: backend {backend} on {dev}")
    return rank, dev


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ranks = init_ranks(args.device)
    if ranks is None:
        if args.model_parallel != 1:
            raise SystemExit("--model-parallel needs ranks: run under "
                             "torchrun")
        rank, dev, mesh = 0, resolve_device(args.device), None
    else:
        (rank, dev), mesh = ranks, make_local_mesh(args.model_parallel)
    try:
        _train(args, rank, dev, mesh)
    finally:
        if ranks is not None:
            dist.destroy_process_group()


def _train(args, rank, dev, mesh) -> None:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, seq_len=args.seq_len or 128,
                             global_batch=args.batch or 8)
    shape = next(s for s in cfg.shapes if s.name == args.shape)
    if args.seq_len or args.batch:
        shape = dataclasses.replace(
            shape, seq_len=args.seq_len or shape.seq_len,
            global_batch=args.batch or shape.global_batch)

    opt = dataclasses.replace(
        TrainConfig.for_arch(cfg).optimizer, peak_lr=args.lr,
        total_steps=args.steps, warmup_steps=max(args.steps // 20, 5))
    tc = TrainConfig.for_arch(cfg, optimizer=opt,
                              num_microbatches=args.microbatches,
                              compress_grads=args.compress_grads)

    if rank == 0:
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
              f"shape={shape.name} batch={shape.global_batch} "
              f"seq={shape.seq_len} device={dev} optimizer={opt.name} "
              f"mesh={None if mesh is None else mesh.shape}")

    state = init_train_state(cfg, tc, args.seed, device=dev, mesh=mesh)
    step_fn = make_train_step(cfg, tc, mesh=mesh)
    pf = Prefetcher(cfg, shape, seed=args.seed)
    try:
        t0 = time.perf_counter()
        state, info = run_resilient(
            step_fn, state, lambda s: batch_on(pf.get(s), dev),
            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, log_every=args.log_every,
            state_shardings=getattr(step_fn, "state_shardings", None))
        dt = time.perf_counter() - t0
    finally:
        pf.close()

    if rank != 0:
        return
    loss = float(info["final_metrics"]["loss"])
    tok_per_step = shape.global_batch * shape.seq_len
    print(f"done: {info['steps']} steps in {dt:.1f}s "
          f"({dt / max(info['steps'], 1):.3f}s/step, "
          f"{tok_per_step / (dt / max(info['steps'], 1)):.0f} tok/s) "
          f"final loss {loss:.4f} restarts={info['restarts']}")


if __name__ == "__main__":
    main()
