"""Training from the command line, on one device:

    python -m repro_torch.launch.train --arch granite-3-2b --reduced --device cpu
    python -m repro_torch.launch.train --arch granite-3-2b --steps 8 \\
        --batch 2 --microbatches 2

The port of ``repro.launch.train`` for one card (the reference's mesh and
``--model-parallel`` apply its sharding rules, which come with the port's
sharded train step, ROADMAP queue 1 item 12's LM half): the flags are the
reference's, ``--reduced`` (off by default) swaps in the same-family
CPU-scale config, and ``--device`` picks the device (default: the CUDA
card).  Fault tolerance is on: a checkpoint every ``--ckpt-every`` steps,
and a run resumes from the latest intact one in ``--ckpt-dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import resolve_device
from repro_torch.training.fault_tolerance import run_resilient
from repro_torch.training.train_loop import (
    TrainConfig, init_train_state, make_train_step)


def batch_on(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


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
    dev = resolve_device(args.device)

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

    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"shape={shape.name} batch={shape.global_batch} seq={shape.seq_len} "
          f"device={dev} optimizer={opt.name}")

    state = init_train_state(cfg, tc, args.seed, device=dev)
    step_fn = make_train_step(cfg, tc)
    pf = Prefetcher(cfg, shape, seed=args.seed)
    try:
        t0 = time.perf_counter()
        state, info = run_resilient(
            step_fn, state, lambda s: batch_on(pf.get(s), dev),
            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, log_every=args.log_every)
        dt = time.perf_counter() - t0
    finally:
        pf.close()

    loss = float(info["final_metrics"]["loss"])
    tok_per_step = shape.global_batch * shape.seq_len
    print(f"done: {info['steps']} steps in {dt:.1f}s "
          f"({dt / max(info['steps'], 1):.3f}s/step, "
          f"{tok_per_step / (dt / max(info['steps'], 1)):.0f} tok/s) "
          f"final loss {loss:.4f} restarts={info['restarts']}")


if __name__ == "__main__":
    main()
