"""LM training from the command line — the twin of
``examples/train_lm.py``: config -> model -> microbatched train step ->
fault-tolerant loop with async checkpointing -> resume, on one device.

Default is a CPU-sized model; ``--params 100m --steps 300`` runs the
~100M-parameter few-hundred-step protocol on the card.

    PYTHONPATH=src python -m repro_torch.train_lm --steps 30 --device cpu
    PYTHONPATH=src python -m repro_torch.train_lm --params 100m --steps 300
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.device import resolve_device
from repro_torch.launch.train import batch_on
from repro_torch.training.fault_tolerance import run_resilient
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import (
    TrainConfig, init_train_state, make_train_step)


def build_config(size: str):
    base = get_config("granite-3-2b")  # GQA + SwiGLU family
    if size == "tiny":
        cfg = reduced_config(base, seq_len=128, global_batch=8)
    elif size == "20m":
        cfg = dataclasses.replace(
            reduced_config(base, seq_len=256, global_batch=8),
            name="granite-20m", num_layers=6, d_model=384, num_heads=6,
            num_kv_heads=2, head_dim=64, d_ff=1536, vocab_size=8192)
    elif size == "100m":
        cfg = dataclasses.replace(
            reduced_config(base, seq_len=512, global_batch=16),
            name="granite-100m", num_layers=12, d_model=768, num_heads=12,
            num_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32768)
    else:
        raise SystemExit(f"unknown --params {size}")
    return cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", default="tiny", choices=["tiny", "20m", "100m"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_config(args.params)
    tc = TrainConfig(
        optimizer=OptimizerConfig(peak_lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(args.steps // 10, 2)),
        num_microbatches=args.microbatches)
    state = init_train_state(cfg, tc, 0, device=dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{cfg.num_layers}L d={cfg.d_model}, seq={cfg.shapes[0].seq_len}, "
          f"batch={cfg.shapes[0].global_batch}, device={dev}")

    step_fn = make_train_step(cfg, tc)
    batch_fn = lambda s: batch_on(batch_for_step(cfg, cfg.shapes[0], s), dev)

    t0 = time.perf_counter()
    state, info = run_resilient(
        step_fn, state, batch_fn, total_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 5),
        log_every=max(args.steps // 10, 1))
    dt = time.perf_counter() - t0

    loss = float(info["final_metrics"]["loss"])
    toks = cfg.shapes[0].global_batch * cfg.shapes[0].seq_len
    print(f"\n{info['steps']} steps in {dt:.1f}s "
          f"({dt / max(info['steps'], 1):.2f}s/step, "
          f"{toks * info['steps'] / dt:.0f} tok/s) "
          f"final loss {loss:.4f} "
          f"(restarts={info['restarts']}, stragglers={info['stragglers']})")
    with torch.no_grad():
        init_loss = float(init_train_state(cfg, tc, 0, device=dev)
                          .params.forward_train(batch_fn(0))[0])
    print(f"loss {init_loss:.3f} -> {loss:.3f} "
          f"(uniform baseline ln V = {math.log(cfg.vocab_size):.3f}; the "
          f"structured stream's floor is ~{0.33:.2f})")
    assert loss < init_loss - 0.02, (loss, init_loss)


if __name__ == "__main__":
    main()
