"""Where a train step's time goes: one LM train step under
``torch.profiler``.

    python -m repro_torch.launch.trace_train --arch granite-3-2b \\
        [--batch 2] [--microbatches 2] [--seq-len 4096] [--top 16]
    python -m repro_torch.launch.trace_train --reduced --device cpu

Builds the train state at full width and depth with seeded random weights
(``--reduced`` for the reduced config; the optimizer is the one
``TrainConfig.for_arch`` picks), warms the step up, and reports what
:func:`repro_torch.launch.trace_serve.trace` reports for one step of
``--batch`` sequences of ``--seq-len`` tokens in ``--microbatches``: the
unprofiled wall, the device's busy time and idle share, the host
operations and device kernels per layer, and the ``--top`` kernels by
device time.  The step updates the state, so each traced call is the next
step on step 0's batch.
"""

from __future__ import annotations

import argparse
import dataclasses


from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.device import resolve_device
from repro_torch.launch.trace_serve import trace
from repro_torch.launch.train import batch_on
from repro_torch.training.train_loop import (
    TrainConfig, init_train_state, make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = dataclasses.replace(
        next(s for s in cfg.shapes if s.name == "train_4k"),
        seq_len=args.seq_len, global_batch=args.batch)
    tc = TrainConfig.for_arch(cfg, num_microbatches=args.microbatches)
    box = [init_train_state(cfg, tc, 0, device=device)]
    step = make_train_step(cfg, tc)
    batch = batch_on(batch_for_step(cfg, shape, 0), device)

    def one_step():
        box[0], _ = step(box[0], batch)

    r = trace(one_step, device, cfg.num_layers, args.reps, top=args.top)
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.param_dtype, "device": str(device),
           "batch": args.batch, "microbatches": args.microbatches,
           "seq_len": args.seq_len, "optimizer": tc.optimizer.name,
           "step": r}
    busy = ("no device timeline" if r["device_busy_ms"] is None else
            f"device busy {r['device_busy_ms']:.1f} ms, idle share "
            f"{r['device_idle_share']:.3f}")
    print(f"{cfg.name} train step ({args.batch} x {args.seq_len} tokens, "
          f"{args.microbatches} microbatches, {tc.optimizer.name}, "
          f"{device}): wall {r['wall_ms']:.1f} ms (unprofiled), {busy}; "
          f"{r['host_ops_per_layer']:.1f} host ops and "
          f"{r['device_events_per_layer']:.1f} device events per layer")
    for k in r["top_kernels"]:
        print(f"    {k['ms']:9.3f} ms {k['count']:5d}x  {k['name'][:90]}")
    return out


if __name__ == "__main__":
    main()
