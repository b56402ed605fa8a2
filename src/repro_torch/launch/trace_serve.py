"""Where the serve path's time goes: one prefill and one engine tick under
``torch.profiler``.

    python -m repro_torch.launch.trace_serve --arch granite-3-2b \
        [--prompt-len 2048] [--device cpu] [--reduced]

Builds the model at full width and depth with seeded random weights
(``--reduced`` for the reduced config), warms both calls up, and then, for
one b=1 prefill of ``--prompt-len`` tokens and one ``ServeEngine`` tick with
SLOTS active slots on a ``--max-seq`` cache:

- the call's host-clock wall without the profiler (mean of ``--reps``
  calls, each ending in a synchronize);
- under the profiler, once: the device's busy time (the union of its
  kernel, copy and set intervals), the PyTorch operations the host issued
  (top-level ``aten`` calls) and the device kernels launched, per layer;
- the device's idle share, 1 - busy / wall, against the unprofiled wall;
- the device kernels with the most time.

On the CPU there is no device timeline: busy time and idle share are
None and no device event is counted.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServeEngine

SLOTS = 4  # the engine's default and the smoke's decode tick
TOP = 8  # device kernels listed per traced call


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall_ms(fn, device: torch.device, reps: int) -> float:
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace(fn, device: torch.device, layers: int, reps: int,
          top: int = TOP):
    """Wall (unprofiled, after one warm-up call), then one profiled call of
    ``fn``: a dict of what the module docstring lists (``top`` kernels)."""
    fn()
    wall_ms = _wall_ms(fn, device, reps)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        fn()
        _sync(device)
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = [e for e in events if e.device_type == DeviceType.CPU
                and e.cpu_parent is None and e.name.startswith("aten::")]
    busy_ms = None
    if device.type == "cuda":
        busy_ms = _union_us((e.time_range.start, e.time_range.end)
                            for e in dev) / 1e3
    by_name: dict[str, list] = {}
    for e in dev:
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += (e.time_range.end - e.time_range.start) / 1e3
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (None if busy_ms is None
                              else 1.0 - busy_ms / wall_ms),
        "host_ops": len(host_ops),
        "host_ops_per_layer": len(host_ops) / layers,
        "device_events": len(dev),
        "device_events_per_layer": len(dev) / layers,
        "top_kernels": [{"name": n, "count": c, "ms": ms}
                        for n, (c, ms) in kernels]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = M.init_params(cfg, 0, device=args.device)
    device = model.device
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).tolist()

    toks = torch.as_tensor([prompt], device=device)
    caches = M.init_caches(cfg, 1, args.prompt_len, device=device)
    prefill = trace(lambda: model.forward_prefill({"tokens": toks}, caches),
                    device, cfg.num_layers, args.reps)
    del caches

    engine = ServeEngine(cfg, model, slots=SLOTS, max_seq=args.max_seq,
                         device=device)
    for i in range(SLOTS):
        engine.submit(Request(uid=i, tokens=prompt,
                              max_new_tokens=args.max_seq))
    engine.step()  # admits every slot and decodes once
    tick = trace(engine.step, device, cfg.num_layers, args.reps)
    if not all(r is not None for r in engine.active):
        raise SystemExit("a slot went idle during the traced ticks")

    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.activation_dtype, "device": str(device),
           "prompt_len": args.prompt_len, "slots": SLOTS,
           "max_seq": args.max_seq, "prefill": prefill, "tick": tick}
    for what, r in (("prefill", prefill), ("tick", tick)):
        busy = ("no device timeline" if r["device_busy_ms"] is None else
                f"device busy {r['device_busy_ms']:.3f} ms, idle share "
                f"{r['device_idle_share']:.3f}")
        print(f"{cfg.name} {what}: wall {r['wall_ms']:.3f} ms (unprofiled), "
              f"{busy}; {r['host_ops_per_layer']:.1f} "
              f"host ops and {r['device_events_per_layer']:.1f} device "
              f"events per layer")
        for k in r["top_kernels"]:
            print(f"    {k['ms']:9.3f} ms {k['count']:5d}x  {k['name'][:90]}")
    return out


if __name__ == "__main__":
    main()
