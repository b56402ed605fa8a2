"""Time the window spread and gather kernels at the main path's shapes.

    python -m repro_torch.launch.time_window [--json PATH] [--reps 20]

On the main path's geometry (spiral nodes, d = 3, ``scale_nodes`` and
``build_window_geometry`` of SETUP_2 and SETUP_3) at n = 10^5 (C = 1 and
4, float64 and float32) and n = 10^6 (SETUP_2, C = 1, float64), each kernel
is timed with CUDA events over back-to-back calls after warm-up, and held
against its plain version (max |k - p| / max |p|).  The geometry's tile
plan, where the package has one, is built once per geometry and passed to
every call; its build time is printed on its own line.

The script imports ``repro_torch`` from ``sys.path`` like any user, so it
also times another checkout's kernels: run this file with ``PYTHONPATH``
set to that checkout's ``src``.  Two versions are compared only within one
machine and one call, in turns (A, B, B, A).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import time

import torch

from repro_torch.core import fastsum
from repro_torch.core.nfft import build_window_geometry, padded_grid_size
from repro_torch.data.synthetic import spiral
from repro_torch.kernels import nfft_window

SHAPES = ([(100_000, s, c, dt) for s in ("SETUP_2", "SETUP_3")
           for c in (1, 4) for dt in ("float64", "float32")]
          + [(1_000_000, "SETUP_2", 1, "float64")])


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def geometry(n: int, setup_name: str, dev):
    pts, _ = spiral(n, seed=0)
    pts = torch.as_tensor(pts, device=dev)
    params = getattr(fastsum, setup_name)
    scaled, _, _ = fastsum.scale_nodes(pts, params.eps_b_eff)
    plan = params.nfft_plan(3)
    return plan, build_window_geometry(plan, scaled)


def plan_line(n: int, setup_name: str, geom, build_ms: float) -> str:
    """The tile plan's shape: distinct window corners, tiles, box sizes,
    and the box cells of all tiles (the spread's global atomics per
    channel, at most; the scatter of one atomic per window cell makes
    n * taps^3)."""
    t = geom.tiles
    cells = t.table[:, 5:8].to(torch.long).prod(dim=1)
    corners = torch.unique(geom.base, dim=0).shape[0]
    return (f"[plan] n={n} {setup_name} d=3: {corners} distinct window "
            f"corners ({n / corners:.0f} nodes each), {t.n_tiles} tiles, "
            f"box cells median {int(cells.median())} / largest "
            f"{t.max_cells}, all boxes {int(cells.sum())} cells against "
            f"{n * t.taps ** 3} window cells; built in {build_ms:.2f} ms "
            "(host clock)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="", help="a name for this version")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_window needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[device] {smi.stdout.strip() or torch.cuda.get_device_name(0)}",
          flush=True)
    planned = "tiles" in inspect.signature(
        nfft_window.window_spread).parameters
    rows, geoms = [], {}
    for n, setup_name, c, dname in SHAPES:
        if (n, setup_name) not in geoms:
            plan, geom = geometry(n, setup_name, dev)
            kw = {}
            if planned:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kw["tiles"] = geom.tiles
                torch.cuda.synchronize()
                build_ms = (time.perf_counter() - t0) * 1e3
                print(plan_line(n, setup_name, geom, build_ms), flush=True)
            geoms[(n, setup_name)] = (plan, geom, kw)
        plan, geom, kw = geoms[(n, setup_name)]
        dtype = getattr(torch, dname)
        base, w = geom.base, geom.weights.to(dtype)
        pad = padded_grid_size(plan)
        gen = torch.Generator(device=dev).manual_seed(c)
        x = torch.randn((n, c), generator=gen, dtype=dtype, device=dev)
        g = torch.randn((pad,) * 3 + (c,), generator=gen, dtype=dtype,
                        device=dev)
        for kname, kfn, pfn in (
                ("spread",
                 lambda: nfft_window.window_spread(x, base, w,
                                                   padded_size=pad, **kw),
                 lambda: nfft_window.window_spread_plain(x, base, w,
                                                         padded_size=pad)),
                ("gather", lambda: nfft_window.window_gather(g, base, w, **kw),
                 lambda: nfft_window.window_gather_plain(g, base, w))):
            want = pfn()
            rel = float((kfn() - want).abs().max() / want.abs().max())
            ms = time_ms(kfn, args.reps)
            row = {"label": args.label, "kernel": kname, "n": n,
                   "setup": setup_name, "d": 3, "c": c, "dtype": dname,
                   "ms": ms, "rel_err": rel}
            rows.append(row)
            print(f"[time] {args.label} {kname:6s} n={n} {setup_name} d=3 "
                  f"C={c} {dname}: {ms:.4f} ms, rel err {rel:.2e}",
                  flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
