"""Time the window spread and gather kernels at the main path's shapes.

    python -m repro_torch.launch.time_window [--json PATH] [--reps 20]
        [--deterministic] [--label NAME]

On the main path's geometry (spiral nodes, d = 3, ``scale_nodes`` and
``build_window_geometry`` of SETUP_2 and SETUP_3) at n = 10^5 (C = 1 and
4, float64 and float32) and n = 10^6 (SETUP_2, C = 1, float64), each kernel
is timed with CUDA events over back-to-back calls after warm-up ("a
call"), and held against its plain version (max |k - p| / max |p|); each
spread also gets a device time, the same calls replayed from one CUDA
graph, so no host work sits between them.  The geometry's tile plan,
where the package has one, is built once per geometry and passed to
every call; its build time is printed on its own line.

``--deterministic`` times the spread under
``torch.use_deterministic_algorithms`` beside the atomic spread, each a
call and on the device, at the shapes of the paths that run it (float64):
the main path's SETUP_3 and SETUP_2 at C = 1, the lockstep bank's SETUP_2
at C = 16, the sweep's d = 1 (N = 64, m = 4, n = 50,000) at C = 16, the
m = 9 window pieces (N = 32, d = 3, n = 10^5) and KRR's CG (crescent, N =
256, m = 5, n = 10^4, d = 2) at C = 1, with its five repeats bitwise
equal or not, its error against plain, its scratch, and its schedule's
build time (host clock, before any timed call), bytes, waves and chunks
where the package has ``spread_block_index``.

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

import numpy as np

from repro_torch.core import fastsum
from repro_torch.core.kernels import make_kernel
from repro_torch.core.nfft import build_window_geometry, padded_grid_size
from repro_torch.data.synthetic import crescent_fullmoon, spiral
from repro_torch.kernels import nfft_window

SHAPES = ([(100_000, s, c, dt) for s in ("SETUP_2", "SETUP_3")
           for c in (1, 4) for dt in ("float64", "float32")]
          + [(1_000_000, "SETUP_2", 1, "float64")])
# --deterministic: (label, geometry, C); float64
DET_SHAPES = (("main SETUP_3", "SETUP_3", 1), ("main SETUP_2", "SETUP_2", 1),
              ("bank lockstep SETUP_2", "SETUP_2", 16),
              ("sweep d=1 N=64 m=4 n=50000", "sweep_d1", 16),
              ("spiral N=32 m=9 n=100000 (pieces)", "wide_m9", 1),
              ("KRR CG crescent N=256 m=5 n=10000 d=2", "krr", 1))
DET_REPEATS = 5


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


def graph_ms(fn, reps: int) -> float:
    """The device's time a call: ``reps`` calls captured in one CUDA graph
    and the graph replayed, so no host work sits between the kernels (at a
    latency-bound shape ``time_ms`` reads the host's time a call).  The
    first call, outside the capture, builds whatever the calls cache."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 3, 1) / reps


def geometry(n: int, setup_name: str, dev):
    pts, _ = spiral(n, seed=0)
    pts = torch.as_tensor(pts, device=dev)
    params = getattr(fastsum, setup_name)
    scaled, _, _ = fastsum.scale_nodes(pts, params.eps_b_eff)
    plan = params.nfft_plan(3)
    return plan, build_window_geometry(plan, scaled)


def det_geometry(name: str, dev):
    """(NFFT plan, window geometry) of a --deterministic shape."""
    if name in ("SETUP_2", "SETUP_3"):
        return geometry(100_000, name, dev)
    if name == "sweep_d1":  # benchmarks/sweep_scaling.py's d = 1 dataset
        pts = np.sort(np.random.default_rng(7).normal(size=(50_000, 1))
                      * 2.0, axis=0)
        params = fastsum.FastsumParams(n_bandwidth=64, m=4)
    elif name == "wide_m9":
        pts, _ = spiral(100_000, seed=0)
        params = fastsum.FastsumParams(n_bandwidth=32, m=9, eps_b=0.0)
    else:  # KRR's Gram: the first 10^4 of crescent_fullmoon(10,400, seed=5)
        pts, _ = crescent_fullmoon(10_400, seed=5)
        params = fastsum.FastsumParams(n_bandwidth=256, m=5, eps_b=None)
        op = fastsum.make_fastsum(make_kernel("gaussian", sigma=2.0),
                                  torch.as_tensor(pts[:10_000], device=dev),
                                  params, device=dev)
        return op.plan, op.src_window
    d = 1 if name == "sweep_d1" else 3
    pts = torch.as_tensor(np.asarray(pts)[:, :d], device=dev)
    scaled, _, _ = fastsum.scale_nodes(pts, params.eps_b_eff)
    plan = params.nfft_plan(d)
    return plan, build_window_geometry(plan, scaled)


def det_row(label: str, plan, geom, c: int, reps: int, dev) -> dict:
    """The deterministic and the atomic spread at one shape, float64: a
    call and the device's time each, the deterministic mode's repeats,
    error, scratch and schedule."""
    base, w, tiles = geom.base, geom.weights.to(torch.float64), geom.tiles
    n, d, _ = w.shape
    pad = padded_grid_size(plan)
    gen = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((n, c), generator=gen, dtype=torch.float64, device=dev)
    spread = lambda: nfft_window.window_spread(x, base, w, padded_size=pad,
                                               tiles=tiles)
    row = {"label": label, "n": n, "d": d, "taps": plan.taps, "c": c,
           "padded": pad, "tiles": tiles.n_tiles}
    block_index = getattr(nfft_window, "spread_block_index", None)
    if block_index is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = block_index(tiles, pad, c, 8)
        torch.cuda.synchronize()
        row.update(index_ms=(time.perf_counter() - t0) * 1e3,
                   index_mb=index.nbytes / 1e6, waves=index.n_waves,
                   chunks=index.chunks.shape[0], side=index.side)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [spread()]
        torch.cuda.synchronize()
        row["first_call_ms"] = (time.perf_counter() - t0) * 1e3
        outs += [spread() for _ in range(DET_REPEATS - 1)]
        row["det_ms"] = time_ms(spread, reps)
        row["det_device_ms"] = graph_ms(spread, reps)
    finally:
        torch.use_deterministic_algorithms(prev)
    row["scratch_mb"] = (nfft_window.window_spread_deterministic.scratch_bytes
                         / 1e6)
    row["repeats_equal"] = all(torch.equal(outs[0], o) for o in outs[1:])
    want = nfft_window.window_spread_plain(x, base, w, padded_size=pad)
    row["rel_err"] = float((outs[0] - want).abs().max() / want.abs().max())
    del outs, want
    row["atomic_ms"] = time_ms(spread, reps)
    row["atomic_device_ms"] = graph_ms(spread, reps)
    return row


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
    ap.add_argument("--deterministic", action="store_true",
                    help="time the deterministic spread beside the atomic "
                         "one at the shapes of the paths that run it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_window needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[device] {smi.stdout.strip() or torch.cuda.get_device_name(0)}",
          flush=True)
    rows = []
    if args.deterministic:
        for label, name, c in DET_SHAPES:
            plan, geom = det_geometry(name, dev)
            reps = 3 if plan.taps > 16 else args.reps
            row = dict(det_row(label, plan, geom, c, reps, dev),
                       version=args.label)
            rows.append(row)
            sched = (f"; schedule {row['index_ms']:.2f} ms, "
                     f"{row['index_mb']:.2f} MB, {row['waves']} waves, "
                     f"{row['chunks']} chunks, side {row['side']}"
                     if "index_ms" in row else "")
            print(f"[det] {args.label} {label} C={c}: {row['det_ms']:.4f} ms "
                  f"a call, {row['det_device_ms']:.4f} ms on the device "
                  f"(atomic {row['atomic_ms']:.4f} / "
                  f"{row['atomic_device_ms']:.4f}); rel err "
                  f"{row['rel_err']:.2e}, {DET_REPEATS} repeats bitwise "
                  f"equal: {row['repeats_equal']}; scratch "
                  f"{row['scratch_mb']:.1f} MB; first call "
                  f"{row['first_call_ms']:.1f} ms{sched}", flush=True)
            del plan, geom
            torch.cuda.empty_cache()
        return dump(args.json, rows)
    planned = "tiles" in inspect.signature(
        nfft_window.window_spread).parameters
    geoms = {}
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
            device = ""
            if kname == "spread":
                row["device_ms"] = graph_ms(kfn, args.reps)
                device = f" ({row['device_ms']:.4f} ms on the device)"
            rows.append(row)
            print(f"[time] {args.label} {kname:6s} n={n} {setup_name} d=3 "
                  f"C={c} {dname}: {ms:.4f} ms{device}, rel err {rel:.2e}",
                  flush=True)
    return dump(args.json, rows)


def dump(path, rows) -> int:
    if path:
        with open(path, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
