"""Multi-pod dry run: trace every (architecture x input shape) cell as one
rank of the production meshes, and derive its roofline terms.

The port of ``repro.launch.dryrun``.  It is a dry run, not a CPU fallback:
nothing is computed and nothing is allocated.  The port's own step
functions (``launch.steps.make_step_fn`` over a mesh: the sharded train
step, the sharded prefill and decode) and the sharded matvec body of
``dist.fastsum_dist`` run once on ``meta`` tensors as rank ``--rank``
(default 0) of a described (16, 16) or (2, 16, 16) mesh
(``Mesh(shape, rank=r, described=True)``), with no card and no process
group.  Its collectives count what a live rank would hand them; the
kernel wrappers count their kernels' ``work``; a dispatch mode counts the
aten ops (``launch.steps.trace_call``).

Per cell it records the trace's wall time (``trace_s``), ``memory`` (the
rank's argument bytes from the shardings, its output bytes and the peak of
live bytes over the meta tensors' storages: no allocator slack, no cuBLAS
or NCCL workspaces), ``stats`` (FLOPs, HBM bytes, the collective bytes in
the reference's "moved" and "payload" models, DCI bytes), the three
roofline terms (``launch.roofline``, the H100 data sheet's peaks) and
``whole_parts``: the parts of the model that every rank computes whole
(MLA and NFFT attention, which the reference does not split either), whose
counts therefore overstate a split rank's work.  Heads and experts that
the "model" axis does not divide split in ceil blocks, as the reference's
GSPMD pads them: each rank counts its own block (qwen1.5-32b's 40 heads
on 16 ranks: 3 on ranks 0-12, 1 on rank 13, none on ranks 14 and 15).

The *paper-technique* cells (``graph-fastsum-*``) trace the distributed
NFFT fast-summation matvec body at node counts up to 2^27 in both spectral
modes, and ``graph-serve-*`` the graph-predict serving tick.  The port's
tick sorts each rank's rows of the pack locally, so it moves no bytes
where the reference's global sort under XLA does; its record says so.

    python -m repro_torch.launch.dryrun --arch all --mesh both --graph \\
        --graph-serve
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ALL_ARCHS, EXTRA_ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, make_production_mesh, \
    mesh_chip_count
from repro_torch.launch.steps import trace_call, trace_cell
from repro_torch.training.train_loop import TrainConfig

GRAPH_SERVE_NOTE = ("each rank builds and Morton-sorts the geometry of its "
                    "own rows of the pack: no collective, where the "
                    "reference's global sort under XLA moves bytes; the "
                    "guard runs on the host, not in the traced body")


def _mesh_name(mesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())


def _error(rec: dict, e: Exception) -> dict:
    rec.update(status="error", error=f"{type(e).__name__}: {e}",
               traceback=traceback.format_exc()[-2000:])
    return rec


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, *,
             microbatch_override: int | None = None,
             compress_grads: bool = False, rank: int = 0) -> dict:
    """One (arch x shape) cell traced as rank ``rank`` of the production
    mesh."""
    cfg = get_config(arch_name)
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chip_count(mesh)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": _mesh_name(mesh),
           "chips": chips, "kind": shape.kind, "rank": rank}
    if shape.skip_reason:
        rec.update(status="skipped", skip_reason=shape.skip_reason)
        return rec
    tc = TrainConfig.for_arch(cfg)
    if microbatch_override:
        tc = dataclasses.replace(tc, num_microbatches=microbatch_override)
    if compress_grads:
        tc = dataclasses.replace(tc, compress_grads=True)
    try:
        out = trace_cell(cfg, shape, mesh, rank=rank, tc=tc)
        stats = out["stats"]
        roof = rl.roofline_from_stats(
            stats, kind=out["kind"],
            active_params=float(cfg.active_param_count()),
            batch=shape.global_batch, seq=shape.seq_len, chips=chips,
            dtype=cfg.activation_dtype)
        rec.update(status="ok", trace_s=round(out["trace_s"], 2),
                   memory=out["memory"], stats=stats.to_json(),
                   roofline=roof.to_json(), params=int(cfg.param_count()),
                   active_params=int(cfg.active_param_count()),
                   num_microbatches=tc.num_microbatches,
                   whole_parts=out["whole_parts"])
        if out["replicated"] is not None:
            rec["serve_replicated"] = out["replicated"]
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        _error(rec, e)
    return rec


def _setup(name: str):
    from repro_torch.core.fastsum import SETUP_1, SETUP_2, SETUP_3
    return {"setup1": SETUP_1, "setup2": SETUP_2, "setup3": SETUP_3}[name]


def _rank_mesh(mesh, multi_pod: bool, rank: int) -> Mesh:
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    return Mesh(mesh.shape, rank=rank, described=True)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def run_graph_cell(n_nodes: int, d: int, multi_pod: bool, *,
                   setup_name: str = "setup2", spectral_mode: str = "psum",
                   mesh=None, bank_size: int = 1, rank: int = 0) -> dict:
    """Trace the distributed Algorithm 3.1 matvec body at cluster scale.

    Runs the *shipped* per-shard body (``dist.fastsum_dist.
    make_sharded_matvec``: the support-block psum in ``"psum"``, the
    reduce-scattered pencil FFT in ``"pencil"``) on rank ``rank``'s block
    of ``n_nodes`` (ghost-padded to the rank count) sorted rows.  ``mesh``
    overrides the production mesh's shape; ``bank_size > 1`` traces the
    multiplier-bank body (``make_sharded_matvec_bank``, lockstep: the
    shape one bank Krylov iteration runs for an S-point sweep).  float32,
    as the reference's cells."""
    from repro_torch.dist import fastsum_dist

    params = _setup(setup_name)
    rank_mesh = _rank_mesh(mesh, multi_pod, rank)
    chips = mesh_chip_count(rank_mesh)
    axes = tuple(a for a in ("pod", "data", "model")
                 if a in rank_mesh.axis_names)
    plan = params.nfft_plan(d)
    grid, taps = plan.grid_size, plan.taps
    tag = "-pencil" if spectral_mode == "pencil" else ""
    banktag = f"-bank{bank_size}" if bank_size > 1 else ""
    effective = spectral_mode
    if spectral_mode == "pencil" and fastsum_dist.resolve_pencil_spec(
            plan, rank_mesh, axes) is None:
        effective = "psum"
    n_nodes += (-n_nodes) % chips  # ghost-pad so the node dim shards evenly
    rows = n_nodes // chips
    rec = {"arch": f"graph-fastsum{tag}{banktag}-{setup_name}-d{d}",
           "shape": f"n{n_nodes}", "mesh": _mesh_name(rank_mesh),
           "chips": chips, "kind": "graph_matvec", "rank": rank,
           "spectral_mode": spectral_mode,
           "spectral_mode_effective": effective, "bank": bank_size}
    try:
        t0 = time.perf_counter()
        spectrum = (grid,) * (d - 1) + (grid // 2 + 1,)
        base = _meta((rows, d), torch.int32)
        w1d = _meta((rows, d, taps), torch.float32)
        if bank_size > 1:
            mult = _meta((bank_size,) + spectrum, torch.complex64)
            x = _meta((bank_size, rows, 1), torch.float32)
            body = fastsum_dist.make_sharded_matvec_bank(
                plan, rank_mesh, axes, spectral_mode=spectral_mode)
        else:
            mult = _meta(spectrum, torch.complex64)
            x = _meta((rows, 1), torch.float32)
            body = fastsum_dist.make_sharded_matvec(
                plan, rank_mesh, axes, spectral_mode=spectral_mode)
        with torch.no_grad():
            out = trace_call(rank_mesh, body, mult, base, w1d, x)
        stats = out["stats"]
        # useful work model as the reference's: the direct dense matvec is
        # 2 n^2 (d + 2) flops; the fastsum does O(n)
        roof = rl.roofline_from_stats(
            stats, kind="prefill", active_params=float(n_nodes), batch=1,
            seq=1, chips=chips, dtype="float32")
        rec.update(status="ok", trace_s=round(time.perf_counter() - t0, 2),
                   memory=out["memory"], stats=stats.to_json(),
                   roofline=roof.to_json(), grid=grid,
                   bandwidth=plan.n_bandwidth, d=d)
    except Exception as e:  # noqa: BLE001
        _error(rec, e)
    return rec


def meta_fastsum(setup_name: str, n: int, d: int, *, bank_size: int = 1):
    """A float64 fast-summation operator of n Morton-sorted nodes in d
    dimensions whose tensors are all on ``meta`` (a ``FastsumOperator``,
    or with ``bank_size`` > 1 a ``FastsumOperatorBank`` of that many
    members): what ``make_fastsum`` builds, in shape and dtype, for
    tracing its matvecs."""
    from repro_torch.core.fastsum import (
        FastsumOperator, FastsumOperatorBank)
    from repro_torch.core.nfft import WindowGeometry

    params = _setup(setup_name)
    plan = params.nfft_plan(d)
    real, cplx = torch.float64, torch.complex128
    grid = plan.grid_size
    half = (grid,) * (d - 1) + (grid // 2 + 1,)
    full = (plan.n_bandwidth,) * d
    geom = WindowGeometry(base=_meta((n, d), torch.int32),
                          weights=_meta((n, d, plan.taps), real),
                          perm=_meta((n,), torch.long),
                          inv=_meta((n,), torch.long))
    src = _meta((n, d), real)
    if bank_size > 1:
        return FastsumOperatorBank(
            plan=plan, b_hat_bank=_meta((bank_size,) + full, cplx),
            scaled_src=src, kernel_at_zero=_meta((bank_size,), real),
            multiplier_bank=_meta((bank_size,) + half, cplx),
            src_window=geom, rho=1.0, fs_params=params)
    return FastsumOperator(
        plan=plan, b_hat=_meta(full, cplx), scaled_src=src, output_scale=1.0,
        kernel_at_zero=1.0, multiplier_half=_meta(half, cplx),
        src_window=geom, rho=1.0, fs_params=params)


def trace_matvec(op, x_shape: tuple, mesh=None, *, rank: int = 0,
                 spectral_mode: str = "psum", pencil_axes=None) -> dict:
    """``op.matvec`` on a ``meta`` x of ``x_shape`` (``op`` from
    :func:`meta_fastsum`), traced once (``launch.steps.trace_call``); with
    ``mesh``, the distributed matvec (``dist.fastsum_dist.
    distributed_matvec_fn`` / ``distributed_matvec_bank_fn`` over all its
    axes) as rank ``rank`` of its shape."""
    from repro_torch.core.fastsum import FastsumOperatorBank
    from repro_torch.dist import fastsum_dist

    x = _meta(tuple(x_shape), op.scaled_src.dtype)
    if mesh is None:
        with torch.no_grad():
            return trace_call(Mesh({"data": 1}, rank=0, described=True),
                              op.matvec, x)
    rank_mesh = Mesh(mesh.shape, rank=rank, described=True)
    make = (fastsum_dist.distributed_matvec_bank_fn
            if isinstance(op, FastsumOperatorBank)
            else fastsum_dist.distributed_matvec_fn)
    with torch.no_grad():
        mv = make(op, rank_mesh, rank_mesh.axis_names,
                  spectral_mode=spectral_mode, pencil_axes=pencil_axes)
        return trace_call(rank_mesh, mv, x)


def run_graph_serve_cell(slots: int, chunk: int, d: int, multi_pod: bool, *,
                         setup_name: str = "setup2", mesh=None,
                         guarded: bool = True, rank: int = 0) -> dict:
    """Trace the graph-predict serve tick body at cluster scale.

    The device part of :class:`repro_torch.serving.graph.GraphServeEngine`'s
    tick, the function the engine runs (``serving.graph.tick_predict``):
    the packed target window geometry of this rank's rows and the ragged
    column gather over the resident tenant grids.  Query rows shard across
    the mesh; the grid stack is replicated.  ``guarded`` is recorded only:
    the engine's guard (finite outputs) runs on the host after the tick,
    so it adds nothing to the device's work, where the reference fuses a
    validity mask into its lowered body."""
    from repro_torch.serving.graph import tick_predict

    params = _setup(setup_name)
    rank_mesh = _rank_mesh(mesh, multi_pod, rank)
    chips = mesh_chip_count(rank_mesh)
    plan = params.nfft_plan(d)
    m_pack = slots * chunk
    m_pack += (-m_pack) % chips  # pad rows so the pack shards evenly
    rows = m_pack // chips
    rec = {"arch": f"graph-serve-{setup_name}-d{d}",
           "shape": f"slots{slots}x{chunk}", "mesh": _mesh_name(rank_mesh),
           "chips": chips, "kind": "graph_serve_tick", "rank": rank,
           "rows": m_pack, "channels": slots, "guarded": guarded,
           "note": GRAPH_SERVE_NOTE}
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            out = trace_call(
                rank_mesh, tick_predict, plan,
                _meta((rows, d), torch.float32),
                _meta((plan.grid_size,) * d + (slots,), torch.float32),
                _meta((rows,), torch.int32))
        rec.update(status="ok", trace_s=round(time.perf_counter() - t0, 2),
                   memory=out["memory"], stats=out["stats"].to_json(),
                   grid=plan.grid_size, bandwidth=plan.n_bandwidth, d=d)
    except Exception as e:  # noqa: BLE001
        _error(rec, e)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="arch name, comma list, or 'all'")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh whose step is traced")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--graph", action="store_true",
                    help="also trace the paper-technique fastsum cells")
    ap.add_argument("--graph-n", type=int, default=2 ** 27)
    ap.add_argument("--graph-bank", type=int, default=8,
                    help="bank size S for the graph-fastsum-bank cells "
                         "(<2 disables them)")
    ap.add_argument("--graph-serve", action="store_true",
                    help="also trace the serving-tier tick body (packed "
                         "target geometry + ragged gather)")
    ap.add_argument("--serve-slots", type=int, default=64)
    ap.add_argument("--serve-chunk", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    if args.arch == "all":
        archs = [c.name for c in ALL_ARCHS + EXTRA_ARCHS]
    else:
        archs = args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    t_start = time.perf_counter()
    for name in archs:
        cfg = get_config(name)
        shape_names = ([s.name for s in cfg.shapes] if args.shapes == "all"
                       else args.shapes.split(","))
        for sn in shape_names:
            if sn not in {s.name for s in cfg.shapes}:
                continue
            for mp in meshes:
                rec = run_cell(name, sn, mp,
                               microbatch_override=args.microbatches,
                               compress_grads=args.compress_grads,
                               rank=args.rank)
                results.append(rec)
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f" trace={rec['trace_s']}s"
                             f" dominant={r['dominant']}"
                             f" compute={r['compute_s']:.3e}s"
                             f" memory={r['memory_s']:.3e}s"
                             f" coll={r['collective_s']:.3e}s")
                    if rec["whole_parts"]:
                        extra += (" computed whole on every rank: "
                                  + "; ".join(rec["whole_parts"]))
                elif rec["status"] == "error":
                    extra = " " + rec["error"][:160]
                print(f"[{rec['status']:7s}] {name} x {sn} @ {rec['mesh']}"
                      f"{extra}", flush=True)

    if args.graph:
        for mp in meshes:
            for setup in ("setup1", "setup2", "setup3"):
                cells = [("psum", 1), ("pencil", 1)]
                if args.graph_bank >= 2:
                    cells += [("psum", args.graph_bank),
                              ("pencil", args.graph_bank)]
                for mode, bank in cells:
                    rec = run_graph_cell(args.graph_n, 3, mp,
                                         setup_name=setup,
                                         spectral_mode=mode,
                                         bank_size=bank, rank=args.rank)
                    results.append(rec)
                    extra = ""
                    if rec["status"] == "ok":
                        pay = rec["stats"]["collective_payload_bytes"]
                        extra = f" coll_payload={pay:.3e}B"
                    print(f"[{rec['status']:7s}] {rec['arch']} x "
                          f"{rec['shape']} @ {rec['mesh']}{extra}",
                          flush=True)

    if args.graph_serve:
        for mp in meshes:
            for setup in ("setup1", "setup2", "setup3"):
                rec = run_graph_serve_cell(args.serve_slots,
                                           args.serve_chunk, 3, mp,
                                           setup_name=setup, rank=args.rank)
                results.append(rec)
                extra = ""
                if rec["status"] == "ok":
                    extra = (f" trace={rec['trace_s']}s"
                             f" rows={rec['rows']}")
                print(f"[{rec['status']:7s}] {rec['arch']} x "
                      f"{rec['shape']} @ {rec['mesh']}{extra}", flush=True)

    suffix = f"_{args.tag}" if args.tag else ""
    path = os.path.join(args.out, f"dryrun{suffix}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_err} errors -> {path} "
          f"({time.perf_counter() - t_start:.1f} s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
