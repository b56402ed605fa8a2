"""Rank-side cases of the port's distribution tests.

Module-level functions that ``repro_torch.launch.ranks.RankPool`` runs on
every rank, SPMD, as ``fn(ctx, *args)`` (tests/test_torch_dist.py,
tests/test_torch_pencil_fft.py and the ``gpu`` tests of
tests/test_torch_gpu.py).  Each rank builds the same operator from the
same numpy points; meshes and operators are kept in ``ctx.cache`` for the
rank's life.  Results go back as numpy arrays.  No JAX here: the card's
tests import this module too.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fastsum as tfs
from repro_torch.core import kernels as tkern
from repro_torch.core.lanczos import eigsh as _eigsh
from repro_torch.data.synthetic import spiral
from repro_torch.dist import compression, fastsum_dist, pencil_fft
from repro_torch.launch.mesh import make_mesh

SIGMA = 3.5
BANK_SIGMAS = (2.0, 3.5, 5.0)


def points(d: int, n: int) -> np.ndarray:
    """The JAX distribution tests' points: the spiral (seed 3) at d = 3,
    uniform on [-3, 3]^2 (seed 0) at d = 2."""
    if d == 3:
        return spiral(n, seed=3)[0]
    return np.random.default_rng(0).uniform(-3, 3, (n, 2))


def rhs(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape)


def axis_names(shape) -> tuple:
    return ("data",) if len(shape) == 1 else ("data", "model")


def mesh(ctx, shape):
    key = ("mesh", tuple(shape))
    if key not in ctx.cache:
        ctx.cache[key] = make_mesh(shape, axis_names(shape))
    return ctx.cache[key]


def operator(ctx, d: int, setup: str, n: int):
    key = ("op", d, setup, n)
    if key not in ctx.cache:
        ctx.cache[key] = tfs.make_fastsum(
            tkern.make_kernel("gaussian", sigma=SIGMA), points(d, n),
            getattr(tfs, setup), device=ctx.device)
    return ctx.cache[key]


def bank(ctx, d: int, setup: str, n: int):
    key = ("bank", d, setup, n)
    if key not in ctx.cache:
        ctx.cache[key] = tfs.make_fastsum_bank(
            [tkern.make_kernel("gaussian", sigma=s) for s in BANK_SIGMAS],
            points(d, n), getattr(tfs, setup), device=ctx.device)
    return ctx.cache[key]


def _tensor(ctx, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a, device=ctx.device)


def matvec(ctx, d, setup, n, mode, shape, pencil_axes, x):
    """One distributed matvec of ``x`` (numpy) on every rank: y, this
    rank's collective traffic, the pencil spec that ran, and the
    single-device matvec of the same x on the rank's device."""
    op = operator(ctx, d, setup, n)
    m = mesh(ctx, shape)
    mv = fastsum_dist.distributed_matvec_fn(
        op, m, m.axis_names, spectral_mode=mode, pencil_axes=pencil_axes)
    x = _tensor(ctx, x)
    m.traffic.clear()
    y = mv(x)
    return {"y": y.cpu().numpy(), "traffic": dict(m.traffic),
            "spec": mv.spec, "single": op.matvec(x).cpu().numpy()}


def bank_matvec(ctx, d, setup, n, mode, shape, x):
    b = bank(ctx, d, setup, n)
    m = mesh(ctx, shape)
    mv = fastsum_dist.distributed_matvec_bank_fn(b, m, m.axis_names,
                                                 spectral_mode=mode)
    x = _tensor(ctx, x)
    return {"y": mv(x).cpu().numpy(), "single": b.matvec(x).cpu().numpy()}


def eigsh(ctx, d, setup, n, k, shape, mode):
    """eigsh of the normalized adjacency through the distributed matvec,
    from a start vector seeded alike on every rank; the degrees through the
    distributed matvec too, so every rank holds the same bits (a rank's
    own degrees come from an atomic spread on the card)."""
    op = operator(ctx, d, setup, n)
    m = mesh(ctx, shape)
    mv_w = fastsum_dist.distributed_matvec_fn(op, m, m.axis_names,
                                              spectral_mode=mode)
    deg = mv_w(torch.ones(n, dtype=torch.float64, device=ctx.device))
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp(deg,
                                            min=torch.finfo(deg.dtype).tiny))
    res = _eigsh(lambda v: inv_sqrt * mv_w(inv_sqrt * v), n, k,
                 device=ctx.device,
                 generator=torch.Generator(device=ctx.device).manual_seed(0))
    return res.eigenvalues.cpu().numpy()


def compress(ctx, g_all: np.ndarray, resid_all: np.ndarray):
    """compress_psum over every rank: rank r holds row r."""
    m = mesh(ctx, (ctx.world,))
    mean, resid = compression.compress_psum(
        _tensor(ctx, g_all[ctx.rank]), "data",
        _tensor(ctx, resid_all[ctx.rank]), m)
    return {"mean": mean.cpu().numpy(), "resid": resid.cpu().numpy()}


def pencil(ctx, d, grid, shape, pencil_axes, seed, channels):
    """The pencil transforms on every rank's own random grid: this rank's
    block of the accumulated spectrum (and its row/col group indices), the
    round trip's worst error on its pencil, the all-gathered inverse
    transform of the spectrum, and the multiplier sandwich's adjoint
    residual for an even (radial) multiplier."""
    m = mesh(ctx, shape)
    spec = pencil_fft.make_pencil_spec(m, m.axis_names, grid, d,
                                       pencil_axes=pencil_axes)
    g = _tensor(ctx, rhs((grid,) * d + (channels,), seed + ctx.rank))
    acc = pencil_fft.pencil_accumulate(g, spec, m)
    fwd = pencil_fft.pencil_rfftn(acc, spec, m)
    back = pencil_fft.pencil_irfftn(fwd, spec, m)
    # an even multiplier on the half-spectrum makes irfftn . mult . rfftn
    # symmetric: <y, S x> = <x, S y> for the accumulated grids x, y
    k = np.fft.fftfreq(grid, d=1.0 / grid)
    k2 = sum(np.meshgrid(*([k ** 2] * d), indexing="ij"))
    mult = _tensor(ctx, np.exp(-k2 / 7.0)[..., : grid // 2 + 1]
                   .astype(complex))
    slab = pencil_fft.multiplier_slab(mult, spec, m)
    y = _tensor(ctx, rhs((grid,) * d + (channels,), seed + 100 + ctx.rank))
    acc_y = pencil_fft.pencil_accumulate(y, spec, m)

    def sandwich(p):
        gh = pencil_fft.pencil_rfftn(p, spec, m)
        return pencil_fft.pencil_irfftn(gh * slab[..., None], spec, m)

    lhs = m.psum((acc_y * sandwich(acc)).sum().reshape(1), m.axis_names)
    rhs_ = m.psum((acc * sandwich(acc_y)).sum().reshape(1), m.axis_names)
    adj = float((lhs - rhs_).abs()) / max(float(lhs.abs()), 1.0)
    return {"spectrum": fwd.cpu().numpy(),
            "row": pencil_fft.group_index(m, spec.row_axes),
            "col": pencil_fft.group_index(m, spec.col_axes),
            "roundtrip": float((back - acc).abs().max()),
            "grid": pencil_fft.pencil_allgather(back, spec, m).cpu().numpy(),
            "adjoint": adj, "half": spec.half,
            "spec": (spec.row_axes, spec.col_axes, spec.extra_axes)}
