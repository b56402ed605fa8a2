"""Fault injection of the PyTorch port (``repro_torch.runtime.faultinject``)
against the JAX package's.

Seeded schedules and masks are numpy's in both packages, so they are held
equal exactly; the kill points fire where the JAX package's fire; the
solver-side injectors quarantine the same columns and bank members through
the port's guarded solvers as tests/test_chaos.py asserts for the JAX
package (siblings within 1e-7 of ``numpy.linalg.solve``).  The engine-side
injectors (``TickChaos``, grid poisoning, plan corruption) run through
both engines in tests/test_torch_serving_graph.py.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import faultinject as jfi
from repro_torch.core import solvers as tsol
from repro_torch.runtime import faultinject as tfi
from repro_torch.training.fault_tolerance import InjectedFault

# the module: ``repro_torch.core`` re-exports the function ``lanczos``
# under its name, as ``repro.core`` does
tlan = importlib.import_module("repro_torch.core.lanczos")

pytestmark = pytest.mark.chaos


@pytest.mark.parametrize("seed,kw", [
    (5, dict(ticks=200, p_drop=0.1, p_slow=0.1)),
    (0, dict(ticks=500)),
    (7, dict(ticks=300, models=("a", "b", "c"), p_poison=0.2,
             slow_s=0.01))])
def test_chaos_schedule_is_the_jax_packages(seed, kw):
    got, want = tfi.chaos_schedule(seed, **kw), jfi.chaos_schedule(seed, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.drop_ticks  # some drops scheduled
    assert got == tfi.chaos_schedule(seed, **kw)  # deterministic


def test_nan_poison_grid_mask_is_the_jax_packages():
    grid = np.arange(2 * 9 * 9, dtype=np.float64).reshape(2, 9, 9) + 1.0
    got = tfi.nan_poison_grid(torch.as_tensor(grid), frac=0.3, seed=4)
    want = np.asarray(jfi.nan_poison_grid(jnp.asarray(grid), frac=0.3,
                                          seed=4))
    np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(want))
    assert 0 < int(torch.isnan(got).sum()) < grid.size
    np.testing.assert_array_equal(got.numpy()[~np.isnan(want)],
                                  grid[~np.isnan(want)])


@pytest.mark.parametrize("hook", ["point", "schedule"])
def test_kill_points_fire_where_the_jax_packages_fire(hook):
    def fires(make):
        h, out = make(), []
        for i in range(0, 40, 5):
            try:
                h(i)
            except jfi.Preemption:
                out.append(("jax", i))
            except tfi.Preemption:
                out.append(("torch", i))
        return [i for _, i in out]

    if hook == "point":
        got = fires(lambda: tfi.KillPoint(at_iteration=7, kills=2))
        want = fires(lambda: jfi.KillPoint(at_iteration=7, kills=2))
    else:
        got = fires(lambda: tfi.KillSchedule(at_iterations=(3, 8, 30)))
        want = fires(lambda: jfi.KillSchedule(at_iterations=(3, 8, 30)))
    assert got == want and got
    assert issubclass(tfi.Preemption, InjectedFault)


def _spd(n, seed=0):
    m = np.random.default_rng(seed).normal(size=(n, n))
    return m @ m.T + n * np.eye(n)


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_poisoned_column_quarantined_not_contagious(solver):
    a = _spd(80, seed=1)
    ta = torch.as_tensor(a)
    mv = tfi.poison_columns(lambda x: ta @ x, [1])
    b = np.random.default_rng(2).normal(size=(80, 3))
    sol = getattr(tsol, solver)(mv, torch.as_tensor(b), tol=1e-10,
                                maxiter=2000)
    h = sol.health
    assert h.nonfinite.tolist() == [False, True, False]
    assert not bool(h.rhs_nonfinite.any())
    assert int(h.breakdown_iter[1]) == 0  # caught at once
    for c in (0, 2):
        assert bool(sol.converged[c])
        np.testing.assert_allclose(sol.x[:, c].numpy(),
                                   np.linalg.solve(a, b[:, c]),
                                   rtol=1e-7, atol=1e-7)
    assert not bool(sol.converged[1])
    assert bool(torch.isfinite(sol.x).all())


def test_poisoned_bank_member_isolated_in_bank_solve():
    mats = [_spd(50, seed=s) for s in (3, 4, 5)]
    stack = torch.as_tensor(np.stack(mats))
    mv = tfi.poison_bank_member(
        lambda xb: torch.einsum("sij,sjc->sic", stack, xb), [1])
    b = np.random.default_rng(6).normal(size=(3, 50, 2))
    sol = tsol.cg_bank(mv, torch.as_tensor(b), tol=1e-10, maxiter=2000)
    h = sol.health
    assert tuple(h.nonfinite.shape) == (3, 2)
    assert bool(h.nonfinite[1].all()) and not bool(h.nonfinite[[0, 2]].any())
    for s in (0, 2):
        for c in range(2):
            np.testing.assert_allclose(sol.x[s, :, c].numpy(),
                                       np.linalg.solve(mats[s], b[s, :, c]),
                                       rtol=1e-7, atol=1e-7)
    assert bool(torch.isfinite(sol.x).all())


def test_eigsh_poisoned_operator_flagged_not_trusted():
    res = tlan.eigsh(lambda x: torch.full_like(x, float("nan")), n=40, k=3,
                     num_iters=20, device="cpu")
    assert bool(res.health.nonfinite)
    assert int(res.health.breakdown_iter) == 0
    assert bool(torch.isinf(res.residual_bounds).all())
    assert bool(torch.isfinite(res.eigenvalues).all())


def test_slow_matvec_counts_and_delays():
    slow = tfi.SlowMatvec(lambda x: 2.0 * x, delay_s=0.0)
    x = torch.ones(3)
    assert torch.equal(slow(x), 2.0 * x) and slow.calls == 1
    slow.delay_s = 0.01
    slow(x)
    assert slow.calls == 2


def test_grid_hook_is_the_fault_seam():
    """``fused_pipeline(grid_hook=...)`` (tests/test_chaos.py's case on the
    port): the hook sees the spread grid (M,)*d + (C,); the identity hook
    changes nothing, bit for bit; a poisoning hook propagates NaN to every
    output; a hooked call is forward-only."""
    from repro_torch.core import fastsum_exec
    from repro_torch.core.fastsum import FastsumParams, make_fastsum
    from repro_torch.core.kernels import make_kernel

    rng = np.random.default_rng(8)
    pts = torch.as_tensor(rng.normal(size=(100, 2)))
    fs = make_fastsum(make_kernel("gaussian", sigma=3.5), pts,
                      FastsumParams(n_bandwidth=16, m=4), device="cpu")
    mult = fastsum_exec.fused_spectral_multiplier(fs.plan, fs.b_hat)
    x = torch.as_tensor(rng.normal(size=(100,)))
    args = (fs.plan, mult, fs.src_window, fs.src_window)
    base = fastsum_exec.fused_pipeline(*args, x)
    shapes = []
    same = fastsum_exec.fused_pipeline(
        *args, x, grid_hook=lambda g: shapes.append(tuple(g.shape)) or g)
    assert shapes == [(fs.plan.grid_size,) * 2 + (1,)]
    assert torch.equal(base, same)
    bad = fastsum_exec.fused_pipeline(
        *args, x, grid_hook=lambda g: torch.full_like(g, float("nan")))
    assert not bool(torch.isfinite(bad).any())
    xg = x.clone().requires_grad_(True)
    assert fastsum_exec.fused_pipeline(*args, xg).requires_grad
    assert not fastsum_exec.fused_pipeline(*args, xg,
                                           grid_hook=lambda g: g).requires_grad
