"""CG / MINRES of the PyTorch port against the JAX package, on the CPU.

Both packages solve the same numpy systems.  Iterates are compared to the
solve's own tolerance (|x_port - x_jax| <= 10 * tol * max(||b_c||, 1) /
lambda_min per column, the error a residual of that size allows) and
iteration counts within +-2 (sums run in another order, so a column may
cross its tolerance one step earlier or later); the health flags must be
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as js
from repro_torch.core import solvers as ts


def _spd(n, seed=0):
    m = np.random.default_rng(seed).normal(size=(n, n))
    return m @ m.T + n * np.eye(n)


def _indefinite(n, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    vals = np.concatenate([-np.linspace(1.0, 5.0, n // 2),
                           np.linspace(0.5, 4.0, n - n // 2)])
    return q @ np.diag(vals) @ q.T


def _solve_both(solver, a, b, **kw):
    jsolver = getattr(js, solver)
    tsolver = getattr(ts, solver)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if solver == "cg":
        jkw["implicit_diff"] = False
    if "preconditioner" in kw:
        dj, dt = jnp.diag(ja), torch.diag(ta)
        jkw["preconditioner"] = lambda r: r / (dj if r.ndim == 1
                                               else dj[:, None])
        tkw["preconditioner"] = lambda r: r / (dt if r.ndim == 1
                                               else dt[:, None])
    want = jsolver(lambda x: ja @ x, jnp.asarray(b), **jkw)
    got = tsolver(lambda x: ta @ x, torch.as_tensor(b), **tkw)
    return want, got


def _assert_same(want, got, a, b, tol):
    lam_min = np.abs(np.linalg.eigvalsh(a)).min()
    bn = np.linalg.norm(b.reshape(b.shape[0], -1), axis=0)
    allowed = 10 * tol * np.maximum(bn, 1.0) / lam_min
    wx = np.asarray(want.x).reshape(b.shape[0], -1)
    gx = got.x.numpy().reshape(b.shape[0], -1)
    ok = ~np.asarray(want.health.any_fault).reshape(-1)
    err = np.abs(wx - gx).max(axis=0)
    assert np.all(err[ok] <= allowed[ok]), (err, allowed)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert np.all(np.abs(got.num_iters.numpy().astype(int)
                         - np.asarray(want.num_iters)) <= 2)
    for name in ("rhs_nonfinite", "nonfinite", "stagnated"):
        np.testing.assert_array_equal(getattr(got.health, name).numpy(),
                                      np.asarray(getattr(want.health, name)))
    assert got.health.breakdown_iter.dtype == torch.int32


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_spd_matches_jax(solver, batched):
    a = _spd(120, seed=1)
    rng = np.random.default_rng(2)
    b = rng.normal(size=(120, 3) if batched else 120)
    want, got = _solve_both(solver, a, b, tol=1e-10, maxiter=500)
    assert bool(got.converged.all())
    _assert_same(want, got, a, b, 1e-10)
    # the true residual at exit, up to the round-off of forming b - A x
    res = np.linalg.norm((b - a @ got.x.numpy()).reshape(120, -1), axis=0)
    np.testing.assert_allclose(got.residual_norm.numpy().reshape(-1), res,
                               rtol=1e-6, atol=1e-14 * np.abs(b).max() * 120)


def test_minres_indefinite_matches_jax():
    a = _indefinite(100, seed=3)
    b = np.random.default_rng(4).normal(size=(100, 2))
    want, got = _solve_both("minres", a, b, tol=1e-10, maxiter=1000)
    assert bool(got.converged.all())
    _assert_same(want, got, a, b, 1e-10)


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_columns_at_wildly_different_scales(solver):
    """Each column meets its own tolerance tol * max(||b_c||, 1), and the
    tiny column freezes earlier than the huge one, on both sides."""
    a = _spd(120, seed=7)
    b = np.random.default_rng(8).normal(size=(120, 3)) \
        * np.array([1e-6, 1.0, 1e6])
    want, got = _solve_both(solver, a, b, tol=1e-10, maxiter=2000)
    _assert_same(want, got, a, b, 1e-10)
    assert bool(got.converged.all())
    assert int(got.num_iters[0]) < int(got.num_iters[2])


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_nonfinite_rhs_column_is_quarantined(solver):
    a = _spd(60, seed=9)
    b = np.random.default_rng(10).normal(size=(60, 3))
    b[5, 1] = np.nan
    want, got = _solve_both(solver, a, b, tol=1e-10, maxiter=500)
    _assert_same(want, got, a, b, 1e-10)
    assert got.health.rhs_nonfinite.tolist() == [False, True, False]
    assert int(got.num_iters[1]) == 0 and float(got.x[:, 1].abs().max()) == 0
    assert got.residual_norm[1] == float("inf")
    assert bool(got.converged[0]) and bool(got.converged[2])


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_stagnation_freezes_the_column(solver):
    """cond ~1e12 and a tolerance below attainable accuracy: the residual
    stops improving and a short stall window freezes the column."""
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(80, 80)))
    a = q @ np.diag(np.logspace(-12, 0, 80)) @ q.T
    b = rng.normal(size=(80, 2))
    want, got = _solve_both(solver, a, b, tol=1e-15, maxiter=3000,
                            stall_window=20)
    for name in ("rhs_nonfinite", "nonfinite", "stagnated"):
        np.testing.assert_array_equal(getattr(got.health, name).numpy(),
                                      np.asarray(getattr(want.health, name)))
    assert bool(got.health.stagnated.all())
    assert not bool(got.converged.any())
    assert int(got.num_iters.max()) < 3000


def test_cg_x0_and_preconditioner_match_jax():
    a = _spd(100, seed=11)
    rng = np.random.default_rng(12)
    b = rng.normal(size=(100, 2))
    x0 = rng.normal(size=(100, 2))
    want, got = _solve_both("cg", a, b, tol=1e-11, maxiter=500, x0=x0,
                            preconditioner=True)
    assert bool(got.converged.all())
    _assert_same(want, got, a, b, 1e-11)


def test_nonfinite_iterate_reverts_and_freezes():
    """An operator that poisons column 1 from the 3rd application on: that
    column keeps its last finite iterate, its sibling converges as if
    alone (up to the round-off of a two-column against a one-column
    product), and the breakdown iteration is recorded."""
    a = _spd(50, seed=13)
    b = np.random.default_rng(14).normal(size=(50, 2))
    ta = torch.as_tensor(a)
    calls = []

    def poisoned(x):
        calls.append(1)
        y = ta @ x
        if len(calls) >= 3:
            y[:, 1] = float("nan")
        return y

    got = ts.cg(poisoned, torch.as_tensor(b), tol=1e-10, maxiter=200)
    alone = ts.cg(lambda x: ta @ x, torch.as_tensor(b[:, :1]), tol=1e-10,
                  maxiter=200)
    assert got.health.nonfinite.tolist() == [False, True]
    assert int(got.health.breakdown_iter[1]) == 2
    assert bool(torch.isfinite(got.x).all())
    assert int(got.num_iters[0]) == int(alone.num_iters[0])
    torch.testing.assert_close(got.x[:, :1], alone.x, rtol=1e-12, atol=0)
