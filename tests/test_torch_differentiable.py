"""Differentiation in the PyTorch port against the JAX package and against
finite differences (CPU, float64).

The counterpart of tests/test_differentiable.py: the spread/gather adjoint
identity, the fused matvec's gradients in its values and in the kernel
parameter (against central differences and the dense oracle),
implicit-diff CG (primal parity, gradients, banks, quarantined solves),
the KRR validation loss and gradient model selection.  Its learn-sigma
NFFT-attention train step waits for the LM framework's training (ROADMAP
queue 1 item 13), and its jit-construction test becomes a check that
points which require grad plan the same operator.

Beyond the reference's own tests: the same numpy inputs through
``jax.grad`` of the JAX package and the port's autograd (sigma-bar and
x-bar of <w, W~x> to 1e-10 relative for single, bank and rectangular
operators; the KRR loss's (log sigma, log beta) gradients to 1e-8, which
two CG runs at tol 1e-12 agree to; the first iterates of krr_fit_grad's
loss path to 1e-6), a test that no window step is differentiated by
autograd (the plain window versions never see a tensor that requires
grad, and a backward costs one spread on the target geometry and one
gather on the source geometry), and the complex multiplier's cotangent
against a finite difference.  The KRR checks against finite differences
use a Richardson-extrapolated central difference (steps h and h/2, h =
1e-3): the plain one at h = 1e-5 misses the reference's 1e-5 limit by its
truncation error where the gradient is ~1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastsum as jfs
from repro.core import kernels as jkern
from repro.core import solvers as jsol
from repro.graph import krr as jkrr
from repro_torch.core import fastsum as tfs
from repro_torch.core import fastsum_exec as texec
from repro_torch.core import kernels as tkern
from repro_torch.core import solvers as tsol
from repro_torch.core.regularization import kernel_radial_derivatives
from repro_torch.graph import krr as tkrr
from repro_torch.kernels import nfft_window as twin


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's tensors are small, and under pytest-xdist's parallel
    workers torch's OpenMP threads oversubscribe the cores, so its many
    small parallel operations stall.  One thread here; the caller's count
    back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KERNELS = [
    ("gaussian", 3.5),
    ("laplacian_rbf", 2.0),
    ("multiquadric", 1.0),
    ("inverse_multiquadric", 1.0),
]
SMALL = dict(n_bandwidth=16, m=4)
# the multiquadric Gram matrix is conditionally negative definite: a large
# beta keeps K + beta I SPD (tests/test_differentiable.py)
KRR_CASES = [
    ("gaussian", 0.8, 1e-2),
    ("laplacian_rbf", 0.8, 1e-2),
    ("multiquadric", 0.8, 50.0),
    ("inverse_multiquadric", 0.8, 1e-2),
]
RICHARDSON_H = 1e-3


def _points(d, n, seed, scale=2.0):
    return np.random.default_rng(seed).normal(size=(n, d)) * scale


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _param(value):
    return torch.tensor(float(value), dtype=torch.float64, requires_grad=True)


def _richardson(f, x0, h=RICHARDSON_H):
    """Central difference at steps h and h/2, extrapolated: O(h^4)."""
    d1 = (f(x0 + h) - f(x0 - h)) / (2 * h)
    d2 = (f(x0 + h / 2) - f(x0 - h / 2)) / h
    return (4 * d2 - d1) / 3


# ------------------------------------------------------------ kernels
@pytest.mark.parametrize("kname,kparam", KERNELS)
def test_kernel_parameter_keeps_its_graph(kname, kparam):
    """A tensor parameter stays a tensor: K(0) and the radial derivatives
    are differentiable in it; a float parameter keeps K(0) a float."""
    assert isinstance(tkern.kernel_from_param(kname, kparam).at_zero(), float)
    p = _param(kparam)
    kern = tkern.kernel_from_param(kname, p)
    assert kern.params[tkern.KERNEL_PARAM_NAME[kname]] is p
    k0 = kern.at_zero()
    (g,) = torch.autograd.grad(k0 + kernel_radial_derivatives(
        kern.rescaled(0.3), 0.4, 3).sum(), p)

    def value(v):
        k = tkern.kernel_from_param(kname, v)
        return k.at_zero() + float(kernel_radial_derivatives(
            k.rescaled(0.3), 0.4, 3).sum())

    assert _rel(g, _richardson(value, kparam)) < 1e-8


# ------------------------------------------------------- adjoint identities
@pytest.mark.parametrize("kname,kparam", KERNELS)
@pytest.mark.parametrize("d", [1, 2, 3])
def test_spread_gather_adjoint(kname, kparam, d):
    """<spread(x), g> == <x, gather(g)>: the transpose the backward uses."""
    op = tfs.make_fastsum(tkern.kernel_from_param(kname, kparam),
                          _points(d, 90, d), tfs.FastsumParams(n_bandwidth=8,
                                                               m=2),
                          device="cpu")
    plan, geom = op.plan, op.src_window
    x = torch.as_tensor(_normal((90, 2), 10 + d))
    g = torch.as_tensor(_normal((plan.grid_size,) * d + (2,), 20 + d))
    lhs = float((texec.window_spread(plan, geom, x) * g).sum())
    rhs = float((x * texec.window_gather(plan, geom, g)).sum())
    assert _rel(lhs, rhs) < 1e-12, (lhs, rhs)


# ----------------------------------------------------- fused-matvec gradcheck
def test_fused_matvec_input_gradient_is_transpose():
    """grad_x <c, W~x> == W~^T c == W~c (symmetric operator)."""
    op = tfs.make_fastsum(tkern.make_kernel("gaussian", sigma=3.5),
                          _points(2, 200, 1), tfs.FastsumParams(**SMALL),
                          device="cpu")
    c = torch.as_tensor(_normal(200, 2))
    x = torch.as_tensor(_normal(200, 3)).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.dot(c, op.matvec_tilde(x)), x)
    ref = op.matvec_tilde(c)
    assert _rel_max(g, ref) < 1e-12


@pytest.mark.parametrize("kname,kparam", KERNELS)
@pytest.mark.parametrize("d", [1, 2])
def test_fused_matvec_param_gradcheck_vs_fd(kname, kparam, d):
    """d/dp <w, W~_p x> by autograd vs a central difference."""
    pts = _points(d, 150, 30 + d)
    x = torch.as_tensor(_normal(150, 4))
    w = torch.as_tensor(_normal(150, 5))
    op = tfs.make_fastsum(tkern.kernel_from_param(kname, kparam), pts,
                          tfs.FastsumParams(**SMALL), device="cpu")

    def loss(p):
        return torch.dot(w, op.with_kernel(
            tkern.kernel_from_param(kname, p)).matvec_tilde(x))

    p = _param(kparam)
    (g,) = torch.autograd.grad(loss(p), p)
    eps = 1e-5 * kparam
    fd = (float(loss(kparam + eps)) - float(loss(kparam - eps))) / (2 * eps)
    assert _rel(g, fd) < 1e-6, (kname, d, float(g), fd)


def test_fused_matvec_param_gradcheck_vs_dense_oracle():
    """The sigma-gradient of the fused W matvec (SETUP_2) tracks central
    differences of the exact direct sum."""
    pts = torch.as_tensor(_points(2, 150, 40))
    x = torch.as_tensor(_normal(150, 6))
    w = torch.as_tensor(_normal(150, 7))
    op = tfs.make_fastsum(tkern.make_kernel("gaussian", sigma=3.5), pts,
                          tfs.SETUP_2, device="cpu")
    p = _param(3.5)
    (g,) = torch.autograd.grad(torch.dot(w, op.with_kernel(
        tkern.make_kernel("gaussian", sigma=p)).matvec(x)), p)

    def dense(s):
        return float(torch.dot(w, tfs.direct_matvec_tiled(
            tkern.make_kernel("gaussian", sigma=s), pts, x)))

    eps = 1e-4
    fd = (dense(3.5 + eps) - dense(3.5 - eps)) / (2 * eps)
    assert _rel(g, fd) < 1e-4, (float(g), fd)


def test_operator_construction_from_points_that_require_grad():
    """Points that require grad plan the same operator (the node positions
    are plan-time data): the same rho and output, and no gradient."""
    kern = tkern.make_kernel("gaussian", sigma=3.5)
    pts = torch.as_tensor(_points(2, 160, 41, scale=5.0))
    x = torch.as_tensor(_normal(160, 8))
    params = tfs.FastsumParams(**SMALL)
    plain = tfs.make_fastsum(kern, pts, params, device="cpu")
    leaf = pts.clone().requires_grad_(True)
    op = tfs.make_fastsum(kern, leaf, params, device="cpu")
    assert op.rho == plain.rho
    out = op.matvec_tilde(x)
    assert not out.requires_grad
    torch.testing.assert_close(out, plain.matvec_tilde(x), rtol=0, atol=0)


def test_with_kernel_needs_the_planning_state():
    op = tfs.make_fastsum(tkern.make_kernel("gaussian", sigma=3.5),
                          _points(2, 50, 42), tfs.FastsumParams(**SMALL),
                          device="cpu")
    with pytest.raises(ValueError, match="planning state"):
        dataclasses.replace(op, rho=None).with_kernel(
            tkern.make_kernel("gaussian", sigma=2.0))


def test_multiplier_cotangent_convention():
    """torch's cotangent of the complex multiplier m is conj of JAX's: for
    the real loss, dL = Re <m-bar, dm>, checked against a central
    difference along a random complex direction."""
    op = tfs.make_fastsum(tkern.make_kernel("gaussian", sigma=3.5),
                          _points(2, 120, 43), tfs.FastsumParams(**SMALL),
                          device="cpu")
    x = torch.as_tensor(_normal((120, 2), 9))
    w = torch.as_tensor(_normal((120, 2), 10))
    m0 = op.multiplier_half.detach()

    def loss(m):
        return (w * texec.fused_pipeline(op.plan, m, op.src_window,
                                         op.src_window, x)).sum()

    m = m0.clone().requires_grad_(True)
    (m_bar,) = torch.autograd.grad(loss(m), m)
    dm = torch.complex(torch.as_tensor(_normal(m0.shape, 11)),
                       torch.as_tensor(_normal(m0.shape, 12))) * m0.abs().max()
    eps = 1e-3
    fd = (float(loss(m0 + eps * dm)) - float(loss(m0 - eps * dm))) / (2 * eps)
    assert _rel(torch.vdot(m_bar.flatten(), dm.flatten()).real, fd) < 1e-10


# ------------------------------------------- the backward is the transpose
def _grad_case(case):
    """(operator, loss(x), n_source, n_target) of one pipeline flavour."""
    pts = _points(2, 120, 44)
    params = tfs.FastsumParams(**SMALL)
    w = torch.as_tensor(_normal((4, 120, 2), 13))
    kern = tkern.make_kernel("gaussian", sigma=_param(2.0))
    if case == "single":
        op = tfs.make_fastsum(kern, pts, params, device="cpu")
        return lambda x: (w[0] * op.matvec(x)).sum(), 120, 120
    if case == "rectangular":
        op = tfs.make_fastsum(kern, pts, params,
                              target_points=_points(2, 40, 45), device="cpu")
        return lambda x: (w[0, :40] * op.matvec_tilde(x)).sum(), 120, 40
    bank = tfs.make_fastsum_bank(
        [kern, tkern.make_kernel("laplacian_rbf", sigma=_param(1.5))], pts,
        params, device="cpu")
    if case == "bank_broadcast":
        return lambda x: (w[:2] * bank.matvec(x)).sum(), 120, 120
    return lambda x: (w[:2] * bank.matvec_tilde(
        x[None].expand(2, 120, 2))).sum(), 120, 120


@pytest.mark.parametrize("case", ["single", "rectangular", "bank_broadcast",
                                  "bank_lockstep"])
def test_backward_is_the_transpose_pipeline(case, monkeypatch):
    """No window step is differentiated by autograd: the plain window
    versions never get a tensor that requires grad, and the backward
    launches exactly one spread, on the target geometry, and one gather,
    on the source geometry."""
    calls = []
    plain_spread, plain_gather = (twin.window_spread_plain,
                                  twin.window_gather_plain)

    def spread(x, base, weights, **kw):
        assert not any(t.requires_grad for t in (x, base, weights))
        calls.append(("spread", base.shape[0]))
        return plain_spread(x, base, weights, **kw)

    def gather(grid, base, weights):
        assert not any(t.requires_grad for t in (grid, base, weights))
        calls.append(("gather", base.shape[0]))
        return plain_gather(grid, base, weights)

    monkeypatch.setattr(twin, "window_spread_plain", spread)
    monkeypatch.setattr(twin, "window_gather_plain", gather)
    loss, n_src, n_tgt = _grad_case(case)
    x = torch.as_tensor(_normal((120, 2), 14)).requires_grad_(True)
    out = loss(x)
    assert calls == [("spread", n_src), ("gather", n_tgt)]
    calls.clear()
    out.backward()
    assert sorted(calls) == [("gather", n_src), ("spread", n_tgt)]
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


# ------------------------------------------------ parity with the JAX package
def _jax_and_torch_ops(kname, kparam, d, rect=False):
    pts = _points(d, 130, 50 + d)
    tgt = _points(d, 50, 60 + d) if rect else None
    jop = jfs.make_fastsum(jkern.kernel_from_param(kname, kparam),
                           jnp.asarray(pts), jfs.FastsumParams(**SMALL),
                           target_points=None if tgt is None
                           else jnp.asarray(tgt))
    top = tfs.make_fastsum(tkern.kernel_from_param(kname, kparam), pts,
                           tfs.FastsumParams(**SMALL), target_points=tgt,
                           device="cpu")
    return jop, top, 130 if tgt is None else 50


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rectangular"])
@pytest.mark.parametrize("kname,kparam", KERNELS)
def test_fused_matvec_grads_match_jax(kname, kparam, rect):
    """sigma-bar (or c-bar) and x-bar of <w, W~x> (W x when square)."""
    jop, top, n_out = _jax_and_torch_ops(kname, kparam, 2, rect)
    x, w = _normal(130, 15), _normal(n_out, 16)

    def jloss(p, v):
        o = jop.with_kernel(jkern.kernel_from_param(kname, p))
        return jnp.vdot(jnp.asarray(w), o.matvec_tilde(v) if rect
                        else o.matvec(v))

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(kparam),
                                                 jnp.asarray(x))
    p = _param(kparam)
    tx = torch.as_tensor(x).requires_grad_(True)
    o = top.with_kernel(tkern.kernel_from_param(kname, p))
    out = o.matvec_tilde(tx) if rect else o.matvec(tx)
    tg_p, tg_x = torch.autograd.grad(torch.dot(torch.as_tensor(w), out),
                                     (p, tx))
    assert _rel(tg_p, jg_p) < 1e-10, (float(tg_p), float(jg_p))
    assert _rel_max(tg_x, jg_x) < 1e-10


@pytest.mark.parametrize("flavour", ["broadcast", "lockstep", "columns",
                                     "matvec"])
def test_bank_grads_match_jax(flavour):
    """Each member's parameter gradient and x-bar through a bank matvec."""
    members = KERNELS[:3]
    pts = _points(2, 110, 70)
    s = len(members)
    x = _normal((s, 110, 2) if flavour in ("lockstep", "columns")
                else (110, 2), 17)
    w = _normal((s, 110, 2), 18)

    def apply(bank, v, move):
        if flavour == "columns":
            flat = move(v, 0, 1).reshape(110, s * 2)
            out = bank.matvec_tilde_columns(flat)
            return move(out.reshape(110, s, 2), 1, 0)
        return bank.matvec(v) if flavour == "matvec" else \
            bank.matvec_tilde(v)

    def jloss(ps, v):
        bank = jfs.make_fastsum_bank(
            [jkern.kernel_from_param(k, p) for (k, _), p in zip(members, ps)],
            jnp.asarray(pts), jfs.FastsumParams(**SMALL))
        return jnp.vdot(jnp.asarray(w), apply(bank, v, jnp.moveaxis))

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        [jnp.asarray(p) for _, p in members], jnp.asarray(x))
    ps = [_param(p) for _, p in members]
    tx = torch.as_tensor(x).requires_grad_(True)
    bank = tfs.make_fastsum_bank(
        [tkern.kernel_from_param(k, p) for (k, _), p in zip(members, ps)],
        pts, tfs.FastsumParams(**SMALL), device="cpu")
    out = apply(bank, tx, torch.movedim)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(), ps + [tx])
    for tg, jg in zip(grads[:-1], jg_p):
        assert _rel(tg, jg) < 1e-10, (float(tg), float(jg))
    assert _rel_max(grads[-1], jg_x) < 1e-10


# ------------------------------------------------------------ implicit-diff CG
def _spd_matvec(theta, scale):
    def mv(v):  # scale*I + 0.01*theta*C^T C with C = cumsum: SPD for theta>0
        t = torch.cumsum(v, dim=0)
        return scale * v + 0.01 * theta * torch.flip(
            torch.cumsum(torch.flip(t, (0,)), dim=0), (0,))
    return mv


def test_cg_implicit_diff_primal_parity():
    b = torch.as_tensor(_normal(40, 19))
    theta = _param(1.3)
    x_imp = tsol.cg(_spd_matvec(theta, 4.0), b, tol=1e-12,
                    implicit_diff=True).x
    assert x_imp.requires_grad
    with torch.no_grad():
        x_pln = tsol.cg(_spd_matvec(theta, 4.0), b, tol=1e-12,
                        implicit_diff=False).x
    torch.testing.assert_close(x_imp.detach(), x_pln, rtol=0, atol=0)


def test_cg_implicit_diff_grads_vs_fd():
    """theta- and b-gradients through the solve match central differences,
    and match jax.grad of the JAX package's implicit-diff CG."""
    b0, w = _normal(40, 20), torch.as_tensor(_normal(40, 21))

    def loss(theta, rhs):
        return torch.dot(w, tsol.cg(_spd_matvec(theta, 4.0), rhs,
                                    tol=1e-13).x)

    theta = _param(1.3)
    b = torch.as_tensor(b0).requires_grad_(True)
    g_th, g_b = torch.autograd.grad(loss(theta, b), (theta, b))
    eps = 1e-6
    with torch.no_grad():
        fd_th = (float(loss(1.3 + eps, torch.as_tensor(b0)))
                 - float(loss(1.3 - eps, torch.as_tensor(b0)))) / (2 * eps)
        e7 = np.zeros(40)
        e7[7] = eps
        fd_b = (float(loss(1.3, torch.as_tensor(b0 + e7)))
                - float(loss(1.3, torch.as_tensor(b0 - e7)))) / (2 * eps)
    assert _rel(g_th, fd_th) < 1e-6
    assert _rel(g_b[7], fd_b) < 1e-6

    def jmv(theta):
        def mv(v):
            t = jnp.cumsum(v, axis=0)
            return 4.0 * v + 0.01 * theta * jnp.cumsum(t[::-1], axis=0)[::-1]
        return mv

    jg_th, jg_b = jax.grad(lambda th, rhs: jnp.vdot(
        jnp.asarray(w.numpy()), jsol.cg(jmv(th), rhs, tol=1e-13).x),
        argnums=(0, 1))(jnp.asarray(1.3), jnp.asarray(b0))
    assert _rel(g_th, jg_th) < 1e-10
    assert _rel_max(g_b, jg_b) < 1e-10


def test_cg_bank_implicit_diff_grads_vs_fd():
    bs = torch.as_tensor(_normal((3, 30), 22))
    w = torch.as_tensor(_normal((3, 30), 23))

    def loss(theta):
        mv = _spd_matvec(theta, 4.0)

        def bank_mv(v):  # (S, n, C) -> (S, n, C), member s on v[s]
            return torch.stack([mv(vs) for vs in v])

        return (w * tsol.cg_bank(bank_mv, bs, tol=1e-13).x).sum()

    theta = _param(0.9)
    (g,) = torch.autograd.grad(loss(theta), theta)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(0.9 + eps)) - float(loss(0.9 - eps))) / (2 * eps)
    assert _rel(g, fd) < 1e-6, (float(g), fd)


def test_cg_quarantined_solve_emits_zero_cotangents():
    """A faulted (NaN-poisoned) solve yields finite, exactly zero,
    gradients."""
    b_bad = torch.as_tensor(_normal(20, 24))
    b_bad[3] = torch.nan
    theta = _param(1.1)
    sol = tsol.cg(_spd_matvec(theta, 4.0), b_bad, tol=1e-10)
    assert bool(sol.health.rhs_nonfinite)
    loss = (torch.where(torch.isfinite(sol.x), sol.x, 0.0) ** 2).sum()
    (g,) = torch.autograd.grad(loss, theta, allow_unused=True)
    g = torch.zeros(()) if g is None else g
    assert bool(torch.isfinite(g)) and float(g) == 0.0


def test_cg_faulted_column_gets_zero_cotangent():
    """In a batched solve the quarantined column's cotangent is zero and
    its healthy sibling's matches the single-column solve."""
    b = torch.as_tensor(_normal((20, 2), 25))
    b[4, 1] = torch.nan
    rhs = b.clone().requires_grad_(True)
    theta = _param(1.1)
    sol = tsol.cg(_spd_matvec(theta, 4.0), rhs, tol=1e-12)
    x = torch.where(torch.isfinite(sol.x), sol.x, 0.0)
    g_b, g_th = torch.autograd.grad(x.sum(), (rhs, theta))
    assert float(g_b[:, 1].abs().max()) == 0.0
    one = b[:, 0].clone().requires_grad_(True)
    theta1 = _param(1.1)
    g1_b, g1_th = torch.autograd.grad(tsol.cg(_spd_matvec(theta1, 4.0), one,
                                              tol=1e-12).x.sum(),
                                      (one, theta1))
    assert _rel_max(g_b[:, 0], g1_b) < 1e-12
    assert _rel(g_th, g1_th) < 1e-12


# --------------------------------------------------------------- KRR gradients
def _krr_problem(d, n_train=120, n_val=60, seed=7):
    rng = np.random.default_rng(seed)
    xtr = rng.uniform(-2, 2, (n_train, d))
    xva = rng.uniform(-2, 2, (n_val, d))

    def fun(x):
        return np.sin(x[:, 0]) + (np.cos(2 * x[:, 1]) if d > 1 else 0.0)

    return xtr, fun(xtr), xva, fun(xva)


def _krr_ops(kname, sigma, d):
    xtr, ftr, xva, fva = _krr_problem(d)
    params = tfs.FastsumParams(**SMALL)
    kern = tkern.kernel_from_param(kname, sigma)
    return (tfs.make_fastsum(kern, xtr, params, device="cpu"),
            tfs.make_fastsum(kern, xtr, params, target_points=xva,
                             device="cpu"), ftr, fva)


def _krr_grads(kname, gram, pred, ftr, fva, ls, lb):
    a, b = _param(ls), _param(lb)
    loss = tkrr.krr_validation_loss(kname, gram, pred, ftr, fva, a, b,
                                    tol=1e-12, maxiter=4000)
    return torch.autograd.grad(loss, (a, b))


@pytest.mark.parametrize("kname,sigma,beta", KRR_CASES)
@pytest.mark.parametrize("d", [1, 2])
def test_krr_validation_loss_gradcheck(kname, sigma, beta, d):
    """grad w.r.t. (log sigma, log beta) vs Richardson central differences."""
    gram, pred, ftr, fva = _krr_ops(kname, sigma, d)
    ls0, lb0 = np.log(sigma), np.log(beta)
    g_ls, g_lb = _krr_grads(kname, gram, pred, ftr, fva, ls0, lb0)

    def loss(ls, lb):
        with torch.no_grad():
            return float(tkrr.krr_validation_loss(
                kname, gram, pred, ftr, fva, ls, lb, tol=1e-12,
                maxiter=4000))

    fd_ls = _richardson(lambda v: loss(v, lb0), ls0)
    fd_lb = _richardson(lambda v: loss(ls0, v), lb0)
    for g, fd in ((g_ls, fd_ls), (g_lb, fd_lb)):
        assert _rel(g, fd) < 1e-5, (kname, d, float(g), fd)


@pytest.mark.parametrize("kname,sigma,beta", KRR_CASES)
@pytest.mark.parametrize("d", [1, 2])
def test_krr_validation_loss_grads_match_jax(kname, sigma, beta, d):
    """(log sigma, log beta) gradients against jax.grad of the reference."""
    xtr, ftr, xva, fva = _krr_problem(d)
    params = jfs.FastsumParams(**SMALL)
    kern = jkern.kernel_from_param(kname, sigma)
    jgram = jfs.make_fastsum(kern, jnp.asarray(xtr), params)
    jpred = jfs.make_fastsum(kern, jnp.asarray(xtr), params,
                             target_points=jnp.asarray(xva))
    jg = jax.grad(lambda a, b: jkrr.krr_validation_loss(
        kname, jgram, jpred, jnp.asarray(ftr), jnp.asarray(fva), a, b,
        tol=1e-12, maxiter=4000), argnums=(0, 1))(
            jnp.asarray(np.log(sigma)), jnp.asarray(np.log(beta)))
    tg = _krr_grads(kname, *_krr_ops(kname, sigma, d), np.log(sigma),
                    np.log(beta))
    for t, j in zip(tg, jg):
        assert _rel(t, j) < 1e-8, (kname, d, float(t), float(j))


def test_krr_fit_grad_loss_path_matches_jax():
    """The first iterates of Adam on the validation loss, both packages."""
    xtr, ftr, xva, fva = _krr_problem(2, n_train=100, n_val=40, seed=8)
    kw = dict(init_sigma=0.6, init_beta=1e-2, steps=2, lr=0.2, tol=1e-12,
              maxiter=3000)
    jres = jkrr.krr_fit_grad("gaussian", xtr, ftr, xva, fva,
                             jfs.FastsumParams(**SMALL), **kw)
    tres = tkrr.krr_fit_grad("gaussian", xtr, ftr, xva, fva,
                             tfs.FastsumParams(**SMALL), device="cpu", **kw)
    assert _rel_max(tres.loss_path.numpy(), jres.loss_path) < 1e-6
    assert _rel_max(tres.log_sigma_path.numpy(), jres.log_sigma_path) < 1e-6
    assert _rel(tres.sigma, jres.sigma) < 1e-6


def test_krr_fit_grad_recovers_sweep_optimum():
    """Gradient model selection lands within one grid cell of the sweep."""
    rng = np.random.default_rng(3)
    n, n_val = 300, 120
    xtr = rng.uniform(-0.25, 0.25, (n, 1))
    xva = rng.uniform(-0.25, 0.25, (n_val, 1))

    def truth(p):
        return np.sin(8 * p[:, 0]) + 0.3 * np.cos(20 * p[:, 0])

    ftr = truth(xtr) + 0.05 * rng.normal(size=n)
    fva = truth(xva)
    params = tfs.FastsumParams(n_bandwidth=32, m=4, eps_b=0.0)
    sigmas = [0.05, 0.1, 0.2, 0.4, 0.8]
    betas = [1e-4, 1e-3, 1e-2, 1e-1]
    sweep = tkrr.krr_fit_sweep("gaussian", xtr, ftr, betas, sigmas, params,
                               tol=1e-10, maxiter=600, device="cpu")
    losses = np.zeros((len(sigmas), len(betas)))
    for i in range(len(sigmas)):
        for j in range(len(betas)):
            pred = tkrr.krr_predict(tkrr.krr_sweep_model(sweep, i, j), xva)
            losses[i, j] = float(((pred.numpy() - fva) ** 2).mean())
    i_best, j_best = np.unravel_index(np.argmin(losses), losses.shape)
    res = tkrr.krr_fit_grad("gaussian", xtr, ftr, xva, fva, params,
                            init_sigma=0.4, init_beta=1e-2, steps=25, lr=0.3,
                            tol=1e-10, maxiter=600, device="cpu")
    cell = np.log(sigmas[1]) - np.log(sigmas[0])
    dist = abs(np.log(res.sigma) - np.log(sigmas[i_best])) / cell
    assert dist <= 1.0, (res.sigma, sigmas[i_best], dist)
    assert res.val_loss <= 1.5 * losses[i_best, j_best]
    assert res.val_loss == float(res.loss_path.min())
    pred = tkrr.krr_predict(res.model, xva)
    assert float(((pred.numpy() - fva) ** 2).mean()) <= 1.5 * res.val_loss


def test_krr_grad_finite_through_guarded_path():
    """A poisoned training vector faults the solve; the gradients are
    finite, and zero (the loss no longer depends on sigma or beta)."""
    xtr, ftr, xva, fva = _krr_problem(1)
    ftr[5] = np.nan
    params = tfs.FastsumParams(**SMALL)
    kern = tkern.make_kernel("gaussian", sigma=0.5)
    gram = tfs.make_fastsum(kern, xtr, params, device="cpu")
    pred = tfs.make_fastsum(kern, xtr, params, target_points=xva,
                            device="cpu")
    a, b = _param(np.log(0.5)), _param(np.log(1e-2))
    loss = tkrr.krr_validation_loss("gaussian", gram, pred, ftr, fva, a, b,
                                    tol=1e-10)
    g_ls, g_lb = torch.autograd.grad(loss, (a, b))
    for g in (g_ls, g_lb):
        assert bool(torch.isfinite(g)) and float(g) == 0.0
