"""Operator banks, prediction plans, bank solvers, the (sigma, beta) sweep and
multilayer SSL of the PyTorch port against the JAX package.

The same numpy points go through ``repro.core`` (XLA window backend, CPU,
x64) and ``repro_torch.core`` on the CPU.  Tolerances, relative to the
largest output entry: plans 1e-15 (their window bases and permutations
equal; window weights 1e-14, as in test_torch_plan.py), multipliers 1e-13, bank matvecs 1e-12 where both packages plan
and execute, 1e-13 where the port executes the JAX package's own planned
bank (``fastsum_bank_from_arrays``).  Two CG runs agree to about
residual / beta, so solves are held to 1e-8 (bank solvers at tol 1e-10)
and 1e-6 (the sweep and SSL at tol 1e-8 / 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastsum as jfs
from repro.core import fastsum_exec as jexec
from repro.core import kernels as jkern
from repro.core import solvers as jsol
from repro.graph import krr as jkrr
from repro.graph import ssl as jssl
from repro_torch.core import fastsum as tfs
from repro_torch.core import fastsum_exec as texec
from repro_torch.core import kernels as tkern
from repro_torch.core import solvers as tsol
from repro_torch.graph import krr as tkrr
from repro_torch.graph import ssl as tssl


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


KERNELS = [("gaussian", {"sigma": 3.5}), ("laplacian_rbf", {"sigma": 2.0}),
           ("multiquadric", {"c": 1.0}), ("inverse_multiquadric", {"c": 1.0})]
SETUPS = {"SETUP_1": 16, "SETUP_2": 32}  # N; m = N // 8


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _points(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)) * 2.0


def _params(setup):
    n_bw = SETUPS[setup]
    return (jfs.FastsumParams(n_bandwidth=n_bw, m=n_bw // 8),
            tfs.FastsumParams(n_bandwidth=n_bw, m=n_bw // 8))


def _kernels(s):
    picked = [KERNELS[i % len(KERNELS)] for i in range(s)]
    return ([jkern.make_kernel(k, **p) for k, p in picked],
            [tkern.make_kernel(k, **p) for k, p in picked])


def _banks(d, setup, s, n=300, seed=0):
    pts = _points(n, d, seed + d)
    jp, tp = _params(setup)
    jk, tk = _kernels(s)
    return (pts, jfs.make_fastsum_bank(jk, jnp.asarray(pts), jp),
            tfs.make_fastsum_bank(tk, pts, tp, device="cpu"))


def _bank_leaves(bank) -> dict:
    return {"multiplier_bank": bank.multiplier_bank,
            "b_hat_bank": bank.b_hat_bank,
            "kernel_at_zero": bank.kernel_at_zero,
            "scaled_src": bank.scaled_src,
            "src_window.base": bank.src_window.base,
            "src_window.weights": bank.src_window.weights,
            "src_window.perm": bank.src_window.perm}


# ------------------------------------------------------------ plans
@pytest.mark.parametrize("d", [1, 2, 3])
def test_scale_nodes_uncentered_matches(d):
    pts = _points(200, d, d) + 3.0
    js, jrho, jshift = jfs.scale_nodes(jnp.asarray(pts), 0.1, center=False)
    ts, trho, tshift = tfs.scale_nodes(torch.as_tensor(pts), 0.1,
                                       center=False)
    assert trho == pytest.approx(float(jrho), rel=1e-15)
    assert not tshift.any() and not np.asarray(jshift).any()
    assert _rel(ts.numpy(), js) <= 1e-15


@pytest.mark.parametrize("domain", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("setup", ["SETUP_1", "SETUP_2"])
def test_prediction_plan_matches(setup, d, domain):
    pts = _points(250, d, 20 + d)
    dom = _points(7, d, 30 + d) * 2.0 if domain else None
    jp, tp = _params(setup)
    jpred = jfs.make_prediction_plan(
        jnp.asarray(pts), jp, domain_points=None if dom is None
        else jnp.asarray(dom), margin=0.3)
    tpred = tfs.make_prediction_plan(pts, tp, domain_points=dom, margin=0.3,
                                     device="cpu")
    assert tpred.rho == pytest.approx(jpred.rho, rel=1e-15)
    assert np.abs(tpred.shift - jpred.shift).max() \
        <= 1e-15 * max(np.abs(jpred.shift).max(), 1.0)
    assert tpred.radius == jpred.radius
    assert _rel(tpred.scaled_src.numpy(), jpred.scaled_src) <= 1e-15
    np.testing.assert_array_equal(tpred.src_window.base.numpy(),
                                  np.asarray(jpred.src_window.base))
    np.testing.assert_array_equal(tpred.src_window.perm.numpy(),
                                  np.asarray(jpred.src_window.perm))
    # the Kaiser-Bessel values differ by an ulp or two between the packages
    # (tests/test_torch_plan.py holds window weights to 1e-14)
    assert _rel(tpred.src_window.weights.numpy(),
                jpred.src_window.weights) <= 1e-14
    # targets: scaling, admissibility and the target window
    q = _points(40, d, 40 + d)
    q[:3] += 100.0  # far outside the domain
    tq, jq = tpred.scale_targets(q), jpred.scale_targets(jnp.asarray(q))
    assert _rel(tq.numpy(), jq) <= 1e-15
    np.testing.assert_array_equal(tpred.admissible(tq).numpy(),
                                  np.asarray(jpred.admissible(jq)))
    assert not tpred.admissible(tq)[:3].any()
    ok = tpred.admissible(tq).numpy()
    twin, jwin = (tpred.target_window(tq[ok]),
                  jpred.target_window(jq[np.flatnonzero(ok)]))
    np.testing.assert_array_equal(twin.base.numpy(), np.asarray(jwin.base))
    assert _rel(twin.weights.numpy(), jwin.weights) <= 1e-14


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kname,param", KERNELS)
def test_prediction_multiplier_matches(kname, param, d):
    pts = _points(200, d, 50 + d)
    jp, tp = _params("SETUP_2")
    jpred = jfs.make_prediction_plan(jnp.asarray(pts), jp)
    tpred = tfs.make_prediction_plan(pts, tp, device="cpu")
    want = jfs.prediction_multiplier(jkern.make_kernel(kname, **param),
                                     jpred, jp)
    got = tfs.prediction_multiplier(tkern.make_kernel(kname, **param),
                                    tpred, tp)
    assert _rel(got.numpy(), want) <= 1e-13


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("s", [1, 3])
def test_bank_multipliers_match(s, d):
    _, jbank, tbank = _banks(d, "SETUP_2", s)
    assert tbank.size == jbank.size == s
    assert _rel(tbank.multiplier_bank.numpy(), jbank.multiplier_bank) <= 1e-13
    assert _rel(tbank.b_hat_bank.numpy(), jbank.b_hat_bank) <= 1e-13
    assert _rel(tbank.kernel_at_zero.numpy(), jbank.kernel_at_zero) <= 1e-13


# ------------------------------------------------------------ bank matvecs
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("setup", ["SETUP_1", "SETUP_2"])
def test_bank_matvecs_match_jax(setup, d, s):
    pts, jbank, tbank = _banks(d, setup, s)
    rng = np.random.default_rng(s + 10 * d)
    n = pts.shape[0]
    for shape in [(n,), (n, 1), (n, 2), (s, n, 2)]:
        x = rng.normal(size=shape)
        want = jbank.matvec_tilde(jnp.asarray(x), backend="xla")
        got = tbank.matvec_tilde(torch.as_tensor(x))
        assert tuple(got.shape) == want.shape
        assert _rel(got.numpy(), want) <= 1e-12, shape
        want = jbank.matvec(jnp.asarray(x), backend="xla")
        assert _rel(tbank.matvec(torch.as_tensor(x)).numpy(), want) <= 1e-12
    u = rng.normal(size=(n, s * 2))
    want = jbank.matvec_tilde_columns(jnp.asarray(u), backend="xla")
    assert _rel(tbank.matvec_tilde_columns(torch.as_tensor(u)).numpy(),
                want) <= 1e-12
    x = rng.normal(size=(n, 2))
    for m in range(s):
        want = jbank.member(m).matvec(jnp.asarray(x), backend="xla")
        assert _rel(tbank.member(m).matvec(torch.as_tensor(x)).numpy(),
                    want) <= 1e-12
    w = rng.uniform(0.1, 1.0, size=s)
    want = jbank.mixture(w).matvec(jnp.asarray(x), backend="xla")
    got = tbank.mixture(w).matvec(torch.as_tensor(x)).numpy()
    assert _rel(got, want) <= 1e-12
    # the mixture is the weighted sum of the members, in the port alone
    members = tbank.matvec(torch.as_tensor(x)).numpy()
    assert _rel(got, np.tensordot(w, members, axes=1)) <= 1e-12


def test_bank_lockstep_layout_is_bank_major():
    """Lockstep and columns flavours against each member on its own
    columns, with S and C >= 2: a transposed layout fails here."""
    pts, _, tbank = _banks(2, "SETUP_2", 3)
    n = pts.shape[0]
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(3, n, 2)))
    lock = tbank.matvec_tilde(x)
    cols = tbank.matvec_tilde_columns(x.permute(1, 0, 2).reshape(n, 6))
    for m in range(3):
        want = tbank.member(m).matvec_tilde(x[m]).numpy()
        assert _rel(lock[m].numpy(), want) <= 1e-13
        assert _rel(cols[:, 2 * m:2 * m + 2].numpy(), want) <= 1e-13


@pytest.mark.parametrize("d", [1, 2, 3])
def test_bank_from_arrays_executes_jax_bank(d):
    pts, jbank, _ = _banks(d, "SETUP_2", 3, seed=5)
    _, tp = _params("SETUP_2")
    tbank = tfs.fastsum_bank_from_arrays(
        {k: np.asarray(v) for k, v in _bank_leaves(jbank).items()}, tp,
        device="cpu")
    rng = np.random.default_rng(d)
    x = rng.normal(size=(pts.shape[0], 2))
    for xx in (x, rng.normal(size=(3,) + x.shape)):
        assert _rel(tbank.matvec(torch.as_tensor(xx)).numpy(),
                    jbank.matvec(jnp.asarray(xx), backend="xla")) <= 1e-13
    u = rng.normal(size=(pts.shape[0], 6))
    assert _rel(tbank.matvec_tilde_columns(torch.as_tensor(u)).numpy(),
                jbank.matvec_tilde_columns(jnp.asarray(u), backend="xla")) \
        <= 1e-13
    w = [0.5, 0.3, 0.2]
    assert _rel(tbank.mixture(w).matvec(torch.as_tensor(x)).numpy(),
                jbank.mixture(w).matvec(jnp.asarray(x), backend="xla")) \
        <= 1e-13


@pytest.mark.parametrize("d", [1, 2, 3])
def test_transform_and_gather_columns_match_jax(d):
    pts = _points(300, d, 60 + d)
    jp, tp = _params("SETUP_2")
    jpred = jfs.make_prediction_plan(jnp.asarray(pts), jp)
    tpred = tfs.make_prediction_plan(pts, tp, device="cpu")
    jk, tk = _kernels(3)
    jm = jnp.stack([jfs.prediction_multiplier(k, jpred, jp) for k in jk])
    tm = torch.stack([tfs.prediction_multiplier(k, tpred, tp) for k in tk])
    rng = np.random.default_rng(d)
    xb = rng.normal(size=(300, 3))
    jgrid = jexec.fused_transform_columns(jpred.plan, jm, jpred.src_window,
                                          jnp.asarray(xb), backend="xla")
    tgrid = texec.fused_transform_columns(tpred.plan, tm, tpred.src_window,
                                          torch.as_tensor(xb))
    assert _rel(tgrid.numpy(), jgrid) <= 1e-12
    q = rng.uniform(-2, 2, size=(50, d))
    tq = tpred.scale_targets(q)
    col = rng.integers(0, 3, size=50).astype(np.int32)
    got = texec.fused_gather_columns(tpred.plan, tpred.target_window(tq),
                                     tgrid, torch.as_tensor(col))
    want = jexec.fused_gather_columns(
        jpred.plan, jpred.target_window(jpred.scale_targets(jnp.asarray(q))),
        jgrid, jnp.asarray(col), backend="xla")
    assert got.shape == (50,)
    assert _rel(got.numpy(), want) <= 1e-12
    # each row reads its own channel: against the full gather
    full = texec.window_gather(tpred.plan, tpred.target_window(tq), tgrid)
    np.testing.assert_array_equal(got.numpy(),
                                  full.numpy()[np.arange(50), col])


@pytest.mark.parametrize("s", [1, 4])
def test_bank_matvec_one_spread_one_rfftn(s, monkeypatch):
    """The counterpart of test_bank_lowers_one_forward_rfft_and_one_spread:
    whatever S is, a bank matvec (every flavour) spreads once, runs one
    forward rfftn, one irfftn and gathers once."""
    pts = _points(400, 2, 70)
    bank = tfs.make_fastsum_bank(
        [tkern.make_kernel("gaussian", sigma=3.0 + 0.5 * k) for k in range(s)],
        pts, tfs.FastsumParams(n_bandwidth=16, m=4), device="cpu")
    calls = {"spread": 0, "gather": 0, "rfftn": 0, "irfftn": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(texec, "window_spread",
                        counted("spread", texec.window_spread))
    monkeypatch.setattr(texec, "window_gather",
                        counted("gather", texec.window_gather))
    monkeypatch.setattr(torch.fft, "rfftn", counted("rfftn", torch.fft.rfftn))
    monkeypatch.setattr(torch.fft, "irfftn",
                        counted("irfftn", torch.fft.irfftn))
    rng = np.random.default_rng(s)
    for x in (rng.normal(size=(400,)), rng.normal(size=(400, 2)),
              rng.normal(size=(s, 400, 2))):
        bank.matvec(torch.as_tensor(x))
    bank.matvec_tilde_columns(torch.as_tensor(rng.normal(size=(400, 2 * s))))
    assert calls == {"spread": 4, "gather": 4, "rfftn": 4, "irfftn": 4}


def test_bank_rejects_mismatched_shapes():
    pts, _, tbank = _banks(2, "SETUP_1", 3)
    n = pts.shape[0]
    with pytest.raises(ValueError, match="bank axis"):
        tbank.matvec_tilde(torch.zeros((4, n, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="S\\*C"):
        tbank.matvec_tilde_columns(torch.zeros((n, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="S\\*C"):
        tbank.matvec_tilde_columns(torch.zeros((n,), dtype=torch.float64))
    with pytest.raises(ValueError, match="weights"):
        tbank.mixture([0.5, 0.5])
    with pytest.raises(ValueError, match="at least one"):
        tfs.make_fastsum_bank([], pts, tfs.SETUP_1, device="cpu")
    rect = tfs.make_fastsum_bank([tkern.make_kernel("gaussian", sigma=2.0)],
                                 pts, tfs.SETUP_1,
                                 target_points=pts[:20] + 0.1, device="cpu")
    assert rect.matvec_tilde(torch.ones(n, dtype=torch.float64)).shape \
        == (1, 20)
    with pytest.raises(ValueError, match="target_points"):
        rect.matvec(torch.ones(n, dtype=torch.float64))


# ------------------------------------------------------------ bank solvers
@pytest.mark.parametrize("name", ["cg", "minres"])
def test_bank_solvers_match_jax(name):
    """Gaussian members (SPD Gram matrices), tests/test_fastsum_bank.py's
    sigmas."""
    pts = _points(200, 2, 13)
    jp, tp = _params("SETUP_2")
    sigmas = (2.0, 3.5, 5.0)
    jbank = jfs.make_fastsum_bank(
        [jkern.make_kernel("gaussian", sigma=s) for s in sigmas],
        jnp.asarray(pts), jp)
    tbank = tfs.make_fastsum_bank(
        [tkern.make_kernel("gaussian", sigma=s) for s in sigmas], pts, tp,
        device="cpu")
    beta = 0.5
    b = np.random.default_rng(7).normal(size=(3, 200, 2))
    jsolve = getattr(jsol, f"{name}_bank")
    tsolve = getattr(tsol, f"{name}_bank")
    want = jsolve(lambda x: jbank.matvec_tilde(x, backend="xla") + beta * x,
                  jnp.asarray(b), tol=1e-10, maxiter=500)
    got = tsolve(lambda x: tbank.matvec_tilde(x) + beta * x,
                 torch.as_tensor(b), tol=1e-10, maxiter=500)
    assert tuple(got.x.shape) == (3, 200, 2)
    assert tuple(got.num_iters.shape) == (3, 2)
    assert tuple(got.health.nonfinite.shape) == (3, 2)
    assert _rel(got.x.numpy(), want.x) <= 1e-8
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert got.converged.all()
    assert np.abs(got.num_iters.numpy()
                  - np.asarray(want.num_iters)).max() <= 1
    # (S, n) right-hand sides give (S,) fields
    one = tsolve(lambda x: tbank.matvec_tilde(x) + beta * x,
                 torch.as_tensor(b[..., 0]), tol=1e-10, maxiter=500)
    assert tuple(one.x.shape) == (3, 200) and tuple(one.converged.shape) \
        == (3,)
    assert _rel(one.x.numpy(), got.x[..., 0].numpy()) <= 1e-8


def test_poisoned_bank_member_isolated_in_bank_solve():
    """tests/test_chaos.py's case, poisoned by hand: one member's operator
    emits NaN; all its systems are quarantined, its siblings converge."""
    rng = np.random.default_rng(6)
    mats = []
    for _ in range(3):
        m = rng.normal(size=(50, 50))
        mats.append(m @ m.T + 50 * np.eye(50))
    stack = torch.as_tensor(np.stack(mats))

    def poisoned(xb):  # (S, n, C) -> (S, n, C), member 1 emits NaN
        yb = torch.einsum("sij,sjc->sic", stack, xb)
        yb[1] = float("nan")
        return yb

    b = rng.normal(size=(3, 50, 2))
    sol = tsol.cg_bank(poisoned, torch.as_tensor(b), tol=1e-10, maxiter=2000)
    nonfinite = sol.health.nonfinite.numpy()
    assert nonfinite.shape == (3, 2)
    assert nonfinite[1].all() and not nonfinite[[0, 2]].any()
    for s in (0, 2):
        for c in range(2):
            np.testing.assert_allclose(sol.x[s, :, c].numpy(),
                                       np.linalg.solve(mats[s], b[s, :, c]),
                                       rtol=1e-7, atol=1e-7)
    assert torch.isfinite(sol.x).all()


# ------------------------------------------------------------ sweep, SSL
def _krr_data(n=400, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 2))
    return x, np.sin(3 * x[:, 0]) + x[:, 1] ** 2


def test_krr_fit_sweep_matches_jax_and_sequential():
    x, y = _krr_data()
    jp = jfs.FastsumParams(n_bandwidth=32, m=4)
    tp = tfs.FastsumParams(n_bandwidth=32, m=4)
    sigmas, betas = (0.8, 1.5), (1e-2, 1e-1)
    want = jkrr.krr_fit_sweep("gaussian", jnp.asarray(x), jnp.asarray(y),
                              betas, sigmas, jp, tol=1e-10, maxiter=400)
    got = tkrr.krr_fit_sweep("gaussian", x, y, betas, sigmas, tp, tol=1e-10,
                             maxiter=400, device="cpu")
    assert tuple(got.alphas.shape) == (2, 400, 2)
    assert got.converged.all() and got.sigmas == sigmas
    assert _rel(got.alphas.numpy(), want.alphas) <= 1e-6
    for i, s in enumerate(sigmas):
        for j, b in enumerate(betas):
            seq = tkrr.krr_fit(tkern.make_kernel("gaussian", sigma=s), x, y,
                               b, tp, tol=1e-10, maxiter=400, device="cpu")
            assert _rel(got.alphas[i, :, j].numpy(), seq.alpha.numpy()) \
                <= 1e-6, (i, j)


def test_krr_sweep_model_serves_cell():
    x, y = _krr_data(seed=6)
    tp = tfs.FastsumParams(n_bandwidth=32, m=4)
    sweep = tkrr.krr_fit_sweep("gaussian", x, y, [1e-2], (0.7, 1.2), tp,
                               tol=1e-10, maxiter=400, device="cpu")
    model = tkrr.krr_sweep_model(sweep, 1, 0)
    assert model.kernel.params["sigma"] == 1.2
    assert model.pred_cache == {} and bool(model.converged)
    xte = np.random.default_rng(7).uniform(-1, 1, size=(60, 2))
    p = tkrr.krr_predict(model, xte)
    pd = tkrr.krr_predict_direct(model, xte)
    assert _rel(p.numpy(), pd.numpy()) < 1e-4


def test_multilayer_ssl_matches_jax():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(300, 2))
    f = np.zeros(300)
    f[:10] = np.sign(pts[:10, 0])
    jk = [jkern.make_kernel("gaussian", sigma=s) for s in (0.75, 1.5)]
    tk = [tkern.make_kernel("gaussian", sigma=s) for s in (0.75, 1.5)]
    jp = jfs.FastsumParams(n_bandwidth=64, m=4, eps_b=0.0)
    tp = tfs.FastsumParams(n_bandwidth=64, m=4, eps_b=0.0)
    want = jssl.kernel_ssl_cg_multilayer(jk, [0.5, 0.5], jnp.asarray(pts), jp,
                                         jnp.asarray(f), 10.0, tol=1e-8)
    got = tssl.kernel_ssl_cg_multilayer(tk, [0.5, 0.5], pts, tp,
                                        torch.as_tensor(f), 10.0, tol=1e-8,
                                        device="cpu")
    assert bool(got.converged) and bool(want.converged)
    assert _rel(got.u.numpy(), want.u) <= 1e-6
    assert abs(int(got.num_iters) - int(want.num_iters)) <= 1


def test_mixture_adjacency_symmetric():
    pts = _points(250, 3, 9)
    ks = [tkern.make_kernel("gaussian", sigma=3.5),
          tkern.make_kernel("laplacian_rbf", sigma=2.0)]
    adj = tfs.make_normalized_adjacency_mixture(ks, [0.7, 0.3], pts,
                                                tfs.SETUP_1, device="cpu")
    rng = np.random.default_rng(10)
    x, y = (torch.as_tensor(rng.normal(size=250)) for _ in range(2))
    lhs = float(adj.matvec(x) @ y)
    rhs = float(x @ adj.matvec(y))
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


@pytest.mark.parametrize("setup", ["SETUP_2", "SETUP_3"])
def test_mixture_matches_dense_multilayer_weight_matrix(setup):
    """tests/test_fastsum_bank.py's two Gaussian layers against the dense
    weighted sum of the layers' W: the port's mixture matches the JAX
    package's within 1e-12 and the dense one within the fast summation's
    own error (the JAX mixture's, 3e-9 at SETUP_3, with 1 % room); the
    mixture adjacency likewise against the dense normalization."""
    pts = _points(250, 2, 11)
    w = [0.6, 0.4]
    jk = [jkern.make_kernel("gaussian", sigma=s) for s in (3.5, 2.0)]
    tk = [tkern.make_kernel("gaussian", sigma=s) for s in (3.5, 2.0)]
    tpts = torch.as_tensor(pts)
    dense = sum(wi * tfs.dense_weight_matrix(k, tpts) for wi, k in zip(w, tk))
    x = np.random.default_rng(12).normal(size=250)
    jbank = jfs.make_fastsum_bank(jk, jnp.asarray(pts), getattr(jfs, setup))
    tbank = tfs.make_fastsum_bank(tk, pts, getattr(tfs, setup), device="cpu")
    want = jbank.mixture(w).matvec(jnp.asarray(x), backend="xla")
    got = tbank.mixture(w).matvec(torch.as_tensor(x)).numpy()
    exact = (dense @ torch.as_tensor(x)).numpy()
    assert _rel(got, want) <= 1e-12
    assert _rel(got, exact) <= 1.01 * _rel(want, exact)
    jadj = jfs.make_normalized_adjacency_mixture(jk, w, jnp.asarray(pts),
                                                 getattr(jfs, setup))
    tadj = tfs.make_normalized_adjacency_mixture(tk, w, pts,
                                                 getattr(tfs, setup),
                                                 device="cpu")
    inv = 1.0 / torch.sqrt(dense.sum(dim=1))
    exact = (inv * (dense @ (inv * torch.as_tensor(x)))).numpy()
    want = jadj.matvec(jnp.asarray(x))
    got = tadj.matvec(torch.as_tensor(x)).numpy()
    assert _rel(got, want) <= 1e-12
    assert _rel(got, exact) <= 1.01 * _rel(want, exact)
