"""Error bound and accuracy guard of the PyTorch port against the JAX
package, on the CPU.

Both packages plan on the same numpy points.  The Monte-Carlo eps
estimate draws its samples from ``np.random.default_rng(seed)`` on both
sides, so the port probes the very points the reference probes.
Tolerances: 1e-12 relative for the trigonometric evaluation and the
probe's eps and eta (different summation orders of the same sums); 1e-9
for the exact a-posteriori quantities and the bounds along the guard's
ladder (they take differences of nearly equal n x n matrices, and the
bound divides by eta - eps); the guard's list of attempted bandwidths and
its fallback must be equal; the direct floor agrees with the dense matrix
to 1e-12 relative.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error as jerr
from repro.core import fastsum as jfs
from repro.core import kernels as jkern
from repro.core import regularization as jreg
from repro.runtime import guards as jguards
from repro_torch.core import error as terr
from repro_torch.core import fastsum as tfs
from repro_torch.core import kernels as tkern
from repro_torch.core import regularization as treg
from repro_torch.runtime import guards as tguards

SIGMA = 3.5


def _points(n=200, d=2, seed=7):
    return np.random.default_rng(seed).normal(size=(n, d))


def _pair(params_kw):
    return jfs.FastsumParams(**params_kw), tfs.FastsumParams(**params_kw)


def _close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b))


def test_lemma31_bound_matches():
    for eta, eps in ((0.5, 0.01), (0.5, 0.25), (0.5, 0.5), (0.5, 0.6),
                     (float("nan"), 0.1), (0.5, float("nan")), (0.0, 0.0),
                     (-0.1, 0.01), (1e-3, 1e-9)):
        assert terr.lemma31_bound(eta, eps) == jerr.lemma31_bound(eta, eps)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_trigonometric_eval_matches(d):
    jk = jkern.make_kernel("gaussian", sigma=0.1)
    tk = tkern.make_kernel("gaussian", sigma=0.1)
    n = 16 if d == 3 else 32
    jb = jreg.kernel_fourier_coefficients(jk, d, n, 4, 0.1)
    tb = treg.kernel_fourier_coefficients(tk, d, n, 4, 0.1, device="cpu")
    y = np.random.default_rng(d).uniform(-0.5, 0.5, size=(7, 5, d))
    want = np.asarray(jreg.trigonometric_eval(jb, jnp.asarray(y)))
    got = treg.trigonometric_eval(tb, torch.as_tensor(y)).numpy()
    assert got.shape == (7, 5)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("kname,param", [("gaussian", {"sigma": SIGMA}),
                                         ("inverse_multiquadric", {"c": 1.0})])
@pytest.mark.parametrize("n_bandwidth", [16, 32])
def test_estimate_epsilon_and_probe_match(kname, param, n_bandwidth):
    pts = _points()
    jp, tp = _pair({"n_bandwidth": n_bandwidth, "m": 4})
    jk, tk = jkern.make_kernel(kname, **param), tkern.make_kernel(kname, **param)
    jop = jfs.make_fastsum(jk, jnp.asarray(pts), jp)
    top = tfs.make_fastsum(tk, pts, tp, device="cpu")
    rho = float(jop.rho)
    want = jerr.estimate_epsilon(jk.rescaled(rho), jop, 200, 3.0,
                                 n_samples=1024, seed=5)
    got = terr.estimate_epsilon(tk.rescaled(top.rho), top, 200, 3.0,
                                n_samples=1024, seed=5)
    assert _close(got, want)
    jr = jguards.probe_fastsum(jk, jnp.asarray(pts), jp, jop, n_samples=1024)
    tr = tguards.probe_fastsum(tk, pts, tp, top, n_samples=1024)
    assert tr.n_bandwidth == jr.n_bandwidth
    assert _close(tr.eta, jr.eta) and _close(tr.eps, jr.eps)
    assert _close(tr.bound, jr.bound) or tr.bound == jr.bound == float("inf")


def test_aposteriori_report_and_exact_error_norm_match():
    pts = np.random.default_rng(3).uniform(-5.0, 5.0, size=(150, 3))
    jk = jkern.make_kernel("gaussian", sigma=SIGMA)
    tk = tkern.make_kernel("gaussian", sigma=SIGMA)
    jp, tp = _pair({"n_bandwidth": 16, "m": 2, "eps_b": 0.0})
    jop = jfs.make_fastsum(jk, jnp.asarray(pts), jp)
    top = tfs.make_fastsum(tk, pts, tp, device="cpu")
    want = jerr.aposteriori_report(jk, jnp.asarray(pts), jop)
    got = terr.aposteriori_report(tk, torch.as_tensor(pts), top)
    assert set(got) == set(want)
    for key in ("eta", "eps", "bound", "a_err_inf"):
        assert _close(got[key], want[key], 1e-9), (key, got[key], want[key])
    assert got["a_err_inf"] <= got["bound"]
    assert _close(terr.exact_error_norm(tk, torch.as_tensor(pts), top),
                  jerr.exact_error_norm(jk, jnp.asarray(pts), jop), 1e-9)


@pytest.mark.parametrize("case", [
    # accepted at once / escalated / direct floor / unguarded best attempt
    dict(params={"n_bandwidth": 32, "m": 4}, policy={"bound_tol": 0.1}),
    dict(params={"n_bandwidth": 8, "m": 4}, policy={"bound_tol": 0.1}),
    dict(params={"n_bandwidth": 8, "m": 4},
         policy={"bound_tol": 0.0, "max_bandwidth": 16,
                 "direct_threshold": 1024}),
    dict(params={"n_bandwidth": 8, "m": 4},
         policy={"bound_tol": 0.0, "max_bandwidth": 16,
                 "direct_threshold": 0}),
])
def test_guarded_fastsum_takes_the_same_ladder(case):
    pts = _points(n=200, seed=7)
    jp, tp = _pair(case["params"])
    jk = jkern.make_kernel("gaussian", sigma=SIGMA)
    tk = tkern.make_kernel("gaussian", sigma=SIGMA)
    warns = case["policy"].get("direct_threshold", 8192) < 200
    with pytest.warns(RuntimeWarning, match="UNGUARDED") if warns \
            else contextlib.nullcontext():
        jop, jrep = jguards.guarded_fastsum(
            jk, jnp.asarray(pts), jp,
            policy=jguards.GuardPolicy(**case["policy"]))
    with pytest.warns(RuntimeWarning, match="UNGUARDED") if warns \
            else contextlib.nullcontext():
        top, trep = tguards.guarded_fastsum(
            tk, pts, tp, policy=tguards.GuardPolicy(**case["policy"]),
            device="cpu")
    assert [a.n_bandwidth for a in trep.attempts] \
        == [a.n_bandwidth for a in jrep.attempts]
    assert (trep.fallback, trep.ok) == (jrep.fallback, jrep.ok)
    for ta, ja in zip(trep.attempts, jrep.attempts):
        assert _close(ta.bound, ja.bound, 1e-9) \
            or ta.bound == ja.bound == float("inf")
    x = np.random.default_rng(1).normal(size=(200, 2))
    want = np.asarray(jop.matvec(jnp.asarray(x)))
    got = top.matvec(torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("d", [2, 3])
def test_direct_floor_matches_dense(d):
    pts = _points(n=240, d=d, seed=11)
    tk = tkern.make_kernel("gaussian", sigma=SIGMA)
    adj, rep = tguards.guarded_normalized_adjacency(
        tk, pts, tfs.FastsumParams(n_bandwidth=8, m=4),
        policy=tguards.GuardPolicy(bound_tol=0.0, max_bandwidth=8,
                                   direct_threshold=1024), device="cpu")
    assert rep.fallback == "direct" and rep.escalations == 0
    assert isinstance(adj.fastsum, tguards.DirectKernelOperator)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(240, 3)))
    tpts = torch.as_tensor(pts)
    dense = tfs.dense_normalized_adjacency(tk, tpts)
    got = adj.matvec(x)
    assert float((got - dense @ x).abs().max()) \
        <= 1e-12 * float((dense @ x).abs().max())
    w = tfs.dense_weight_matrix(tk, tpts)
    tilde = adj.fastsum.matvec_tilde(x)
    assert float((tilde - (w @ x + x)).abs().max()) \
        <= 1e-12 * float((w @ x).abs().max())
    assert torch.allclose(adj.degrees, w.sum(dim=1), rtol=1e-12, atol=0)
