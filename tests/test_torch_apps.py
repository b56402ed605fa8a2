"""Kernel SSL and kernel ridge regression of the PyTorch port against the
JAX package, on the CPU.

``jax.random`` cannot be reproduced by torch, so each parity test builds
the training vector with the JAX function and hands the same numpy array
to both sides.  Solves are compared to their own tolerance: CG stops at
||r|| <= tol * max(||b||, 1), so the iterates may differ by up to
tol * max(||b||, 1) / lambda_min (lambda_min >= 1 for I + beta L_s, >= beta
for K + beta I), taken here with a factor of 10; iteration counts within
+-2, and within +-2 % for the ~350-step KRR solves at beta = 1e-2 (there
round-off alone moves the count: perturbing f by one ulp moves the JAX
package's own count from 361 to anywhere in 360..363).  Operators applied
to the same vectors agree to 1e-12 relative.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FastsumParams as JParams
from repro.core import make_kernel as jmake_kernel
from repro.core import make_normalized_adjacency as jmake_adj
from repro.core.lanczos import eigsh as jeigsh
from repro.data import synthetic as jdata
from repro.graph import krr as jkrr
from repro.graph import ssl as jssl
from repro_torch.core.fastsum import FastsumParams as TParams
from repro_torch.core.fastsum import make_normalized_adjacency as tmake_adj
from repro_torch.core.kernels import make_kernel as tmake_kernel
from repro_torch.data import synthetic as tdata
from repro_torch.data.synthetic import gaussian_blobs
from repro_torch.graph import krr as tkrr
from repro_torch.graph import spectral as tspec
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


ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n,seed", [(1001, 0), (4000, 5)])
def test_crescent_fullmoon_identical(n, seed):
    jp, jl = jdata.crescent_fullmoon(n, seed=seed)
    tp, tl = tdata.crescent_fullmoon(n, seed=seed)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)


def _ssl_setup(n=2000, seed=3):
    pts, labs = jdata.crescent_fullmoon(n, seed=seed)
    f, _ = jssl.make_training_vector(jnp.asarray(labs), 25, 2, key=KEY,
                                     positive_class=1)
    kw = dict(n_bandwidth=128, m=4, eps_b=0.0)
    jop = jmake_adj(jmake_kernel("gaussian", sigma=0.8), jnp.asarray(pts),
                    JParams(**kw))
    top = tmake_adj(tmake_kernel("gaussian", sigma=0.8), pts, TParams(**kw),
                    device="cpu")
    return pts, labs, np.array(f), jop, top


def test_kernel_ssl_cg_matches_jax():
    pts, labs, f, jop, top = _ssl_setup()
    tol = 1e-8
    want = jssl.kernel_ssl_cg(jop, jnp.asarray(f), 1e3, tol=tol)
    got = tssl.kernel_ssl_cg(top, torch.as_tensor(f), 1e3, tol=tol)
    assert bool(got.converged) and bool(want.converged)
    assert abs(int(got.num_iters) - int(want.num_iters)) <= 2
    allowed = 10 * tol * max(np.linalg.norm(f), 1.0)
    assert np.abs(got.u.numpy() - np.asarray(want.u)).max() <= allowed
    # the Laplacian matvec itself: same operator, same vector
    x = np.random.default_rng(0).normal(size=f.shape)
    assert _rel(top.laplacian_matvec(torch.as_tensor(x)).numpy(),
                jop.laplacian_matvec(jnp.asarray(x))) <= 1e-12
    assert _rel(top.stochastic_matvec(torch.as_tensor(x)).numpy(),
                jop.stochastic_matvec(jnp.asarray(x))) <= 1e-12
    mis = float(((got.u > 0).numpy().astype(np.int32) != labs).mean())
    assert mis < 0.05, mis


def test_eigenbasis_solvers_match_jax():
    """kernel_ssl_eig and allen_cahn_ssl on the same eigenpairs and f."""
    _, labs, f, jop, _ = _ssl_setup(n=1500, seed=4)
    eig = jeigsh(jop.matvec, jop.n, 10, key=KEY)
    lam, vec = np.array(eig.eigenvalues), np.array(eig.eigenvectors)
    want = jssl.kernel_ssl_eig(jnp.asarray(lam), jnp.asarray(vec),
                               jnp.asarray(f), 1e3)
    got = tssl.kernel_ssl_eig(torch.as_tensor(lam), torch.as_tensor(vec),
                              torch.as_tensor(f), 1e3)
    assert _rel(got.numpy(), want) <= 1e-12
    want = jssl.allen_cahn_ssl(jnp.asarray(1.0 - lam), jnp.asarray(vec),
                               jnp.asarray(f))
    got = tssl.allen_cahn_ssl(torch.as_tensor(1.0 - lam),
                              torch.as_tensor(vec), torch.as_tensor(f))
    assert abs(got.num_steps - want.num_steps) <= 2
    assert _rel(got.u.numpy(), want.u) <= 1e-6


def test_allen_cahn_multiclass_on_blobs():
    """Fig. 6 analogue on the port alone (its draws come from torch)."""
    pts, labs = gaussian_blobs(1500, n_classes=5, d=3, spread=7.0, seed=2)
    op = tmake_adj(tmake_kernel("gaussian", sigma=3.5), pts,
                   TParams(n_bandwidth=32, m=4, eps_b=0.0), device="cpu")
    pred = tssl.allen_cahn_multiclass(
        op, labs, 5, 5, k=5, generator=torch.Generator().manual_seed(0))
    acc = float((pred.numpy() == labs).mean())
    assert acc > 0.9, acc


def test_training_vector_clamps_small_classes():
    labels = np.array([0] * 40 + [1] * 3)
    f, mask = tssl.make_training_vector(
        labels, 25, 2, generator=torch.Generator().manual_seed(0),
        positive_class=1)
    f, mask = f.numpy(), mask.numpy()
    assert f.dtype == np.float64
    assert (f[labels == 1] == 1.0).all()
    assert ((f == 1.0) & (labels == 0)).sum() == 0
    assert (f[labels == 0] == -1.0).sum() == 25
    assert mask.sum() == 28 and (f[~mask] == 0.0).all()


KRR_CASES = [("gaussian", {"sigma": 1.0}, dict(n_bandwidth=64, m=4, eps_b=0.0)),
             ("inverse_multiquadric", {"c": 1.0}, dict(n_bandwidth=128, m=5))]


def _krr_data(n=1000, n_test=200, seed=5):
    rng = np.random.default_rng(seed)
    xtr = rng.uniform(-3, 3, (n, 2))
    ytr = np.sign(xtr[:, 0] ** 2 + xtr[:, 1] ** 2 - 4.0)
    xte = rng.uniform(-3, 3, (n_test, 2))
    return xtr, ytr, xte, np.sign(xte[:, 0] ** 2 + xte[:, 1] ** 2 - 4.0)


@pytest.mark.parametrize("kname,param,params", KRR_CASES)
def test_krr_fit_and_predict_match_jax(kname, param, params):
    xtr, ytr, xte, yte = _krr_data()
    tol, beta = 1e-8, 1e-2
    jm = jkrr.krr_fit(jmake_kernel(kname, **param), jnp.asarray(xtr),
                      jnp.asarray(ytr), beta, JParams(**params), tol=tol)
    tm = tkrr.krr_fit(tmake_kernel(kname, **param), xtr, ytr, beta,
                      TParams(**params), tol=tol, device="cpu")
    assert bool(tm.converged) and bool(jm.converged)
    assert abs(int(tm.num_iters) - int(jm.num_iters)) \
        <= max(2, 0.02 * int(jm.num_iters))
    allowed = 10 * tol * max(np.linalg.norm(ytr), 1.0) / beta
    assert np.abs(tm.alpha.numpy() - np.asarray(jm.alpha)).max() <= allowed
    pred = tkrr.krr_predict(tm, xte)
    assert float((np.sign(pred.numpy()) == yte).mean()) > 0.95
    # the prediction operators on the same dual vector (the JAX alpha)
    same = tm._replace(alpha=torch.as_tensor(np.array(jm.alpha)),
                       pred_cache={})
    assert _rel(tkrr.krr_predict(same, xte).numpy(),
                jkrr.krr_predict(jm, jnp.asarray(xte))) <= 1e-12
    assert _rel(tkrr.krr_predict_direct(same, xte).numpy(),
                jkrr.krr_predict_direct(jm, jnp.asarray(xte))) <= 1e-12
    queries = [xte[:30], xte[30:37], xte[37:]]
    custom = np.random.default_rng(1).normal(size=xtr.shape[0])
    want = jkrr.krr_predict_many(jm, [jnp.asarray(q) for q in queries],
                                 rhs=[None, jnp.asarray(custom), None])
    got = tkrr.krr_predict_many(same, queries, rhs=[None, custom, None])
    assert [g.shape[0] for g in got] == [30, 7, xte.shape[0] - 37]
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-12


def test_krr_prediction_cache_is_keyed_by_content(monkeypatch):
    xtr, ytr, xte, _ = _krr_data(n=200, n_test=50)
    model = tkrr.krr_fit(tmake_kernel("gaussian", sigma=1.0), xtr, ytr, 1e-2,
                         TParams(n_bandwidth=32, m=3, eps_b=0.0),
                         device="cpu")
    calls = []
    real = tkrr.make_fastsum
    monkeypatch.setattr(tkrr, "make_fastsum",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    first = tkrr.krr_predict(model, xte)
    again = tkrr.krr_predict(model, torch.as_tensor(xte.copy()))
    assert len(calls) == 1 and torch.equal(first, again)
    # a model refit with an equal kernel made anew shares the cache key
    twin = model._replace(kernel=tmake_kernel("gaussian", sigma=1.0))
    tkrr.krr_predict(twin, xte)
    assert len(calls) == 1
    others = [xte + k for k in range(1, tkrr.PRED_CACHE_SLOTS + 1)]
    for q in others:
        tkrr.krr_predict(model, q)
    assert len(calls) == 1 + tkrr.PRED_CACHE_SLOTS
    tkrr.krr_predict(model, xte)  # evicted: least recently used
    assert len(calls) == 2 + tkrr.PRED_CACHE_SLOTS
    stats = tkrr.krr_pred_cache_stats(model)
    assert stats == {"hits": 2, "misses": 2 + tkrr.PRED_CACHE_SLOTS,
                     "plans": 2 + tkrr.PRED_CACHE_SLOTS,
                     "resident": tkrr.PRED_CACHE_SLOTS}


def test_target_operator_rescales_the_union():
    """Targets far outside the sources: the operator must rescale sources
    and targets together, or the prediction wraps around the torus."""
    xtr, ytr, _, _ = _krr_data(n=300)
    far = np.random.default_rng(2).uniform(5, 8, (40, 2))
    model = tkrr.krr_fit(tmake_kernel("gaussian", sigma=1.5), xtr, ytr, 1e-2,
                         TParams(n_bandwidth=64, m=4, eps_b=0.0),
                         device="cpu")
    op = tkrr.krr_prediction_operator(model, far)
    assert op.n_target == 40 and op.n_source == 300
    assert float(torch.linalg.vector_norm(op.scaled_tgt, dim=1).max()) <= 0.25
    with pytest.raises(ValueError, match="matvec_tilde"):
        op.matvec(model.alpha)
    assert _rel(tkrr.krr_predict(model, far).numpy(),
                tkrr.krr_predict_direct(model, far).numpy()) <= 1e-6


def test_ssl_crescent_entry_point_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.ssl_crescent", "--n", "2000",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["gaussian", "laplacian_rbf"]
    assert all("misclassification" in ln and "device=cpu" in ln
               for ln in lines)


@pytest.mark.parametrize("height,width,seed", [(60, 90, 0), (100, 150, 0),
                                               (533, 800, 3)])
def test_synthetic_image_identical(height, width, seed):
    jimg, jlab = jdata.synthetic_image(height, width, seed=seed)
    timg, tlab = tdata.synthetic_image(height, width, seed=seed)
    np.testing.assert_array_equal(timg, jimg)
    np.testing.assert_array_equal(tlab, jlab)
    assert timg.dtype == jimg.dtype and tlab.dtype == jlab.dtype


class _NoMatvec:
    """An adjacency whose matvec must not be called."""

    def __init__(self, n):
        self.inv_sqrt_deg = torch.ones(n, dtype=torch.float64)
        self.n = n

    def matvec(self, x):
        raise AssertionError("spectral_clustering ran Lanczos")


def test_spectral_clustering_with_given_eigenvectors():
    """Precomputed eigenvectors (here of the dense A of three far-apart
    blobs): no operator application, full agreement with the labels."""
    pts, labels = gaussian_blobs(600, 3, d=2, spread=20.0, scale=0.5,
                                 seed=2)
    from repro_torch.core import dense_normalized_adjacency
    a = dense_normalized_adjacency(tmake_kernel("gaussian", sigma=2.0),
                                   torch.as_tensor(pts))
    lam, vec = torch.linalg.eigh(a)
    vecs, vals = vec.flip(1)[:, :3], lam.flip(0)[:3]
    res = tspec.spectral_clustering(_NoMatvec(600), 3, eigenvectors=vecs,
                                    eigenvalues=vals)
    assert res.eigenvectors is vecs and res.eigenvalues is vals
    assert tspec.clustering_agreement(labels, res.assignments.numpy(),
                                      3) == 1.0


def _run_module(args, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 REPRO_BENCH_DIR=str(tmp_path), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_image_segmentation_entry_point_runs_on_cpu(tmp_path):
    out = _run_module(["repro_torch.image_segmentation", "--height", "30",
                       "--width", "45", "--device", "cpu", "--out",
                       str(tmp_path)], tmp_path)
    assert "device=cpu" in out and "k=4: clustered" in out
    for name in ("input.ppm", "segmentation_k2.ppm", "segmentation_k4.ppm"):
        assert (tmp_path / name).read_bytes().startswith(b"P6 45 30 255\n")
    assert "agreement with the truth regions 1.0000" in out


@pytest.mark.parametrize("figure,size,cases", [
    ("fig3_eigenvalues", "200", ("nfft-lanczos-setup3 n=200 eigerr",
                                 "nystrom-L=n/4 n=200 eigerr",
                                 "hybrid-L=50 n=200 eigerr")),
    ("fig5_segmentation", "20", ("nfft k=4 n=600 disagreement",
                                 "nystrom k=4 L=25 n=600 mean-disagreement"))])
def test_figure_drivers_run_small_on_cpu(tmp_path, figure, size, cases):
    _run_module([f"repro_torch.figures.{figure}", "--device", "cpu",
                 "--sizes", size], tmp_path)
    import json
    rows = json.loads((tmp_path / f"torch_{figure}.json").read_text())
    by_case = {r["case"]: r["value"] for r in rows}
    for case in cases:
        assert np.isfinite(by_case[case]), case
    if figure == "fig3_eigenvalues":
        assert by_case["nfft-lanczos-setup3 n=200 eigerr"] < 1e-13
        assert by_case["hybrid-L=50 n=200 eigerr"] < 1e-2
