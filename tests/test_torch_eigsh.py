"""Lanczos/eigsh and spectral clustering of the PyTorch port.

Start vectors are made with numpy and handed to both packages (``jax.random``
and ``torch.Generator`` draw different numbers), so the port's eigenvalues
are held against the JAX package's to 1e-10.  The paper's Fig. 3 tiers of
``tests/test_lanczos.py`` are rerun on the port alone.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastsum as jfs
from repro.core import kernels as jkern
from repro.data import synthetic as jsyn
from repro_torch import quickstart
from repro_torch.core import fastsum as tfs
from repro_torch.core import kernels as tkern
from repro_torch.data import synthetic as tsyn
from repro_torch.graph import spectral as tspec


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


# the module: ``repro_torch.core`` re-exports the function ``lanczos``
# under its name, as ``repro.core`` does
tlan = importlib.import_module("repro_torch.core.lanczos")

# repro.core re-exports a function named `lanczos` over the module name
jlan = importlib.import_module("repro.core.lanczos")


def _sym(n, seed):
    m = np.random.default_rng(seed).normal(size=(n, n))
    return (m + m.T) / 2.0


def _separated(n, seed):
    """Symmetric, with 8 extremal eigenvalues at each end spaced by 1."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = rng.uniform(-1.0, 1.0, n)
    lam[:8] = 2.0 + np.arange(8)
    lam[8:16] = -2.0 - np.arange(8)
    return (q * lam) @ q.T


def test_synthetic_copies_match_the_reference():
    for fn in ("spiral", "gaussian_blobs"):
        tp, tl = getattr(tsyn, fn)(333, seed=4)
        jp, jl = getattr(jsyn, fn)(333, seed=4)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("which", ["LA", "SA"])
@pytest.mark.parametrize("block_size", [1, 4])
def test_eigsh_matches_jax_on_dense(block_size, which):
    n, k = 300, 6
    a = _separated(n, 0)
    rng = np.random.default_rng(1)
    v0 = rng.normal(size=(n,) if block_size == 1 else (n, block_size))
    ja = jnp.asarray(a)
    want = jlan.eigsh(lambda x: ja @ x, n, k, num_iters=120, which=which,
                      v0=jnp.asarray(v0), block_size=block_size)
    ta = torch.as_tensor(a)
    got = tlan.eigsh(lambda x: ta @ x, n, k, num_iters=120, which=which,
                     v0=v0, block_size=block_size, device="cpu")
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=0, atol=1e-10)
    assert got.num_matvecs == want.num_matvecs
    assert got.num_iters == want.num_iters
    ref = np.sort(np.linalg.eigvalsh(a))
    ref = ref[::-1][:k] if which == "LA" else ref[:k]
    np.testing.assert_allclose(got.eigenvalues.numpy(), ref, atol=1e-9)
    vecs = got.eigenvectors.numpy()  # eigenvectors up to sign
    r = a @ vecs - vecs * got.eigenvalues.numpy()[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-7
    assert not bool(got.health.nonfinite)


def test_eigsh_generator_is_reproducible():
    a = torch.as_tensor(_sym(80, 2))
    runs = [tlan.eigsh(lambda x: a @ x, 80, 3, device="cpu",
                       generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0].eigenvalues, runs[1].eigenvalues)


def test_block_v0_wider_than_shrunk_block():
    n, k = 10, 4
    a = _sym(n, 7)
    v0 = np.random.default_rng(7).normal(size=(n, 8))  # shrinks to 5
    ta = torch.as_tensor(a)
    res = tlan.eigsh(lambda x: ta @ x, n, k, v0=v0, block_size=8,
                     num_iters=n, device="cpu")
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.sort(np.linalg.eigvalsh(a))[::-1][:k],
                               atol=1e-8)


@pytest.mark.parametrize("block_size", [1, 2])
def test_breakdown_truncates_like_a_short_run(block_size):
    """A matvec that turns non-finite at call 5 leaves exactly the
    factorization of a clean 5-call run; bounds read inf."""
    n, k = 60, 2
    ta = torch.as_tensor(_sym(n, 3))
    v0 = np.random.default_rng(3).normal(
        size=(n,) if block_size == 1 else (n, block_size))
    calls = []

    def poisoned(x):
        calls.append(1)
        y = ta @ x
        return y * float("nan") if len(calls) > 5 else y

    bad = tlan.eigsh(poisoned, n, k, num_iters=20 * block_size, v0=v0,
                     block_size=block_size, device="cpu")
    clean = tlan.eigsh(lambda x: ta @ x, n, k, num_iters=5 * block_size,
                       v0=v0, block_size=block_size, device="cpu")
    assert bool(bad.health.nonfinite) and int(bad.health.breakdown_iter) == 5
    assert torch.isinf(bad.residual_bounds).all()
    np.testing.assert_allclose(bad.eigenvalues.numpy(),
                               clean.eigenvalues.numpy(), atol=1e-12)


class TestPaperFigure3Tiers:
    """The port reproduces the paper's three accuracy setups (spiral data,
    sigma=3.5, 10 largest eigenpairs of A), with the tiers of
    tests/test_lanczos.py."""

    @classmethod
    def setup_class(cls):
        pts, _ = tsyn.spiral(1000, seed=0)
        cls.pts = torch.as_tensor(pts)
        cls.kern = tkern.make_kernel("gaussian", sigma=3.5)
        cls.a_dense = tfs.dense_normalized_adjacency(cls.kern, cls.pts)
        cls.ref = torch.linalg.eigvalsh(cls.a_dense).flip(0)[:10]

    @pytest.mark.parametrize("setup,eig_tol,res_tol", [
        ("SETUP_1", 5e-3, 1e-2),
        ("SETUP_2", 5e-8, 5e-7),
        ("SETUP_3", 1e-13, 1e-12),
    ])
    def test_tier(self, setup, eig_tol, res_tol):
        op = tfs.make_normalized_adjacency(self.kern, self.pts,
                                           getattr(tfs, setup), device="cpu")
        res = tlan.eigsh(op.matvec, op.n, 10, num_iters=80, device="cpu")
        assert float((res.eigenvalues - self.ref).abs().max()) < eig_tol
        r = (self.a_dense @ res.eigenvectors
             - res.eigenvectors * res.eigenvalues[None, :])
        assert float(torch.linalg.vector_norm(r, dim=0).max()) < res_tol

    def test_smallest_laplacian_equals_one_minus_largest(self):
        op = tfs.make_normalized_adjacency(self.kern, self.pts, tfs.SETUP_2,
                                           device="cpu")
        res = tlan.eigsh_smallest_laplacian(op.matvec, op.n, 5, num_iters=60,
                                            device="cpu")
        np.testing.assert_allclose(res.eigenvalues.numpy(),
                                   1.0 - self.ref[:5].numpy(), atol=1e-7)


def test_kmeans_separates_blobs():
    pts, labels = tsyn.gaussian_blobs(1500, n_classes=4, d=2, spread=10.0,
                                      scale=0.5, seed=3)
    km = tspec.kmeans(torch.as_tensor(pts), 4,
                      generator=torch.Generator().manual_seed(0))
    assert tspec.clustering_agreement(labels, km.assignments.numpy(), 4) >= 0.99
    assert km.centers.shape == (4, 2) and torch.isfinite(km.inertia)


def test_spectral_clustering_end_to_end():
    pts, labels = tsyn.gaussian_blobs(600, n_classes=3, d=3, spread=10.0,
                                      scale=0.5, seed=1)
    op = tfs.make_normalized_adjacency(tkern.make_kernel("gaussian", sigma=2.0),
                                       pts, tfs.SETUP_2, device="cpu")
    res = tspec.spectral_clustering(
        op, 3, generator=torch.Generator().manual_seed(1), block_size=3)
    assert res.assignments.shape == (600,)
    assert set(res.assignments.tolist()) <= {0, 1, 2}
    assert res.eigenvectors.shape == (600, 3)
    assert float(res.eigenvalues[0]) == pytest.approx(1.0, abs=1e-4)
    assert tspec.clustering_agreement(labels, res.assignments.numpy(), 3) >= 0.95


def test_whole_slice_matches_jax():
    """Quickstart's path at n=2000 (spiral -> normalized adjacency -> eigsh,
    single-vector and block) on both packages with one numpy start vector."""
    n, k = 2000, 10
    pts, _ = tsyn.spiral(n, seed=0)
    rng = np.random.default_rng(11)
    jadj = jfs.make_normalized_adjacency(
        jkern.make_kernel("gaussian", sigma=3.5), jnp.asarray(pts),
        jfs.SETUP_2)
    tadj = tfs.make_normalized_adjacency(
        tkern.make_kernel("gaussian", sigma=3.5), pts, tfs.SETUP_2,
        device="cpu")
    for block_size in (1, 4):
        v0 = rng.normal(size=(n,) if block_size == 1 else (n, block_size))
        want = jlan.eigsh(jadj.matvec, n, k, v0=jnp.asarray(v0),
                          block_size=block_size)
        got = tlan.eigsh(tadj.matvec, n, k, v0=v0, block_size=block_size,
                         device="cpu")
        np.testing.assert_allclose(got.eigenvalues.numpy(),
                                   np.asarray(want.eigenvalues),
                                   rtol=0, atol=1e-10)
        assert torch.isfinite(got.residual_bounds).all()


def test_quickstart_cli_on_cpu(capsys):
    quickstart.main(["--n", "300", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("10 eigenpairs") == 3
    assert "max eigenvalue error vs dense" in out
    assert "spectral clustering" in out
