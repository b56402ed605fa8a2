"""Nyström of the PyTorch port against the JAX package, on the CPU.

``jax.random`` cannot be reproduced by torch, so the parity tests draw the
sample permutation and the probe matrix G with ``jax.random`` and hand the
same numbers to the port's private helpers.  Tolerances: eigenvalues
within 1e-9 absolute; eigenvectors within 1e-7 after aligning each one's
sign (every top-k gap here is above 1e-6, so no projector comparison is
needed; the test asserts the gaps).  The traditional method runs with
jitter 1e-6, which brings cond(W̃_XX + jitter I) from ~1.7e9 to ~2.6e7 at
n = 800, L = 200 (asserted below 1e8): its one LU then loses at most ~8
digits in either package.

The behaviour tests repeat ``tests/test_nystrom.py``'s six, with torch
generators and the same tiers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SETUP_2 as JSETUP_2
from repro.core import make_kernel as jmake_kernel
from repro.core import make_normalized_adjacency as jmake_adj
from repro.core import nystrom as jny
from repro_torch.core import SETUP_2, dense_normalized_adjacency, make_kernel
from repro_torch.core import make_normalized_adjacency as tmake_adj
from repro_torch.core import nystrom as tny
from repro_torch.data.synthetic import spiral


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


SIGMA = 3.5
JITTER = 1e-6


@pytest.fixture(scope="module")
def problem():
    """Spiral n = 800 (tests/test_nystrom.py's): points, both packages'
    SETUP_2 operators, and the dense top-10 eigenvalues."""
    pts, _ = spiral(800, seed=4)
    tpts = torch.as_tensor(pts)
    kern = make_kernel("gaussian", sigma=SIGMA)
    ref = torch.linalg.eigvalsh(dense_normalized_adjacency(kern, tpts))
    return {
        "pts": pts, "tpts": tpts, "kern": kern,
        "jkern": jmake_kernel("gaussian", sigma=SIGMA),
        "tadj": tmake_adj(kern, pts, SETUP_2, device="cpu"),
        "jadj": jmake_adj(jmake_kernel("gaussian", sigma=SIGMA),
                          jnp.asarray(pts), JSETUP_2),
        "ref": ref.flip(0)[:10],
    }


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _assert_pairs_match(got, want):
    lam_t, lam_j = got.eigenvalues.numpy(), np.asarray(want.eigenvalues)
    assert np.abs(lam_t - lam_j).max() <= 1e-9
    assert np.abs(np.diff(lam_j)).min() > 1e-6  # simple: compare vectors
    vec_t, vec_j = got.eigenvectors.numpy(), np.asarray(want.eigenvectors)
    sign = np.sign((vec_t * vec_j).sum(axis=0))
    assert np.abs(vec_t * sign - vec_j).max() <= 1e-7


@pytest.mark.parametrize("l_size,key", [(200, 0), (80, 2)])
def test_traditional_matches_jax(problem, l_size, key):
    n = problem["pts"].shape[0]
    perm = np.array(jax.random.permutation(jax.random.PRNGKey(key), n))
    sample = problem["pts"][perm[:l_size]]
    w = np.exp(-((sample[:, None] - sample[None]) ** 2).sum(-1) / SIGMA ** 2)
    eig = np.linalg.eigvalsh(w + JITTER * np.eye(l_size))
    assert eig[-1] / eig[0] < 1e8
    want = jny.nystrom_traditional(problem["jkern"],
                                   jnp.asarray(problem["pts"]), 10, l_size,
                                   key=jax.random.PRNGKey(key), jitter=JITTER)
    got = tny._traditional_from_perm(problem["kern"], problem["tpts"], 10,
                                     l_size, torch.as_tensor(perm), JITTER)
    _assert_pairs_match(got, want)


@pytest.mark.parametrize("l_size,rank,key", [(20, 10, 4), (50, 10, 1),
                                             (50, 50, 1), (30, 8, 3)])
def test_hybrid_matches_jax(problem, l_size, rank, key):
    k = min(rank, 10)
    n = problem["pts"].shape[0]
    want = jny.nystrom_gaussian_nfft(problem["jadj"], k, num_columns=l_size,
                                     rank=rank, key=jax.random.PRNGKey(key))
    g = np.array(jax.random.normal(jax.random.PRNGKey(key), (n, l_size),
                                   dtype=jnp.float64))
    got = tny._hybrid_from_probes(problem["tadj"], k, torch.as_tensor(g),
                                  rank, None)
    _assert_pairs_match(got, want)


def test_kernel_block_matches_explicit_differences():
    rng = np.random.default_rng(0)
    rows, cols = rng.normal(size=(7, 3)), rng.normal(size=(1000, 3))
    kern = make_kernel("gaussian", sigma=1.3)
    want = np.exp(-((rows[:, None] - cols[None]) ** 2).sum(-1) / 1.3 ** 2)
    old = tny._BLOCK_ELEMS
    try:
        tny._BLOCK_ELEMS = 7 * 3 * 64  # 16 chunks of 64 columns
        got = tny._kernel_block(kern, torch.as_tensor(rows),
                                torch.as_tensor(cols))
    finally:
        tny._BLOCK_ELEMS = old
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


def test_generators_default_and_reproduce(problem):
    a = tny.nystrom_gaussian_nfft(problem["tadj"], 5, num_columns=20)
    b = tny.nystrom_gaussian_nfft(problem["tadj"], 5, num_columns=20,
                                  generator=_gen(0))
    assert torch.equal(a.eigenvalues, b.eigenvalues)
    c = tny.nystrom_traditional(problem["kern"], problem["tpts"], 5, 100)
    d = tny.nystrom_traditional(problem["kern"], problem["tpts"], 5, 100,
                                generator=_gen(0))
    assert torch.equal(c.eigenvectors, d.eigenvectors)


# ------------------------------------------------ tests/test_nystrom.py's six
def test_traditional_nystrom_reasonable_at_large_l(problem):
    res = tny.nystrom_traditional(problem["kern"], problem["tpts"], 10,
                                  800 // 4, generator=_gen(0))
    err = float((res.eigenvalues - problem["ref"]).abs().max())
    assert err < 0.5, err  # paper: averages above 1e-2 even at L = n/4


def test_hybrid_beats_traditional_at_small_l(problem):
    hybrid = tny.nystrom_gaussian_nfft(problem["tadj"], 10, num_columns=50,
                                       rank=10, generator=_gen(1))
    err_h = float((hybrid.eigenvalues - problem["ref"]).abs().max())
    trad = tny.nystrom_traditional(problem["kern"], problem["tpts"], 10,
                                   800 // 10, generator=_gen(2))
    err_t = float((trad.eigenvalues - problem["ref"]).abs().max())
    assert err_h < 1e-2, err_h
    assert err_h < err_t, (err_h, err_t)


def test_hybrid_eigenvectors_orthonormal():
    pts, _ = spiral(500, seed=4)
    adj = tmake_adj(make_kernel("gaussian", sigma=SIGMA), pts, SETUP_2,
                    device="cpu")
    res = tny.nystrom_gaussian_nfft(adj, 8, num_columns=30, rank=8,
                                    generator=_gen(3))
    gram = res.eigenvectors.T @ res.eigenvectors
    np.testing.assert_allclose(gram.numpy(), np.eye(8), atol=1e-10)


class _DenseSymOp:
    """Duck-typed stand-in for NormalizedAdjacencyOperator."""

    def __init__(self, a):
        self.a = a
        self.inv_sqrt_deg = torch.ones(a.shape[0], dtype=a.dtype)

    @property
    def n(self):
        return self.a.shape[0]

    def matvec(self, x):
        return self.a @ x


def test_hybrid_truncates_tiny_trailing_sigma():
    """Rank-5 operator sketched at rank 15: the trailing Ritz values of
    Q^T A Q sit at round-off, and unguarded 1/sigma would poison the core
    matrix; the truncation keeps the top block exact, the rest 0."""
    rng = np.random.default_rng(0)
    n = 200
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    vals = np.zeros(n)
    vals[:5] = [1.0, 0.8, 0.6, 0.4, 0.2]
    op = _DenseSymOp(torch.as_tensor(q @ np.diag(vals) @ q.T))
    res = tny.nystrom_gaussian_nfft(op, 8, num_columns=20, rank=15,
                                    generator=_gen(0))
    ev = res.eigenvalues.numpy()
    assert np.all(np.isfinite(ev))
    np.testing.assert_allclose(ev[:5], vals[:5], atol=1e-10)
    np.testing.assert_allclose(ev[5:], 0.0, atol=1e-10)


def test_hybrid_indefinite_cancellation_guard(problem):
    """rank == num_columns drives the sketch into the cancellation band,
    where an unguarded 1/sigma once injected an eigenvalue ~3.8: every
    returned eigenvalue stays in A's spectral range and the top ten stay
    accurate."""
    res = tny.nystrom_gaussian_nfft(problem["tadj"], 10, num_columns=50,
                                    rank=50, generator=_gen(1))
    assert float(res.eigenvalues.abs().max()) <= 1.01
    err = float((res.eigenvalues - problem["ref"]).abs().max())
    assert err < 1e-2, err


def test_hybrid_l20_tier(problem):
    res = tny.nystrom_gaussian_nfft(problem["tadj"], 10, num_columns=20,
                                    rank=10, generator=_gen(4))
    err = float((res.eigenvalues - problem["ref"]).abs().max())
    assert err < 5e-2, err  # paper: L=20 gives errors ~1e-3..1e-2
