"""The two-NFFT oracles of the PyTorch port against the JAX package, on the
CPU: the flat geometry, the NFFT and NDFT transforms, and
``FastsumOperator.matvec_tilde_reference``.

Same inputs (numpy, from a seed) through both packages.  Tolerances:
geometry indices and permutation equal, weights and every transform
within 1e-12 of the largest reference entry; NFFT against NDFT at
``tests/test_nfft.py``'s ``TOL[m]``; the fused matvec against the
two-NFFT path within 1e-12 (``tests/test_fastsum_exec.py``'s limit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FastsumParams as JParams
from repro.core import make_fastsum as jmake_fastsum
from repro.core import make_kernel as jmake_kernel
from repro.core import nfft as jnfft
from repro_torch.core import FastsumParams, make_fastsum, make_kernel
from repro_torch.core import nfft as tnfft

TOL = {2: 5e-3, 4: 5e-6, 8: 1e-12}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _setup(d, m, n=150, seed=0):
    n_bw = 16 if d == 3 else 32
    rng = np.random.default_rng(seed + 10 * d + m)
    nodes = rng.uniform(-0.5, 0.5, size=(n, d))
    jplan = jnfft.NfftPlan(d=d, n_bandwidth=n_bw, m=m)
    tplan = tnfft.NfftPlan(d=d, n_bandwidth=n_bw, m=m)
    return (jplan, tplan, nodes, rng, n_bw,
            jnfft.build_geometry(jplan, jnp.asarray(nodes)),
            tnfft.build_geometry(tplan, torch.as_tensor(nodes)))


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_transforms_match_jax(d, m):
    jplan, tplan, nodes, rng, n_bw, jgeom, tgeom = _setup(d, m)
    np.testing.assert_array_equal(tgeom.indices.numpy(),
                                  np.asarray(jgeom.indices))
    np.testing.assert_array_equal(tgeom.perm.numpy(), np.asarray(jgeom.perm))
    assert _rel(tgeom.weights, jgeom.weights) <= 1e-12
    f_hat = (rng.normal(size=(n_bw,) * d + (3,))
             + 1j * rng.normal(size=(n_bw,) * d + (3,)))
    x = rng.normal(size=(nodes.shape[0], 3))
    tn, jn = torch.as_tensor(nodes), jnp.asarray(nodes)
    pairs = [
        (tnfft.nfft_forward(tplan, tgeom, torch.as_tensor(f_hat)),
         jnfft.nfft_forward(jplan, jgeom, jnp.asarray(f_hat))),
        (tnfft.nfft_adjoint(tplan, tgeom, torch.as_tensor(x)),
         jnfft.nfft_adjoint(jplan, jgeom, jnp.asarray(x))),
        (tnfft.nfft_forward(tplan, tgeom, torch.as_tensor(f_hat[..., 0])),
         jnfft.nfft_forward(jplan, jgeom, jnp.asarray(f_hat[..., 0]))),
        (tnfft.nfft_adjoint(tplan, tgeom, torch.as_tensor(x[:, 0])),
         jnfft.nfft_adjoint(jplan, jgeom, jnp.asarray(x[:, 0]))),
        (tnfft.ndft_forward(n_bw, tn, torch.as_tensor(f_hat)),
         jnfft.ndft_forward(n_bw, jn, jnp.asarray(f_hat))),
        (tnfft.ndft_adjoint(n_bw, tn, torch.as_tensor(x)),
         jnfft.ndft_adjoint(n_bw, jn, jnp.asarray(x))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_nfft_matches_ndft(d, m):
    _, plan, nodes, rng, n_bw, _, geom = _setup(d, m)
    tn = torch.as_tensor(nodes)
    f_hat = torch.as_tensor(rng.normal(size=(n_bw,) * d)
                            + 1j * rng.normal(size=(n_bw,) * d))
    assert _rel(tnfft.nfft_forward(plan, geom, f_hat),
                tnfft.ndft_forward(n_bw, tn, f_hat)) < TOL[m]
    x = torch.as_tensor(rng.normal(size=(nodes.shape[0],)))
    assert _rel(tnfft.nfft_adjoint(plan, geom, x),
                tnfft.ndft_adjoint(n_bw, tn, x)) < TOL[m]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_exact_adjointness_and_sort_invariance(d):
    _, plan, nodes, rng, n_bw, _, geom = _setup(d, 4)
    f_hat = torch.as_tensor(rng.normal(size=(n_bw,) * d)
                            + 1j * rng.normal(size=(n_bw,) * d))
    x = torch.as_tensor(rng.normal(size=(nodes.shape[0],))
                        + 1j * rng.normal(size=(nodes.shape[0],)))
    lhs = torch.vdot(tnfft.nfft_forward(plan, geom, f_hat), x)
    rhs = torch.vdot(f_hat.reshape(-1),
                     tnfft.nfft_adjoint(plan, geom, x).reshape(-1))
    assert abs(complex(lhs - rhs)) / abs(complex(lhs)) < 1e-13
    unsorted = tnfft.build_geometry(plan, torch.as_tensor(nodes), sort=False)
    assert unsorted.perm is None
    assert _rel(tnfft.nfft_forward(plan, unsorted, f_hat),
                tnfft.nfft_forward(plan, geom, f_hat)) <= 1e-14


KERNELS = [("gaussian", dict(sigma=3.5), 1), ("gaussian", dict(sigma=3.5), 3),
           ("laplacian_rbf", dict(sigma=2.0), 2),
           ("multiquadric", dict(c=1.0), 2),
           ("inverse_multiquadric", dict(c=1.0), 3)]


@pytest.mark.parametrize("c", [1, 5])
@pytest.mark.parametrize("kname,kw,d", KERNELS)
def test_matvec_tilde_reference_matches_jax_and_fused(kname, kw, d, c):
    rng = np.random.default_rng(3 + d)
    pts = rng.normal(size=(300, d)) * 2.0
    x = rng.normal(size=(300, c) if c > 1 else (300,))
    kw_params = dict(n_bandwidth=16, m=4)
    jop = jmake_fastsum(jmake_kernel(kname, **kw), jnp.asarray(pts),
                        JParams(**kw_params))
    top = make_fastsum(make_kernel(kname, **kw), pts,
                       FastsumParams(**kw_params), device="cpu")
    want = np.asarray(jop.matvec_tilde_reference(jnp.asarray(x)))
    got = top.matvec_tilde_reference(torch.as_tensor(x))
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-12
    assert _rel(top.matvec_tilde(torch.as_tensor(x)).numpy(), got) <= 1e-12
    assert _rel(top.matvec_reference(torch.as_tensor(x)).numpy(),
                np.asarray(jop.matvec_reference(jnp.asarray(x)))) <= 1e-12
    assert top.src_geometry is top.src_geometry  # built once, kept


def test_reference_with_separate_targets_matches_jax():
    rng = np.random.default_rng(8)
    src, tgt = rng.normal(size=(200, 2)), rng.normal(size=(90, 2)) * 1.5
    x = rng.normal(size=(200,))
    params = dict(n_bandwidth=32, m=4)
    jop = jmake_fastsum(jmake_kernel("gaussian", sigma=1.0), jnp.asarray(src),
                        JParams(**params), target_points=jnp.asarray(tgt))
    top = make_fastsum(make_kernel("gaussian", sigma=1.0), src,
                       FastsumParams(**params), target_points=tgt,
                       device="cpu")
    got = top.matvec_tilde_reference(torch.as_tensor(x))
    assert got.shape == (90,)
    assert _rel(got.numpy(),
                np.asarray(jop.matvec_tilde_reference(jnp.asarray(x)))) \
        <= 1e-12
    assert _rel(top.matvec_tilde(torch.as_tensor(x)).numpy(), got) <= 1e-12
    with pytest.raises(ValueError, match="matvec_tilde"):
        top.matvec_reference(torch.as_tensor(x))
