"""The port's dense kernel direct sum against the JAX package, on the CPU.

``repro_torch.kernels.kernel_matvec`` (CPU tensors take its plain version)
against the Pallas kernel run in interpret mode and against its oracle
``repro.kernels.ref.kernel_matvec_ref``, on the sweeps of
``tests/test_kernels_pallas.py``; and the port's ``direct_matvec_tiled``
against the JAX one.  Tolerances are relative to the output's largest
entry: 1e-12 in float64 and 2e-5 in float32 (the JAX test's own), since
the sums run in another order; ``direct_matvec_tiled`` 1e-12, since the
port evaluates the profile on r^2 and the JAX function on r.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastsum as jfs
from repro.core import kernels as jkern
from repro.kernels import ops, ref
from repro_torch.core import fastsum as tfs
from repro_torch.core import kernels as tkern
from repro_torch.kernels import kernel_matvec as tkm

RNG = np.random.default_rng(11)
KERNELS = [("gaussian", 2.0), ("laplacian_rbf", 0.7), ("multiquadric", 1.0),
           ("inverse_multiquadric", 1.0)]


def _tol(dtype):
    return 2e-5 if dtype == np.float32 else 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _both(a, b, x, kname, param, zero_diagonal=True):
    """(port, Pallas interpret, ref) outputs on the same numpy inputs."""
    port = tkm.kernel_matvec(torch.as_tensor(a), torch.as_tensor(b),
                             torch.as_tensor(x), kernel_name=kname,
                             param=param, zero_diagonal=zero_diagonal)
    pallas = ops.kernel_matvec(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x),
                               kernel_name=kname, param=param,
                               zero_diagonal=zero_diagonal, tile_j=64,
                               tile_i=128, interpret=True)
    oracle = ref.kernel_matvec_ref(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(x), kname, param,
                                   zero_diagonal=zero_diagonal)
    return port.numpy(), np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("n,d,c", [(64, 1, 1), (200, 2, 1), (300, 3, 2),
                                   (257, 3, 1), (128, 2, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_matvec_shapes(n, d, c, dtype):
    pts = RNG.normal(size=(n, d)).astype(dtype)
    x = RNG.normal(size=(n, c)).astype(dtype)
    port, pallas, oracle = _both(pts, pts, x, "gaussian", 1.5)
    assert port.shape == (n, c) and port.dtype == dtype
    assert _rel(port, oracle) < _tol(dtype)
    assert _rel(port, pallas) < _tol(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kname,param", KERNELS)
def test_kernel_matvec_all_kernels(kname, param, dtype):
    pts = RNG.normal(size=(200, 3)).astype(dtype)
    x = RNG.normal(size=(200,)).astype(dtype)
    port, pallas, oracle = _both(pts, pts, x, kname, param)
    assert port.shape == (200,)
    assert _rel(port, oracle) < _tol(dtype)
    assert _rel(port, pallas) < _tol(dtype)


@pytest.mark.parametrize("zero_diagonal", [False, True])
@pytest.mark.parametrize("kname,param", KERNELS)
def test_kernel_matvec_rectangular(kname, param, zero_diagonal):
    """Separate source/target sets (KRR prediction).  With the zero
    diagonal the JAX kernel masks by index even here; so does the port."""
    a = RNG.normal(size=(150, 2))
    b = RNG.normal(size=(220, 2))
    x = RNG.normal(size=(220, 3))
    port, pallas, oracle = _both(a, b, x, kname, param, zero_diagonal)
    assert port.shape == (150, 3)
    assert _rel(port, oracle) < 1e-12
    assert _rel(port, pallas) < 1e-12


@pytest.mark.parametrize("n_out,n_in", [(257, 257), (131, 300), (300, 131)])
def test_kernel_matvec_ragged_row_tiles(monkeypatch, n_out, n_in):
    """Row tiles of the plain version that do not divide n_out, with the
    diagonal crossing tile boundaries (and, for n_out > n_in, running out
    inside a tile)."""
    monkeypatch.setattr(tkm, "_PLAIN_TILE_ELEMS", 37 * n_in * 3)
    a = RNG.normal(size=(n_out, 3))
    b = a[:n_in] if n_in <= n_out else np.concatenate(
        [a, RNG.normal(size=(n_in - n_out, 3))])
    x = RNG.normal(size=(n_in, 2))
    port, pallas, oracle = _both(a, b, x, "laplacian_rbf", 0.7)
    assert _rel(port, oracle) < 1e-12
    assert _rel(port, pallas) < 1e-12


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kname,param", [("gaussian", {"sigma": 1.5}),
                                         ("laplacian_rbf", {"sigma": 1.0}),
                                         ("multiquadric", {"c": 1.0}),
                                         ("inverse_multiquadric", {"c": 1.0})])
def test_direct_matvec_tiled_matches_jax(kname, param, d, batched):
    pts = RNG.normal(size=(300, d))
    x = RNG.normal(size=(300, 2) if batched else (300,))
    want = jfs.direct_matvec_tiled(jkern.make_kernel(kname, **param),
                                   jnp.asarray(pts), jnp.asarray(x), tile=128)
    got = tfs.direct_matvec_tiled(tkern.make_kernel(kname, **param),
                                  torch.as_tensor(pts), torch.as_tensor(x))
    assert got.shape == x.shape
    assert _rel(got.numpy(), want) <= 1e-12


def test_kernel_matvec_rejects_what_it_does_not_take():
    pts = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown kernel"):
        tkm.kernel_matvec(pts, pts, torch.zeros(4, dtype=torch.float64),
                          kernel_name="cauchy")
    with pytest.raises(TypeError):
        tkm.kernel_matvec(pts, pts, torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="x must be"):
        tkm.kernel_matvec(pts, pts, torch.zeros(5, dtype=torch.float64))
    # a device that is neither the CPU nor a card raises: no plain fallback
    meta = torch.zeros((4, 2), dtype=torch.float64, device="meta")
    launches = tkm.kernel_matvec.launches
    with pytest.raises(ValueError, match="no kernel_matvec kernel"):
        tkm.kernel_matvec(meta, meta, torch.zeros(4, dtype=torch.float64,
                                                  device="meta"))
    assert tkm.kernel_matvec.launches == launches
