"""Fused fast-summation operators of the PyTorch port against the JAX package.

The same numpy points are planned and executed by ``repro.core`` (XLA
window backend, CPU, x64) and by ``repro_torch.core`` on the CPU.
Tolerances are relative to the output's largest entry: 1e-12 where both
packages plan and execute, 1e-13 where the port executes the JAX
package's own planned arrays (``fastsum_from_arrays``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastsum as jfs
from repro.core import fastsum_exec as jexec
from repro.core import kernels as jkern
from repro_torch.core import fastsum as tfs
from repro_torch.core import fastsum_exec as texec
from repro_torch.core import kernels as tkern
from repro_torch.data.synthetic import spiral
from repro_torch.device import resolve_device
from repro_torch.kernels import nfft_window as twin

# the module: ``repro_torch.core`` re-exports the function ``lanczos``
# under its name, as ``repro.core`` does
tlan = importlib.import_module("repro_torch.core.lanczos")

KERNELS = [("gaussian", {"sigma": 1.5}), ("laplacian_rbf", {"sigma": 1.0}),
           ("multiquadric", {"c": 1.0}), ("inverse_multiquadric", {"c": 1.0})]
# eps_B defaults to p/N = 3/16: the regularized transition is exercised
JPARAMS = jfs.FastsumParams(n_bandwidth=16, m=3)
TPARAMS = tfs.FastsumParams(n_bandwidth=16, m=3)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max()


def _points(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d))


def _jax_leaves(op) -> dict:
    return {"b_hat": op.b_hat, "multiplier_half": op.multiplier_half,
            "src_window.base": op.src_window.base,
            "src_window.weights": op.src_window.weights,
            "src_window.perm": op.src_window.perm,
            "scaled_src": op.scaled_src, "output_scale": op.output_scale,
            "kernel_at_zero": op.kernel_at_zero, "rho": op.rho}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kname,param", KERNELS)
def test_fused_matvec_tilde_matches(kname, param, d, batched):
    pts = _points(300, d, seed=d)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 3) if batched else (300,))
    jop = jfs.make_fastsum(jkern.make_kernel(kname, **param),
                           jnp.asarray(pts), JPARAMS)
    top = tfs.make_fastsum(tkern.make_kernel(kname, **param), pts, TPARAMS,
                           device="cpu")
    want = np.asarray(jexec.fused_matvec_tilde(
        jop.plan, jop.multiplier_half, jop.src_window, jop.tgt_window,
        jnp.asarray(x), backend="xla"))
    got = texec.fused_matvec_tilde(top.plan, top.multiplier_half,
                                   top.src_window, top.src_window,
                                   torch.as_tensor(x))
    assert got.shape == x.shape and got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-12
    assert top.rho == pytest.approx(float(jop.rho), rel=1e-15)
    assert _rel(top.matvec_tilde(torch.as_tensor(x)).numpy(),
                np.asarray(jop.matvec_tilde(jnp.asarray(x), backend="xla"))) \
        <= 1e-12


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kname,param", KERNELS)
def test_fastsum_from_arrays_executes_jax_plan(kname, param, d):
    pts = _points(250, d, seed=10 + d)
    jop = jfs.make_fastsum(jkern.make_kernel(kname, **param),
                           jnp.asarray(pts), JPARAMS)
    top = tfs.fastsum_from_arrays(
        {k: np.asarray(v) for k, v in _jax_leaves(jop).items()}, TPARAMS,
        device="cpu")
    x = np.random.default_rng(2).normal(size=(250, 2))
    want = np.asarray(jop.matvec(jnp.asarray(x), backend="xla"))
    assert _rel(top.matvec(torch.as_tensor(x)).numpy(), want) <= 1e-13
    assert _rel(top.matvec(torch.as_tensor(x[:, 0])).numpy(), want[:, 0]) \
        <= 1e-13


@pytest.mark.parametrize("setup", ["SETUP_1", "SETUP_2", "SETUP_3"])
def test_degrees_and_normalized_adjacency(setup):
    pts = _points(400, 3, seed=4) * 2.0
    jadj = jfs.make_normalized_adjacency(
        jkern.make_kernel("gaussian", sigma=3.5), jnp.asarray(pts),
        getattr(jfs, setup))
    tadj = tfs.make_normalized_adjacency(
        tkern.make_kernel("gaussian", sigma=3.5), pts, getattr(tfs, setup),
        device="cpu")
    assert _rel(tadj.degrees.numpy(), np.asarray(jadj.degrees)) <= 1e-12
    x = np.random.default_rng(5).normal(size=(400, 4))
    assert _rel(tadj.matvec(torch.as_tensor(x)).numpy(),
                np.asarray(jadj.matvec(jnp.asarray(x)))) <= 1e-12


@pytest.mark.parametrize("m", [9, 16])
def test_windows_over_the_box_budget_match_jax(m):
    """d = 3, N = 32 with m = 9 and 16: windows of 19^3 and 33^3 cells,
    beyond the card kernels' 6,144-cell box (the card cuts them into
    pieces; 33^3 float64 cells would not fit 227 KB of shared memory
    either).  The JAX package takes any m; so does the port, and on the
    CPU it builds no tile plan."""
    pts, _ = spiral(200, seed=0)
    x = np.random.default_rng(m).normal(size=(200, 2))
    jop = jfs.make_fastsum(jkern.make_kernel("gaussian", sigma=3.5),
                           jnp.asarray(pts),
                           jfs.FastsumParams(n_bandwidth=32, m=m, eps_b=0.0))
    before = twin.build_tile_plan.builds
    top = tfs.make_fastsum(tkern.make_kernel("gaussian", sigma=3.5), pts,
                           tfs.FastsumParams(n_bandwidth=32, m=m, eps_b=0.0),
                           device="cpu")
    got = top.matvec(torch.as_tensor(x)).numpy()
    assert twin.build_tile_plan.builds == before
    want = np.asarray(jop.matvec(jnp.asarray(x), backend="xla"))
    assert np.isfinite(got).all() and got.shape == (200, 2)
    assert _rel(got, want) <= 1e-12


def test_dense_oracles_match():
    pts = _points(150, 3, seed=6)
    for kname, param in KERNELS:
        jk, tk = jkern.make_kernel(kname, **param), tkern.make_kernel(kname, **param)
        np.testing.assert_allclose(
            tfs.dense_weight_matrix(tk, torch.as_tensor(pts)).numpy(),
            np.asarray(jfs.dense_weight_matrix(jk, jnp.asarray(pts))),
            rtol=1e-14, atol=1e-14)
    k = (jkern.make_kernel("gaussian", sigma=2.0),
         tkern.make_kernel("gaussian", sigma=2.0))
    np.testing.assert_allclose(
        tfs.dense_normalized_adjacency(k[1], torch.as_tensor(pts)).numpy(),
        np.asarray(jfs.dense_normalized_adjacency(k[0], jnp.asarray(pts))),
        rtol=1e-13, atol=1e-15)


def test_fastsum_operator_approximates_dense():
    """The port's own check: W x against the dense W at SETUP_3 (the
    approximation error of this point set is ~3e-11 relative)."""
    pts = torch.as_tensor(_points(300, 3, seed=8) * 2.0)
    kern = tkern.make_kernel("gaussian", sigma=3.5)
    op = tfs.make_fastsum(kern, pts, tfs.SETUP_3, device="cpu")
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(300,)))
    want = tfs.dense_weight_matrix(kern, pts) @ x
    assert float((op.matvec(x) - want).abs().max() / want.abs().max()) < 1e-9


def test_scale_nodes_rejects_non_finite():
    pts = torch.as_tensor(_points(20, 2))
    pts[3, 1] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        tfs.scale_nodes(pts, 0.0)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    """Without a card the default device raises and names device="cpu";
    nothing continues on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _points(50, 2)
    kern = tkern.make_kernel("gaussian", sigma=1.0)
    calls = [
        lambda: resolve_device(None),
        lambda: tfs.make_fastsum(kern, pts, tfs.SETUP_1),
        lambda: tfs.make_normalized_adjacency(kern, pts, tfs.SETUP_1),
        lambda: tfs.make_fastsum(kern, pts, tfs.SETUP_1, device="cuda"),
        lambda: tlan.eigsh(lambda v: v, 50, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert twin.window_spread.launches == 0
