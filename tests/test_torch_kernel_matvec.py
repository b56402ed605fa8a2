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

import jax
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
from repro_torch.launch.roofline import TraceCounter

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


def _emulate_kernel(a, b, x, kname, param, zero_diagonal, splits):
    """The CUDA kernel's summation order, in PyTorch on the CPU: the
    sources cut into runs of ``split_length(n_in, splits)``; in a run, tiles
    of SOURCE_TILE sources, each tile's sources added one by one into a
    partial sum, the partial sums added in tile order; the runs' sums
    added in split order.  Rows are independent (R rows a thread changes
    nothing in a row's sum), so all rows go at once."""
    a, b, x = (torch.as_tensor(t) for t in (a, b, x))
    x2 = x[:, None] if x.ndim == 1 else x
    n_out, n_in = a.shape[0], b.shape[0]
    step = tkm.split_length(n_in, splits)
    total = None
    for i_begin in range(0, n_in, step):
        i_end = min(n_in, i_begin + step)
        acc = torch.zeros((n_out, x2.shape[1]), dtype=x.dtype)
        for i0 in range(i_begin, i_end, tkm.SOURCE_TILE):
            part = torch.zeros_like(acc)
            for j in range(i0, min(i_end, i0 + tkm.SOURCE_TILE)):
                r2 = torch.zeros(n_out, dtype=x.dtype)
                for m in range(a.shape[1]):
                    r2 = r2 + (a[:, m] - b[j, m]) ** 2
                w = tkm.kernel_profile_r2(r2, kname, param)
                if zero_diagonal and j < n_out:
                    w[j] = 0.0
                part += w[:, None] * x2[j]
            acc += part
        total = acc if total is None else total + acc
    return (total[:, 0] if x.ndim == 1 else total).numpy()


@pytest.mark.parametrize("splits", ["chosen", 1, 3])
@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("n_out,n_in,d,c", [(300, 300, 3, 1),
                                            (150, 220, 2, 3)])
@pytest.mark.parametrize("kname,param", KERNELS)
def test_split_summation_order_matches_jax(kname, param, n_out, n_in, d, c,
                                           zero_diagonal, splits):
    """float64, square and rectangular, against the Pallas kernel in
    interpret mode and the oracle; "chosen" is choose_splits' S for a card
    of 4 SMs (5 and 4 splits here)."""
    if splits == "chosen":
        splits = tkm.choose_splits(n_out, n_in, d, c, 4)
        assert splits > 3
    a = RNG.normal(size=(n_out, d))
    b = a if n_out == n_in else RNG.normal(size=(n_in, d))
    x = RNG.normal(size=(n_in, c) if c > 1 else (n_in,))
    got = _emulate_kernel(a, b, x, kname, param, zero_diagonal, splits)
    port, pallas, oracle = _both(a, b, x, kname, param, zero_diagonal)
    assert got.shape == port.shape
    assert _rel(got, oracle) < 1e-12
    assert _rel(got, pallas) < 1e-12
    assert _rel(got, port) < 1e-12


def test_split_summation_order_float32_matches_jax():
    a = RNG.normal(size=(200, 3)).astype(np.float32)
    x = RNG.normal(size=(200, 2)).astype(np.float32)
    for splits in (1, tkm.choose_splits(200, 200, 3, 2, 8)):
        got = _emulate_kernel(a, a, x, "laplacian_rbf", 0.7, True, splits)
        port, pallas, oracle = _both(a, a, x, "laplacian_rbf", 0.7)
        assert got.dtype == np.float32
        assert _rel(got, oracle) < _tol(np.float32)
        assert _rel(got, pallas) < _tol(np.float32)


@pytest.mark.parametrize("sm_count", [132, 114, 66])
@pytest.mark.parametrize("n_out,n_in,d,c", [(8000, 8000, 3, 1),
                                            (8000, 8000, 3, 4),
                                            (400, 10_000, 2, 1),
                                            (100_000, 100_000, 2, 1),
                                            (5000, 5000, 5, 8)])
def test_choose_splits_fills_the_card(n_out, n_in, d, c, sm_count):
    """The guard path's n = 8000 and KRR's 400 x 10^4 run many (row block,
    split) blocks, at least one per SM; the split length is a whole number
    of tiles and no split is empty."""
    s = tkm.choose_splits(n_out, n_in, d, c, sm_count)
    row_blocks = -(-n_out // (tkm.BLOCK_THREADS
                               * tkm.rows_per_thread(c, d)))
    assert 1 <= s <= tkm.MAX_SPLITS
    assert s * row_blocks >= sm_count
    if row_blocks < sm_count:
        assert s > 1
    step = tkm.split_length(n_in, s)
    assert step % tkm.SOURCE_TILE == 0
    assert (s - 1) * step < n_in <= s * step
    assert s * n_out * c <= max(tkm.SCRATCH_ELEMS, n_out * c)


@pytest.mark.parametrize("n,c", [(1_000_000, 1), (300_000, 4),
                                 (2_000_000, 9)])
def test_choose_splits_is_one_where_row_blocks_fill_the_card(n, c):
    row_blocks = -(-n // (tkm.BLOCK_THREADS * tkm.rows_per_thread(c, 3)))
    assert row_blocks >= tkm.BLOCKS_PER_SM * 132
    assert tkm.choose_splits(n, n, 3, c, 132) == 1
    assert tkm.split_length(n, 1) >= n


SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_120kernel_matvec_kernelIdLi3ELi0ELi1ELi4EEEvPKT_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   DADD R2, R4, -R6 ;
.L_x_1:
        /*0020*/                   LDS.64 R8, [R3] ;
        /*0030*/                   DADD R10, R12, -R8 ;
        /*0040*/                   DFMA R14, R10, R10, R14 ;
        /*0050*/              @!P0 BRA `(.L_x_2) ;
        /*0060*/                   DMUL R16, R14, R18 ;
        /*0070*/                   DSETP.GEU.AND P1, PT, |R16|, 708, PT ;
        /*0080*/               @P2 BRA `(.L_x_1) ;
        /*0090*/                   DFMA R20, R20, R20, R20 ;
        /*00a0*/               @P3 BRA 0x10 ;
.L_x_2:
        /*00b0*/                   BRA `(.L_x_1) ;
        /*00c0*/                   EXIT ;
"""


def test_time_kernel_matvec_counts_the_pair_loop(monkeypatch, tmp_path):
    """The SASS reader resolves labels, and the pair loop is the smallest
    span closed by a conditional backward branch (the unconditional jump
    back from out-of-line code is not a loop)."""
    from repro_torch.launch import time_kernel_matvec as tkt
    monkeypatch.setattr(tkt.subprocess, "run", lambda *a, **k: type(
        "P", (), {"stdout": SASS})())
    funcs = tkt.sass_functions(tmp_path / "lib.so")
    (name,) = funcs
    ops, lines = tkt.pair_loop(funcs[name])
    assert ops == {"LDS": 1, "DADD": 1, "DFMA": 1, "BRA": 2, "DMUL": 1,
                   "DSETP": 1}
    assert lines[0].startswith("/*0020*/ LDS") and "0x20" in lines[-1]
    assert tkt.pairs(400, 10_000, False) == 4_000_000
    assert tkt.pairs(8000, 8000, True) == 8000 * 7999
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            tkt.main([])


def test_kernel_matvec_rejects_what_it_does_not_take():
    pts = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown kernel"):
        tkm.kernel_matvec(pts, pts, torch.zeros(4, dtype=torch.float64),
                          kernel_name="cauchy")
    with pytest.raises(TypeError):
        tkm.kernel_matvec(pts, pts, torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="x must be"):
        tkm.kernel_matvec(pts, pts, torch.zeros(5, dtype=torch.float64))
    # meta (the dry run) takes no plain fallback: a meta result of the
    # kernel's shape, nothing computed, the launch counted by the trace
    # counter and not as one on the card
    meta = torch.zeros((4, 2), dtype=torch.float64, device="meta")
    launches = tkm.kernel_matvec.launches
    with TraceCounter() as counter:
        y = tkm.kernel_matvec(meta, meta, torch.zeros(
            4, dtype=torch.float64, device="meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (4,)
    assert counter.kernels["kernel_matvec"]["launches"] == 1
    assert tkm.kernel_matvec.launches == launches


@pytest.mark.parametrize("kname,param", KERNELS)
def test_reference_direct_sum_has_no_points_or_parameter_gradient(kname,
                                                                  param):
    """Pins the reference's behaviour, which the port's CUDA direct sum
    follows by raising (test_torch_gpu.py::
    test_kernel_matvec_refuses_grad_on_card): ``jax.grad`` of
    <w, direct_matvec_tiled(k, p, x)> in the points is NaN in every entry
    (the diagonal is masked after sqrt(max(r^2, 0)), whose derivative at
    r^2 = 0 is inf, times a zero cotangent), and the kernel is a static
    argument, so a traced kernel parameter cannot go in at all."""
    rng = np.random.default_rng(0)
    p, x, w = (jnp.asarray(rng.normal(size=s)) for s in ((50, 2), 50, 50))
    key = "sigma" if kname in ("gaussian", "laplacian_rbf") else "c"
    kern = jkern.make_kernel(kname, **{key: param})
    g = jax.grad(lambda q: w @ jfs.direct_matvec_tiled(kern, q, x,
                                                        tile=16))(p)
    assert bool(jnp.isnan(g).all())
    with pytest.raises(ValueError, match="Non-hashable static arguments"):
        jax.grad(lambda s: w @ jfs.direct_matvec_tiled(
            jkern.make_kernel(kname, **{key: s}), p, x, tile=16))(param)
