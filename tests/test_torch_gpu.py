"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips (inside the ``cuda`` fixture) when no card
is present.  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the largest output entry: spread 1e-12 (f64) /
1e-4 (f32), since its tiles' boxes land on the grid with atomics in a
varying order (its deterministic mode adds them in an order its schedule
fixes, and is held to the same tolerance and to bitwise repeats); gather
1e-13 / 1e-5 (another order of the window's sum);
kernel_matvec 1e-12 / 1e-4 (its sums run in another order than the plain
version's matrix product, and float32 exp/sqrt differ by an ulp or two).
flash_attention, elementwise |k - p| <= atol + rtol |p|: float32 2e-5
absolute, the JAX kernel tests' own limit (tests/test_kernels_pallas.py);
bfloat16 and float16 two ulps of the output dtype (rtol 2^-6 and 2^-9,
atol 2e-5), since both sides sum in float32 and round once.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_dist_cases as dist_cases
import _torch_shard_cases as shard_cases
import _torch_wide_cases as wide
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import fastsum as tfs
from repro_torch.core import fastsum_exec as texec
from repro_torch.core import nystrom as tny
from repro_torch.core.kernels import make_kernel
from repro_torch.core.nfft import build_window_geometry, padded_grid_size
from repro_torch.data.synthetic import crescent_fullmoon, spiral
from repro_torch.graph import krr as tkrr
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.device import resolve_device
from repro_torch.kernels import nfft_window as twin
from repro_torch.launch import serve as tserve
from repro_torch.launch import trace_serve as ttrace
from repro_torch.launch.ranks import RankPool
from repro_torch.models import model as tmodel
from repro_torch.runtime import guards as tguards
from repro_torch.serving import graph as tgraph
from repro_torch.serving.engine import Request, ServeEngine

pytestmark = pytest.mark.gpu

TOL = {("spread", torch.float64): 1e-12, ("spread", torch.float32): 1e-4,
       ("gather", torch.float64): 1e-13, ("gather", torch.float32): 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def _geometry(setup, d, n, dtype, device):
    pts, _ = spiral(n, seed=d)
    pts = torch.as_tensor(pts[:, :d], device=device)
    scaled, _, _ = tfs.scale_nodes(pts, setup.eps_b_eff)
    plan = setup.nfft_plan(d)
    geom = build_window_geometry(plan, scaled)
    return plan, geom.base, geom.weights.to(dtype)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("setup", ["SETUP_2", "SETUP_3"])
def test_kernels_match_plain(cuda, setup, d, c, dtype):
    plan, base, w = _geometry(getattr(tfs, setup), d, 3000, dtype, cuda)
    pad = padded_grid_size(plan)
    gen = torch.Generator(device=cuda).manual_seed(d + c)
    x = torch.randn((base.shape[0], c), generator=gen, dtype=dtype,
                    device=cuda)
    g = torch.randn((pad,) * d + (c,), generator=gen, dtype=dtype,
                    device=cuda)
    spread_launches = twin.window_spread.launches
    got_s = twin.window_spread(x, base, w, padded_size=pad)
    got_g = twin.window_gather(g, base, w)
    torch.cuda.synchronize()
    assert twin.window_spread.launches == spread_launches + 1
    assert _rel(got_s, twin.window_spread_plain(x, base, w, padded_size=pad)) \
        <= TOL[("spread", dtype)]
    assert _rel(got_g, twin.window_gather_plain(g, base, w)) \
        <= TOL[("gather", dtype)]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_adjoint_identity_on_card(cuda, d):
    plan, base, w = _geometry(tfs.SETUP_3, d, 3000, torch.float64, cuda)
    pad = padded_grid_size(plan)
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((base.shape[0], 2), generator=gen, dtype=torch.float64,
                    device=cuda)
    g = torch.randn((pad,) * d + (2,), generator=gen, dtype=torch.float64,
                    device=cuda)
    lhs = float((twin.window_gather(g, base, w) * x).sum())
    rhs = float((g * twin.window_spread(x, base, w, padded_size=pad)).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def _stress_geometry(kind, setup, d, n, device):
    """Geometries that stress the tile plan: uniform random nodes, the
    spiral unsorted, and the SSL path's crescent-fullmoon (N=128, m=3)."""
    if kind == "ssl":
        pts, _ = crescent_fullmoon(n, seed=0)
        params = tfs.FastsumParams(n_bandwidth=128, m=3, eps_b=0.0)
    else:
        if kind == "uniform":
            pts = np.random.default_rng(0).uniform(-1, 1, (n, d))
        else:
            pts, _ = spiral(n, seed=d)
        params = getattr(tfs, setup)
    pts = torch.as_tensor(pts[:, :d], device=device)
    scaled, _, _ = tfs.scale_nodes(pts, params.eps_b_eff)
    plan = params.nfft_plan(d)
    return plan, build_window_geometry(plan, scaled,
                                       sort=kind != "unsorted")


STRESS = [("uniform", "SETUP_3", 3, 4), ("unsorted", "SETUP_3", 3, 4),
          ("unsorted", "SETUP_2", 1, 4), ("ssl", None, 2, 4),
          ("spiral", "SETUP_3", 3, 16), ("spiral", "SETUP_2", 2, 16)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind,setup,d,c", STRESS)
def test_kernels_match_plain_on_stress_geometries(cuda, kind, setup, d, c,
                                                  dtype):
    plan, geom = _stress_geometry(kind, setup, d, 5000, cuda)
    pad = padded_grid_size(plan)
    base, w, tiles = geom.base, geom.weights.to(dtype), geom.tiles
    gen = torch.Generator(device=cuda).manual_seed(d + c)
    x = torch.randn((base.shape[0], c), generator=gen, dtype=dtype,
                    device=cuda)
    g = torch.randn((pad,) * d + (c,), generator=gen, dtype=dtype,
                    device=cuda)
    launches = (twin.window_spread.launches, twin.window_gather.launches)
    got_s = twin.window_spread(x, base, w, padded_size=pad, tiles=tiles)
    got_g = twin.window_gather(g, base, w, tiles=tiles)
    torch.cuda.synchronize()
    assert (twin.window_spread.launches,
            twin.window_gather.launches) == (launches[0] + 1,
                                             launches[1] + 1)
    assert _rel(got_s, twin.window_spread_plain(x, base, w, padded_size=pad)) \
        <= TOL[("spread", dtype)]
    assert _rel(got_g, twin.window_gather_plain(g, base, w)) \
        <= TOL[("gather", dtype)]


@pytest.mark.parametrize("kind,setup,d,c", STRESS)
def test_adjoint_identity_on_stress_geometries(cuda, kind, setup, d, c):
    plan, geom = _stress_geometry(kind, setup, d, 5000, cuda)
    pad = padded_grid_size(plan)
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn((geom.base.shape[0], c), generator=gen,
                    dtype=torch.float64, device=cuda)
    g = torch.randn((pad,) * d + (c,), generator=gen, dtype=torch.float64,
                    device=cuda)
    lhs = float((twin.window_gather(g, geom.base, geom.weights,
                                    tiles=geom.tiles) * x).sum())
    rhs = float((g * twin.window_spread(x, geom.base, geom.weights,
                                        padded_size=pad,
                                        tiles=geom.tiles)).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,d,taps,padded,c", [
    (1, 3, 15, 40, 1), (37, 2, 9, 64, 3), (300, 1, 301, 700, 2),
    (300, 2, 21, 64, 4), (200, 3, 17, 48, 5), (500, 3, 5, 40, 16),
    (60, 3, 19, 40, 2), (20, 3, 33, 50, 1), (40, 2, 79, 100, 3)])
def test_kernels_match_plain_on_random_windows(cuda, n, d, taps, padded, c,
                                               dtype):
    """Random corners and weights: ragged and single-row tiles, windows
    wider than a warp's plane block (d = 2, taps 21; d = 1, taps 301, with
    fewer rows a tile), ragged channel passes, and windows over the box
    budget, cut into slabs (d = 3, taps 19 and 33; d = 2, taps 79)."""
    rng = np.random.default_rng(n + d)
    base = torch.as_tensor(rng.integers(0, padded - taps + 1, (n, d)),
                           dtype=torch.int32, device=cuda)
    w = torch.as_tensor(rng.normal(size=(n, d, taps)), dtype=dtype,
                        device=cuda)
    x = torch.as_tensor(rng.normal(size=(n, c)), dtype=dtype, device=cuda)
    g = torch.as_tensor(rng.normal(size=(padded,) * d + (c,)), dtype=dtype,
                        device=cuda)
    assert _rel(twin.window_spread(x, base, w, padded_size=padded),
                twin.window_spread_plain(x, base, w, padded_size=padded)) \
        <= TOL[("spread", dtype)]
    assert _rel(twin.window_gather(g, base, w),
                twin.window_gather_plain(g, base, w)) \
        <= TOL[("gather", dtype)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("m", [9, 16])
def test_windows_over_the_box_budget_match_plain(cuda, m, c, dtype):
    """d = 3, N = 32, m = 9 and 16 (taps 19 and 33): every window is cut
    into slabs, one tile each; the spread adds each slab's cells, the
    gather sums a node's slabs in order."""
    params = tfs.FastsumParams(n_bandwidth=32, m=m, eps_b=0.0)
    plan, base, w = _geometry(params, 3, 3000, dtype, cuda)
    pad = padded_grid_size(plan)
    tiles = twin.build_tile_plan(base, plan.taps)
    assert tiles.max_rows == 1 and tiles.n_tiles > base.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(m + c)
    x = torch.randn((base.shape[0], c), generator=gen, dtype=dtype,
                    device=cuda)
    g = torch.randn((pad,) * 3 + (c,), generator=gen, dtype=dtype,
                    device=cuda)
    got_s = twin.window_spread(x, base, w, padded_size=pad, tiles=tiles)
    got_g = twin.window_gather(g, base, w, tiles=tiles)
    assert _rel(got_s, twin.window_spread_plain(x, base, w, padded_size=pad)) \
        <= TOL[("spread", dtype)]
    assert _rel(got_g, twin.window_gather_plain(g, base, w)) \
        <= TOL[("gather", dtype)]
    assert torch.equal(got_g, twin.window_gather(g, base, w, tiles=tiles))
    if dtype == torch.float64:
        lhs = float((got_g * x).sum())
        rhs = float((g * got_s).sum())
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


@pytest.mark.parametrize("m", [9, 16])
def test_fastsum_with_wide_windows_on_card_matches_cpu(cuda, m):
    pts, _ = spiral(200, seed=0)
    kern = make_kernel("gaussian", sigma=3.5)
    params = tfs.FastsumParams(n_bandwidth=32, m=m, eps_b=0.0)
    x = np.random.default_rng(m).normal(size=(200, 2))
    got = tfs.make_fastsum(kern, pts, params, device=cuda).matvec(
        torch.as_tensor(x, device=cuda)).cpu()
    want = tfs.make_fastsum(kern, pts, params, device="cpu").matvec(
        torch.as_tensor(x))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c", [1, 5, 16])
@pytest.mark.parametrize("setup,d,m", [("SETUP_2", 3, None),
                                       ("SETUP_3", 3, None),
                                       ("SETUP_3", 2, None),
                                       ("SETUP_3", 1, None),
                                       ("SETUP_2", 3, 9)])
def test_deterministic_spread_repeats_bitwise_and_matches_plain(
        cuda, setup, d, m, c, dtype):
    """Under torch.use_deterministic_algorithms, window_spread takes the
    two-phase kernel: five runs are bitwise equal, within the spread's
    tolerance of plain, and counted apart from the atomic launches."""
    params = getattr(tfs, setup) if m is None else tfs.FastsumParams(
        n_bandwidth=32, m=m, eps_b=0.0)
    plan, base, w = _geometry(params, d, 3000, dtype, cuda)
    pad = padded_grid_size(plan)
    tiles = twin.build_tile_plan(base, plan.taps)
    x = torch.randn((base.shape[0], c), dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(c))
    atomic, det = (twin.window_spread.launches,
                   twin.window_spread_deterministic.launches)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        outs = [twin.window_spread(x, base, w, padded_size=pad, tiles=tiles)
                for _ in range(5)]
    finally:
        torch.use_deterministic_algorithms(prev)
    assert twin.window_spread.launches == atomic
    assert twin.window_spread_deterministic.launches == det + 5
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = twin.window_spread_plain(x, base, w, padded_size=pad)
    assert _rel(outs[0], want) <= TOL[("spread", dtype)]
    index = twin.spread_block_index(tiles, pad, c, x.element_size())
    assert (twin.window_spread_deterministic.scratch_bytes
            == index.scratch_cells * c * x.element_size()
            <= twin.DET_SCRATCH_BYTES)


def _det_repeats(x, base, w, pad, tiles, reps=5):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return [twin.window_spread(x, base, w, padded_size=pad, tiles=tiles)
                for _ in range(reps)]
    finally:
        torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["waves", "long lists"])
def test_deterministic_spread_in_waves_and_over_many_chunks(
        cuda, case, dtype, monkeypatch):
    """The scratch cap cut to force at least three waves (later waves add
    onto the grid), and output blocks whose tile lists span many chunks
    (nodes crowded on a few corners: partials summed by the last chunk to
    arrive): five runs bitwise equal, within the spread's tolerance of
    plain, scratch within the cap, arrival counters left at zero."""
    c = 5
    if case == "waves":
        plan, base, w = _geometry(tfs.SETUP_2, 3, 3000, dtype, cuda)
        pad = padded_grid_size(plan)
        taps = plan.taps
    else:
        taps, pad = 9, 48
        base = torch.randint(20, 24, (20_000, 3), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3))
        base = base.to(cuda)
        w = torch.rand((20_000, 3, taps), dtype=dtype, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(4))
    tiles = twin.build_tile_plan(base, taps)
    cells = tiles.table[:, 5:8].to(torch.long).prod(dim=1)
    if case == "waves":
        cap = max(int(cells.max()), int(cells.sum()) // 4) * c * 8
        monkeypatch.setattr(twin, "DET_SCRATCH_BYTES", cap)
    x = torch.randn((base.shape[0], c), dtype=dtype, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(c))
    outs = _det_repeats(x, base, w, pad, tiles)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = twin.window_spread_plain(x, base, w, padded_size=pad)
    assert _rel(outs[0], want) <= TOL[("spread", dtype)]
    index = twin.spread_block_index(tiles, pad, c, x.element_size())
    if case == "waves":
        assert index.n_waves >= 3
    else:
        assert int(index.chunks[:, 4].max()) >= 8
    assert (twin.window_spread_deterministic.scratch_bytes
            <= twin.DET_SCRATCH_BYTES)
    assert int(index.arrivals.abs().sum()) == 0


def test_deterministic_spread_raises_instead_of_falling_back(cuda):
    """An output-block index whose waves stop one tile short of the plan:
    the kernel refuses the call before any launch, and the wrapper
    raises."""
    plan, base, w = _geometry(tfs.SETUP_2, 3, 500, torch.float64, cuda)
    pad = padded_grid_size(plan)
    x = torch.randn((500, 1), dtype=torch.float64, device=cuda)
    tiles = twin.build_tile_plan(base, plan.taps)
    index = twin.spread_block_index(tiles, pad, 1, 8)
    waves = index.waves.clone()
    waves[-1, 1] -= 1
    key = (pad, twin.det_wave_cells(1, 8), index.side)
    assert tiles.block_index[key] is index
    tiles.block_index[key] = dataclasses.replace(index, waves=waves)
    grid = torch.zeros((pad,) * 3 + (1,), dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError, match="deterministic window_spread"):
        twin.window_spread_deterministic(x, base, w, grid, tiles)
    assert int(grid.abs().sum()) == 0


def test_durable_cg_on_card_resumes_bitwise(cuda, tmp_path):
    """A resumable CG over a fastsum operator on the card, killed twice,
    equals the uninterrupted run and plain cg under the switch."""
    from repro_torch.core import solvers as tsol
    from repro_torch.runtime import (
        DurablePolicy, KillSchedule, durable, resumable_solve)
    pts, _ = spiral(4000, seed=0)
    op = tfs.make_normalized_adjacency(make_kernel("gaussian", sigma=3.5),
                                       pts, tfs.SETUP_2, device=cuda)
    mv = lambda v: 2.0 * v - op.matvec(v)
    b = torch.randn((4000, 2), dtype=torch.float64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    with durable.deterministic():
        ref = tsol.cg(mv, b, tol=1e-10, maxiter=200).x
    det = twin.window_spread_deterministic.launches
    sol, rep = resumable_solve(mv, b, ckpt_dir=str(tmp_path), tol=1e-10,
                               maxiter=200,
                               policy=DurablePolicy(snapshot_every=4),
                               fault_hook=KillSchedule((5, 11)))
    assert rep.restarts == 2
    assert twin.window_spread_deterministic.launches > det
    assert torch.equal(sol.x, ref)


def test_gather_is_deterministic_and_wrappers_build_a_plan(cuda):
    plan, geom = _stress_geometry("spiral", "SETUP_3", 3, 5000, cuda)
    pad = padded_grid_size(plan)
    g = torch.randn((pad,) * 3 + (2,), dtype=torch.float64, device=cuda)
    first = twin.window_gather(g, geom.base, geom.weights, tiles=geom.tiles)
    again = twin.window_gather(g, geom.base, geom.weights)  # plan built here
    assert torch.equal(first, again)


def test_matvec_on_card_matches_cpu(cuda):
    pts, _ = spiral(2000, seed=0)
    kern = make_kernel("gaussian", sigma=3.5)
    x = np.random.default_rng(0).normal(size=(2000, 3))
    on_card = tfs.make_fastsum(kern, pts, tfs.SETUP_2, device=cuda)
    on_cpu = tfs.make_fastsum(kern, pts, tfs.SETUP_2, device="cpu")
    got = on_card.matvec(torch.as_tensor(x, device=cuda)).cpu()
    want = on_cpu.matvec(torch.as_tensor(x))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("weights", ["window", "random"])
@pytest.mark.parametrize("c", [20, 50])
def test_kernels_match_plain_at_probe_widths(cuda, c, weights, dtype):
    """C = L, the hybrid Nyström's probe blocks (L = 20 and 50): neither is
    a multiple of the spread's 4- or the gather's 8-channel pass, so the
    last pass runs padded; with the geometry's own weights and with seeded
    standard normal ones.  The adjoint identity at float64."""
    plan, base, w = _geometry(tfs.SETUP_2, 3, 20000, dtype, cuda)
    if weights == "random":
        w = torch.randn(w.shape, dtype=dtype, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9))
    pad = padded_grid_size(plan)
    tiles = twin.build_tile_plan(base, plan.taps)
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn((base.shape[0], c), generator=gen, dtype=dtype,
                    device=cuda)
    g = torch.randn((pad,) * 3 + (c,), generator=gen, dtype=dtype,
                    device=cuda)
    got_s = twin.window_spread(x, base, w, padded_size=pad, tiles=tiles)
    got_g = twin.window_gather(g, base, w, tiles=tiles)
    assert _rel(got_s, twin.window_spread_plain(x, base, w, padded_size=pad)) \
        <= TOL[("spread", dtype)]
    assert _rel(got_g, twin.window_gather_plain(g, base, w)) \
        <= TOL[("gather", dtype)]
    if dtype == torch.float64:
        lhs = float((got_g * x).sum())
        rhs = float((g * got_s).sum())
        assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


@pytest.mark.parametrize("c", [1, 4])
def test_fused_matvec_matches_two_nfft_reference_on_card(cuda, c):
    """The fused path (window kernels) against matvec_tilde_reference (flat
    geometry, index_add_, cuFFT) within 1e-12 of the reference's largest
    entry, the limit of tests/test_fastsum_exec.py."""
    pts, _ = spiral(20000, seed=0)
    op = tfs.make_fastsum(make_kernel("gaussian", sigma=3.5), pts,
                          tfs.SETUP_2, device=cuda)
    x = torch.randn((20000, c), dtype=torch.float64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(c))
    spread = twin.window_spread.launches
    ref = op.matvec_tilde_reference(x)
    assert twin.window_spread.launches == spread
    assert _rel(op.matvec_tilde(x), ref) <= 1e-12


def test_hybrid_nystrom_launches_kernels_and_matches_plain_windows(
        cuda, monkeypatch):
    """Algorithm 5.1 at n = 10^5, L = 50: both products with A take all 50
    columns through one spread and one gather launch each.  The same run
    with the plain window versions (on the card) agrees: eigenvalues within
    1e-10, eigenvectors within 1e-8 after sign alignment (the top ten
    Ritz values are 1e-2 apart)."""
    pts, _ = spiral(100_000, seed=0)
    adj = tfs.make_normalized_adjacency(make_kernel("gaussian", sigma=3.5),
                                        pts, tfs.SETUP_2, device=cuda)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(0)
        return tny.nystrom_gaussian_nfft(adj, 10, num_columns=50, rank=10,
                                         generator=gen)

    launches = (twin.window_spread.launches, twin.window_gather.launches)
    got = run()
    torch.cuda.synchronize()
    assert (twin.window_spread.launches - launches[0],
            twin.window_gather.launches - launches[1]) == (2, 2)
    monkeypatch.setattr(twin, "window_spread",
                        lambda x, b, w, *, padded_size, tiles=None:
                        twin.window_spread_plain(x, b, w,
                                                 padded_size=padded_size))
    monkeypatch.setattr(twin, "window_gather",
                        lambda g, b, w, *, tiles=None:
                        twin.window_gather_plain(g, b, w))
    want = run()
    assert float((got.eigenvalues - want.eigenvalues).abs().max()) <= 1e-10
    sign = torch.sign((got.eigenvectors * want.eigenvectors).sum(dim=0))
    assert float((got.eigenvectors * sign - want.eigenvectors).abs().max()) \
        <= 1e-8
    assert float(got.eigenvalues.abs().max()) <= 1.01


KM_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
PROFILES = [("gaussian", 2.0), ("laplacian_rbf", 0.7), ("multiquadric", 1.0),
            ("inverse_multiquadric", 1.0)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("n_out,n_in,d,c", [(1000, 1000, 3, 1),
                                            (777, 1301, 2, 4),
                                            (129, 65, 1, 3),
                                            (300, 500, 5, 9),
                                            (8000, 8000, 3, 1),
                                            (400, 10_000, 2, 1)])
@pytest.mark.parametrize("kname,param", PROFILES)
def test_kernel_matvec_matches_plain(cuda, kname, param, n_out, n_in, d, c,
                                     zero_diagonal, dtype):
    rng = np.random.default_rng(n_out + d)
    a = torch.as_tensor(rng.normal(size=(n_out, d)), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.normal(size=(n_in, d)), dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.normal(size=(n_in, c)), dtype=dtype, device=cuda)
    kw = dict(kernel_name=kname, param=param, zero_diagonal=zero_diagonal)
    launches = tkm.kernel_matvec.launches
    got = tkm.kernel_matvec(a, b, x, **kw)
    again = tkm.kernel_matvec(a, b, x, **kw)
    torch.cuda.synchronize()
    assert tkm.kernel_matvec.launches == launches + 2
    assert torch.equal(got, again)  # fixed summation order
    assert _rel(got, tkm.kernel_matvec_plain(a, b, x, **kw)) <= KM_TOL[dtype]


@pytest.mark.parametrize("n_out,n_in,c", [(8000, 8000, 1), (8000, 8000, 4),
                                          (400, 10_000, 1)])
def test_kernel_matvec_splits_the_sources_at_small_shapes(cuda, n_out, n_in,
                                                          c):
    """The guard path's and KRR's shapes run several source splits on this
    card (the cases above then exercise the second pass), and the split
    result equals one split's up to the order of the sum."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = tkm.choose_splits(n_out, n_in, 3, c, sms)
    assert splits > 1
    rng = np.random.default_rng(c)
    a = torch.as_tensor(rng.normal(size=(n_out, 3)), device=cuda)
    b = a if n_out == n_in else torch.as_tensor(rng.normal(size=(n_in, 3)),
                                                device=cuda)
    x = torch.as_tensor(rng.normal(size=(n_in, c)), device=cuda)
    got = tkm.kernel_matvec(a, b, x, kernel_name="gaussian", param=2.0)
    want = tkm.kernel_matvec_plain(a, b, x, kernel_name="gaussian",
                                   param=2.0)
    assert _rel(got, want) <= KM_TOL[torch.float64]


def test_direct_operators_on_card_match_cpu(cuda):
    pts, _ = spiral(1500, seed=4)
    kern = make_kernel("gaussian", sigma=3.5)
    x = np.random.default_rng(1).normal(size=(1500, 2))
    got = tfs.direct_matvec_tiled(kern, torch.as_tensor(pts, device=cuda),
                                  torch.as_tensor(x, device=cuda)).cpu()
    want = tfs.direct_matvec_tiled(kern, torch.as_tensor(pts),
                                   torch.as_tensor(x))
    assert _rel(got, want) <= 1e-12
    adj, report = tguards.guarded_normalized_adjacency(
        kern, pts, tfs.SETUP_1,
        policy=tguards.GuardPolicy(bound_tol=0.0, max_bandwidth=16,
                                   direct_threshold=1500), device=cuda)
    assert report.fallback == "direct"
    dense = tfs.dense_normalized_adjacency(kern, torch.as_tensor(pts))
    got = adj.matvec(torch.as_tensor(x, device=cuda)).cpu()
    assert _rel(got, dense @ torch.as_tensor(x)) <= 1e-12


def test_krr_predict_direct_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    pts, tgt = rng.normal(size=(800, 2)), rng.normal(size=(90, 2))
    alpha = rng.normal(size=800)
    kern = make_kernel("inverse_multiquadric", c=2.0)
    model = {dev: tkrr.KRRModel(torch.as_tensor(alpha, device=dev),
                                torch.as_tensor(pts, device=dev), kern,
                                tfs.SETUP_2, None, None)
             for dev in (cuda, torch.device("cpu"))}
    got = tkrr.krr_predict_direct(model[cuda], tgt).cpu()
    assert _rel(got, tkrr.krr_predict_direct(model[torch.device("cpu")],
                                             tgt)) <= 1e-12


FLASH_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-5, 2.0 ** -6),
             torch.float16: (2e-5, 2.0 ** -9)}


def _flash_close(got, want, dtype):
    atol, rtol = FLASH_TOL[dtype]
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _qkv(shape_q, shape_kv, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=device).to(dtype)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (2, 4, 2, 128, 128, 64), (1, 8, 1, 100, 100, 64), (1, 2, 2, 64, 192, 32),
    (1, 16, 8, 96, 96, 128), (1, 4, 2, 70, 70, 16), (2, 4, 4, 1, 300, 64),
    (1, 4, 2, 200, 130, 64)])
def test_flash_matches_plain(cuda, b, hq, hkv, sq, sk, dh, causal):
    q, k, v = _qkv((b, hq, sq, dh), (b, hkv, sk, dh), torch.float32, cuda,
                   sq + dh)
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert _flash_close(got, want, torch.float32)


@pytest.mark.parametrize("s", [512, 1000, 2048])
def test_flash_granite_heads_float32_matches_plain(cuda, s):
    """Many causal 64-row tiles (the early stop at each tile's diagonal)."""
    q, k, v = _qkv((1, 32, s, 64), (1, 8, s, 64), torch.float32, cuda, s)
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    assert _flash_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sq", [512, 1000])
def test_flash_half_precision_matches_plain(cuda, dtype, sq):
    q, k, v = _qkv((1, 32, sq, 64), (1, 8, sq, 64), dtype, cuda, sq)
    got = tfa.flash_attention(q, k, v, causal=True)
    assert got.dtype == dtype
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=True)
    assert _flash_close(got, want, dtype)


HALF = [torch.bfloat16, torch.float16]


def _flash_tc_case(cuda, dtype, shape_q, shape_kv, seed, q_gain=1.0,
                   grid=None, **kw):
    """A tensor-core kernel (bf16/f16: wgmma; float32: TF32 mma.sync,
    three products) against the plain version on the same inputs, upcast
    to float32; one launch counted.  ``grid`` rounds q and k to multiples
    of 1/grid first."""
    q, k, v = _qkv(shape_q, shape_kv, torch.float32, cuda, seed)
    if grid:
        q, k = (torch.round(t * grid) / grid for t in (q, k))
    q, k, v = (q * q_gain).to(dtype), k.to(dtype), v.to(dtype)
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    want = tfa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert _flash_close(got, want, dtype)
    return got


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq", [1, 63, 64, 65, 1000, 2048])
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_match_plain(cuda, dtype, dh, sq, causal):
    """Every head dim over full, partial (sq = 1, 63, 65, 1000) and
    many-tile query ranges; sk = sq."""
    _flash_tc_case(cuda, dtype, (1, 4, sq, dh), (1, 2, sq, dh), sq + dh,
                   causal=causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(65, 40), (200, 130), (1, 4096),
                                   (100, 300), (1000, 1500), (63, 2048)])
@pytest.mark.parametrize("dh", [64, 80, 256])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_cross_lengths(cuda, dtype, dh, sq, sk, causal):
    """sk < sq (causal: the first sq - sk rows see no key) and sk > sq
    (decode alignment: row t sees keys <= t + sk - sq)."""
    _flash_tc_case(cuda, dtype, (1, 4, sq, dh), (1, 4, sk, dh), sq + sk,
                   causal=causal)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("dh", [64, 80, 256])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_gqa_and_batch(cuda, dtype, dh, group, b):
    _flash_tc_case(cuda, dtype, (b, 2 * group, 300, dh), (b, 2, 300, dh),
                   group + b, causal=True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_mqa_at_256(cuda, dtype, b, causal):
    """paligemma-3b's heads: 8 q heads on 1 KV head at dh = 256."""
    _flash_tc_case(cuda, dtype, (b, 8, 300, 256), (b, 1, 300, 256), 8 + b,
                   causal=causal)


@pytest.mark.parametrize("scale", [0.05, -0.2, 0.0])
@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_explicit_scale(cuda, dtype, dh, scale):
    """A given scale; negative (the kernel flips q's sign, or at dh = 256,
    where q is staged in shared memory, the scores') and 0 (every visible
    key weighs the same) too."""
    _flash_tc_case(cuda, dtype, (1, 8, 257, dh), (1, 2, 257, dh), 5,
                   causal=True, scale=scale)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_underflowing_probabilities(cuda, dtype, causal):
    """q scaled by 30: logits of ~30 standard deviations, most
    probabilities underflow to 0 in float32.  q and k are rounded to
    quarter units first, so that every q.k and its partial sums are exact
    in float32: at this gain the float32 sums of unrounded inputs alone
    put the plain version 0.7 of the float16 limit off the exact
    attention, whatever the kernel does."""
    _flash_tc_case(cuda, dtype, (1, 8, 512, 64), (1, 2, 512, 64), 9,
                   q_gain=30.0, grid=4, causal=causal)


@pytest.mark.parametrize("dh", [32, 80, 256])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_rows_without_keys_are_zero(cuda, dtype, dh):
    got = _flash_tc_case(cuda, dtype, (2, 4, 100, dh), (2, 2, 30, dh), 4,
                         causal=True)
    assert bool((got[:, :, :70] == 0).all())


@pytest.mark.parametrize("dh", [64, 80, 256])
@pytest.mark.parametrize("dtype", HALF)
def test_flash_tensor_cores_take_unaligned_views(cuda, dtype, dh):
    """Tensors whose data starts off a 16-byte boundary (the kernel copies
    rows in 16-byte pieces) are copied first: same result."""
    q, k, v = _qkv((1, 4, 70, dh), (1, 2, 70, dh), dtype, cuda, 8)

    def shifted(t):
        view = torch.empty(t.numel() + 1, dtype=dtype,
                           device=cuda)[1:].view(t.shape)
        return view.copy_(t)

    qs, ks, vs = (shifted(t) for t in (q, k, v))
    assert qs.data_ptr() % 16 != 0
    got = tfa.flash_attention(qs, ks, vs, causal=True)
    assert torch.equal(got, tfa.flash_attention(q, k, v, causal=True))


def test_flash_bf16_launch_counts(cuda):
    q, k, v = _qkv((1, 32, 128, 64), (1, 8, 128, 64), torch.bfloat16, cuda,
                   1)
    launches = tfa.flash_attention.launches
    tfa.flash_attention(q, k, v, causal=True)
    tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == launches + 2


def test_flash_rows_without_keys_are_zero_on_card(cuda):
    q, k, v = _qkv((1, 2, 40, 32), (1, 1, 25, 32), torch.float32, cuda, 3)
    got = tfa.flash_attention(q, k, v, causal=True)
    assert bool((got[:, :, :15] == 0).all())
    assert bool(torch.isfinite(got).all())
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    assert _flash_close(got, want, torch.float32)


def test_flash_rejects_unsupported_head_dim(cuda):
    q, k, v = _qkv((1, 2, 8, 48), (1, 2, 8, 48), torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="16, 32, 64, 80, 128, 256"):
        tfa.flash_attention(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1, 300), (63, 63), (200, 200),
                                   (100, 40), (1000, 1000)])
@pytest.mark.parametrize("dh", [80, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_cuda_core_head_dims_match_plain(cuda, dtype, dh, sq, sk,
                                               causal):
    """dh = 80 (hubert) and 256 (gemma, paligemma), which the first float32
    kernel ran on the CUDA cores: every dtype on the tensor cores now; GQA,
    ragged tiles, cross lengths, rows without keys."""
    _flash_tc_case(cuda, dtype, (1, 4, sq, dh), (1, 2, sk, dh), sq + dh,
                   causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_hubert_and_gemma_heads_match_plain(cuda, dtype):
    """The heads the frontends and gemma prefill with: hubert's 16 x 80
    non-causal and gemma-7b's 16 x 256 causal, at 1024 tokens."""
    _flash_tc_case(cuda, dtype, (1, 16, 1024, 80), (1, 16, 1024, 80), 80)
    _flash_tc_case(cuda, dtype, (1, 16, 1024, 256), (1, 16, 1024, 256),
                   256, causal=True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1, 300), (63, 63), (65, 65), (200, 130),
                                   (100, 40), (130, 500), (1000, 1000)])
@pytest.mark.parametrize("dh", tfa.HEAD_DIMS)
def test_flash_float32_tensor_cores_match_plain(cuda, dh, sq, sk, causal):
    """The float32 kernel (TF32 mma.sync, hi/lo split, three products) at
    every head dim it is built for, within 2e-5 of the plain version: a
    single query, ragged 64-row blocks and key tiles, sk < sq (causal: the
    first sq - sk rows see no key) and sk > sq (decode alignment), GQA 2:1,
    one launch a call."""
    _flash_tc_case(cuda, torch.float32, (1, 4, sq, dh), (1, 2, sk, dh),
                   sq + sk + dh, causal=causal)


@pytest.mark.parametrize("dh", tfa.HEAD_DIMS)
def test_flash_float32_tensor_cores_rows_without_keys_are_zero(cuda, dh):
    got = _flash_tc_case(cuda, torch.float32, (2, 4, 100, dh),
                         (2, 2, 30, dh), 5, causal=True)
    assert bool((got[:, :, :70] == 0).all())


@pytest.mark.parametrize("scale,q_gain", [(-0.2, 1.0), (0.05, 1.0),
                                          (0.0, 1.0), (None, 4.0)])
@pytest.mark.parametrize("dh", tfa.HEAD_DIMS)
def test_flash_float32_tensor_cores_scale_and_large_logits(cuda, dh, scale,
                                                           q_gain):
    """A negative scale (q flipped, or at dh = 256 the scores), a zero
    scale, and q times 4 (logits of ~4 standard deviations)."""
    _flash_tc_case(cuda, torch.float32, (1, 8, 257, dh), (1, 2, 257, dh),
                   dh + 1, q_gain=q_gain, causal=True, scale=scale)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-v3-671b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b"])
def test_reduced_mixers_serve_on_card_matches_cpu(cuda, name):
    """Reduced MoE, MLA, Mamba and hybrid models (float32) served on the
    card give the CPU's greedy tokens; prefill launches the flash kernel
    once per GQA attention layer (MLA and Mamba never)."""
    cfg = reduced_config(get_config(name))
    on_card = tmodel.init_params(cfg, 5, device=cuda)
    on_cpu = tmodel.init_params(cfg, 5, device="cpu")
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    n_attn = sum(tmodel.layer_signature(cfg, i).mixer == "attn"
                 for i in range(cfg.num_layers))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (3, 16, 9, 16)]
    outputs = {}
    for dev, model in ((cuda, on_card), (torch.device("cpu"), on_cpu)):
        engine = ServeEngine(cfg, model, slots=2, max_seq=64, device=dev)
        reqs = [Request(uid=i, tokens=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        launches = tfa.flash_attention.launches
        engine.run_until_drained()
        if dev.type == "cuda":
            assert tfa.flash_attention.launches - launches \
                == n_attn * len(prompts)
        outputs[dev.type] = [r.output for r in reqs]
    assert outputs["cuda"] == outputs["cpu"]


def test_reduced_serve_on_card_matches_cpu(cuda):
    """Reduced granite-3-2b (float32, head dim 16) served on the card: every
    prefill launches the flash kernel once per layer, and the tokens equal
    the same weights' greedy tokens on the CPU."""
    cfg = reduced_config(get_config("granite-3-2b"))
    on_card = tmodel.init_params(cfg, 5, device=cuda)
    on_cpu = tmodel.init_params(cfg, 5, device="cpu")
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(3, 20, 5)]
    outputs = {}
    for dev, model in ((cuda, on_card), (torch.device("cpu"), on_cpu)):
        engine = ServeEngine(cfg, model, slots=2, max_seq=64, device=dev)
        reqs = [Request(uid=i, tokens=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        launches = tfa.flash_attention.launches
        engine.run_until_drained()
        if dev.type == "cuda":
            assert tfa.flash_attention.launches - launches \
                == cfg.num_layers * len(prompts)
        outputs[dev.type] = [r.output for r in reqs]
    assert outputs["cuda"] == outputs["cpu"]


def test_reduced_nfft_model_on_card_matches_cpu(cuda):
    """Reduced granite-3-2b-nfft (float32, TF32 off) on the card: prefill
    logits, four decode steps and both (S, z) tensors of every layer
    against the same weights on the CPU, within 5e-5 (float32 phase
    features at 34 rad); no kernel of the package launches."""
    cfg = reduced_config(get_config("granite-3-2b-nfft"))
    on_card = tmodel.init_params(cfg, 5, device=cuda)
    on_cpu = tmodel.init_params(cfg, 5, device="cpu")
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 256))
    steps = np.random.default_rng(8).integers(0, cfg.vocab_size, (4, 2, 1))
    out = {}
    launches = (tfa.flash_attention.launches, tkm.kernel_matvec.launches,
                twin.window_spread.launches, twin.window_gather.launches)
    for dev, model in ((cuda, on_card), (torch.device("cpu"), on_cpu)):
        caches = tmodel.init_caches(cfg, 2, 512, device=dev)
        logits, _ = model.forward_prefill(
            {"tokens": torch.as_tensor(toks, device=dev)}, caches)
        seq = [logits]
        for i, tok in enumerate(steps):
            logits, _ = model.forward_decode(
                torch.as_tensor(tok, device=dev),
                torch.full((2,), 256 + i, device=dev), caches)
            seq.append(logits)
        out[dev.type] = ([t.cpu() for t in seq],
                         [t.cpu() for c in caches for t in c])
    assert launches == (tfa.flash_attention.launches,
                        tkm.kernel_matvec.launches,
                        twin.window_spread.launches,
                        twin.window_gather.launches)
    for got, want in zip(out["cuda"][0] + out["cuda"][1],
                         out["cpu"][0] + out["cpu"][1]):
        assert _rel(got, want) <= 5e-5


def test_nfft_phase_matmuls_keep_tf32_off(cuda):
    """The chunked kernel attention gives the same bits whether the caller
    has TF32 on or off, and the caller's setting comes back."""
    from repro_torch.models import nfft_attention as tnf
    gen = torch.Generator(device=cuda).manual_seed(0)
    qf, kf = (0.17 * torch.tanh(torch.randn((1, 4, 512, 2), device=cuda,
                                            generator=gen))
              for _ in range(2))
    v = torch.randn((1, 4, 512, 16), device=cuda, generator=gen)
    freqs, bhat = tnf._on_device(32, 2, 0.15, torch.device(cuda))
    prev = torch.backends.cuda.matmul.allow_tf32
    got = {}
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            with tnf._full_fp32(torch.device(cuda)):
                got[flag] = tnf.causal_kernel_attention(qf, kf, v, freqs,
                                                        bhat, 0.15)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(got[True], got[False])


def test_flash_prefill_matches_einsum_on_card(cuda):
    cfg = reduced_config(get_config("llama3-405b"))
    model = tmodel.init_params(cfg, 2, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)), device=cuda)
    got = {flag: model.forward_prefill(
        {"tokens": toks}, tmodel.init_caches(cfg, 2, 48, device=cuda),
        use_flash=flag)[0] for flag in (True, False)}
    assert _rel(got[True], got[False]) <= 1e-5


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(128, 8), (40, 40)])
def test_flash_wide_heads_match_plain(cuda, hq, hkv, dtype, causal):
    """llama3-405b's heads (128 on 8, GQA 16:1) and qwen1.5-32b's (40 MHA)
    at dh 128, s = 512: the TF32 kernel in float32, wgmma in bf16."""
    q, k, v = _qkv((1, hq, 512, 128), (1, hkv, 512, 128), dtype, cuda, hq)
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert _flash_close(got, want, dtype)


@pytest.fixture
def tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


@pytest.mark.parametrize("name", ["llama3-405b", "qwen1.5-32b"])
def test_wide_variant_on_card_matches_cpu(cuda, tf32_off, name):
    """Reduced llama3-405b at GQA 16:1 and qwen1.5-32b at 10 MHA heads with
    nonzero QKV biases (tests/_torch_wide_cases.py; float32, TF32 off) on
    the card against the same weights on the CPU: the engine's tokens
    equal, flash once per layer and prefill, and a prefill + four decode
    steps' logits within 1e-4 of the largest (the card's TF32 split flash
    and cuBLAS against the CPU's einsum)."""
    cfg = wide.variant(name, reduced_config(get_config(name)))
    on_card = tmodel.init_params(cfg, 5, device=cuda)
    if cfg.qkv_bias:
        biases = [b for blk in on_card.blocks
                  for b in (blk.attn.bq, blk.attn.bk, blk.attn.bv)]
        for b, drawn in zip(biases, wide.qkv_biases(
                [b.shape for b in biases], seed=3)):
            b.copy_(torch.as_tensor(drawn, device=cuda))
    on_cpu = tmodel.init_params(cfg, 5, device="cpu")
    on_cpu.load_state_dict({k: v.cpu()
                            for k, v in on_card.state_dict().items()})
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (3, 40, 17, 64)]
    toks = rng.integers(0, cfg.vocab_size, (2, 48))
    steps = rng.integers(0, cfg.vocab_size, (4, 2, 1))
    outputs, seqs = {}, {}
    for dev, model in ((cuda, on_card), (torch.device("cpu"), on_cpu)):
        engine = ServeEngine(cfg, model, slots=2, max_seq=96, device=dev)
        reqs = [Request(uid=i, tokens=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        launches = tfa.flash_attention.launches
        engine.run_until_drained()
        if dev.type == "cuda":
            assert tfa.flash_attention.launches - launches \
                == cfg.num_layers * len(prompts)
        outputs[dev.type] = [r.output for r in reqs]
        caches = tmodel.init_caches(cfg, 2, 64, device=dev)
        logits, _ = model.forward_prefill(
            {"tokens": torch.as_tensor(toks, device=dev)}, caches)
        seq = [logits]
        for i, tok in enumerate(steps):
            logits, _ = model.forward_decode(
                torch.as_tensor(tok, device=dev),
                torch.full((2,), 48 + i, device=dev), caches)
            seq.append(logits)
        seqs[dev.type] = [t.cpu() for t in seq]
    assert outputs["cuda"] == outputs["cpu"]
    for got, want in zip(seqs["cuda"], seqs["cpu"]):
        assert _rel(got, want) <= 1e-4


def test_default_device_matches_tensors_on_card(cuda):
    dev = resolve_device()
    assert dev == torch.zeros(1, device=cuda).device
    assert dev == resolve_device("cuda")


def test_trace_serve_sees_the_device_timeline(cuda):
    out = ttrace.main(["--reduced", "--prompt-len", "40", "--max-seq", "64",
                       "--reps", "2"])
    for what in ("prefill", "tick"):
        r = out[what]
        assert 0 < r["device_busy_ms"] and r["device_events"] > 0
        assert r["device_idle_share"] < 1


def test_serve_cli_runs_on_card_by_default(cuda, capsys):
    tserve.main(["--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert "device=cuda" in out


# ---------------------------------------------------------------------------
# Operator banks and the graph-predict tier on the card (against the CPU
# port: the window kernels' tolerances, the spread's for whole pipelines)
# ---------------------------------------------------------------------------

def _bank_pair(cuda, s, n=3000):
    pts, _ = spiral(n, seed=1)
    kernels = [make_kernel("gaussian", sigma=2.5 + 0.5 * k) for k in range(s)]
    return pts, {dev: tfs.make_fastsum_bank(kernels, pts, tfs.SETUP_2,
                                            device=dev)
                 for dev in ("cpu", cuda)}


@pytest.mark.parametrize("s", [1, 4])
def test_bank_flavours_on_card_match_cpu(cuda, s):
    """Broadcast (C = 1, 4), lockstep (S, n, 4) and flat columns: one spread
    and one gather launch a call, whatever S is."""
    pts, banks = _bank_pair(cuda, s)
    n = pts.shape[0]
    gen = np.random.default_rng(s)
    for shape in [(n,), (n, 4), (s, n, 4), (n, 4 * s)]:
        x = gen.normal(size=shape)
        fn = "matvec_tilde_columns" if shape == (n, 4 * s) else "matvec"
        want = getattr(banks["cpu"], fn)(torch.as_tensor(x))
        before = (twin.window_spread.launches, twin.window_gather.launches)
        got = getattr(banks[cuda], fn)(torch.as_tensor(x, device=cuda))
        torch.cuda.synchronize()
        assert (twin.window_spread.launches - before[0],
                twin.window_gather.launches - before[1]) == (1, 1)
        assert _rel(got.cpu(), want) <= TOL[("spread", torch.float64)], shape
    w = np.linspace(0.2, 1.0, s)
    x = torch.as_tensor(gen.normal(size=(n,)))
    assert _rel(banks[cuda].mixture(w).matvec(x.to(cuda)).cpu(),
                banks["cpu"].mixture(w).matvec(x)) \
        <= TOL[("spread", torch.float64)]


def test_packed_gather_on_card_matches_cpu(cuda):
    """The tick's packed gather at width 8 with a ragged col_index."""
    pts, _ = spiral(3000, seed=2)
    pts = pts[:, :2]
    params = tfs.FastsumParams(n_bandwidth=64, m=4)
    preds = {dev: tfs.make_prediction_plan(pts, params, device=dev)
             for dev in ("cpu", cuda)}
    plan = preds["cpu"].plan
    gen = np.random.default_rng(3)
    grid = torch.as_tensor(gen.normal(size=(plan.grid_size,) * 2 + (8,)))
    q = preds["cpu"].scale_targets(gen.uniform(-0.5, 0.5, size=(2048, 2)))
    col = torch.as_tensor(gen.integers(0, 8, size=2048))
    want = texec.fused_gather_columns(plan, preds["cpu"].target_window(q),
                                      grid, col)
    before = twin.window_gather.launches
    got = texec.fused_gather_columns(plan, preds[cuda].target_window(q),
                                     grid.to(cuda), col.to(cuda))
    assert twin.window_gather.launches - before == 1
    assert _rel(got.cpu(), want) <= TOL[("gather", torch.float64)]


def test_graph_engine_on_card_matches_cpu(cuda):
    """The same stream through a registry on the card and one on the CPU:
    equal counters, outputs within the spread's tolerance."""
    gen = np.random.default_rng(4)
    xtr = gen.uniform(-3, 3, (2000, 2))
    ytr = np.sign(gen.standard_normal(2000))
    params = tfs.FastsumParams(n_bandwidth=64, m=4)
    queries = [gen.uniform(-2.5, 2.5, (int(m), 2))
               for m in gen.integers(10, 300, size=12)]
    fits = [tkrr.krr_fit(make_kernel("gaussian", sigma=sigma), xtr, ytr,
                         1e-2, params, device="cpu") for sigma in (1.0, 1.5)]
    runs = {}
    for dev in ("cpu", cuda):
        reg = tgraph.GraphModelRegistry()
        for i, fit in enumerate(fits):  # the same dual vectors on both
            reg.register(f"t{i}", fit._replace(
                alpha=fit.alpha.to(dev), train_points=fit.train_points.to(dev),
                pred_cache={}))
        engine = tgraph.GraphServeEngine(reg, slots=4, chunk=64)
        reqs = [tgraph.PredictRequest(uid=i, model_id=f"t{i % 2}",
                                      query_points=q)
                for i, q in enumerate(queries)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        runs[dev] = reqs, engine, reg
    (creqs, ceng, creg), (greqs, geng, greg) = runs["cpu"], runs[cuda]
    assert geng.counters == ceng.counters and greg.counters == creg.counters
    assert geng.counters["geometry_builds"] == geng.counters["ticks"] - 1
    for c, g in zip(creqs, greqs):
        assert g.error is None and c.error is None
        # the spread's tolerance, relative to the sums over |alpha| (the
        # dual vectors cancel ~100x in the predictions)
        fit = fits[int(c.model_id[1])]
        size = tkrr.krr_predict_direct(fit._replace(alpha=fit.alpha.abs()),
                                       c.query_points)
        assert np.abs(g.output - c.output).max() \
            <= TOL[("spread", torch.float64)] * float(size.abs().max())


def test_krr_fit_sweep_on_card_matches_cpu(cuda):
    gen = np.random.default_rng(5)
    x = gen.uniform(-1, 1, (3000, 2))
    y = np.sin(3 * x[:, 0])
    params = tfs.FastsumParams(n_bandwidth=32, m=4)
    sweeps = {dev: tkrr.krr_fit_sweep("gaussian", x, y, (1e-2, 1e-1),
                                      (0.8, 1.5), params, tol=1e-10,
                                      maxiter=400, device=dev)
              for dev in ("cpu", cuda)}
    assert bool(sweeps[cuda].converged.all())
    assert _rel(sweeps[cuda].alphas.cpu(), sweeps["cpu"].alphas) <= 1e-6


def _grad_case(device, case):
    """(loss, leaves) of <w, W x> on ``device``: a square operator, a
    rectangular one (W~), or a broadcast bank of two; the leaves are the
    kernel parameters and x, all float64 from the same seeds."""
    pts, _ = spiral(3000, seed=5)
    params = tfs.SETUP_2
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=3000), device=device)
    x.requires_grad_(True)
    ps = [torch.tensor(s, dtype=torch.float64, device=device,
                       requires_grad=True) for s in (3.0, 2.0)]
    kern = make_kernel("gaussian", sigma=ps[0])
    if case == "bank":
        bank = tfs.make_fastsum_bank(
            [kern, make_kernel("laplacian_rbf", sigma=ps[1])], pts, params,
            device=device)
        w = torch.as_tensor(rng.normal(size=(2, 3000)), device=device)
        return lambda: (w * bank.matvec(x)).sum(), ps + [x]
    if case == "rectangular":
        tgt, _ = spiral(500, seed=7)
        op = tfs.make_fastsum(kern, pts, params, target_points=tgt * 0.8,
                              device=device)
        w = torch.as_tensor(rng.normal(size=500), device=device)
        return lambda: torch.dot(w, op.matvec_tilde(x)), [ps[0], x]
    op = tfs.make_fastsum(kern, pts, params, device=device)
    w = torch.as_tensor(rng.normal(size=3000), device=device)
    return lambda: torch.dot(w, op.matvec(x)), [ps[0], x]


@pytest.mark.parametrize("case", ["square", "rectangular", "bank"])
def test_fused_backward_on_card_matches_cpu(cuda, case):
    """The transpose pipeline on the card against the same backward on the
    CPU's plain window versions: parameter gradients and x-bar within
    1e-12, one spread and one gather launch in each direction."""
    loss, leaves = _grad_case("cpu", case)
    want = torch.autograd.grad(loss(), leaves)
    loss, leaves = _grad_case(cuda, case)
    launches = []
    for step in ("forward", "backward"):
        before = (twin.window_spread.launches, twin.window_gather.launches)
        if step == "forward":
            out = loss()
        else:
            got = torch.autograd.grad(out, leaves)
        torch.cuda.synchronize()
        launches.append((twin.window_spread.launches - before[0],
                         twin.window_gather.launches - before[1]))
    assert launches == [(1, 1), (1, 1)]
    for g, h in zip(got, want):
        assert _rel(g.cpu(), h) <= 1e-12


def test_krr_validation_loss_grads_on_card_match_cpu(cuda):
    """Implicit-diff CG and the prediction's transpose on the card: the
    (log sigma, log beta) gradients agree with the CPU's to 1e-8, what two
    CG runs at tol 1e-12 agree to."""
    pts, labels = crescent_fullmoon(1400, seed=5)
    y = 2.0 * labels - 1.0
    params = tfs.FastsumParams(n_bandwidth=64, m=5, eps_b=None)
    grads = {}
    for device in ("cpu", cuda):
        kern = make_kernel("inverse_multiquadric", c=2.0)
        gram = tfs.make_fastsum(kern, pts[:1200], params, device=device)
        pred = tfs.make_fastsum(kern, pts[:1200], params,
                                target_points=pts[1200:], device=device)
        a, b = (torch.tensor(v, dtype=torch.float64, device=device,
                             requires_grad=True)
                for v in (np.log(2.0), np.log(1e-2)))
        loss = tkrr.krr_validation_loss(
            "inverse_multiquadric", gram, pred,
            torch.as_tensor(y[:1200], device=device),
            torch.as_tensor(y[1200:], device=device), a, b, tol=1e-12,
            maxiter=3000)
        grads[str(device)] = [float(g) for g in
                              torch.autograd.grad(loss, (a, b))]
    for g, h in zip(grads[str(cuda)], grads["cpu"]):
        assert abs(g - h) <= 1e-8 * abs(h)


def test_kernel_matvec_refuses_grad_on_card(cuda):
    """The CUDA direct sum is differentiable in x only: a kernel parameter
    or points that require grad raise instead of dropping the gradient
    (the reference has none there: test_torch_kernel_matvec.py::
    test_reference_direct_sum_has_no_points_or_parameter_gradient)."""
    pts = torch.randn((50, 2), dtype=torch.float64, device=cuda)
    x = torch.randn(50, dtype=torch.float64, device=cuda)
    sigma = torch.tensor(1.0, dtype=torch.float64, device=cuda,
                         requires_grad=True)
    with pytest.raises(ValueError, match="reference has no such gradient"):
        tkm.kernel_matvec(pts, pts, x, param=sigma)
    with pytest.raises(ValueError, match="reference has no such gradient"):
        tkm.kernel_matvec(pts.clone().requires_grad_(True), pts, x)
    assert tkm.kernel_matvec(pts, pts, x.requires_grad_(True),
                             param=1.0).requires_grad
    with torch.no_grad():
        tkm.kernel_matvec(pts, pts, x, param=sigma)


@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("kname,param", [("gaussian", 0.7),
                                         ("inverse_multiquadric", 0.5)])
def test_kernel_matvec_x_gradient_matches_plain_autograd(
        cuda, kname, param, c, zero_diagonal):
    """x̄ of the CUDA direct sum (a second launch, point sets swapped)
    against autograd through the plain version, on a rectangular pair so
    that the swap matters: within 1e-12 of the largest entry."""
    gen = torch.Generator(device=cuda).manual_seed(c)
    a = torch.randn((300, 2), dtype=torch.float64, device=cuda, generator=gen)
    b = torch.randn((700, 2), dtype=torch.float64, device=cuda, generator=gen)
    shape = (700,) if c == 1 else (700, c)
    x = torch.randn(shape, dtype=torch.float64, device=cuda, generator=gen)
    w = torch.randn((300,) + shape[1:], dtype=torch.float64, device=cuda,
                    generator=gen)
    kw = dict(kernel_name=kname, param=param, zero_diagonal=zero_diagonal)
    grads = []
    for fn in (tkm.kernel_matvec, tkm.kernel_matvec_plain):
        xg = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((fn(a, b, xg, **kw) * w).sum(), xg)
        grads.append(g)
    before = tkm.kernel_matvec.launches
    xg = x.clone().requires_grad_(True)
    (tkm.kernel_matvec(a, b, xg, **kw) * w).sum().backward()
    assert tkm.kernel_matvec.launches - before == 2
    scale = float(grads[1].abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-12 * scale


def _train_state_arrays(state):
    """A port train state as the numpy tree ``train_state_from_arrays``
    takes (the port keeps the JAX package's layout)."""
    from repro_torch.dist.compression import CompressionState
    from repro_torch.tree import tree_map
    host = lambda t: t.detach().cpu().numpy()
    return type(state)(
        step=host(state.step), params=tree_map(host, state.params.leaf_tree),
        opt_state=type(state.opt_state)(*[tree_map(host, t)
                                          for t in state.opt_state]),
        ef_state=None if state.ef_state is None else CompressionState(
            tree_map(host, state.ef_state.residuals)))


def test_train_step_on_card_matches_cpu(cuda):
    """The reduced granite-3-2b train step (float32, two microbatches,
    compressed gradients) on the card against the CPU from one state: two
    steps' loss and grad_norm within 1e-4 relative, every parameter within
    1e-4 of its leaf's largest entry; no kernel of the package launches."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.training.train_loop import (
        TrainConfig, init_train_state, make_train_step,
        train_state_from_arrays)
    from repro_torch.tree import tree_leaves
    cfg = reduced_config(get_config("granite-3-2b"))
    tc = TrainConfig(num_microbatches=2, compress_grads=True)
    cpu = init_train_state(cfg, tc, 0, device="cpu")
    card = train_state_from_arrays(_train_state_arrays(cpu), cfg, tc,
                                   device=cuda)
    step = make_train_step(cfg, tc)
    before = (tfa.flash_attention.launches, tkm.kernel_matvec.launches,
              twin.window_spread.launches, twin.window_gather.launches)
    for s in range(2):
        batch = batch_for_step(cfg, cfg.shapes[0], s)
        cpu, want = step(cpu, {k: torch.as_tensor(v) for k, v in
                               batch.items()})
        card, got = step(card, {k: torch.as_tensor(v, device=cuda)
                                for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(
                float(want[k]))
    for a, b in zip(tree_leaves(card.params.leaf_tree),
                    tree_leaves(cpu.params.leaf_tree)):
        assert _rel(a.detach().cpu(), b.detach()) <= 1e-4
    assert before == (tfa.flash_attention.launches,
                      tkm.kernel_matvec.launches, twin.window_spread.launches,
                      twin.window_gather.launches)


@pytest.mark.parametrize("arch,opt", [("olmoe-1b-7b", "adamw"),
                                      ("mamba2-1.3b", "adamw"),
                                      ("deepseek-v3-671b", "adafactor")])
def test_family_train_step_on_card_matches_cpu(cuda, arch, opt):
    """One train step of reduced olmoe-1b-7b (the router and aux loss),
    mamba2-1.3b (the chunked SSD's backward) and deepseek-v3-671b (MLA, the
    MTP loss; Adafactor) on the card against the CPU from one state
    (float32, two microbatches): loss and grad_norm within 1e-4 relative,
    every parameter within 1e-4 of its leaf's largest entry (of 1 for a
    leaf that is zero at init, whose values are the update alone: see
    tests/test_torch_train.py's ``_assert_params_close``); no kernel of
    the package launches."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import (
        TrainConfig, init_train_state, make_train_step,
        train_state_from_arrays)
    from repro_torch.tree import tree_leaves
    cfg = reduced_config(get_config(arch))
    kw = {"factored_min_dim": 16} if opt == "adafactor" else {}
    tc = TrainConfig(optimizer=OptimizerConfig(name=opt, **kw),
                     num_microbatches=2)
    cpu = init_train_state(cfg, tc, 0, device="cpu")
    card = train_state_from_arrays(_train_state_arrays(cpu), cfg, tc,
                                   device=cuda)
    zero = [not bool(t.detach().any())
            for t in tree_leaves(cpu.params.stack_for_training())]
    step = make_train_step(cfg, tc)
    before = (tfa.flash_attention.launches, tkm.kernel_matvec.launches,
              twin.window_spread.launches, twin.window_gather.launches)
    batch = batch_for_step(cfg, cfg.shapes[0], 0)
    cpu, want = step(cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
    card, got = step(card, {k: torch.as_tensor(v, device=cuda)
                            for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(
            float(want[k])), k
    for a, b, z in zip(tree_leaves(card.params.leaf_tree),
                       tree_leaves(cpu.params.leaf_tree), zero):
        a, b = a.detach().cpu(), b.detach()
        scale = 1.0 if z else float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale
    assert before == (tfa.flash_attention.launches,
                      tkm.kernel_matvec.launches, twin.window_spread.launches,
                      twin.window_gather.launches)


def test_lm_resume_on_card_bitwise(cuda, tmp_path):
    """The LM train step through run_resilient on the card, under the
    deterministic switch, killed at step 4 after the checkpoint at 2:
    the final loss and every leaf of the state equal the uninterrupted
    run's, bit for bit."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.runtime import durable
    from repro_torch.training.fault_tolerance import (
        InjectedFault, run_resilient)
    from repro_torch.training.train_loop import (
        TrainConfig, init_train_state, make_train_step)
    from repro_torch.tree import tree_leaves
    cfg = reduced_config(get_config("granite-3-2b"))
    tc = TrainConfig(num_microbatches=1)
    batch_fn = lambda s: {k: torch.as_tensor(v, device=cuda) for k, v in
                          batch_for_step(cfg, cfg.shapes[0], s).items()}
    fired = {"done": False}

    def fault_hook(s):
        if s == 4 and not fired["done"]:
            fired["done"] = True
            raise InjectedFault("simulated node failure")

    runs = []
    with durable.deterministic():
        for name, hook in (("ref", None), ("ft", fault_hook)):
            runs.append(run_resilient(
                make_train_step(cfg, tc), init_train_state(cfg, tc, 0,
                                                           device=cuda),
                batch_fn, total_steps=6, ckpt_dir=str(tmp_path / name),
                ckpt_every=2, fault_hook=hook, log_every=100))
    (ref, ref_info), (state, info) = runs
    assert info["restarts"] == 1
    assert torch.equal(info["final_metrics"]["loss"],
                       ref_info["final_metrics"]["loss"])
    for a, b in zip(tree_leaves(state), tree_leaves(ref)):
        assert torch.equal(a, b)


def test_trace_train_sees_the_device_timeline(cuda):
    from repro_torch.launch import trace_train
    out = trace_train.main(["--reduced", "--seq-len", "64", "--reps", "1"])
    r = out["step"]
    assert 0 < r["device_busy_ms"] and r["device_events"] > 0
    assert r["device_idle_share"] < 1


# ---------------------------------------------------------------------------
# The distributed matvec on the card: NCCL at world size 1, and two gloo
# ranks sharing cuda:0 (NCCL refuses two ranks on one device), against the
# single-device matvec on the card within 1e-12
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_pools():
    """One NCCL rank and two gloo ranks on cuda:0, started on first use
    and stopped at the module's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    pools = {}

    def get(world, backend):
        if (world, backend) not in pools:
            pools[world, backend] = RankPool(world, backend, "cuda:0")
        return pools[world, backend]

    yield get
    for pool in pools.values():
        pool.close()


@pytest.mark.parametrize("mode", ["psum", "pencil"])
@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")])
def test_distributed_matvec_on_card_matches_single_device(
        card_pools, world, backend, mode):
    """At world size 1 the pencil mode degenerates to psum (one warning);
    at two ranks it pencils grid axis 0.  y is bitwise the same on every
    rank."""
    pool = card_pools(world, backend)
    x = dist_cases.rhs((4099, 3), 7)
    for xs in (x, x[:, 0]):
        for d, setup in ((3, "SETUP_1"), (2, "SETUP_2")):
            outs = pool.run(dist_cases.matvec, d, setup, 4099, mode,
                            (world,), None, xs)
            assert all(o["y"].tobytes() == outs[0]["y"].tobytes()
                       for o in outs)
            assert (outs[0]["spec"] is not None) == (mode == "pencil"
                                                     and world > 1)
            for o in outs:
                assert _rel(torch.as_tensor(o["y"]),
                            torch.as_tensor(o["single"])) <= 1e-12


@pytest.mark.parametrize("mode", ["psum", "pencil"])
def test_distributed_bank_matvec_on_card_matches_single_device(
        card_pools, mode):
    pool = card_pools(2, "gloo")
    for shape in ((4099, 2), (3, 4099, 2)):
        outs = pool.run(dist_cases.bank_matvec, 3, "SETUP_1", 4099, mode,
                        (2,), dist_cases.rhs(shape, 8))
        for o in outs:
            assert _rel(torch.as_tensor(o["y"]),
                        torch.as_tensor(o["single"])) <= 1e-12


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_distributed_sharded_train_step_on_card_matches_single_device(
        card_pools, mesh):
    """Two gloo ranks on cuda:0 take three sharded steps of reduced
    granite-3-2b (AdamW, 2 microbatches, compression) from the seeded
    init; the single-device step on the card from the same init: losses
    within 1e-5 relative, every gathered parameter within 1e-5 of its
    leaf's largest entry, unsplit leaves bitwise equal on the ranks."""
    pool = card_pools(2, "gloo")
    case = ("adamw", 2, True)
    outs = pool.run(shard_cases.train, "granite-3-2b", mesh, *case, 8, None,
                    3)
    assert outs[0]["digests"] == outs[1]["digests"]
    cfg = shard_cases.config("granite-3-2b", 8)
    tc = shard_cases.train_config(*case)
    dev = torch.device("cuda")
    from repro_torch.training import train_loop as ttl
    from repro_torch.tree import tree_leaves
    state = ttl.init_train_state(cfg, tc, 0, device=dev)
    step = ttl.make_train_step(cfg, tc)

    class Ctx:
        device = dev

    for s in range(3):
        state, m = step(state, shard_cases.batch(Ctx, cfg, s))
        got = outs[0]["metrics"][s]["loss"]
        assert abs(got - float(m["loss"])) <= 1e-5 * float(m["loss"])
    single = shard_cases.param_tree(state.params)
    for a, b in zip(tree_leaves(outs[0]["full"]["params"]),
                    tree_leaves(single)):
        assert _rel(torch.as_tensor(a), torch.as_tensor(b)) <= 1e-5
