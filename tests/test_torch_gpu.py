"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips (inside the ``cuda`` fixture) when no card
is present.  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the largest output entry: spread 1e-12 (f64) /
1e-4 (f32), since its atomics add in a varying order; gather 1e-13 / 1e-5;
kernel_matvec 1e-12 / 1e-4 (its sums run in another order than the plain
version's matrix product, and float32 exp/sqrt differ by an ulp or two).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fastsum as tfs
from repro_torch.core.kernels import make_kernel
from repro_torch.core.nfft import build_window_geometry, padded_grid_size
from repro_torch.data.synthetic import spiral
from repro_torch.graph import krr as tkrr
from repro_torch.kernels import kernel_matvec as tkm
from repro_torch.kernels import nfft_window as twin
from repro_torch.runtime import guards as tguards

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


def test_matvec_on_card_matches_cpu(cuda):
    pts, _ = spiral(2000, seed=0)
    kern = make_kernel("gaussian", sigma=3.5)
    x = np.random.default_rng(0).normal(size=(2000, 3))
    on_card = tfs.make_fastsum(kern, pts, tfs.SETUP_2, device=cuda)
    on_cpu = tfs.make_fastsum(kern, pts, tfs.SETUP_2, device="cpu")
    got = on_card.matvec(torch.as_tensor(x, device=cuda)).cpu()
    want = on_cpu.matvec(torch.as_tensor(x))
    assert _rel(got, want) <= 1e-12


KM_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
PROFILES = [("gaussian", 2.0), ("laplacian_rbf", 0.7), ("multiquadric", 1.0),
            ("inverse_multiquadric", 1.0)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("zero_diagonal", [True, False])
@pytest.mark.parametrize("n_out,n_in,d,c", [(1000, 1000, 3, 1),
                                            (777, 1301, 2, 4),
                                            (129, 65, 1, 3),
                                            (300, 500, 5, 9)])
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
