"""Figure 3 — eigenvalue accuracy and runtime on spiral data (twin of
``benchmarks/fig3_eigenvalues.py``).

Paper protocol (Section 6.1): 10 largest eigenpairs of
A = D^{-1/2} W D^{-1/2}, Gaussian sigma = 3.5, methods:
  * NFFT-based Lanczos, setups #1 (N=16,m=2) / #2 (N=32,m=4) / #3 (N=64,m=7)
  * traditional Nyström, L in {n/10, n/4}
  * hybrid Nyström-Gaussian-NFFT (Alg. 5.1), L in {20, 50}, M = 10
  * the dense eigensolver as ground truth
Metrics: max eigenvalue error (6.1), max residual norm (6.2), runtime.

    PYTHONPATH=src python -m repro_torch.figures.fig3_eigenvalues \
        [--device cpu] [--sizes 500,1000]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fastsum import (
    SETUP_1, SETUP_2, SETUP_3, dense_normalized_adjacency,
    make_normalized_adjacency,
)
from repro_torch.core.kernels import make_kernel
from repro_torch.core.lanczos import eigsh
from repro_torch.core.nystrom import nystrom_gaussian_nfft, nystrom_traditional
from repro_torch.data.synthetic import spiral
from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    Reporter, figure_args, generator, quick, timeit,
)

SIGMA = 3.5
K_EIGS = 10


def residual_norm(a_dense, lam, vec) -> float:
    r = a_dense @ vec - vec * lam[None, :]
    return float(torch.linalg.vector_norm(r, dim=0).max())


def run(report: Reporter | None = None, *, sizes=None, device=None) -> None:
    rep = report or Reporter("fig3_eigenvalues")
    dev = resolve_device(device)
    if sizes is None:
        sizes = [500, 1000, 2000] if quick() else [2000, 5000, 10000, 20000]
    reps = 3 if quick() else 10
    kernel = make_kernel("gaussian", sigma=SIGMA)

    for n in sizes:
        points, _ = spiral(n, seed=1)
        pts = torch.as_tensor(points, device=dev)
        a_dense = dense_normalized_adjacency(kernel, pts)
        t_direct, (lam, _) = timeit(lambda: torch.linalg.eigh(a_dense),
                                    repeats=1)
        lam_ref = lam.flip(0)[:K_EIGS]
        rep.add(f"direct n={n}", t_direct, "s")

        for name, setup in (("setup1", SETUP_1), ("setup2", SETUP_2),
                            ("setup3", SETUP_3)):
            def solve(setup=setup):
                op = make_normalized_adjacency(kernel, pts, setup, device=dev)
                return eigsh(op.matvec, op.n, K_EIGS,
                             generator=generator(dev, 0), dtype=pts.dtype,
                             device=dev)
            t, res = timeit(solve, repeats=1)
            err = float((res.eigenvalues - lam_ref).abs().max())
            resid = residual_norm(a_dense, res.eigenvalues, res.eigenvectors)
            rep.add(f"nfft-lanczos-{name} n={n} eigerr", err, "abs",
                    resid=f"{resid:.2e}")
            rep.add(f"nfft-lanczos-{name} n={n} time", t, "s")

        for frac_name, l_size in (("L=n/10", max(n // 10, K_EIGS + 2)),
                                  ("L=n/4", n // 4)):
            errs, resids, t_total = [], [], 0.0
            for r in range(reps):
                t, res = timeit(lambda r=r: nystrom_traditional(
                    kernel, pts, K_EIGS, l_size,
                    generator=generator(dev, 100 + r)), warmup=0, repeats=1)
                t_total += t
                errs.append(float((res.eigenvalues - lam_ref).abs().max()))
                resids.append(residual_norm(a_dense, res.eigenvalues,
                                            res.eigenvectors))
            rep.add(f"nystrom-{frac_name} n={n} eigerr", float(np.mean(errs)),
                    "abs", min=f"{min(errs):.2e}", max=f"{max(errs):.2e}")
            rep.add(f"nystrom-{frac_name} n={n} resid",
                    float(np.mean(resids)), "abs", max=f"{max(resids):.2e}")
            rep.add(f"nystrom-{frac_name} n={n} time", t_total / reps, "s")

        # block Lanczos through the fused multi-column engine
        def solve_block():
            op = make_normalized_adjacency(kernel, pts, SETUP_2, device=dev)
            return eigsh(op.matvec, op.n, K_EIGS, generator=generator(dev, 0),
                         dtype=pts.dtype, num_iters=80, block_size=8,
                         device=dev)
        t, res = timeit(solve_block, repeats=1)
        err = float((res.eigenvalues - lam_ref).abs().max())
        rep.add(f"nfft-block-lanczos-setup2 n={n} eigerr", err, "abs",
                matvecs=res.num_matvecs)
        rep.add(f"nfft-block-lanczos-setup2 n={n} time", t, "s")

        op_nfft = make_normalized_adjacency(kernel, pts, SETUP_2, device=dev)
        for l_size in (20, 50):
            errs, t_total = [], 0.0
            for r in range(reps):
                t, res = timeit(lambda r=r: nystrom_gaussian_nfft(
                    op_nfft, K_EIGS, num_columns=l_size, rank=K_EIGS,
                    generator=generator(dev, 200 + r)), warmup=0, repeats=1)
                t_total += t
                errs.append(float((res.eigenvalues - lam_ref).abs().max()))
            rep.add(f"hybrid-L={l_size} n={n} eigerr", float(np.mean(errs)),
                    "abs", min=f"{min(errs):.2e}", max=f"{max(errs):.2e}")
            rep.add(f"hybrid-L={l_size} n={n} time", t_total / reps, "s")
        del a_dense

    rep.save()


def main(argv=None) -> None:
    device, sizes = figure_args(argv, __doc__)
    run(sizes=sizes, device=device)


if __name__ == "__main__":
    main()
