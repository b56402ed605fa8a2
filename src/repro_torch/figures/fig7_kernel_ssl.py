"""Figures 7 & 8 — kernel SSL on crescent-fullmoon (twin of
``benchmarks/fig7_kernel_ssl.py``).

Paper protocol (Section 6.2.3): solve (I + beta L_s) u = f by CG (tol
1e-4, maxiter 1000) with NFFT matvecs; Gaussian (Fig. 7) and Laplacian
RBF (Fig. 8); s samples per class, a grid of beta.  Metric: the
misclassification rate of sign(u).  The reference's sigma = 0.75 and beta
grid follow its crescent generator's scale, which the port's shares.

    PYTHONPATH=src python -m repro_torch.figures.fig7_kernel_ssl \
        [--device cpu] [--sizes 2000]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.fastsum import FastsumParams, make_normalized_adjacency
from repro_torch.core.kernels import make_kernel
from repro_torch.core.lanczos import eigsh
from repro_torch.data.synthetic import crescent_fullmoon
from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    Reporter, figure_args, generator, quick, sync,
)
from repro_torch.graph.ssl import (
    kernel_ssl_cg, kernel_ssl_eig, make_training_vector,
)


def _default_n() -> int:
    return 2000 if quick() else 20000


def run_kernel(rep: Reporter, kernel_name: str, sigma: float,
               params: FastsumParams, tag: str, *, n: int | None = None,
               device=None) -> None:
    dev = resolve_device(device)
    n = n or _default_n()
    samples = (1, 5, 25) if quick() else (1, 2, 5, 10, 25)
    betas = (1e2, 1e3, 1e4) if quick() else (1e2, 3e2, 1e3, 3e3, 1e4)
    instances = 2 if quick() else 5
    reps_per = 2 if quick() else 10

    kernel = make_kernel(kernel_name, sigma=sigma)
    ops = []
    for inst in range(instances):  # one plan per instance, as the solves
        points, labels = crescent_fullmoon(n, seed=60 + inst)
        pts = torch.as_tensor(points, device=dev)
        ops.append((make_normalized_adjacency(kernel, pts, params,
                                              device=dev), labels))
    for s in samples:
        for beta in betas:
            rates, iters = [], []
            for inst, (op, labels) in enumerate(ops):
                labs = torch.as_tensor(labels, device=dev)
                for r in range(reps_per):
                    f, _ = make_training_vector(
                        labs, s, 2, generator=generator(dev, 17 * inst + r),
                        positive_class=1)
                    res = kernel_ssl_cg(op, f, beta, tol=1e-4, maxiter=1000)
                    pred = (res.u > 0).to(labs.dtype)
                    rates.append(float((pred != labs).double().mean()))
                    iters.append(int(res.num_iters))
            rep.add(f"{tag} n={n} s={s} beta={beta:g} misclass",
                    float(np.mean(rates)), "frac",
                    max=f"{max(rates):.4f}", cg_iters=int(np.mean(iters)))


def run_truncated_eig(rep: Reporter, *, n: int | None = None,
                      device=None) -> None:
    """Section 6.2.3's second method: the k=10 truncated eigenapproximation
    of A (NFFT-Lanczos) and a Sherman-Morrison-Woodbury solve."""
    dev = resolve_device(device)
    n = n or _default_n()
    points, labels = crescent_fullmoon(n, seed=60)
    pts = torch.as_tensor(points, device=dev)
    labs = torch.as_tensor(labels, device=dev)
    kernel = make_kernel("gaussian", sigma=0.75)
    op = make_normalized_adjacency(
        kernel, pts, FastsumParams(n_bandwidth=64 if quick() else 128,
                                   m=3, eps_b=0.0), device=dev)
    sync()
    t0 = time.perf_counter()
    eig = eigsh(op.matvec, op.n, 10, generator=generator(dev, 3),
                dtype=pts.dtype, device=dev)
    sync()
    t_eig = time.perf_counter() - t0
    for s in ((5, 25) if quick() else (1, 2, 5, 10, 25)):
        rates, t_solve = [], 0.0
        for r in range(4):
            f, _ = make_training_vector(labs, s, 2,
                                        generator=generator(dev, 7 * r),
                                        positive_class=1)
            t0 = time.perf_counter()
            u = kernel_ssl_eig(eig.eigenvalues, eig.eigenvectors, f, 1e3)
            sync()
            t_solve += time.perf_counter() - t0
            rates.append(float(((u > 0).to(labs.dtype) != labs)
                               .double().mean()))
        rep.add(f"trunc-eig k=10 n={n} s={s} beta=1e3 misclass",
                float(np.mean(rates)), "frac",
                eig_time=f"{t_eig:.2f}s", solve_time=f"{t_solve / 4:.4f}s")


def run(report: Reporter | None = None, *, sizes=None, device=None) -> None:
    rep = report or Reporter("fig7_kernel_ssl")
    for n in sizes or [None]:
        run_kernel(rep, "gaussian", 0.75,
                   FastsumParams(n_bandwidth=64 if quick() else 128, m=3,
                                 eps_b=0.0), "gaussian", n=n, device=device)
        run_truncated_eig(rep, n=n, device=device)
    rep.save()


def main(argv=None) -> None:
    device, sizes = figure_args(argv, __doc__)
    run(sizes=sizes, device=device)


if __name__ == "__main__":
    main()
