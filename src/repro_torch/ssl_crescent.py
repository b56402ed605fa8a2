"""Semi-supervised learning on crescent-fullmoon — the twin of
``examples/ssl_crescent.py`` (paper Section 6.2.3).

Solves (I + beta L_s) u = f by CG with NFFT matvecs for a handful of
labeled samples per class, and prints the misclassification rate; also runs
the Laplacian-RBF variant to show kernel flexibility (Fig. 8).

    PYTHONPATH=src python -m repro_torch.ssl_crescent --n 20000 --samples 5 \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.fastsum import FastsumParams, make_normalized_adjacency
from repro_torch.core.kernels import make_kernel
from repro_torch.data.synthetic import crescent_fullmoon
from repro_torch.device import resolve_device
from repro_torch.graph.ssl import kernel_ssl_cg, make_training_vector

RUNS = (("gaussian", 0.75, FastsumParams(n_bandwidth=64, m=3, eps_b=0.0)),
        ("laplacian_rbf", 0.4, FastsumParams(n_bandwidth=128, m=4)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--beta", type=float, default=1e3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    points, labels = crescent_fullmoon(args.n, seed=0)
    pts = torch.as_tensor(points, device=dev)
    labs = torch.as_tensor(labels, device=dev)

    for kname, sigma, params in RUNS:
        kernel = make_kernel(kname, sigma=sigma)
        t0 = time.perf_counter()
        op = make_normalized_adjacency(kernel, pts, params, device=dev)
        f, _ = make_training_vector(
            labs, args.samples, 2,
            generator=torch.Generator(device=dev).manual_seed(0),
            positive_class=1)
        res = kernel_ssl_cg(op, f, args.beta, tol=1e-4, maxiter=1000)
        rate = float(((res.u > 0).to(torch.int32) != labs).double().mean())
        dt = time.perf_counter() - t0  # the float() above synchronizes
        print(f"{kname:15s} sigma={sigma}: misclassification "
              f"{rate * 100:.2f}%  (CG iters={int(res.num_iters)}, "
              f"{dt:.2f}s, n={args.n}, s={args.samples}/class, "
              f"beta={args.beta:g}, device={dev})")


if __name__ == "__main__":
    main()
