"""Figure 9 — kernel ridge regression with the Gaussian and the inverse
multiquadric (twin of ``benchmarks/fig9_krr.py``).

Paper protocol (Section 6.3): alpha = (K + beta I)^{-1} f by CG with NFFT
matvecs on the Gram matrix (diagonal K(0), i.e. W̃); the decision
function F(x) = sum_i alpha_i K(x_i, x) classifies a 2-D two-class set;
fast prediction is held against the exact direct sum (on the card the
hand-written ``kernel_matvec``).

    PYTHONPATH=src python -m repro_torch.figures.fig9_krr \
        [--device cpu] [--sizes 1000]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fastsum import FastsumParams
from repro_torch.core.kernels import make_kernel
from repro_torch.data.synthetic import crescent_fullmoon
from repro_torch.device import resolve_device
from repro_torch.figures.common import Reporter, figure_args, quick, timeit
from repro_torch.graph.krr import krr_fit, krr_predict, krr_predict_direct

# sigma/c = 2.0 on data spanning radius ~13, resolved by N = 256; beta =
# 1e-2 keeps the Gram system well conditioned
PARAMS = FastsumParams(n_bandwidth=256, m=5, eps_b=None)
BETA = 1e-2


def run(report: Reporter | None = None, *, sizes=None, device=None) -> None:
    rep = report or Reporter("fig9_krr")
    dev = resolve_device(device)
    n_test = 400
    for n in sizes or [1000 if quick() else 10000]:
        points, labels = crescent_fullmoon(n + n_test, seed=5)
        x_train = torch.as_tensor(points[:n], device=dev)
        y_train = torch.as_tensor(2.0 * labels[:n] - 1.0, device=dev)
        x_test = torch.as_tensor(points[n:], device=dev)
        y_test = labels[n:]

        for kernel_name, param in (("gaussian", 2.0),
                                   ("inverse_multiquadric", 2.0)):
            kern = (make_kernel(kernel_name, sigma=param)
                    if kernel_name == "gaussian"
                    else make_kernel(kernel_name, c=param))
            t_fit, model = timeit(lambda kern=kern: krr_fit(
                kern, x_train, y_train, BETA, PARAMS, tol=1e-8,
                maxiter=2000, device=dev), repeats=1)
            pred = krr_predict(model, x_test)
            acc = float(np.mean((pred.cpu().numpy() > 0) == (y_test == 1)))
            rep.add(f"{kernel_name} n={n} test-accuracy", acc, "frac",
                    fit_time=f"{t_fit:.2f}s", cg_iters=int(model.num_iters))
            direct = krr_predict_direct(model, x_test)
            err = float((pred - direct).abs().max()
                        / torch.clamp(direct.abs().max(), min=1e-30))
            rep.add(f"{kernel_name} n={n} predict-vs-direct relerr", err,
                    "rel")
    rep.save()


def main(argv=None) -> None:
    device, sizes = figure_args(argv, __doc__)
    run(sizes=sizes, device=device)


if __name__ == "__main__":
    main()
