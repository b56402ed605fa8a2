"""Figure 8 — kernel SSL with the Laplacian RBF kernel (twin of
``benchmarks/fig8_kernel_ssl_laplacian.py``).

Figure 7's protocol with a kernel that has a kink at 0, which the
p-smoothing of the boundary regularization handles: the fast summation
works for any K well approximated by a trigonometric polynomial.

    PYTHONPATH=src python -m repro_torch.figures.fig8_kernel_ssl_laplacian \
        [--device cpu] [--sizes 2000]
"""

from __future__ import annotations

from repro_torch.core.fastsum import FastsumParams
from repro_torch.figures.common import Reporter, figure_args
from repro_torch.figures.fig7_kernel_ssl import run_kernel


def run(report: Reporter | None = None, *, sizes=None, device=None) -> None:
    rep = report or Reporter("fig8_kernel_ssl_laplacian")
    for n in sizes or [None]:
        run_kernel(rep, "laplacian_rbf", 0.4,
                   FastsumParams(n_bandwidth=128, m=4, p=4, eps_b=None),
                   "laplacian-rbf", n=n, device=device)
    rep.save()


def main(argv=None) -> None:
    device, sizes = figure_args(argv, __doc__)
    run(sizes=sizes, device=device)


if __name__ == "__main__":
    main()
