"""Figure 6 — semi-supervised learning by the Allen–Cahn phase-field
method (twin of ``benchmarks/fig6_phasefield.py``).

Paper protocol (Section 6.2.2): 5-class Gaussian-blob data, k = 5
smallest eigenpairs of L_s; NFFT-Lanczos (N=32, m=4, eps_B=0) against
traditional Nyström (L = n/20), tau=0.1, eps=10, omega0=1e4,
c = 2/eps + omega0; classification accuracy against samples per class s.

    PYTHONPATH=src python -m repro_torch.figures.fig6_phasefield \
        [--device cpu] [--sizes 2000]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fastsum import SETUP_2, make_normalized_adjacency
from repro_torch.core.kernels import make_kernel
from repro_torch.core.nystrom import nystrom_traditional
from repro_torch.data.synthetic import gaussian_blobs
from repro_torch.device import resolve_device
from repro_torch.figures.common import Reporter, figure_args, generator, quick
from repro_torch.graph.ssl import allen_cahn_multiclass

SIGMA = 3.5


def run(report: Reporter | None = None, *, sizes=None, device=None) -> None:
    rep = report or Reporter("fig6_phasefield")
    dev = resolve_device(device)
    sizes = sizes or [2000 if quick() else 20000]
    n_classes = 5
    samples = (1, 2, 3, 5) if quick() else (1, 2, 3, 4, 5, 7, 10)
    instances = 3 if quick() else 10
    kernel = make_kernel("gaussian", sigma=SIGMA)

    for n in sizes:
        acc_nfft: dict[int, list] = {s: [] for s in samples}
        acc_nys: dict[int, list] = {s: [] for s in samples}
        for inst in range(instances):
            points, labels = gaussian_blobs(n, n_classes, seed=40 + inst)
            pts = torch.as_tensor(points, device=dev)
            labs = torch.as_tensor(labels, device=dev)
            op = make_normalized_adjacency(kernel, pts, SETUP_2, device=dev)
            nys = nystrom_traditional(kernel, pts, n_classes,
                                      max(n // 20, 20),
                                      generator=generator(dev, inst))
            for s in samples:
                pred = allen_cahn_multiclass(
                    op, labs, n_classes, s, k=n_classes,
                    generator=generator(dev, 1000 * inst + s))
                acc_nfft[s].append(float((pred == labs).double().mean()))
                # Nyström's pairs in place of eigsh's
                pred2 = allen_cahn_multiclass(
                    op, labs, n_classes, s, k=n_classes,
                    generator=generator(dev, 1000 * inst + s),
                    eigsh_fn=lambda: nys)
                acc_nys[s].append(float((pred2 == labs).double().mean()))

        for s in samples:
            rep.add(f"nfft n={n} s={s} accuracy", float(np.mean(acc_nfft[s])),
                    "frac", worst=f"{min(acc_nfft[s]):.3f}")
            rep.add(f"nystrom n={n} s={s} accuracy",
                    float(np.mean(acc_nys[s])), "frac",
                    worst=f"{min(acc_nys[s]):.3f}")
    rep.save()


def main(argv=None) -> None:
    device, sizes = figure_args(argv, __doc__)
    run(sizes=sizes, device=device)


if __name__ == "__main__":
    main()
