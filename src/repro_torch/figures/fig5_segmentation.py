"""Figure 5 — image segmentation via spectral clustering (twin of
``benchmarks/fig5_segmentation.py``).

Paper protocol (Section 6.2.1): every pixel is a node, v_j in RGB space,
Gaussian sigma = 90, k = 2 / 4 clusters on the smallest eigenvectors of
L_s; NFFT-Lanczos parameters N=16, m=2, p=2, eps_B=1/8.  The stand-in
image (``synthetic_image``) is small enough for the dense ground truth;
the NFFT result is compared with it (% label disagreement), and the
traditional Nyström's failure statistics are taken over repeated runs.

    PYTHONPATH=src python -m repro_torch.figures.fig5_segmentation \
        [--device cpu] [--sizes 40]

``--sizes`` gives image heights; the width is 1.5x the height.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fastsum import (
    dense_normalized_adjacency, make_normalized_adjacency,
)
from repro_torch.core.kernels import make_kernel
from repro_torch.core.nystrom import nystrom_traditional
from repro_torch.data.synthetic import synthetic_image
from repro_torch.device import resolve_device
from repro_torch.figures.common import (
    Reporter, figure_args, generator, quick, timeit,
)
from repro_torch.graph.spectral import (
    clustering_agreement, kmeans, spectral_clustering,
)
from repro_torch.image_segmentation import PARAMS  # N=16, m=2, p=2, 1/8

SIGMA = 90.0


def _assign(vecs: torch.Tensor, k: int, dev) -> np.ndarray:
    """k-means on the row-normalized first k eigenvectors, one fixed seed
    (the reference reuses one key for every k-means)."""
    rows = vecs[:, :k] / torch.clamp(
        torch.linalg.vector_norm(vecs[:, :k], dim=1, keepdim=True), min=1e-30)
    km = kmeans(rows, k, generator=generator(dev, 0))
    return km.assignments.cpu().numpy()


def run(report: Reporter | None = None, *, sizes=None, device=None) -> None:
    rep = report or Reporter("fig5_segmentation")
    dev = resolve_device(device)
    heights = sizes or [40 if quick() else 60]
    kernel = make_kernel("gaussian", sigma=SIGMA)
    for h in heights:
        w = (3 * h) // 2
        img, _ = synthetic_image(h, w)
        pixels = torch.as_tensor(img.reshape(-1, 3), device=dev)
        n = pixels.shape[0]

        # ground truth: dense eigensolver on the full A
        a_dense = dense_normalized_adjacency(kernel, pixels)
        _, vec = torch.linalg.eigh(a_dense)
        del a_dense
        vec_ref = vec.flip(1)[:, :4]

        for k in (2, 4):
            ref_assign = _assign(vec_ref, k, dev)

            def nfft_pipeline(k=k):
                op = make_normalized_adjacency(kernel, pixels, PARAMS,
                                               device=dev)
                return spectral_clustering(op, k, generator=generator(dev, 0))
            t, res = timeit(nfft_pipeline, repeats=1)
            agree = clustering_agreement(ref_assign,
                                         res.assignments.cpu().numpy(), k)
            rep.add(f"nfft k={k} n={n} disagreement", 1.0 - agree, "frac",
                    time=f"{t:.2f}s")

        # traditional Nyström repeated-run failure statistics (paper: 13 of
        # 100 runs "failed")
        k = 4
        l_size = max(25, n // 40)
        reps = 10 if quick() else 50
        ref_assign = _assign(vec_ref, k, dev)
        diffs = []
        for r in range(reps):
            res = nystrom_traditional(kernel, pixels, k, l_size,
                                      generator=generator(dev, 300 + r))
            diffs.append(1.0 - clustering_agreement(
                ref_assign, _assign(res.eigenvectors, k, dev), k))
        diffs = np.asarray(diffs)
        rep.add(f"nystrom k=4 L={l_size} n={n} mean-disagreement",
                float(diffs.mean()), "frac")
        rep.add(f"nystrom k=4 L={l_size} n={n} failed-runs(>20%)",
                float(np.mean(diffs > 0.20)), "frac", runs=reps)
    rep.save()


def main(argv=None) -> None:
    device, sizes = figure_args(argv, __doc__)
    run(sizes=sizes, device=device)


if __name__ == "__main__":
    main()
