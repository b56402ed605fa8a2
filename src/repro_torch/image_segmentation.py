"""Image segmentation by NFFT spectral clustering — the twin of
``examples/image_segmentation.py`` (paper Section 6.2.1).

Every pixel is a graph node with its RGB vector; the dense
(H*W) x (H*W) graph Laplacian is never formed: eigenvectors come from the
NFFT-based Lanczos method with the paper's parameters (N=16, m=2, p=2,
eps_B=1/8, sigma=90).  Writes PPM images of the input and the k=2 / k=4
segmentations.

    PYTHONPATH=src python -m repro_torch.image_segmentation \
        --height 100 --width 150 [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core.fastsum import FastsumParams, make_normalized_adjacency
from repro_torch.core.kernels import make_kernel
from repro_torch.data.synthetic import synthetic_image
from repro_torch.device import resolve_device
from repro_torch.graph.spectral import (
    clustering_agreement, spectral_clustering,
)

PARAMS = FastsumParams(n_bandwidth=16, m=2, p=2, eps_b=1.0 / 8.0)
PALETTE = np.asarray([
    (230, 60, 60), (60, 160, 230), (240, 200, 60), (110, 200, 110),
    (180, 110, 220), (240, 140, 60)], np.uint8)


def write_ppm(path: str, img: np.ndarray) -> None:
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode())
        f.write(img.astype(np.uint8).tobytes())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=100)
    ap.add_argument("--width", type=int, default=150)
    ap.add_argument("--sigma", type=float, default=90.0)
    ap.add_argument("--out", default="experiments/torch_segmentation")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    img, truth = synthetic_image(args.height, args.width)
    n = args.height * args.width
    pixels = torch.as_tensor(img.reshape(-1, 3), device=dev)
    print(f"image {args.height}x{args.width} -> fully connected graph with "
          f"n={n} nodes (dense W would be {n * n * 8 / 1e9:.1f} GB), "
          f"device={dev}")

    kernel = make_kernel("gaussian", sigma=args.sigma)
    os.makedirs(args.out, exist_ok=True)
    write_ppm(os.path.join(args.out, "input.ppm"), img)

    t0 = time.perf_counter()
    op = make_normalized_adjacency(kernel, pixels, PARAMS, device=dev)
    _sync(dev)
    print(f"operator setup (incl. degrees by fast summation): "
          f"{time.perf_counter() - t0:.2f}s")

    for k in (2, 4):
        t0 = time.perf_counter()
        res = spectral_clustering(
            op, k, generator=torch.Generator(device=dev).manual_seed(0))
        _sync(dev)
        dt = time.perf_counter() - t0
        assign = res.assignments.cpu().numpy()
        seg = PALETTE[assign % len(PALETTE)]
        path = os.path.join(args.out, f"segmentation_k{k}.ppm")
        write_ppm(path, seg.reshape(args.height, args.width, 3))
        agree = clustering_agreement(truth.reshape(-1), assign, k)
        print(f"k={k}: clustered in {dt:.2f}s -> {path}; agreement with the "
              f"truth regions {agree:.4f}")
        print(f"   eigenvalues: {res.eigenvalues.cpu().numpy()}")


if __name__ == "__main__":
    main()
