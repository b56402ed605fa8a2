"""Synthetic datasets of the paper's experiments (Section 6), numpy only.

The port's own copy of the JAX package's generators: the same seeds give
the same arrays.

* spiral            — 3-D conical spiral with C arms (Fig. 2a), calibrated
                      so that sigma = 3.5 reproduces the paper's three
                      error tiers.
* crescent_fullmoon — 2-D crescent + full moon (Section 6.2.3, SSL/KRR).
* gaussian_blobs    — C isotropic clusters (Section 6.2.2).
* synthetic_image   — piecewise-constant RGB image + noise, the stand-in
                      for the paper's 533 x 800 photograph (Fig. 5).
"""

from __future__ import annotations

import numpy as np


def spiral(n: int, n_classes: int = 5, h: float = 8.0, r: float = 2.0,
           noise: float = 0.1, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """3-D spiral with ``n_classes`` arms.  Returns (points (n,3), labels)."""
    rng = np.random.default_rng(seed)
    per = n // n_classes
    pts, labs = [], []
    for c in range(n_classes):
        count = per + (1 if c < n % n_classes else 0)
        t = rng.uniform(0, 2 * np.pi, count)
        phi = 2 * np.pi * c / n_classes
        rad = r * (1 + t / np.pi)
        x = rad * np.cos(t + phi)
        y = rad * np.sin(t + phi)
        z = h * (t / np.pi - 1.0)
        pts.append(np.stack([x, y, z], -1) + rng.normal(0, noise, (count, 3)))
        labs.append(np.full(count, c, dtype=np.int32))
    points = np.concatenate(pts).astype(np.float64)
    labels = np.concatenate(labs)
    order = rng.permutation(points.shape[0])
    return points[order], labels[order]


def crescent_fullmoon(n: int, r1: float = 5.0, r2: float = 5.0,
                      r3: float = 8.0,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """2-D crescent + full moon (paper Section 6.2.3), 1-to-3 class ratio.

    Class 0: disk of radius r1 at the origin (the "full moon"), n/4 points.
    Class 1: half-annulus with radii (r2+r1, r3+r1) (the "crescent"), 3n/4.
    """
    rng = np.random.default_rng(seed)
    n_moon = n // 4
    n_cres = n - n_moon

    ang = rng.uniform(0, 2 * np.pi, n_moon)
    rad = r1 * np.sqrt(rng.uniform(0, 1, n_moon))
    moon = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)

    inner, outer = r1 + r2, r1 + r3
    ang_c = rng.uniform(np.pi, 2 * np.pi, n_cres)  # lower half-plane arc
    rad_c = np.sqrt(rng.uniform(inner ** 2, outer ** 2, n_cres))
    cres = np.stack([rad_c * np.cos(ang_c), rad_c * np.sin(ang_c) + r1], -1)

    points = np.concatenate([moon, cres]).astype(np.float64)
    labels = np.concatenate([np.zeros(n_moon, np.int32),
                             np.ones(n_cres, np.int32)])
    order = rng.permutation(n)
    return points[order], labels[order]


def gaussian_blobs(n: int, n_classes: int = 5, d: int = 3,
                   spread: float = 6.0, scale: float = 1.0,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """C isotropic Gaussian clusters around random centers; the label of a
    point is its nearest center (Section 6.2.2)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, spread, (n_classes, d))
    labels = rng.integers(0, n_classes, n)
    points = centers[labels] + rng.normal(0, scale, (n, d))
    d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return points.astype(np.float64), np.argmin(d2, axis=1).astype(np.int32)


def synthetic_image(height: int = 60, width: int = 90, noise: float = 8.0,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Piecewise-constant RGB image (values 0..255) + truth segmentation.

    Four regions: sky, ground, a disk ("sun"), a rectangle ("building").
    Returns (image (H, W, 3) float64, labels (H, W) int32).
    """
    rng = np.random.default_rng(seed)
    img = np.zeros((height, width, 3))
    lab = np.zeros((height, width), np.int32)
    img[:] = (70.0, 120.0, 200.0)  # sky

    horizon = int(height * 0.65)
    img[horizon:] = (60.0, 160.0, 70.0)  # ground
    lab[horizon:] = 1

    cy, cx, rad = int(height * 0.2), int(width * 0.75), max(3, height // 8)
    yy, xx = np.mgrid[0:height, 0:width]
    disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2
    img[disk] = (250.0, 220.0, 60.0)  # sun
    lab[disk] = 2

    y0, y1 = int(height * 0.35), horizon
    x0, x1 = int(width * 0.15), int(width * 0.4)
    img[y0:y1, x0:x1] = (150.0, 60.0, 50.0)  # building
    lab[y0:y1, x0:x1] = 3

    img = np.clip(img + rng.normal(0, noise, img.shape), 0.0, 255.0)
    return img, lab
