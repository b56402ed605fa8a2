"""Spectral clustering (paper Section 6.2.1; Ng–Jordan–Weiss), in PyTorch.

Pipeline: k largest eigenvectors of A = D^{-1/2} W D^{-1/2} by the
NFFT-based Lanczos method -> row-normalize -> k-means (k-means++ init and
Lloyd iterations) on the embedded rows.

Randomness comes from one ``torch.Generator`` on the operator's device:
the Lanczos start vector is drawn first and the k-means++ draws follow it
in sequence, where the reference splits its key into two.  That is no
fault: a JAX key gives the same numbers each time it is used, so two
consumers of one key would see the same stream and must split it, but a
torch generator advances its state with every draw, so consecutive draws
are different, independent parts of one stream.  The two packages cannot
give the same numbers for one seed either way (``jax.random`` and torch's
generators are different algorithms).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.fastsum import NormalizedAdjacencyOperator
from repro_torch.core.lanczos import eigsh


class KMeansResult(NamedTuple):
    assignments: torch.Tensor  # (n,)
    centers: torch.Tensor  # (k, d)
    inertia: torch.Tensor


class SpectralResult(NamedTuple):
    assignments: torch.Tensor
    eigenvalues: torch.Tensor
    eigenvectors: torch.Tensor


def _sq_dists(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return ((points[:, None, :] - centers[None, :, :]) ** 2).sum(dim=-1)


def _kmeanspp_init(points: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    n = points.shape[0]
    centers = torch.zeros((k, points.shape[1]), dtype=points.dtype,
                          device=points.device)
    first = torch.randint(0, n, (1,), generator=generator,
                          device=points.device)
    centers[0] = points[first[0]]
    for i in range(1, k):
        d2 = _sq_dists(points, centers[:i]).min(dim=1).values
        # all points on the chosen centers: draw uniformly instead
        weights = torch.where(d2.sum() > 0, d2, torch.ones_like(d2))
        idx = torch.multinomial(weights, 1, generator=generator)
        centers[i] = points[idx[0]]
    return centers


def kmeans(points: torch.Tensor, k: int, num_iters: int = 50, *,
           generator: torch.Generator) -> KMeansResult:
    """k-means++ initialisation followed by ``num_iters`` Lloyd steps."""
    centers = _kmeanspp_init(points, k, generator)
    for _ in range(num_iters):
        assign = _sq_dists(points, centers).argmin(dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
        counts = one_hot.sum(dim=0)
        new_centers = (one_hot.T @ points) / torch.clamp(counts, min=1.0)[:, None]
        # keep empty clusters where they were
        centers = torch.where((counts > 0)[:, None], new_centers, centers)
    d2 = _sq_dists(points, centers)
    return KMeansResult(assignments=d2.argmin(dim=1), centers=centers,
                        inertia=d2.min(dim=1).values.sum())


def spectral_clustering(adjacency: NormalizedAdjacencyOperator, k: int, *,
                        generator: torch.Generator | None = None,
                        num_lanczos_iters: int | None = None,
                        block_size: int = 1,
                        eigenvectors: torch.Tensor | None = None,
                        eigenvalues: torch.Tensor | None = None
                        ) -> SpectralResult:
    """NJW spectral clustering with NFFT-accelerated eigenvectors.

    ``generator`` must live on the operator's device (default: one seeded
    with 0).  ``block_size > 1`` uses block Lanczos.  Pass precomputed
    ``eigenvectors`` (and their ``eigenvalues``) to reuse them, e.g. from
    Nyström: then no Lanczos runs and the adjacency is used only for its
    device.
    """
    dev = adjacency.inv_sqrt_deg.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if eigenvectors is None:
        res = eigsh(adjacency.matvec, adjacency.n, k,
                    num_iters=num_lanczos_iters, generator=generator,
                    block_size=block_size,
                    dtype=adjacency.inv_sqrt_deg.dtype, device=dev)
        eigenvectors, eigenvalues = res.eigenvectors, res.eigenvalues
    vecs = eigenvectors
    rows = vecs / torch.clamp(torch.linalg.vector_norm(vecs, dim=1,
                                                       keepdim=True), min=1e-30)
    km = kmeans(rows, k, generator=generator)
    return SpectralResult(assignments=km.assignments,
                          eigenvalues=eigenvalues, eigenvectors=vecs)


def clustering_agreement(a, b, k: int) -> float:
    """Fraction of points whose cluster assignment agrees between two
    labelings, maximized over label permutations (brute force for k <= 6,
    greedy above)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if k <= 6:
        return max(float(np.mean(a == np.asarray(perm)[b]))
                   for perm in itertools.permutations(range(k)))
    remaining = set(range(k))
    mapping = {}
    for c in range(k):
        cnt, t = max((np.sum((b == c) & (a == t)), t) for t in remaining)
        mapping[c] = t
        remaining.discard(t)
    mapped = np.asarray([mapping[x] for x in b])
    return float(np.mean(a == mapped))
