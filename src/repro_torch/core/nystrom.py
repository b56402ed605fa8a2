"""Nyström eigenvalue approximation (paper Section 5), in PyTorch.

Counterpart of ``repro.core.nystrom``.

Traditional Nyström (§5.1): sub-sample L nodes, build the full-kernel
blocks W̃_XX and W̃_XY explicitly, approximate W̃ ≈ C^T W̃_XX^{-1} C with
C = [W̃_XX W̃_XY], recover the zero-diagonal adjacency as
W_E = W̃_E - diag(W̃_E), and extract the eigendecomposition of A_E by the
paper's QR variant (QR of D_E^{-1/2} C^T, then the eigendecomposition of
R W̃_XX^{-1} R^T minus the span(Q)-projected diagonal correction).  Plain
``torch.linalg`` (cuBLAS / cuSOLVER on the card): the reference computes
it outside any Pallas kernel.

Hybrid Nyström-Gaussian-NFFT (Algorithm 5.1): randomized range finder
Q = orth(A G) whose products A·G and A·Q each go through the NFFT fast
summation with all L columns at once (on the card: one spread and one
gather launch each), then a rank-M truncated eigendecomposition of
(A Q)(Q^T A Q)^{-1}(A Q)^T.

Both return (eigenvalues, eigenvectors) of A := D^{-1/2} W D^{-1/2}.  The
public functions draw their randomness (the sample permutation, the probe
matrix G) from a ``torch.Generator`` on the operator's or the points'
device, seeded with 0 when none is given; the arithmetic lives in private
helpers that take the draw, so the same numbers can go through both
packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.fastsum import NormalizedAdjacencyOperator
from repro_torch.core.kernels import Kernel

# elements of one (L, chunk, d) difference temporary in _kernel_block
_BLOCK_ELEMS = 1 << 25


class NystromResult(NamedTuple):
    eigenvalues: torch.Tensor  # (k,) descending
    eigenvectors: torch.Tensor  # (n, k)


def _kernel_block(kernel: Kernel, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """Full kernel block W̃ between row nodes and col nodes.

    Explicit coordinate differences, as the reference computes them (the
    matrix-product form |a|^2 + |b|^2 - 2 a.b loses digits to
    cancellation), chunked over ``cols`` so that the (L, chunk, d)
    temporary stays bounded.
    """
    n_rows, d = rows.shape
    step = max(1, _BLOCK_ELEMS // max(1, n_rows * d))
    out = torch.empty((n_rows, cols.shape[0]), dtype=rows.dtype,
                      device=rows.device)
    for start in range(0, cols.shape[0], step):
        diff = rows[:, None, :] - cols[None, start:start + step, :]
        r = torch.sqrt(torch.clamp((diff * diff).sum(dim=-1), min=0.0))
        out[:, start:start + step] = kernel.phi(r)
    return out


def _generator(device: torch.device,
               generator: torch.Generator | None) -> torch.Generator:
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    return generator


def nystrom_traditional(kernel: Kernel, points: torch.Tensor, k: int,
                        sample_size: int, *,
                        generator: torch.Generator | None = None,
                        jitter: float = 0.0) -> NystromResult:
    """Traditional Nyström (§5.1) with the paper's QR-based extraction.

    O(n L^2); only W̃_XX (L x L) and W̃_XY (L x (n-L)) are formed.
    ``points`` (n, d) is a tensor on the device to run on; ``generator``
    lives there too.
    """
    gen = _generator(points.device, generator)
    perm = torch.randperm(points.shape[0], generator=gen,
                          device=points.device)
    return _traditional_from_perm(kernel, points, k, sample_size, perm,
                                  jitter)


def _traditional_from_perm(kernel: Kernel, points: torch.Tensor, k: int,
                           sample_size: int, perm: torch.Tensor,
                           jitter: float) -> NystromResult:
    n, l_size = points.shape[0], sample_size
    perm = perm.to(device=points.device, dtype=torch.long)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(n, device=perm.device)
    pts = points[perm]
    x_pts, y_pts = pts[:l_size], pts[l_size:]

    # Nyström factorizes the *full* kernel matrix W̃ (SPD for the
    # Gaussian): W̃_E = C^T W̃_XX^{-1} C with C = [W̃_XX  W̃_XY]; the
    # zero-diagonal adjacency is recovered afterwards as
    # W_E = W̃_E - diag(W̃_E).
    wt_xx = _kernel_block(kernel, x_pts, x_pts)
    c = torch.cat([wt_xx, _kernel_block(kernel, x_pts, y_pts)], dim=1)
    wt_reg = wt_xx + jitter * torch.eye(l_size, dtype=wt_xx.dtype,
                                        device=wt_xx.device)
    del wt_xx
    # one LU serves every solve (W̃_XX is not SPD for every kernel:
    # multiquadrics are conditionally definite)
    lu, piv = torch.linalg.lu_factor(wt_reg)

    def solve(b):
        return torch.linalg.lu_solve(lu, piv, b)

    # diag(W̃_E)_i = c_i^T W̃_XX^{-1} c_i and deg = W_E 1, both O(n L^2)
    sc = solve(c)  # W̃_XX^{-1} C, (L, n)
    diag_e = (c * sc).sum(dim=0)
    deg = c.T @ sc.sum(dim=1) - diag_e
    del sc
    # Negative degrees cannot be ruled out (the traditional method's
    # failure mode): keep the sign, clamp |deg| >= tiny against 0-division.
    tiny = torch.finfo(deg.dtype).tiny
    inv_sqrt_deg = torch.sign(deg) / torch.sqrt(torch.clamp(deg.abs(),
                                                            min=tiny))

    # QR variant: A_E = Q (R W̃_XX^{-1} R^T - Q^T Δ Q) Q^T with
    # C D^{-1/2} = (QR)^T and Δ = D^{-1/2} diag(W̃_E) D^{-1/2}; the
    # diagonal correction is projected onto span(Q).
    c.mul_(inv_sqrt_deg[None, :])
    q_hat, r_hat = torch.linalg.qr(c.T)  # (n, L), (L, L)
    del c
    delta = diag_e * inv_sqrt_deg ** 2
    middle = r_hat @ solve(r_hat.T) - q_hat.T @ (delta[:, None] * q_hat)
    middle = (middle + middle.T) / 2.0
    theta, u = torch.linalg.eigh(middle)
    order = torch.argsort(-theta, stable=True)[:k]
    vecs = q_hat @ u[:, order]
    return NystromResult(eigenvalues=theta[order],
                         eigenvectors=vecs[inv_perm])


def nystrom_gaussian_nfft(adjacency: NormalizedAdjacencyOperator, k: int, *,
                          num_columns: int, rank: int | None = None,
                          generator: torch.Generator | None = None,
                          sigma_tol: float | None = None) -> NystromResult:
    """Algorithm 5.1 — hybrid Nyström-Gaussian-NFFT.

    ``num_columns`` = L Gaussian probe columns, ``rank`` = M >= k (default
    k).  Both products with A take all L columns in one fast summation.

    ``sigma_tol``: relative floor for the core-matrix inversion.  A is
    indefinite, so trailing Ritz values of Q^T A Q can land near zero by
    +/- cancellation, and R diag(1/sigma) R^T would blow up by 1/sigma.
    Directions with sigma <= sigma_tol * max|sigma| get inverse 0
    (truncated pseudo-inverse).  Default 1e-3, as in the reference.
    """
    dev = adjacency.inv_sqrt_deg.device
    gen = _generator(dev, generator)
    g = torch.randn((adjacency.n, num_columns), generator=gen,
                    dtype=adjacency.inv_sqrt_deg.dtype, device=dev)  # step 3
    return _hybrid_from_probes(adjacency, k, g, rank, sigma_tol)


def _hybrid_from_probes(adjacency, k: int, g: torch.Tensor,
                        rank: int | None,
                        sigma_tol: float | None) -> NystromResult:
    m_rank = k if rank is None else rank
    # steps 1-2 (fast-summation parameters, degrees) are inside `adjacency`
    y = adjacency.matvec(g)  # (n, L) through one fast summation
    q, _ = torch.linalg.qr(y)
    del y
    b1 = adjacency.matvec(q)  # step 4
    b2 = q.T @ b1
    del q
    b2 = (b2 + b2.T) / 2.0

    theta, u = torch.linalg.eigh(b2)  # step 5
    order = torch.argsort(-theta, stable=True)[:m_rank]
    sigma_m = theta[order]
    u_m = u[:, order]

    q_hat, r_hat = torch.linalg.qr(b1 @ u_m)  # step 6
    del b1
    # adaptive rank truncation: only sigma above tol * max|sigma| are
    # inverted
    tol = 1e-3 if sigma_tol is None else sigma_tol
    keep = sigma_m > tol * sigma_m.abs().max()
    inv_sigma = torch.where(keep, 1.0 / torch.where(keep, sigma_m, 1.0), 0.0)
    core = (r_hat * inv_sigma[None, :]) @ r_hat.T  # step 7
    core = (core + core.T) / 2.0
    lam, u_hat = torch.linalg.eigh(core)
    order2 = torch.argsort(-lam, stable=True)[:k]  # step 8
    return NystromResult(eigenvalues=lam[order2],
                         eigenvectors=q_hat @ u_hat[:, order2])
