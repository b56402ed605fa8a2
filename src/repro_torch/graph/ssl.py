"""Semi-supervised learning on graphs (paper Sections 6.2.2 and 6.2.3).

PyTorch counterpart of ``repro.graph.ssl``.

1. Phase-field / Allen–Cahn method (Bertozzi–Flenner): convexity-split
   semi-implicit time stepping of

       u_t = -eps L_s u - (1/eps) psi'(u) + Omega (f - u)

   projected on the k smallest eigenpairs of L_s.  Binary labels +-1; the
   multiclass driver runs one-vs-rest.

2. Kernel method (Zhou et al.):  solve  (I + beta L_s) u = f  by CG with
   NFFT matvecs (Eq. (6.4)), or with a truncated eigenapproximation
   V_k diag(1-lam_k) V_k^T of A for O(nk) solves.

Randomness comes from a ``torch.Generator``; it cannot give the numbers
``jax.random`` gives for the same seed.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.fastsum import (
    FastsumParams, NormalizedAdjacencyOperator,
    make_normalized_adjacency_mixture,
)
from repro_torch.core.lanczos import eigsh
from repro_torch.core.solvers import cg


def make_training_vector(labels, n_samples_per_class: int, n_classes: int,
                         *, generator: torch.Generator,
                         positive_class: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary training vector f (+1 for positive-class samples, -1 for
    other-class samples, 0 elsewhere, float64) and the sample mask
    (Section 6.2.2), on ``generator``'s device.

    Per-class sample counts are clamped to the class size, so a class with
    fewer than ``n_samples_per_class`` members contributes all of them and
    nothing else.  Each class draws ``n`` uniforms from ``generator`` in
    turn.
    """
    labels = torch.as_tensor(labels, device=generator.device)
    n = labels.shape[0]
    f = torch.zeros((n,), dtype=torch.float64, device=labels.device)
    mask = torch.zeros((n,), dtype=torch.bool, device=labels.device)
    for c in range(n_classes):
        members = labels == c
        take = min(n_samples_per_class, int(members.sum()))
        draws = torch.rand((n,), generator=generator, dtype=torch.float64,
                           device=labels.device)
        if take == 0:
            continue
        chosen = torch.argsort(torch.where(members, draws, 2.0))[:take]
        f[chosen] = 1.0 if c == positive_class else -1.0
        mask[chosen] = True
    return f, mask


class PhaseFieldResult(NamedTuple):
    u: torch.Tensor
    num_steps: int


def allen_cahn_ssl(eigenvalues_ls: torch.Tensor, eigenvectors: torch.Tensor,
                   f: torch.Tensor, *, eps: float = 10.0, tau: float = 0.1,
                   omega0: float = 10_000.0, c: float | None = None,
                   max_steps: int = 500,
                   rtol: float = 1e-10) -> PhaseFieldResult:
    """Allen–Cahn SSL in the truncated eigenbasis (Section 6.2.2).

    ``eigenvalues_ls``: k smallest eigenvalues of L_s; ``eigenvectors``:
    the corresponding (n, k) eigenvectors; ``f``: training vector (+-1 / 0).
    Steps until the relative change falls to ``rtol`` (one host read per
    step) or ``max_steps``.
    """
    if c is None:
        c = 2.0 / eps + omega0
    v, lam = eigenvectors, eigenvalues_ls
    omega = (f != 0).to(f.dtype) * omega0
    denom = 1.0 + tau * (eps * lam + c)  # (k,)
    a_bar, u_bar = v.T @ f, f
    steps, rel = 0, 1.0
    while steps < max_steps and rel > rtol:
        psi_prime = 4.0 * u_bar * (u_bar * u_bar - 1.0)
        # (1 + tau(eps lam + c)) a = a_bar + tau(-(1/eps) v^T psi'(u_bar)
        #                                       + c a_bar + v^T Omega (f-u_bar))
        rhs = (a_bar + tau * (-(1.0 / eps) * (v.T @ psi_prime) + c * a_bar
                              + v.T @ (omega * (f - u_bar))))
        a_new = rhs / denom
        u_new = v @ a_new
        rel = float(((u_new - u_bar) ** 2).sum()
                    / torch.clamp((u_bar ** 2).sum(), min=1e-30))
        a_bar, u_bar, steps = a_new, u_new, steps + 1
    return PhaseFieldResult(u=u_bar, num_steps=steps)


def allen_cahn_multiclass(adjacency: NormalizedAdjacencyOperator, labels,
                          n_classes: int, n_samples_per_class: int, *,
                          k: int = 5, generator: torch.Generator,
                          num_lanczos_iters: int | None = None,
                          eigsh_fn: Callable | None = None,
                          **ac_kwargs) -> torch.Tensor:
    """One-vs-rest Allen–Cahn classification.  Returns predicted labels.

    ``generator`` (on the operator's device) draws the Lanczos start
    vector, then each class's training vector in turn.
    """
    res = (eigsh_fn or (lambda: eigsh(
        adjacency.matvec, adjacency.n, k, num_iters=num_lanczos_iters,
        generator=generator, dtype=adjacency.inv_sqrt_deg.dtype,
        device=adjacency.inv_sqrt_deg.device)))()
    lam_ls = 1.0 - res.eigenvalues  # smallest of L_s
    scores = []
    for cls in range(n_classes):
        f, _ = make_training_vector(labels, n_samples_per_class, n_classes,
                                    generator=generator, positive_class=cls)
        out = allen_cahn_ssl(lam_ls, res.eigenvectors, f.to(lam_ls.dtype),
                             **ac_kwargs)
        scores.append(out.u)
    return torch.stack(scores, dim=1).argmax(dim=1)


class KernelSSLResult(NamedTuple):
    u: torch.Tensor
    num_iters: torch.Tensor
    converged: torch.Tensor


def kernel_ssl_cg(adjacency: NormalizedAdjacencyOperator, f: torch.Tensor,
                  beta: float, *, tol: float = 1e-4,
                  maxiter: int = 1000) -> KernelSSLResult:
    """Solve (I + beta L_s) u = f with CG + NFFT matvecs (Eq. (6.4))."""

    def matvec(x):
        return x + beta * adjacency.laplacian_matvec(x)

    sol = cg(matvec, f, tol=tol, maxiter=maxiter)
    return KernelSSLResult(u=sol.x, num_iters=sol.num_iters,
                           converged=sol.converged)


def kernel_ssl_cg_multilayer(kernels, weights, points,
                             params: FastsumParams, f: torch.Tensor,
                             beta: float, *, tol: float = 1e-4,
                             maxiter: int = 1000,
                             device: str | torch.device | None = None
                             ) -> KernelSSLResult:
    """Kernel SSL on an aggregated multilayer graph
    ``W = sum_l w_l (W̃_l - K_l(0) I)`` over shared nodes.  The layers'
    multipliers collapse into one
    (:func:`repro_torch.core.fastsum.make_normalized_adjacency_mixture`),
    so every CG iteration costs one fused matvec, as a single layer's.
    ``device`` defaults to ``cuda``."""
    adjacency = make_normalized_adjacency_mixture(kernels, weights, points,
                                                  params, device=device)
    f = torch.as_tensor(f, device=adjacency.inv_sqrt_deg.device)
    return kernel_ssl_cg(adjacency, f, beta, tol=tol, maxiter=maxiter)


def kernel_ssl_eig(eigenvalues_a: torch.Tensor, eigenvectors: torch.Tensor,
                   f: torch.Tensor, beta: float) -> torch.Tensor:
    """Same solve via truncated eigenapproximation of A (Section 6.2.3).

    With A ≈ V diag(theta) V^T and Sherman–Morrison–Woodbury,
        (I + beta L_s)^{-1}
      = (1/(1+beta)) [ I + V diag( beta theta / (1+beta-beta theta) ) V^T ].
    """
    theta = eigenvalues_a
    coeff = beta * theta / (1.0 + beta - beta * theta)
    vtf = eigenvectors.T @ f
    return (f + eigenvectors @ (coeff * vtf)) / (1.0 + beta)
