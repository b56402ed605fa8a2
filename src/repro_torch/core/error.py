"""Error propagation for normalized matrices (paper Section 3.1, Lemma 3.1).

PyTorch counterpart of ``repro.core.error``.  Lemma 3.1: for W with
non-negative entries, E an error matrix, and the normalized matrices A,
A_E built from W and W_E = W + E, with

    eta = d_min / ||W||_inf,    eps = ||E||_inf / ||W||_inf,   eps < eta,

it holds  ||A - A_E||_inf <= eps (1 + eta) / (eta (eta - eps)).

The bound, the a-posteriori estimate of eps from the fast-summation
operator (Eq. 3.5/3.6), and the exact O(n^2) probe (Eq. 3.7).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fastsum import FastsumOperator, dense_weight_matrix
from repro_torch.core.kernels import Kernel
from repro_torch.core.regularization import trigonometric_eval


def lemma31_bound(eta: float, eps: float) -> float:
    """The Lemma 3.1 right-hand side; inf if the eps < eta condition fails.

    Degenerate estimates (non-finite eta/eps, or eta <= 0 from an isolated
    node) also map to inf: the bound is never optimistic garbage."""
    if not (np.isfinite(eta) and eta > 0.0 and np.isfinite(eps)):
        return float("inf")
    if eps >= eta:
        return float("inf")
    return eps * (1.0 + eta) / (eta * (eta - eps))


def normalized_from_dense(w: torch.Tensor) -> torch.Tensor:
    inv_sqrt = 1.0 / torch.sqrt(w.sum(dim=1))
    return inv_sqrt[:, None] * w * inv_sqrt[None, :]


def estimate_epsilon(kernel_rescaled: Kernel, fastsum: FastsumOperator,
                     n_nodes: int, w_inf_norm: float,
                     n_samples: int = 4096, seed: int = 0) -> float:
    """eps ≈ n ||K - K_RF||_inf / ||W||_inf  (Eq. 3.6), Monte-Carlo K_ERR.

    The samples come from ``np.random.default_rng(seed)``, so the port
    probes the same points as the JAX package."""
    d = fastsum.plan.d
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_samples, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.0, 0.5, size=(n_samples, 1))
    y = torch.as_tensor(dirs * radii, device=fastsum.device)
    k_rf = trigonometric_eval(fastsum.b_hat, y).real
    k_true = kernel_rescaled.phi(torch.linalg.vector_norm(y, dim=-1))
    k_err = float((k_rf - k_true).abs().max())
    return n_nodes * k_err / w_inf_norm


def exact_error_norm(kernel: Kernel, points: torch.Tensor,
                     fastsum: FastsumOperator) -> float:
    """||E||_inf computed exactly via unit-vector probes (Eq. 3.7). O(n^2)."""
    w = dense_weight_matrix(kernel, points)
    eye = torch.eye(points.shape[0], dtype=w.dtype, device=w.device)
    approx_cols = fastsum.matvec(eye)  # W_E columns (batched matvec)
    return float((approx_cols - w).abs().sum(dim=1).max())


def aposteriori_report(kernel: Kernel, points: torch.Tensor,
                       fastsum: FastsumOperator) -> dict:
    """eta, exact eps, Lemma 3.1 bound, and the exact ||A - A_E||_inf."""
    w = dense_weight_matrix(kernel, points)
    deg = w.sum(dim=1)
    w_inf = float(w.abs().sum(dim=1).max())
    eta = float(deg.min()) / w_inf
    n = points.shape[0]
    w_e = fastsum.matvec(torch.eye(n, dtype=w.dtype, device=w.device))
    eps = float((w_e - w).abs().sum(dim=1).max()) / w_inf
    a = normalized_from_dense(w)
    deg_e = torch.clamp(w_e.sum(dim=1), min=torch.finfo(w.dtype).tiny)
    inv_sqrt_e = 1.0 / torch.sqrt(deg_e)
    a_e = inv_sqrt_e[:, None] * w_e * inv_sqrt_e[None, :]
    return {
        "eta": eta,
        "eps": eps,
        "bound": lemma31_bound(eta, eps),
        "a_err_inf": float((a - a_e).abs().sum(dim=1).max()),
    }
