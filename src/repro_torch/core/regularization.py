"""Kernel regularization and Fourier coefficients (paper Section 3, Eq. (3.4)).

PyTorch counterpart of ``repro.core.regularization``.  ``K_R`` is the
1-periodic smooth continuation of the kernel:

    K_R(y) = K(y)            if ||y|| <= 1/2 - eps_B
           = T_B(||y||)      if 1/2 - eps_B < ||y|| <= 1/2
           = T_B(1/2)        otherwise (cube corners),

with ``T_B`` the degree ``2p-2`` two-point Taylor polynomial matching
``K^(j)`` at ``a = 1/2 - eps_B`` for ``j < p`` and with vanishing first
``p-1`` derivatives at ``b = 1/2``.  The Fourier coefficients of ``K_RF``
are the trapezoidal-rule/DFT approximation

    b_hat[l] = (1/N^d) * sum_{j in I_N^d} K_R(j/N) e^{-2 pi i j.l / N},

kept in FFT order (no fftshift anywhere).

A kernel whose parameter is a tensor carries its graph through every step
(the radial derivatives, the Taylor solve, the samples and the FFT), so
``b_hat`` is differentiable in sigma or c.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.kernels import Kernel


def kernel_radial_derivatives(kernel: Kernel, r0: float,
                              order: int) -> torch.Tensor:
    """``[K(r0), K'(r0), ..., K^(order-1)(r0)]`` in float64, on the kernel
    parameter's device (the CPU for float parameters).

    Repeated ``torch.autograd.grad(create_graph=True)`` over r takes the
    place of the reference's nested ``jax.grad``.  The result keeps its
    graph to a parameter that requires grad, and is detached otherwise.
    """
    r = torch.tensor(float(r0), dtype=torch.float64,
                     device=kernel.param_device, requires_grad=True)
    with torch.enable_grad():
        g = kernel.phi(r)
        derivs = [g]
        for _ in range(order - 1):
            (g,) = torch.autograd.grad(g, r, create_graph=True)
            derivs.append(g)
    out = torch.stack(derivs)
    keep = torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad
        for v in kernel.params.values())
    return out if keep else out.detach()


def two_point_taylor(kernel: Kernel, p: int, eps_b: float) -> torch.Tensor:
    """Coefficients (ascending, in ``t = (r-a)/(b-a)``) of the transition
    polynomial T_B, ``a = 1/2 - eps_B``, ``b = 1/2``."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    a = 0.5 - eps_b
    h = eps_b  # b - a
    n_coef = 2 * p - 1  # degree 2p-2
    mat = np.zeros((n_coef, n_coef))
    # t=0 (r=a): T^(j)(a) = K^(j)(a) * h^j (chain rule in t)
    kd = kernel_radial_derivatives(kernel, a, p)
    rhs_head = kd * torch.tensor([h ** j for j in range(p)],
                                 dtype=torch.float64, device=kd.device)
    for j in range(p):
        mat[j, j] = float(math.factorial(j))
    # t=1 (r=b): T^(j)(b) = 0 for j=1..p-1
    for idx, j in enumerate(range(1, p)):
        for k in range(j, n_coef):
            mat[p + idx, k] = _falling(k, j)
    rhs = torch.cat([rhs_head, torch.zeros(n_coef - p, dtype=torch.float64,
                                           device=kd.device)])
    return torch.linalg.solve(torch.as_tensor(mat, device=kd.device), rhs)


def _falling(k: int, j: int) -> float:
    out = 1.0
    for i in range(j):
        out *= (k - i)
    return out


def regularized_kernel_profile(kernel: Kernel, p: int, eps_b: float):
    """Elementwise radial profile ``K_R(r)`` on tensors.

    With ``eps_B == 0`` no transition is applied (``K_R = K`` inside the
    ball, constant ``K(1/2)`` outside); the paper's setups #1–#3 use that.
    """
    a = 0.5 - eps_b
    if eps_b <= 0.0:
        edge = kernel.phi(torch.tensor(0.5, dtype=torch.float64,
                                       device=kernel.param_device))

        def profile(r):
            edge_r = edge.to(r.device)
            return torch.where(r <= 0.5, kernel.phi(torch.clamp(r, max=0.5)),
                               edge_r)

        return profile

    coeffs = two_point_taylor(kernel, p, eps_b)

    def t_poly(r):
        t = (r - a) / eps_b
        c = coeffs.to(r.device)
        out = torch.zeros_like(t) + c[-1]
        for k in range(c.shape[0] - 2, -1, -1):  # Horner, as polyval
            out = out * t + c[k]
        return out

    edge_val = t_poly(torch.tensor(0.5, dtype=torch.float64,
                                   device=coeffs.device))

    def profile(r):
        inner = kernel.phi(torch.clamp(r, max=a))
        trans = t_poly(torch.clamp(r, a, 0.5))
        return torch.where(r <= a, inner,
                           torch.where(r <= 0.5, trans, edge_val.to(r.device)))

    return profile


def kernel_fourier_coefficients(kernel: Kernel, d: int, n_bandwidth: int,
                                p: int, eps_b: float, *,
                                device: torch.device | str
                                ) -> torch.Tensor:
    """Fourier coefficients ``b_hat`` of K_RF on the full I_N^d grid (Eq. 3.4).

    Returns a complex128 tensor of shape ``(N,)*d`` in FFT order.
    """
    n = n_bandwidth
    profile = regularized_kernel_profile(kernel, p, eps_b)
    # sample positions j/N, j in I_N = {-N/2, ..., N/2-1}, in FFT order
    freqs = torch.fft.fftfreq(n, d=1.0 / n, dtype=torch.float64,
                              device=device)
    coords = freqs / n
    grids = torch.meshgrid(*([coords] * d), indexing="ij")
    radius = torch.sqrt(sum(g * g for g in grids))
    samples = profile(radius)
    return torch.fft.fftn(samples) / (n ** d)


# points per chunk of trigonometric_eval: bounds the (points, N^d) phase
# matrix at ~2^22 complex entries
_TRIG_EVAL_ELEMS = 1 << 22


def trigonometric_eval(b_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Direct evaluation of ``K_RF(y) = sum_l b_hat[l] e^{2 pi i l.y}``.

    Reference/oracle only — O(N^d) per point.  ``b_hat``: complex (N,)*d
    in FFT order; ``y``: real (..., d).  Returns complex (...,).
    """
    d, n = b_hat.ndim, b_hat.shape[0]
    freqs = torch.fft.fftfreq(n, d=1.0 / n, dtype=y.dtype, device=y.device)
    grids = torch.meshgrid(*([freqs] * d), indexing="ij")
    l = torch.stack([g.reshape(-1) for g in grids], dim=-1)  # (N^d, d)
    coeffs = b_hat.reshape(-1)
    flat = y.reshape(-1, d)
    out = torch.empty((flat.shape[0],), dtype=coeffs.dtype, device=y.device)
    step = max(1, _TRIG_EVAL_ELEMS // coeffs.shape[0])
    for s in range(0, flat.shape[0], step):
        phase = 2.0 * math.pi * (flat[s:s + step] @ l.T)
        out[s:s + step] = torch.polar(torch.ones_like(phase), phase) @ coeffs
    return out.reshape(y.shape[:-1])
