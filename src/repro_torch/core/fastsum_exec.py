"""Fused fast-summation execution: spread -> rfftn -> multiply -> irfftn -> gather.

PyTorch counterpart of the hook-free single-operator part of
``repro.core.fastsum_exec``.  One precomputed spectral multiplier on the
oversampled half-spectrum,

    C[k] = b_hat[k] / (M^d * phi_hat[k]^2)   for k in I_N^d, zero-padded
                                              into I_M^d (FFT order),

Hermitian-symmetrized so that one real FFT pair computes exactly what the
two-NFFT path does.  The window step runs on
:mod:`repro_torch.kernels.nfft_window`: the CUDA kernels for tensors on the
card, their plain versions for tensors on the CPU.  The FFT mid-section is
``torch.fft`` (cuFFT on the card).  Everything takes (n,) or (n, C).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.nfft import (
    NfftPlan, WindowGeometry, _embed_map, padded_grid_size, window_shift,
)
from repro_torch.kernels import nfft_window


def fused_spectral_multiplier(plan: NfftPlan,
                              b_hat: torch.Tensor) -> torch.Tensor:
    """Combined multiplier, Hermitian-symmetrized, as an rfftn half-spectrum.

    ``b_hat`` is complex (N,)*d in FFT order.  Returns shape
    ``(M,)*(d-1) + (M//2 + 1,)``, complex, FFT order.
    """
    d, grid = plan.d, plan.grid_size
    dev = b_hat.device
    phi_hat = plan.deconvolution_grid()  # (N,)*d real, numpy
    small = b_hat / torch.as_tensor((grid ** d) * phi_hat * phi_hat,
                                    device=dev)
    emb = torch.tensor(_embed_map(plan), device=dev)
    mesh = torch.meshgrid(*([emb] * d), indexing="ij")
    big = torch.zeros((grid,) * d, dtype=small.dtype, device=dev)
    big[mesh] = small
    # conj-reflect: rev[k] = big[(-k) mod M] along every axis
    rev = big
    for ax in range(d):
        rev = torch.roll(torch.flip(rev, dims=(ax,)), 1, dims=ax)
    sym = 0.5 * (big + torch.conj(rev))
    return sym[..., : grid // 2 + 1].contiguous()


@functools.lru_cache(maxsize=None)
def spectral_support(plan: NfftPlan) -> tuple:
    """Per-dim indices where the fused multiplier is nonzero (half-spectrum):
    ``[0..N/2]`` and ``[M-N/2..M-1]`` per leading dimension, ``[0..N/2]``
    along the rfft axis."""
    n, grid = plan.n_bandwidth, plan.grid_size
    full = np.concatenate([np.arange(n // 2 + 1),
                           np.arange(grid - n // 2, grid)]).astype(np.int32)
    half = np.arange(n // 2 + 1, dtype=np.int32)
    return tuple([full] * (plan.d - 1) + [half])


def _tiles(geometry: WindowGeometry, values: torch.Tensor):
    """The geometry's tile plan for values on the card; None on the CPU,
    whose plain window versions need no plan (none is built there)."""
    return geometry.tiles if values.is_cuda else None


def window_spread(plan: NfftPlan, geometry: WindowGeometry,
                  x: torch.Tensor) -> torch.Tensor:
    """Spread node values (n, C) onto the oversampled grid -> (M,)*d + (C,).

    Permutes the values into Morton row order, runs the spread kernel into
    the wrap-padded grid, folds the pad back, and rolls into FFT order.
    The fold-back adds in place into the padded grid's leading block: the
    pad tail and the block it folds onto never overlap.
    """
    d, grid = plan.d, plan.grid_size
    pad_n = padded_grid_size(plan)
    xs = x[geometry.perm].contiguous()
    gpad = nfft_window.window_spread(xs, geometry.base, geometry.weights,
                                     padded_size=pad_n,
                                     tiles=_tiles(geometry, xs))
    ext = pad_n - grid  # taps - 1: unwrapped u and u - M are the same cell
    for ax in range(d):
        main = gpad.narrow(ax, 0, grid)
        main.narrow(ax, 0, ext).add_(gpad.narrow(ax, grid, ext))
        gpad = main
    # padded coordinate u <-> FFT-order index (u - shift) mod M
    return torch.roll(gpad, (-window_shift(plan),) * d, dims=tuple(range(d)))


def window_gather(plan: NfftPlan, geometry: WindowGeometry,
                  g: torch.Tensor) -> torch.Tensor:
    """Gather node values from the grid (M,)*d + (C,) -> (n, C).

    Exact transpose of :func:`window_spread`: roll, wrap-pad each axis by
    ``taps - 1``, run the gather kernel, restore node order.
    """
    d, taps = plan.d, plan.taps
    gpad = torch.roll(g, (window_shift(plan),) * d, dims=tuple(range(d)))
    for ax in range(d):  # wrap padding, one axis at a time
        gpad = torch.cat([gpad, gpad.narrow(ax, 0, taps - 1)], dim=ax)
    out = nfft_window.window_gather(gpad.contiguous(), geometry.base,
                                    geometry.weights,
                                    tiles=_tiles(geometry, gpad))
    return out[geometry.inv]


def _spectral_mid(plan: NfftPlan, multiplier_half: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """rfftn -> multiply -> irfftn on the spread grid (M,)*d + (C,)."""
    dims = tuple(range(plan.d))
    g_hat = torch.fft.rfftn(g, dim=dims)
    g_hat = g_hat * multiplier_half.to(g_hat.dtype)[..., None]
    y = torch.fft.irfftn(g_hat, s=(plan.grid_size,) * plan.d, dim=dims)
    return y.to(g.dtype)


def fused_pipeline(plan: NfftPlan, multiplier_half: torch.Tensor,
                   src: WindowGeometry, tgt: WindowGeometry,
                   x: torch.Tensor) -> torch.Tensor:
    """spread -> rfftn -> multiply -> irfftn -> gather; x (n,) or (n, C)."""
    batched = x.ndim == 2
    xb = x if batched else x[:, None]
    y = _spectral_mid(plan, multiplier_half, window_spread(plan, src, xb))
    out = window_gather(plan, tgt, y)
    return out if batched else out[:, 0]


# the JAX package's name for y = W̃ x
fused_matvec_tilde = fused_pipeline
