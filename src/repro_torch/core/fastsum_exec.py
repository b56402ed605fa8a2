"""Fused fast-summation execution: spread -> rfftn -> multiply -> irfftn -> gather.

PyTorch counterpart of ``repro.core.fastsum_exec``: single operators and
multiplier banks, with the hooks the distributed matvec
(:mod:`repro_torch.dist.fastsum_dist`) runs its cross-shard spectral sum
through.  One precomputed spectral multiplier on the
oversampled half-spectrum,

    C[k] = b_hat[k] / (M^d * phi_hat[k]^2)   for k in I_N^d, zero-padded
                                              into I_M^d (FFT order),

Hermitian-symmetrized so that one real FFT pair computes exactly what the
two-NFFT path does.  The window step runs on
:mod:`repro_torch.kernels.nfft_window`: the CUDA kernels for tensors on the
card, their plain versions for tensors on the CPU.  The FFT mid-section is
``torch.fft`` (cuFFT on the card).  Everything takes (n,) or (n, C).

Differentiation (the JAX package's custom-VJP core).  The pipeline is
linear in the values and in the multiplier, and :func:`window_spread` and
:func:`window_gather` are exact mutual adjoints on one geometry.  When
autograd needs them, each window step runs as a ``torch.autograd.Function``
whose backward is the other step on the same geometry, so a pipeline's
backward is its transpose: spread the cotangent on the *target* geometry,
the mid-section's VJP (autograd over ``torch.fft`` alone, which counts the
half-spectrum's interior bins twice, as ``jax.vjp`` does), gather on the
*source* geometry — one spread and one gather launch.  No window kernel,
nor its plain version, is ever differentiated by autograd.  The geometry
is plan-time data and gets no gradient.
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


def _needs_grad(t: torch.Tensor) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


class _Spread(torch.autograd.Function):
    """:func:`window_spread` whose backward is :func:`window_gather` on the
    same geometry (its exact adjoint; itself differentiable, for higher
    derivatives)."""

    @staticmethod
    def forward(ctx, x, plan, geometry):
        ctx.plan, ctx.geometry = plan, geometry
        return _spread(plan, geometry, x)

    @staticmethod
    def backward(ctx, g_bar):
        return window_gather(ctx.plan, ctx.geometry, g_bar), None, None


class _Gather(torch.autograd.Function):
    """:func:`window_gather` whose backward is :func:`window_spread` on the
    same geometry (its exact adjoint)."""

    @staticmethod
    def forward(ctx, g, plan, geometry):
        ctx.plan, ctx.geometry = plan, geometry
        return _gather(plan, geometry, g)

    @staticmethod
    def backward(ctx, y_bar):
        return window_spread(ctx.plan, ctx.geometry, y_bar), None, None


def window_spread(plan: NfftPlan, geometry: WindowGeometry,
                  x: torch.Tensor) -> torch.Tensor:
    """Spread node values (n, C) onto the oversampled grid -> (M,)*d + (C,).

    Permutes the values into Morton row order, runs the spread kernel into
    the wrap-padded grid, folds the pad back, and rolls into FFT order.
    The fold-back adds in place into the padded grid's leading block: the
    pad tail and the block it folds onto never overlap.  Differentiable in
    ``x``: the backward is :func:`window_gather` on the same geometry.
    """
    if _needs_grad(x):
        return _Spread.apply(x, plan, geometry)
    return _spread(plan, geometry, x)


def _spread(plan: NfftPlan, geometry: WindowGeometry,
            x: torch.Tensor) -> torch.Tensor:
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
    Differentiable in ``g``: the backward is :func:`window_spread` on the
    same geometry.
    """
    if _needs_grad(g):
        return _Gather.apply(g, plan, geometry)
    return _gather(plan, geometry, g)


def _gather(plan: NfftPlan, geometry: WindowGeometry,
            g: torch.Tensor) -> torch.Tensor:
    d, taps = plan.d, plan.taps
    gpad = torch.roll(g, (window_shift(plan),) * d, dims=tuple(range(d)))
    for ax in range(d):  # wrap padding, one axis at a time
        gpad = torch.cat([gpad, gpad.narrow(ax, 0, taps - 1)], dim=ax)
    out = nfft_window.window_gather(gpad.contiguous(), geometry.base,
                                    geometry.weights,
                                    tiles=_tiles(geometry, gpad))
    return out[geometry.inv]


def _spectral_mid(plan: NfftPlan, multiplier_half: torch.Tensor,
                  g: torch.Tensor, spectral_reduce=None) -> torch.Tensor:
    """rfftn -> multiply -> irfftn on the spread grid (M,)*d + (C,);
    ``spectral_reduce``, when given, maps the product's support block
    (:func:`_reduce_support`) before the inverse transform."""
    dims = tuple(range(plan.d))
    g_hat = torch.fft.rfftn(g, dim=dims)
    g_hat = g_hat * multiplier_half.to(g_hat.dtype)[..., None]
    if spectral_reduce is not None:
        g_hat = _reduce_support(plan, g_hat, spectral_reduce)
    y = torch.fft.irfftn(g_hat, s=(plan.grid_size,) * plan.d, dim=dims)
    return y.to(g.dtype)


@functools.lru_cache(maxsize=None)
def _support_index(plan: NfftPlan, device: torch.device) -> tuple:
    """:func:`spectral_support` as an advanced index on ``device``, built
    once per plan and device."""
    return tuple(torch.meshgrid(*[torch.as_tensor(i, device=device)
                                  for i in spectral_support(plan)],
                                indexing="ij"))


def _reduce_support(plan: NfftPlan, g_hat: torch.Tensor,
                    spectral_reduce) -> torch.Tensor:
    """Apply ``spectral_reduce`` to the support block of a multiplied
    half-spectrum ``(M,)*(d-1) + (M//2+1,) + (C,)`` and write its result
    back there, in place.  ``g_hat`` is the caller's fresh product, zero
    off the support because the multiplier is, so the result is the
    reduced block and zeros elsewhere.  The block goes to the hook as a
    contiguous copy (indexing copies)."""
    index = _support_index(plan, g_hat.device)
    g_hat[index] = spectral_reduce(g_hat[index])
    return g_hat


def fused_pipeline(plan: NfftPlan, multiplier_half: torch.Tensor,
                   src: WindowGeometry, tgt: WindowGeometry,
                   x: torch.Tensor, grid_hook=None, spectral_reduce=None,
                   spectral_op=None) -> torch.Tensor:
    """spread -> rfftn -> multiply -> irfftn -> gather; x (n,) or (n, C).

    Three hooks, as in the JAX package, let the distributed matvec and
    fault injection reuse this one implementation:

    * ``grid_hook`` maps the spread grid ``(M,)*d + (C,)`` to a grid of
      the same shape before the spectral section: the deterministic
      fault-injection seam (:mod:`repro_torch.runtime.faultinject`
      poisons it to model grid memory corruption).
    * ``spectral_reduce`` maps the support block of the multiplied
      half-spectrum (see :func:`spectral_support`): the psum spectral
      mode's one cross-shard sum.
    * ``spectral_op`` replaces the whole rfftn -> multiply -> irfftn
      section: it maps the spread grid to the inverse-transformed grid of
      the same shape (the pencil spectral mode's sharded transform, which
      owns the multiply; ``multiplier_half`` and ``spectral_reduce`` are
      then unused).

    Production single-device callers leave all three ``None``.  A hooked
    call is forward-only, as in the JAX package: it runs on detached
    values and its output carries no graph.
    """
    batched = x.ndim == 2
    xb = x if batched else x[:, None]
    if grid_hook is None and spectral_reduce is None and spectral_op is None:
        y = _spectral_mid(plan, multiplier_half,
                          window_spread(plan, src, xb))
        out = window_gather(plan, tgt, y)
    else:
        with torch.no_grad():
            g = _spread(plan, src, xb.detach())
            if grid_hook is not None:
                g = grid_hook(g)
            if spectral_op is not None:
                y = spectral_op(g).to(g.dtype)
            else:
                y = _spectral_mid(plan, multiplier_half.detach(), g,
                                  spectral_reduce)
            out = _gather(plan, tgt, y)
    return out if batched else out[:, 0]


# the JAX package's name for y = W̃ x
fused_matvec_tilde = fused_pipeline


# ---------------------------------------------------------------------------
# Multiplier banks: one spread and one forward rfftn shared by S operators,
# differentiable as the single pipeline is; the distributed matvec's
# spectral_reduce / spectral_op hooks as in fused_pipeline.
# ---------------------------------------------------------------------------

def stack_multipliers(plan: NfftPlan, b_hats) -> torch.Tensor:
    """Stack per-member fused multipliers into an ``(S,) + half-spectrum``
    bank: members share the plan, only their Fourier coefficients differ."""
    return torch.stack([fused_spectral_multiplier(plan, bh) for bh in b_hats])


def _bank_multiply(plan: NfftPlan, multiplier_bank: torch.Tensor,
                   g_hat: torch.Tensor, broadcast: bool) -> torch.Tensor:
    """Bank spectral multiply -> flat (..., S*C) half-spectrum product,
    bank-major.  ``broadcast``: g_hat's C channels go to every member;
    else g_hat holds S*C lockstep channels, C per member."""
    d, nb = plan.d, multiplier_bank.shape[0]
    mb = torch.movedim(multiplier_bank, 0, -1)  # spectrum + (S,)
    if broadcast:
        gh = g_hat[..., None, :]  # spectrum + (1, C)
    else:
        gh = g_hat.reshape(g_hat.shape[:d] + (nb, g_hat.shape[-1] // nb))
    prod = mb[..., :, None].to(g_hat.dtype) * gh  # spectrum + (S, C)
    return prod.reshape(prod.shape[:d] + (-1,))


def _bank_columns_transform(plan: NfftPlan, multiplier_bank: torch.Tensor,
                            src: WindowGeometry, xb: torch.Tensor, *,
                            broadcast: bool, spectral_reduce=None,
                            spectral_op=None) -> torch.Tensor:
    """spread -> rfftn -> bank multiply -> batched irfftn of ``xb`` (n, K):
    the gather-ready grid ``(M,)*d + (K*S,)`` (broadcast) or ``(K,)``
    (lockstep, K = S*C), real, FFT order.  It depends only on the source
    side, so any number of target sets can be gathered from it.  The hooks
    are :func:`fused_pipeline`'s, with the bank stacked into the channel
    axis (``spectral_op`` owns the bank multiply)."""
    dims = tuple(range(plan.d))
    g = window_spread(plan, src, xb)
    if spectral_op is not None:
        return spectral_op(g).to(xb.dtype)
    g_hat = torch.fft.rfftn(g, dim=dims)
    flat = _bank_multiply(plan, multiplier_bank, g_hat, broadcast)
    if spectral_reduce is not None:
        flat = _reduce_support(plan, flat, spectral_reduce)
    y = torch.fft.irfftn(flat, s=(plan.grid_size,) * plan.d, dim=dims)
    return y.to(xb.dtype)


def fused_pipeline_bank(plan: NfftPlan, multiplier_bank: torch.Tensor,
                        src: WindowGeometry, tgt: WindowGeometry,
                        x: torch.Tensor, spectral_reduce=None,
                        spectral_op=None) -> torch.Tensor:
    """Bank matvec: one spread, one rfftn, one batched irfftn and one
    gather for all S members of ``multiplier_bank`` ((S,) + half-spectrum).

    Broadcast: ``x`` (n,) or (n, C), every member on the same columns ->
    (S, n) / (S, n, C).  Lockstep: ``x`` (S, n, C), member ``s`` on
    ``x[s]`` -> (S, n, C); its S*C columns ride the channel axis.

    ``spectral_reduce`` / ``spectral_op`` are :func:`fused_pipeline`'s
    distribution hooks: the reduce maps the support block of the
    multiplied half-spectrum with the bank stacked into the channel axis;
    the op maps the spread grid to the inverse-transformed grid with S*C
    channels (it owns the bank multiply).  A hooked call is forward-only.
    """
    nb = multiplier_bank.shape[0]
    lockstep = x.ndim == 3
    if lockstep:
        if x.shape[0] != nb:
            raise ValueError(
                f"lockstep x has bank axis {x.shape[0]}, bank has {nb}")
        c = x.shape[-1]
        xb = x.permute(1, 0, 2).reshape(x.shape[1], nb * c)
    else:
        batched = x.ndim == 2
        xb = x if batched else x[:, None]
        c = xb.shape[-1]
    if spectral_reduce is None and spectral_op is None:
        y = _bank_columns_transform(plan, multiplier_bank, src, xb,
                                    broadcast=not lockstep)
        out = window_gather(plan, tgt, y)
    else:
        with torch.no_grad():
            y = _bank_columns_transform(
                plan, multiplier_bank.detach(), src, xb.detach(),
                broadcast=not lockstep, spectral_reduce=spectral_reduce,
                spectral_op=spectral_op)
            out = _gather(plan, tgt, y)
    out = out.reshape(out.shape[0], nb, c).permute(1, 0, 2)  # (S, n, C)
    if lockstep or batched:
        return out
    return out[..., 0]


def fused_pipeline_bank_columns(plan: NfftPlan, multiplier_bank: torch.Tensor,
                                src: WindowGeometry, tgt: WindowGeometry,
                                u: torch.Tensor) -> torch.Tensor:
    """Lockstep bank matvec in flat columns: (n, S*C) -> (n, S*C), column
    ``s*C + j`` belonging to member ``s``: the solvers' layout, with no
    bank-axis copies."""
    nb = multiplier_bank.shape[0]
    if u.ndim != 2 or u.shape[-1] % nb:
        raise ValueError(
            f"columns input must be (n, S*C) with S={nb}, got "
            f"{tuple(u.shape)}")
    return window_gather(plan, tgt, _bank_columns_transform(
        plan, multiplier_bank, src, u, broadcast=False))


def fused_transform_columns(plan: NfftPlan, multiplier_columns: torch.Tensor,
                            src: WindowGeometry,
                            xb: torch.Tensor) -> torch.Tensor:
    """Column ``j`` of ``xb`` (n, K) through multiplier ``j`` of
    ``multiplier_columns`` ((K,) + half-spectrum) -> the grid
    ``(M,)*d + (K,)``: one spread, one rfftn and one batched irfftn for all
    K columns, the gather-ready state a serving tick caches."""
    return _bank_columns_transform(plan, multiplier_columns, src, xb,
                                   broadcast=False)


def fused_gather_columns(plan: NfftPlan, tgt: WindowGeometry,
                         grid: torch.Tensor,
                         col_index: torch.Tensor) -> torch.Tensor:
    """Ragged packed gather: row ``r`` of the target geometry reads channel
    ``col_index[r]`` of ``grid`` ((M,)*d + (K,)) -> (m,).  All K channels
    are gathered, then each row keeps its own (``take_along_axis`` in the
    JAX package): one gather launch serves many requests' rows."""
    out = window_gather(plan, tgt, grid)  # (m, K)
    idx = torch.as_tensor(col_index, device=out.device).to(torch.long)
    return torch.gather(out, 1, idx[:, None])[:, 0]


# the JAX package's names for y[s] = W̃_s x
fused_matvec_tilde_bank = fused_pipeline_bank
fused_matvec_tilde_bank_columns = fused_pipeline_bank_columns
