"""NFFT plan and separable window geometry, in PyTorch.

Counterpart of ``repro.core.nfft`` for the fused fast-summation engine:
the static :class:`NfftPlan` (oversampled grid size M, window cut-off m,
Kaiser–Bessel or Gaussian window, deconvolution grid), Morton ordering of
the nodes, and :class:`WindowGeometry`, the O(n*d*taps) per-node window
data the spread/gather kernels consume.  Conventions follow the paper
(Section 3): nodes in ``[-1/2, 1/2)^d``, coefficient arrays of shape
``(N,)*d`` in FFT order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.special
import torch

from repro_torch.kernels.nfft_window import TilePlan, build_tile_plan

KAISER_BESSEL = "kaiser_bessel"
GAUSSIAN_WINDOW = "gaussian"


@dataclasses.dataclass(frozen=True)
class NfftPlan:
    """Static NFFT parameters."""

    d: int
    n_bandwidth: int  # N, even
    m: int  # window cut-off
    sigma_os: float = 2.0  # oversampling factor
    window: str = KAISER_BESSEL

    def __post_init__(self):
        if self.n_bandwidth % 2:
            raise ValueError("bandwidth N must be even")
        if self.d < 1 or self.m < 1:
            raise ValueError(f"need d >= 1 and m >= 1, got {self.d}, {self.m}")

    @property
    def grid_size(self) -> int:
        """Oversampled grid size M per dimension (even, >= sigma_os*N)."""
        m_grid = int(np.ceil(self.sigma_os * self.n_bandwidth / 2) * 2)
        return max(m_grid, self.n_bandwidth + 2 * self.m + 2)

    @property
    def taps(self) -> int:
        return 2 * self.m + 1

    def window_b(self) -> float:
        sigma = self.grid_size / self.n_bandwidth
        if self.window == KAISER_BESSEL:
            return float(np.pi * (2.0 - 1.0 / sigma))
        if self.window == GAUSSIAN_WINDOW:
            return float((2.0 * sigma / (2.0 * sigma - 1.0)) * self.m / np.pi)
        raise ValueError(self.window)

    def window_spatial(self, x: torch.Tensor) -> torch.Tensor:
        """phi(x), normalized by e^{-b m} (KB) to stay finite in float32.

        The normalization cancels because ``phi`` is always paired with a
        division by ``phi_hat`` carrying the same factor.
        """
        m, grid = self.m, self.grid_size
        b = self.window_b()
        if self.window == KAISER_BESSEL:
            t = m * m - (grid * x) ** 2
            s = torch.sqrt(torch.clamp(t, min=0.0))
            # sinh(b s)/(pi s) * e^{-b m}, overflow-free:
            #   = e^{b(s-m)} (1 - e^{-2 b s}) / (2 pi s)
            num = torch.exp(b * (s - m)) * (1.0 - torch.exp(-2.0 * b * s))
            tiny = s > 1e-12
            safe_s = torch.where(tiny, s, torch.ones_like(s))
            val = torch.where(tiny, num / (2.0 * np.pi * safe_s),
                              torch.full_like(s, b * np.exp(-b * m) / np.pi))
            return torch.where(t >= 0, val, torch.zeros_like(val))
        if self.window == GAUSSIAN_WINDOW:
            val = torch.exp(-((grid * x) ** 2) / b) / np.sqrt(np.pi * b)
            return torch.where(torch.abs(grid * x) <= m, val,
                               torch.zeros_like(val))
        raise ValueError(self.window)

    def deconvolution_grid(self) -> np.ndarray:
        """prod_t phi_hat(l_t) on the (N,)*d coefficient grid, FFT order."""
        return _deconvolution_grid_cached(self)


def _window_fourier_1d_np(plan: NfftPlan, k: np.ndarray) -> np.ndarray:
    """phi_hat(k) per dimension, same e^{-b m} normalization as spatial."""
    m, grid = plan.m, plan.grid_size
    b = plan.window_b()
    if plan.window == KAISER_BESSEL:
        arg = b * b - (2.0 * np.pi * k / grid) ** 2
        s = np.sqrt(np.maximum(arg, 0.0))
        val = scipy.special.i0e(m * s) * np.exp(m * s - b * m)
        return np.where(arg >= 0, val, np.exp(-b * m)) / grid
    if plan.window == GAUSSIAN_WINDOW:
        return np.exp(-b * (np.pi * k / grid) ** 2) / grid
    raise ValueError(plan.window)


@functools.lru_cache(maxsize=None)
def _deconvolution_grid_cached(plan: NfftPlan) -> np.ndarray:
    freqs = np.fft.fftfreq(plan.n_bandwidth, d=1.0 / plan.n_bandwidth)
    one_d = _window_fourier_1d_np(plan, freqs)
    out = one_d
    for _ in range(plan.d - 1):
        out = out[..., None] * one_d
    out.setflags(write=False)  # shared by every caller of the cache
    return out


@functools.lru_cache(maxsize=None)
def _embed_map(plan: NfftPlan) -> np.ndarray:
    """Per-dim index map from FFT-order I_N positions to I_M positions."""
    n, grid = plan.n_bandwidth, plan.grid_size
    k = np.fft.fftfreq(n, d=1.0 / n).astype(np.int64)  # signed freqs
    out = np.mod(k, grid)
    out.setflags(write=False)
    return out


@dataclasses.dataclass
class WindowGeometry:
    """Separable window geometry of a node set, Morton-sorted.

    base: (n, d) int32 — leftmost tap corner in padded-grid coordinates.
    weights: (n, d, taps) — per-dimension window values.
    perm: (n,) int64 — row ``r`` holds node ``perm[r]``.
    inv: (n,) int64 — the inverse permutation (node ``j`` is row
      ``inv[j]``), built once here instead of on every gather.

    :attr:`tiles`, the window kernels' tile plan, is built at first use
    and kept: it depends only on ``base`` and ``taps``.
    """

    base: torch.Tensor
    weights: torch.Tensor
    perm: torch.Tensor
    inv: torch.Tensor
    _tiles: TilePlan | None = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def tiles(self) -> TilePlan:
        if self._tiles is None:
            self._tiles = build_tile_plan(self.base, self.weights.shape[2])
        return self._tiles

    @classmethod
    def from_sorted(cls, base: torch.Tensor, weights: torch.Tensor,
                    perm: torch.Tensor) -> "WindowGeometry":
        perm = perm.to(torch.long)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        return cls(base=base.to(torch.int32).contiguous(),
                   weights=weights.contiguous(), perm=perm, inv=inv)


def morton_codes(cells: torch.Tensor, grid_size: int,
                 dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Z-order (Morton) codes for integer cell coordinates (n, d)."""
    n, d = cells.shape
    bits = max(1, int(grid_size - 1).bit_length())
    if bits * d > torch.iinfo(dtype).bits - 2:
        raise ValueError(f"{bits * d} code bits do not fit {dtype}")
    code = torch.zeros((n,), dtype=dtype, device=cells.device)
    cells = cells.to(dtype)
    for b in range(bits):
        for t in range(d):
            code = code | (((cells[:, t] >> b) & 1) << (b * d + t))
    return code


def _morton_perm(cells: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Stable argsort by Morton code (ties keep node order, as jnp.argsort).

    Codes that would overflow int64 skip the sort: ordering is a layout
    optimization, never a semantic requirement.
    """
    n, d = cells.shape
    bits = max(1, int(grid_size - 1).bit_length())
    if bits * d <= 30:
        codes = morton_codes(cells, grid_size)
    elif bits * d <= 62:
        codes = morton_codes(cells, grid_size, dtype=torch.int64)
    else:
        return torch.arange(n, device=cells.device)
    return torch.argsort(codes, stable=True)


def _window_taps_1d(plan: NfftPlan, nodes: torch.Tensor):
    """Per-dim leftmost taps (n, d) int32 and window values (n, d, taps)."""
    grid, m, taps = plan.grid_size, plan.m, plan.taps
    y = nodes * grid
    base = torch.floor(y).to(torch.int32) - m  # (n, d)
    offs = torch.arange(taps, dtype=torch.int32, device=nodes.device)
    idx_d = base[:, :, None] + offs[None, None, :]  # (n, d, taps)
    dist = nodes[:, :, None] - idx_d.to(nodes.dtype) / grid
    return base, plan.window_spatial(dist)


def window_shift(plan: NfftPlan) -> int:
    """Offset from unwrapped tap coordinates to padded-grid coordinates."""
    return plan.grid_size // 2 + plan.m


def padded_grid_size(plan: NfftPlan) -> int:
    """Per-dim size of the wrap-padded grid the window spread scatters into."""
    return plan.grid_size + plan.taps - 1


def build_window_geometry(plan: NfftPlan, nodes: torch.Tensor, *,
                          sort: bool = True) -> WindowGeometry:
    """Separable window geometry for nodes (n, d) in [-1/2, 1/2)^d."""
    n, d = nodes.shape
    if d != plan.d:
        raise ValueError(f"nodes have d={d}, plan has d={plan.d}")
    base, w_d = _window_taps_1d(plan, nodes)
    base = base + window_shift(plan)  # into [0, grid_size)
    if sort:
        perm = _morton_perm(base, plan.grid_size)
    else:
        perm = torch.arange(n, device=nodes.device)
    return WindowGeometry.from_sorted(base[perm], w_d[perm], perm)


# ---------------------------------------------------------------------------
# Flat tensor-product geometry and the two-NFFT oracle transforms.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NfftGeometry:
    """Flattened tensor-product window geometry (oracle transforms only).

    The fused engine runs on the separable :class:`WindowGeometry`; this
    O(n * taps^d) layout serves the two-NFFT reference path
    (:func:`nfft_forward` / :func:`nfft_adjoint`), plain torch ops with no
    hand-written kernel, so that path is independent of the window kernels.

    indices: (n, taps^d) int64 — flattened oversampled-grid indices.
    weights: (n, taps^d) float — tensor-product window values.
    perm: optional (n,) int64 — row ``r`` holds the geometry of node
      ``perm[r]`` (Morton order); ``None`` means node order.
    """

    indices: torch.Tensor
    weights: torch.Tensor
    perm: torch.Tensor | None = None

    @property
    def n_nodes(self) -> int:
        return self.indices.shape[0]


def build_geometry(plan: NfftPlan, nodes: torch.Tensor, *,
                   sort: bool = True) -> NfftGeometry:
    """Flat window geometry for nodes (n, d) in [-1/2, 1/2)^d.

    With ``sort=True`` rows are ordered by the Morton code of the node's
    base grid cell and the permutation is kept in ``perm``; the transforms
    undo it, so their results do not depend on ``sort``.
    """
    n, d = nodes.shape
    if d != plan.d:
        raise ValueError(f"nodes have d={d}, plan has d={plan.d}")
    grid, taps = plan.grid_size, plan.taps
    base, w_d = _window_taps_1d(plan, nodes)
    offs = torch.arange(taps, dtype=torch.int64, device=nodes.device)
    idx_mod = torch.remainder(base.to(torch.int64)[:, :, None] + offs, grid)
    flat_idx, flat_w = idx_mod[:, 0, :], w_d[:, 0, :]
    for t in range(1, d):  # tensor product across dimensions, C order
        flat_idx = (flat_idx[:, :, None] * grid
                    + idx_mod[:, t, None, :]).reshape(n, -1)
        flat_w = (flat_w[:, :, None] * w_d[:, t, None, :]).reshape(n, -1)
    perm = None
    if sort:
        cells = torch.remainder(base + plan.m, grid)  # node cell in [0, M)
        perm = _morton_perm(cells, grid)
        flat_idx, flat_w = flat_idx[perm], flat_w[perm]
    return NfftGeometry(indices=flat_idx.contiguous(),
                        weights=flat_w.contiguous(), perm=perm)


def _embed_mesh(plan: NfftPlan, device) -> tuple:
    emb = torch.tensor(_embed_map(plan), device=device)
    return torch.meshgrid(*([emb] * plan.d), indexing="ij")


def nfft_forward(plan: NfftPlan, geometry: NfftGeometry,
                 f_hat: torch.Tensor) -> torch.Tensor:
    """Forward NFFT.  f_hat: (N,)*d [+ trailing C] -> (n,) [, C], complex.

    Deconvolve, embed I_N into I_M, inverse FFT (scaled 1/M^d), then each
    node sums its window of the grid.
    """
    d, grid = plan.d, plan.grid_size
    batched = f_hat.ndim == d + 1
    if not batched:
        f_hat = f_hat[..., None]
    c = f_hat.shape[-1]
    dev = f_hat.device
    cdt = torch.complex64 if f_hat.dtype in (torch.float32, torch.complex64) \
        else torch.complex128
    phi_hat = torch.tensor(plan.deconvolution_grid(), device=dev)
    g_hat = f_hat.to(cdt) / phi_hat[..., None]
    big = torch.zeros((grid,) * d + (c,), dtype=cdt, device=dev)
    big[_embed_mesh(plan, dev)] = g_hat
    g = torch.fft.ifftn(big, dim=tuple(range(d)))
    vals = g.reshape(-1, c)[geometry.indices.reshape(-1)]
    vals = vals.reshape(*geometry.indices.shape, c)
    out = (vals * geometry.weights[..., None].to(cdt)).sum(dim=1)
    if geometry.perm is not None:  # rows are Morton-sorted: node order
        out = torch.zeros_like(out).index_copy_(0, geometry.perm, out)
    return out if batched else out[..., 0]


def nfft_adjoint(plan: NfftPlan, geometry: NfftGeometry,
                 x: torch.Tensor) -> torch.Tensor:
    """Adjoint NFFT.  x: (n,) [+ trailing C] -> (N,)*d [, C], complex.

    The exact matrix adjoint of :func:`nfft_forward`: spread
    (``index_add_``), FFT, extract I_N, deconvolve by M^d * phi_hat.
    """
    d, grid = plan.d, plan.grid_size
    batched = x.ndim == 2
    if not batched:
        x = x[..., None]
    c = x.shape[-1]
    dev = x.device
    if geometry.perm is not None:  # rows are Morton-sorted: align x
        x = x[geometry.perm]
    dtype = torch.promote_types(x.dtype, geometry.weights.dtype)
    vals = geometry.weights[..., None].to(dtype) * x[:, None, :].to(dtype)
    g_flat = torch.zeros((grid ** d, c), dtype=dtype, device=dev)
    g_flat.index_add_(0, geometry.indices.reshape(-1), vals.reshape(-1, c))
    g_hat = torch.fft.fftn(g_flat.reshape((grid,) * d + (c,)),
                           dim=tuple(range(d)))
    small = g_hat[_embed_mesh(plan, dev)]
    phi_hat = torch.tensor(plan.deconvolution_grid(), device=dev)
    out = small / ((grid ** d) * phi_hat)[..., None]
    return out if batched else out[..., 0]


def _frequencies(n_bandwidth: int, d: int, nodes: torch.Tensor):
    freqs = torch.fft.fftfreq(n_bandwidth, d=1.0 / n_bandwidth,
                              dtype=nodes.dtype, device=nodes.device)
    grids = torch.meshgrid(*([freqs] * d), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)  # (N^d, d)


def ndft_forward(n_bandwidth: int, nodes: torch.Tensor,
                 f_hat: torch.Tensor) -> torch.Tensor:
    """Direct O(n N^d) forward transform, the NFFT's own oracle."""
    d = nodes.shape[1]
    freq = _frequencies(n_bandwidth, d, nodes)
    phase = torch.exp(2j * np.pi * (nodes @ freq.T))  # (n, N^d)
    flat = f_hat.reshape(n_bandwidth ** d, *f_hat.shape[d:])
    return phase @ flat.to(phase.dtype)


def ndft_adjoint(n_bandwidth: int, nodes: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Direct O(n N^d) adjoint transform."""
    d = nodes.shape[1]
    freq = _frequencies(n_bandwidth, d, nodes)
    phase = torch.exp(-2j * np.pi * (freq @ nodes.T))  # (N^d, n)
    out = phase @ x.to(phase.dtype)
    return out.reshape((n_bandwidth,) * d + tuple(x.shape[1:]))
