"""Pencil-decomposed distributed real FFT over ``torch.distributed``.

The port of ``repro.dist.pencil_fft``.  The psum spectral mode of
:mod:`repro_torch.dist.fastsum_dist` keeps the whole oversampled grid on
every rank and all-reduces the multiplied half-spectrum's support block,
so a rank's spectrum memory and payload stay constant as the mesh grows.
This module shards the transform itself:

    forward (``pencil_rfftn``), grid sharded along its leading axes:
        local rfftn over the unsharded trailing axes
        -> all_to_all transpose (spectrum axis <-> grid axis 1)
        -> FFT along grid axis 1
        -> all_to_all transpose (grid axis 1 <-> grid axis 0)
        -> FFT along the formerly sharded leading axis.
    inverse (``pencil_irfftn``) mirrors the forward exactly.

A :class:`PencilSpec` says how: grid axis 0 is sharded over the ``row``
mesh-axis group (size R <= M) and, for d >= 3, grid axis 1 over the
``col`` group (size C <= M), so up to M^2 ranks hold (M/R, M/C, M, ...)
pencils; mesh axes in neither group are ``extra`` and closed by a psum on
the already scattered pencil.  d = 1 has no trailing axis to keep local,
so callers fall back to the psum mode.

Every function runs on each rank with its own block and takes the
:class:`repro_torch.launch.mesh.Mesh` whose collectives it calls; blocks
go in :meth:`~repro_torch.launch.mesh.Mesh.group_index` order, first axis
name major, so multiplier slabs line up with the reduce-scatter and
all-gather placement.  The FFTs are ``torch.fft`` (cuFFT on the card).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class PencilSpec:
    """Static description of how the oversampled grid is penciled.

    ``row_axes``/``col_axes`` shard grid axes 0/1 (sizes must divide the
    grid); ``extra_axes`` are the remaining node-shard mesh axes whose
    partial sums are closed by psum.
    """

    d: int
    grid: int  # oversampled grid size M per dimension
    row_axes: tuple[str, ...]
    row_sizes: tuple[int, ...]
    col_axes: tuple[str, ...] = ()
    col_sizes: tuple[int, ...] = ()
    extra_axes: tuple[str, ...] = ()

    def __post_init__(self):
        if self.d < 2:
            raise ValueError("pencil decomposition needs a trailing grid axis")
        if self.grid % self.row_size or self.grid % self.col_size:
            raise ValueError(f"groups {self.row_axes} / {self.col_axes} do "
                             f"not divide the grid {self.grid}")
        if self.col_axes and self.d < 3:
            raise ValueError("d=2 has a single shardable grid axis (slab "
                             "decomposition only)")

    @property
    def row_size(self) -> int:
        return math.prod(self.row_sizes) if self.row_axes else 1

    @property
    def col_size(self) -> int:
        return math.prod(self.col_sizes) if self.col_axes else 1

    @property
    def half(self) -> int:
        """rfft-axis length K = M//2 + 1."""
        return self.grid // 2 + 1

    def padded_half(self, group: int) -> int:
        """K rounded up so the rfft axis splits evenly over ``group``."""
        return -(-self.half // group) * group


def make_pencil_spec(mesh, axes, grid: int, d: int, *,
                     pencil_axes=None) -> PencilSpec:
    """Partition the node-shard mesh ``axes`` into row/col/extra groups.

    Greedy: each axis (in order) joins the row group if the grown product
    still divides ``grid``, else (d >= 3) the col group likewise; axes that
    fit neither become extra (psum) axes.  ``pencil_axes=(row_axes,
    col_axes)`` overrides the split (disjoint subsets of ``axes``).  Reads
    only ``mesh.shape[a]``.
    """
    axes = tuple(axes)
    sizes = {a: int(mesh.shape[a]) for a in axes}
    if pencil_axes is not None:
        row, col = tuple(pencil_axes[0]), tuple(pencil_axes[1])
        if not (set(row) | set(col) <= set(axes)) or set(row) & set(col):
            raise ValueError(f"pencil_axes {row} / {col} must be disjoint "
                             f"subsets of {axes}")
    else:
        row, col = [], []
        prods = {0: 1, 1: 1}
        for a in axes:
            for group, target in ((row, 0),) + (((col, 1),) if d >= 3
                                                else ()):
                grown = prods[target] * sizes[a]
                if grown <= grid and grid % grown == 0:
                    prods[target] = grown
                    group.append(a)
                    break
        row, col = tuple(row), tuple(col)
    extra = tuple(a for a in axes if a not in row and a not in col)
    return PencilSpec(
        d=d, grid=grid,
        row_axes=row, row_sizes=tuple(sizes[a] for a in row),
        col_axes=col, col_sizes=tuple(sizes[a] for a in col),
        extra_axes=extra)


def group_index(mesh: Mesh, axes: tuple[str, ...]) -> int:
    """This rank's position in the axis group (first name major): the
    block the group's reduce-scatter and all-gather give it."""
    return mesh.group_index(axes) if axes else 0


def _a2a(x: torch.Tensor, mesh: Mesh, axes, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    if not axes:
        return x  # no group: the tiled all_to_all is the identity
    return mesh.all_to_all(x, axes, split_axis, concat_axis)


def _zero_pad(h: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``h`` zero-padded along ``axis`` to ``size`` (exact zeros)."""
    if h.shape[axis] == size:
        return h
    shape = list(h.shape)
    shape[axis] = size
    out = h.new_zeros(shape)
    out.narrow(axis, 0, h.shape[axis]).copy_(h)
    return out


def pencil_accumulate(g: torch.Tensor, spec: PencilSpec,
                      mesh: Mesh) -> torch.Tensor:
    """Sum per-rank spread grids across the mesh, scattered into pencils.

    ``g``: this rank's full local grid ``(M,)*d + (C,)``.  Returns this
    rank's ``(M/R, M/C, M, ..., M, C)`` pencil of the global sum.  The
    scatters run first, so the psum over the extra axes moves pencils.
    """
    if spec.row_size > 1:
        g = mesh.psum_scatter(g, spec.row_axes, 0)
    if spec.col_size > 1:
        g = mesh.psum_scatter(g, spec.col_axes, 1)
    if spec.extra_axes:
        g = mesh.psum(g, spec.extra_axes)
    return g


def pencil_allgather(y: torch.Tensor, spec: PencilSpec,
                     mesh: Mesh) -> torch.Tensor:
    """Reassemble the full local grid from per-rank pencils (the inverse of
    the scatter half of :func:`pencil_accumulate`)."""
    if spec.col_size > 1:
        y = mesh.all_gather(y, spec.col_axes, 1)
    if spec.row_size > 1:
        y = mesh.all_gather(y, spec.row_axes, 0)
    return y


def pencil_rfftn(g: torch.Tensor, spec: PencilSpec,
                 mesh: Mesh) -> torch.Tensor:
    """Distributed rfftn of a grid pencil (real -> half-spectrum slab).

    Input: ``(M/R, M/C, M, ..., M, C)`` real pencil (d=2: ``(M/R, M, C)``).
    Output layout (grid axes keep their identity; only the sharding moves):

        d == 2 : ``(M, Kp/R, C)``          axis 1 = padded rfft axis,
                 row-sharded
        d >= 3 : ``(M, M/R, M, ..., Kp/C, C)``  axis 1 row-sharded, last
                 grid axis = padded rfft axis, col-sharded

    with ``Kp = padded_half(group)`` (K = M//2+1 zero-padded so it splits
    evenly; the pad carries exact zeros end to end).
    """
    d, rows, cols = spec.d, spec.row_size, spec.col_size
    if d == 2:
        h = torch.fft.rfft(g, dim=1)
        if rows > 1:
            h = _zero_pad(h, 1, spec.padded_half(rows))
            h = _a2a(h, mesh, spec.row_axes, 1, 0)
        return torch.fft.fft(h, dim=0)
    h = torch.fft.rfftn(g, dim=tuple(range(2, d)))
    if cols > 1:
        h = _zero_pad(h, d - 1, spec.padded_half(cols))
        h = _a2a(h, mesh, spec.col_axes, d - 1, 1)
    h = torch.fft.fft(h, dim=1)
    if rows > 1:
        h = _a2a(h, mesh, spec.row_axes, 1, 0)
    return torch.fft.fft(h, dim=0)


def pencil_irfftn(gh: torch.Tensor, spec: PencilSpec,
                  mesh: Mesh) -> torch.Tensor:
    """Exact mirror of :func:`pencil_rfftn` (half-spectrum slab -> real)."""
    d, rows, cols, grid = spec.d, spec.row_size, spec.col_size, spec.grid
    if d == 2:
        h = torch.fft.ifft(gh, dim=0)
        if rows > 1:
            h = _a2a(h, mesh, spec.row_axes, 0, 1)
            h = h[:, : spec.half]
        return torch.fft.irfft(h, n=grid, dim=1)
    h = torch.fft.ifft(gh, dim=0)
    if rows > 1:
        h = _a2a(h, mesh, spec.row_axes, 0, 1)
    h = torch.fft.ifft(h, dim=1)
    if cols > 1:
        h = _a2a(h, mesh, spec.col_axes, 1, d - 1)
        h = h[..., : spec.half, :]
    return torch.fft.irfftn(h, s=(grid,) * (d - 2), dim=tuple(range(2, d)))


def multiplier_slab(mult_half: torch.Tensor, spec: PencilSpec,
                    mesh: Mesh) -> torch.Tensor:
    """This rank's slab of the fused spectral multiplier.

    ``mult_half``: the replicated ``(M,)*(d-1) + (K,)`` half-spectrum
    multiplier (FFT order).  Returns the block matching the
    :func:`pencil_rfftn` output layout for this rank (cut at
    :func:`group_index`; the rfft axis zero-padded like the spectrum, so
    pad bins multiply to exact zeros).
    """
    d, grid = spec.d, spec.grid
    r = group_index(mesh, spec.row_axes)
    if d == 2:
        kp = spec.padded_half(spec.row_size)
        s = kp // spec.row_size
        return _zero_pad(mult_half, 1, kp).narrow(1, r * s, s)
    kp = spec.padded_half(spec.col_size)
    c = group_index(mesh, spec.col_axes)
    s = kp // spec.col_size
    rows = grid // spec.row_size
    return _zero_pad(mult_half, d - 1, kp).narrow(1, r * rows, rows) \
        .narrow(d - 1, c * s, s)
