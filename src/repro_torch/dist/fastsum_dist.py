"""Sharded NFFT fast summation (distributed Algorithm 3.1) on
``torch.distributed``.

The port of ``repro.dist.fastsum_dist``.  The dense kernel matvec
``y = W̃ x`` factors as

    spread  ->  FFT  ->  spectral multiply  ->  IFFT  ->  gather

and only the spectral accumulation couples nodes across shards.  The node
dimension is sharded: each rank spreads and gathers only its block of the
Morton-sorted rows, with the window kernels of
:mod:`repro_torch.kernels.nfft_window` on its shard's geometry.  Two
spectral modes carry the one cross-shard accumulation
(``distributed_matvec_fn(..., spectral_mode=...)``):

``"psum"`` (default)
    Each rank spreads its rows onto the oversampled grid and runs the real
    FFT locally; one all_reduce of the *support block* of the multiplied
    half-spectrum (~``N^d/2`` complex, independent of ``n``) completes the
    sum, and the inverse FFT and gather are local again.

``"pencil"``
    The transform itself is sharded (:mod:`repro_torch.dist.pencil_fft`):
    a reduce_scatter of the spread grid into pencils, local trailing-axis
    FFTs with all_to_all transposes, each rank's multiplier *slab*, and an
    all_gather of the inverse-transformed pencils for the local gather.
    ``d = 1``, or a mesh where no axis divides the grid, falls back to the
    psum path (one ``RuntimeWarning`` a process says so).

SPMD contract: every rank builds the same operator from the same points
and calls ``mv(x)`` with the same ``x``; every rank gets the whole ``y``
(one all_gather of the row blocks), bitwise the same on every rank, so
``eigsh``, ``cg`` and the bank solvers run unchanged over ``mv`` on every
rank.  Operator data a rank computes alone with atomics may differ in
its last bits from another rank's (on the card: the degrees of
``make_normalized_adjacency``, from an atomic spread); data the ranks'
iterations share is taken through the distributed matvec (the degrees as
``mv(ones)``) or under ``torch.use_deterministic_algorithms``.  The caller
initialises the process group and picks its backend and device; nothing
here switches either.  The JAX package's seed body
``_spectral_matvec_local`` and its ``jit=`` option belong to its dry-run
tooling and are not ported.
"""

from __future__ import annotations

import math
import warnings

import torch

from repro_torch.core import fastsum_exec
from repro_torch.core.nfft import NfftPlan, WindowGeometry
from repro_torch.dist import pencil_fft

SPECTRAL_MODES = ("psum", "pencil")


def _fused_matvec_local(plan: NfftPlan, mult_half: torch.Tensor,
                        geometry: WindowGeometry, x: torch.Tensor, mesh,
                        axes: tuple[str, ...]) -> torch.Tensor:
    """Per-shard psum-mode body: the one cross-shard collective is the
    all_reduce of the multiplied half-spectrum's support block, through
    the single-device pipeline's ``spectral_reduce`` hook."""
    reduce = (lambda block: mesh.psum(block, axes)) if axes else None
    return fastsum_exec.fused_pipeline(plan, mult_half, geometry, geometry,
                                       x, spectral_reduce=reduce)


def _pencil_spectrum(g: torch.Tensor, spec: pencil_fft.PencilSpec, mesh):
    """The spread grid's pencil spectrum: reduce-scatter, then rfftn."""
    return pencil_fft.pencil_rfftn(
        pencil_fft.pencil_accumulate(g, spec, mesh), spec, mesh)


def _pencil_grid(gh: torch.Tensor, spec: pencil_fft.PencilSpec, mesh,
                 dtype: torch.dtype) -> torch.Tensor:
    """irfftn of a multiplied pencil spectrum, all-gathered to the grid."""
    y = pencil_fft.pencil_irfftn(gh, spec, mesh)
    return pencil_fft.pencil_allgather(y, spec, mesh).to(dtype)


def _pencil_matvec_local(plan: NfftPlan, mult_half: torch.Tensor,
                         geometry: WindowGeometry, x: torch.Tensor,
                         spec: pencil_fft.PencilSpec, mesh,
                         slab: torch.Tensor) -> torch.Tensor:
    """Per-shard pencil-mode body: the ``spectral_op`` hook replaces the
    rfftn -> multiply -> irfftn section with the sharded transform;
    ``slab`` is this rank's :func:`pencil_fft.multiplier_slab`."""

    def spectral_op(g):
        gh = _pencil_spectrum(g, spec, mesh)
        return _pencil_grid(gh * slab.to(gh.dtype)[..., None], spec, mesh,
                            g.dtype)

    return fastsum_exec.fused_pipeline(plan, mult_half, geometry, geometry,
                                       x, spectral_op=spectral_op)


def _fused_matvec_bank_local(plan: NfftPlan, mult_bank: torch.Tensor,
                             geometry: WindowGeometry, x: torch.Tensor, mesh,
                             axes: tuple[str, ...]) -> torch.Tensor:
    """Per-shard psum-mode bank body: ONE all_reduce of the stacked
    support blocks (the S*C system columns ride the channel axis)."""
    reduce = (lambda block: mesh.psum(block, axes)) if axes else None
    return fastsum_exec.fused_pipeline_bank(plan, mult_bank, geometry,
                                            geometry, x,
                                            spectral_reduce=reduce)


def _bank_slabs(mult_bank: torch.Tensor, spec: pencil_fft.PencilSpec,
                mesh) -> torch.Tensor:
    """This rank's multiplier slabs of a bank: slab spectrum + (S,)."""
    return torch.movedim(torch.stack(
        [pencil_fft.multiplier_slab(m, spec, mesh) for m in mult_bank]),
        0, -1)


def _pencil_matvec_bank_local(plan: NfftPlan, mult_bank: torch.Tensor,
                              geometry: WindowGeometry, x: torch.Tensor,
                              spec: pencil_fft.PencilSpec, mesh,
                              slabs: torch.Tensor) -> torch.Tensor:
    """Per-shard pencil-mode bank body: per-rank ``(S, slab)`` multiplier
    slabs (``slabs``, :func:`_bank_slabs`) multiply the shared pencil
    spectrum member-wise; one reduce_scatter / all_gather pair moves the
    S*C-channel pencils."""
    nb = mult_bank.shape[0]
    c = x.shape[-1] if x.ndim >= 2 else 1
    lockstep = x.ndim == 3

    def spectral_op(g):
        gh = _pencil_spectrum(g, spec, mesh)
        if lockstep:
            ghb = gh.reshape(gh.shape[:-1] + (nb, c))
        else:
            ghb = gh[..., None, :]  # the shared spectrum to every member
        prod = slabs[..., :, None].to(gh.dtype) * ghb
        flat = prod.reshape(prod.shape[:-2] + (nb * c,))
        return _pencil_grid(flat, spec, mesh, g.dtype)

    return fastsum_exec.fused_pipeline_bank(plan, mult_bank, geometry,
                                            geometry, x,
                                            spectral_op=spectral_op)


def resolve_pencil_spec(plan: NfftPlan, mesh, axes, pencil_axes=None):
    """PencilSpec the pencil mode would use, or None when it degenerates.

    None means the psum path runs instead: d = 1 (no trailing axis to keep
    local), or a mesh where no axis divides the grid (a degenerate pencil
    would psum the full grid, strictly worse than the support-block
    psum).  Callers that label results by spectral mode read this for the
    mode that runs.
    """
    if plan.d < 2:
        return None
    spec = pencil_fft.make_pencil_spec(mesh, tuple(axes), plan.grid_size,
                                       plan.d, pencil_axes=pencil_axes)
    return None if spec.row_size * spec.col_size == 1 else spec


# One warning per process when a *requested* pencil mode degenerates: the
# psum substitution is correct (same sum, one collective) but the scaling
# the caller asked for is not what runs; say so once.
_PENCIL_FALLBACK_WARNED = [False]


def _note_pencil_fallback(plan: NfftPlan, mesh) -> None:
    if _PENCIL_FALLBACK_WARNED[0]:
        return
    _PENCIL_FALLBACK_WARNED[0] = True
    warnings.warn(
        f"spectral_mode='pencil' degenerates on this configuration "
        f"(d={plan.d}, grid={plan.grid_size}, mesh shape "
        f"{dict(mesh.shape)}): no mesh axis divides the grid into pencils; "
        "degrading to the support-block psum path (same result, "
        "replicated-spectrum scaling)",
        RuntimeWarning, stacklevel=4)


def _spectral_spec(plan: NfftPlan, mesh, axes, spectral_mode: str,
                   pencil_axes):
    """The PencilSpec that runs (None: the psum path)."""
    if spectral_mode not in SPECTRAL_MODES:
        raise ValueError(f"spectral_mode must be one of {SPECTRAL_MODES}, "
                         f"got {spectral_mode!r}")
    if spectral_mode != "pencil":
        return None
    spec = resolve_pencil_spec(plan, mesh, axes, pencil_axes)
    if spec is None:
        _note_pencil_fallback(plan, mesh)
    return spec


def _shard_body(plan: NfftPlan, mesh, axes, spec, psum_body, pencil_body,
                slab_of):
    """``(mult, base, w1d, x_block) -> y_block`` over this rank's rows.

    The rows are globally Morton-sorted and the caller passes ``x`` in row
    order, so the shard's geometry is its slice of ``base`` and ``w1d``
    with an identity perm.  It is built at the first call and kept while
    the same ``base`` and ``w1d`` tensors come back, so its tile plan (on
    the card) is built once, not once a call.  The pencil mode's
    multiplier slab(s), ``slab_of(mult, spec, mesh)``, are kept likewise
    while the same ``mult`` comes back.
    """
    kept = {}

    def body(mult, base, w1d, x_block):
        if kept.get("key") != (id(base), id(w1d)):
            kept["key"] = (id(base), id(w1d))
            kept["args"] = (base, w1d)  # keeps the ids valid
            kept["geometry"] = WindowGeometry.from_sorted(
                base, w1d, torch.arange(base.shape[0], device=base.device))
        geometry = kept["geometry"]
        if spec is None:
            return psum_body(plan, mult, geometry, x_block, mesh, axes)
        if kept.get("mult") is not mult:
            kept["mult"] = mult
            kept["slab"] = slab_of(mult.detach(), spec, mesh)
        return pencil_body(plan, mult, geometry, x_block, spec, mesh,
                           kept["slab"])

    body.spec = spec
    body.geometry = lambda: kept.get("geometry")
    return body


def make_sharded_matvec(plan: NfftPlan, mesh, axes, *,
                        spectral_mode: str = "psum", pencil_axes=None):
    """Shard-local matvec body ``(mult_half, base, w1d, x) -> y`` in row
    order: ``base``, ``w1d`` and ``x`` are this rank's block of the node
    dimension sharded over ``axes``; the multiplier is replicated.  The
    pencil spec is resolved here, once."""
    axes = tuple(axes)
    spec = _spectral_spec(plan, mesh, axes, spectral_mode, pencil_axes)
    return _shard_body(plan, mesh, axes, spec, _fused_matvec_local,
                       _pencil_matvec_local, pencil_fft.multiplier_slab)


def make_sharded_matvec_bank(plan: NfftPlan, mesh, axes, *,
                             spectral_mode: str = "psum", pencil_axes=None):
    """Shard-local bank body ``(mult_bank, base, w1d, x) -> y``: the bank
    analogue of :func:`make_sharded_matvec`.  ``x`` is (rows, C)
    (broadcast) or (S, rows, C) (lockstep); ``y`` is (S, rows, C).  Each
    shard runs ONE spread and ONE forward transform, and the cross-shard
    sum is one collective: the all_reduce of the stacked support blocks,
    or the pencil reduce_scatter with per-rank ``(S, slab)`` slabs."""
    axes = tuple(axes)
    spec = _spectral_spec(plan, mesh, axes, spectral_mode, pencil_axes)
    return _shard_body(plan, mesh, axes, spec, _fused_matvec_bank_local,
                       _pencil_matvec_bank_local, _bank_slabs)


def _pad_ghost_geometry(win: WindowGeometry, n: int, nshard: int):
    """Ghost-pad a window geometry so the node dimension shards evenly.

    Returns ``(base, w1d, perm, inv_perm, pad)``.  Ghost rows carry zero
    window weights (no spread or gather contribution) and identity perm
    entries.  The JAX package gives them ``base = 0``; here they repeat
    the last real row's base instead, which gives the same result (their
    weights are zero) and keeps them inside the last Morton tile's box: a
    row at cell 0 after the last sorted node would stretch that tile's box
    across the grid, past the window kernels' box budget.
    """
    pad = (-n) % nshard
    base, w1d, perm = win.base, win.weights, win.perm
    if pad:
        base = torch.cat([base, base[-1:].expand(pad, -1)])
        w1d = torch.cat([w1d, w1d.new_zeros((pad,) + w1d.shape[1:])])
        perm = torch.cat([perm, torch.arange(n, n + pad, dtype=perm.dtype,
                                             device=perm.device)])
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                  device=perm.device)
    return base.contiguous(), w1d.contiguous(), perm, inv_perm, pad


class _ShardedRows:
    """This rank's block of an operator's ghost-padded, Morton-sorted
    rows: the padding, the permutations, and the block's ``base`` and
    ``w1d`` (sliced once and kept, so the body's geometry is built once)."""

    def __init__(self, win: WindowGeometry, n: int, mesh, axes):
        self.mesh, self.axes, self.n = mesh, tuple(axes), n
        nshard = math.prod(mesh.shape[a] for a in self.axes)
        base, w1d, self.perm, self.inv_perm, self.pad = \
            _pad_ghost_geometry(win, n, nshard)
        self.rows = (n + self.pad) // nshard
        self.lo = mesh.group_index(self.axes) * self.rows if self.axes \
            else 0
        self.base = base[self.lo: self.lo + self.rows]
        self.w1d = w1d[self.lo: self.lo + self.rows]

    def block(self, xp: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's rows of ``xp`` (node order, padded) along ``dim``,
        in Morton row order."""
        rows = self.perm[self.lo: self.lo + self.rows]
        return xp.index_select(dim, rows)

    def pad_rows(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if not self.pad:
            return x
        shape = list(x.shape)
        shape[dim] = self.pad
        return torch.cat([x, x.new_zeros(shape)], dim=dim)

    def unshard(self, y_block: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather the row blocks along ``dim`` and return node order,
        without the ghost rows: the same bits on every rank."""
        y_sorted = self.mesh.all_gather(y_block, self.axes, dim) \
            if self.axes else y_block
        return y_sorted.index_select(dim, self.inv_perm[: self.n])


def distributed_matvec_fn(op, mesh, axes, *, spectral_mode: str = "psum",
                          pencil_axes=None):
    """Sharded drop-in for ``op.matvec`` (op: :class:`FastsumOperator`).

    Returns ``mv(x)`` computing ``W x = (W̃ - K(0) I) x`` for ``x`` of shape
    (n,) or (n, C), with the node dimension sharded over ``axes`` of
    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`).  The node count is
    padded with zero-weight ghost nodes to a multiple of the shard count,
    so any (n, mesh) works.  ``spectral_mode`` selects the cross-shard
    spectral accumulation (module docstring); ``pencil_axes`` optionally
    overrides the pencil row/col split.  ``mv.rows`` is this rank's
    block (its ``base``, ``w1d``, ``lo`` and ``rows``), ``mv.spec`` the
    pencil spec that runs (None: psum), ``mv.geometry()`` the shard's
    window geometry once a call has built it.
    """
    # op.matvec's own contract: the K(0)-diagonal subtraction is defined
    # only when source and target nodes coincide; a distinct target set
    # (the KRR prediction operator) must fail here, not evaluate the
    # forward NFFT at the wrong nodes.
    if op.scaled_tgt is not None:
        raise ValueError(
            "distributed matvec requires src == tgt nodes (shared geometry)")
    if op.multiplier_half is None or op.src_window is None:
        raise ValueError("distributed matvec requires a fused operator "
                         "(build via make_fastsum)")
    axes = tuple(axes)
    rows = _ShardedRows(op.src_window, op.n_source, mesh, axes)
    body = make_sharded_matvec(op.plan, mesh, axes,
                               spectral_mode=spectral_mode,
                               pencil_axes=pencil_axes)
    out_scale, k0 = op.output_scale, op.kernel_at_zero

    def matvec(x: torch.Tensor) -> torch.Tensor:
        batched = x.ndim == 2
        xb = x if batched else x[:, None]
        y_block = body(op.multiplier_half, rows.base, rows.w1d,
                       rows.block(rows.pad_rows(xb, 0), 0))
        y = rows.unshard(y_block, 0)
        if not batched:
            y = y[:, 0]
        return y * out_scale - k0 * x

    matvec.rows = rows
    matvec.spec = body.spec
    matvec.geometry = body.geometry
    return matvec


def distributed_matvec_bank_fn(bank, mesh, axes, *,
                               spectral_mode: str = "psum",
                               pencil_axes=None):
    """Sharded drop-in for ``bank.matvec`` (bank: ``FastsumOperatorBank``).

    Returns ``mv(x)`` computing ``y[s] = (W̃_s - K_s(0) I) x`` for ``x`` of
    shape (n,) or (n, C) (broadcast), or ``y[s] = (W̃_s - K_s(0) I) x[s]``
    for ``x`` of shape (S, n, C) (lockstep, what a bank Krylov solver
    iterates on), with the node dimension sharded over ``axes`` of
    ``mesh``.  Ghost padding and spectral modes as in
    :func:`distributed_matvec_fn`; the one cross-shard collective carries
    the bank stacked into the channel axis.
    """
    if bank.scaled_tgt is not None:
        raise ValueError("distributed bank matvec requires src == tgt nodes "
                         "(shared geometry)")
    axes = tuple(axes)
    rows = _ShardedRows(bank.src_window, bank.n_source, mesh, axes)
    body = make_sharded_matvec_bank(bank.plan, mesh, axes,
                                    spectral_mode=spectral_mode,
                                    pencil_axes=pencil_axes)
    k0 = bank.kernel_at_zero  # (S,); output scales are folded into the bank

    def matvec(x: torch.Tensor) -> torch.Tensor:
        lockstep = x.ndim == 3
        if lockstep:
            x_block = rows.block(rows.pad_rows(x, 1), 1)
        else:
            batched = x.ndim == 2
            xb = x if batched else x[:, None]
            x_block = rows.block(rows.pad_rows(xb, 0), 0)
        y = rows.unshard(body(bank.multiplier_bank, rows.base, rows.w1d,
                              x_block), 1)  # (S, n, C)
        k = k0.to(y.dtype)
        if lockstep:
            return y - k[:, None, None] * x
        if not batched:
            return y[..., 0] - k[:, None] * x
        return y - k[:, None, None] * x[None]

    matvec.rows = rows
    matvec.spec = body.spec
    matvec.geometry = body.geometry
    return matvec
