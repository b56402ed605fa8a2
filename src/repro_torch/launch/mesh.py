"""Device meshes over ``torch.distributed``, and the collectives that run
over their named axes.

The port of ``repro.launch.mesh``.  A :class:`Mesh` names the axes of a
grid of ranks, as ``jax.sharding.Mesh`` names the axes of a grid of
devices, and runs the collectives that ``jax.lax`` runs over axis names:
:meth:`Mesh.psum`, :meth:`Mesh.pmax`, :meth:`Mesh.psum_scatter`,
:meth:`Mesh.all_gather` and :meth:`Mesh.all_to_all` (tiled).

* ``make_production_mesh`` describes the reference's production meshes,
  (16, 16) over ``("data", "model")`` and (2, 16, 16) over ``("pod",
  "data", "model")``, by shape and axis names.  It starts no process and
  touches no process group; its collectives raise.
* ``Mesh(shape, rank=r, described=True)`` is rank ``r`` of a described
  mesh, the dry run's (:mod:`repro_torch.launch.dryrun`): no process group
  either, and its collectives take ``meta`` tensors only, returning the
  result a live rank would get, in shape and dtype, and counting the same
  traffic.
* ``make_local_mesh(model_parallel)`` lays a ``("data", "model")`` mesh
  over the ranks of the initialised default process group, and
  :func:`make_mesh` any shape.  The caller initialises the group and picks
  its backend; nothing here does.

Rank layout: global rank ``r`` sits at the coordinates of ``r`` in the
row-major (first name major) linearisation of the mesh shape, the device
order of ``jax.make_mesh``.  A collective over several axes, such as a row
group ``("pod", "data")``, runs on one process group per coordinate of the
other axes, made at its first use by every rank in the same order.  Its
blocks go in :meth:`Mesh.group_index` order: this rank's first-name-major
position over those axes, jax's linearisation for multi-name collectives.
``torch.distributed`` orders a group's ranks by global rank, which is that
order when the axes are named in mesh order, so a collective's axes must
be named in mesh order.

Every collective adds the bytes of the operand this rank hands it to
:attr:`Mesh.traffic`, by kind, and the bytes it sends under a ring or
pairwise schedule (all_reduce and all_reduce_max 2(G-1)/G of the operand, reduce_scatter
and all_to_all (G-1)/G, all_gather G-1 times its block) to ``"wire"``;
:attr:`Mesh.traffic_axes` holds the operand bytes by (kind, axes).
Complex tensors cross the wire as ``torch.view_as_real`` views.

:func:`ceil_blocks` narrows tensors to this rank's ceil block along a dim
that the axes do not divide (:func:`block_range`: the last blocks shorter,
as GSPMD pads), differentiably: the model's vocabulary split and the
sharded train step's narrowed vectors.
"""

from __future__ import annotations

import collections
import itertools
import math

import torch
import torch.distributed as dist

# The tensor-in, tensor-out collectives; newer torch releases name them
# *_single and deprecate the older names, which older releases have alone.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Mesh:
    """Named axes over a grid of ranks; ``shape`` maps each axis name to
    its size, in mesh order.  ``rank`` is this process's global rank, or
    None for a mesh that is only described (no process group).  With
    ``described``, ``rank`` is the rank this process stands for on a mesh
    that has no process group: the collectives take ``meta`` tensors,
    return the live rank's result's shape and dtype, and count its
    traffic."""

    def __init__(self, shape: dict, rank: int | None = None, *,
                 described: bool = False):
        self.shape = {str(a): int(s) for a, s in shape.items()}
        self.axis_names = tuple(self.shape)
        if described and not (rank is not None and 0 <= rank < self.size):
            raise ValueError(f"a described rank of {self.shape} needs a rank "
                             f"in [0, {self.size}), got {rank}")
        self.rank = rank
        self.described = described
        # a list to record each collective in, or None: (kind, operand
        # bytes, axes, group size, (lowest, highest) global rank of the
        # group)
        self.log = None
        self._groups = {}
        self.traffic = collections.Counter()
        self.traffic_axes = collections.Counter()

    def __repr__(self) -> str:
        tag = ", described=True" if self.described else ""
        return f"Mesh({self.shape}, rank={self.rank}{tag})"

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self) -> dict:
        """This rank's mesh coordinates."""
        rank = self._live_rank()
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {a: out[a] for a in self.axis_names}

    def group_index(self, axes) -> int:
        """This rank's position in the group of ``axes``, first name
        major (``jax.lax.axis_index`` over several names)."""
        coords = self.coords()
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def group(self, axes):
        """The process group of ``axes`` that holds this rank.  Made at the
        first call for ``axes`` (one group per coordinate of the other
        axes, every rank making all of them in one order), then kept."""
        axes = self._axes(axes)
        if axes not in self._groups:
            self._live_rank()
            if list(axes) != [a for a in self.axis_names if a in axes]:
                raise ValueError(
                    f"collective axes {axes} must be named in mesh order "
                    f"{self.axis_names}: a process group orders its ranks "
                    "by global rank")
            others = [a for a in self.axis_names if a not in axes]
            groups = []
            for fixed in itertools.product(
                    *[range(self.shape[a]) for a in others]):
                pin = dict(zip(others, fixed))
                groups.append([self._linear({**pin, **dict(zip(axes, sub))})
                               for sub in itertools.product(
                                   *[range(self.shape[a]) for a in axes])])
            mine, _ = dist.new_subgroups_by_enumeration(groups)
            if dist.get_rank(mine) != self.group_index(axes):
                raise RuntimeError(
                    f"group of {axes}: process-group rank "
                    f"{dist.get_rank(mine)} is not the first-name-major "
                    f"index {self.group_index(axes)}")
            self._groups[axes] = mine
        return self._groups[axes]

    # -- collectives ---------------------------------------------------------
    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``t`` over the group of ``axes`` (a new tensor; a group
        of one rank still runs the all_reduce)."""
        size = self.group_size(axes)
        buf = t.clone(memory_format=torch.contiguous_format)
        self._count("all_reduce", buf, 2 * (size - 1) / size, axes)
        if not self.described:
            dist.all_reduce(_real(buf), group=self.group(axes))
        return buf

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise max of real ``t`` over the group of ``axes`` (a new
        tensor; ``jax.lax.pmax``)."""
        size = self.group_size(axes)
        buf = t.clone(memory_format=torch.contiguous_format)
        self._count("all_reduce_max", buf, 2 * (size - 1) / size, axes)
        if not self.described:
            dist.all_reduce(buf, op=dist.ReduceOp.MAX,
                            group=self.group(axes))
        return buf

    def psum_scatter(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Sum over the group of ``axes``, scattered in equal blocks along
        ``dim``: block ``i`` to group index ``i`` (``tiled=True``)."""
        size = self.group_size(axes)
        if size == 1:
            return t
        inp = t.movedim(dim, 0).contiguous()
        out = inp.new_empty((inp.shape[0] // size,) + inp.shape[1:])
        self._count("reduce_scatter", inp, (size - 1) / size, axes)
        if not self.described:
            _reduce_scatter(_real(out), _real(inp), group=self.group(axes))
        return out.movedim(0, dim)

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Blocks of the group of ``axes`` concatenated along ``dim`` in
        group-index order (``tiled=True``)."""
        size = self.group_size(axes)
        if size == 1:
            return t
        inp = t.movedim(dim, 0).contiguous()
        out = inp.new_empty((inp.shape[0] * size,) + inp.shape[1:])
        self._count("all_gather", inp, size - 1, axes)
        if not self.described:
            _all_gather(_real(out), _real(inp), group=self.group(axes))
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axes, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``jax.lax.all_to_all(..., tiled=True)``: ``t`` cut in equal
        blocks along ``split_axis``, block ``j`` sent to group index ``j``;
        the blocks received concatenated along ``concat_axis`` in
        group-index order."""
        size = self.group_size(axes)
        if size == 1:
            return t
        moved = t.movedim(split_axis, 0)
        rest = moved.shape[1:]
        inp = moved.reshape((size, moved.shape[0] // size) + rest)
        inp = inp.contiguous()
        out = torch.empty_like(inp)
        self._count("all_to_all", inp, (size - 1) / size, axes)
        if not self.described:
            dist.all_to_all_single(_real(out), _real(inp),
                                   group=self.group(axes))
        # out[j] is this rank's block of rank j's tensor: put the block's
        # axis back, then merge the rank axis into concat_axis, rank major
        out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
        shape = list(out.shape)
        shape[concat_axis: concat_axis + 2] = [shape[concat_axis]
                                               * shape[concat_axis + 1]]
        return out.reshape(shape)

    # -- helpers -------------------------------------------------------------
    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of "
                             f"{self.axis_names}")
        return axes

    def _live_rank(self) -> int:
        if self.rank is None:
            raise RuntimeError(
                f"{self!r} is a described mesh with no process group; use "
                "make_mesh / make_local_mesh after init_process_group")
        return self.rank

    def _linear(self, coords: dict) -> int:
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + coords[a]
        return rank

    def _count(self, kind: str, operand: torch.Tensor, wire: float,
               axes) -> None:
        if self.described and operand.device.type != "meta":
            raise ValueError(f"{self!r} has no process group: its "
                             f"collectives take meta tensors, got one on "
                             f"{operand.device}")
        nbytes = operand.numel() * operand.element_size()
        self.traffic[kind] += nbytes
        self.traffic["wire"] += int(round(wire * nbytes))
        self.traffic_axes[kind, self._axes(axes)] += nbytes
        if self.log is not None:
            axes = self._axes(axes)
            coords = self.coords()
            span = tuple(self._linear({**coords, **{a: end(a) for a in axes}})
                         for end in (lambda a: 0,
                                     lambda a: self.shape[a] - 1))
            self.log.append((kind, nbytes, axes, self.group_size(axes),
                             span))


def _real(t: torch.Tensor) -> torch.Tensor:
    """A real view of ``t`` for the wire (complex as (re, im) pairs)."""
    return torch.view_as_real(t) if t.is_complex() else t


# ---------------------------------------------------------------------------
# Ceil blocks: an axis that does not divide a dim splits it as GSPMD pads
# ---------------------------------------------------------------------------

def block_range(n: int, g: int, i: int) -> tuple:
    """[lo, hi) of block ``i`` of ``n`` in ``g`` ceil blocks (the last
    ones shorter when ``g`` does not divide ``n``, as GSPMD pads)."""
    c = -(-n // g)
    lo = min(i * c, n)
    return lo, min(lo + c, n)


def unit_block(n: int, unit: int, g: int, i: int) -> tuple:
    """[lo, hi) along a dim of ``n`` elements of block ``i`` of its
    ``n / unit`` units (heads of ``unit`` channels) in ``g`` ceil blocks."""
    lo, hi = block_range(n // unit, g, i)
    return lo * unit, hi * unit


def gather_blocks(mesh, tensors: list, dims: list, axes: tuple) -> list:
    """Each tensor gathered along its own dim over ``axes`` of ``mesh``: one
    all_gather of the concatenated blocks."""
    g = mesh.group_size(axes)
    moved = [t.movedim(d, 0) for t, d in zip(tensors, dims)]
    flat = torch.cat([m.reshape(-1) for m in moved])
    out = mesh.all_gather(flat, axes, 0).view(g, -1)
    full, off = [], 0
    for m, d in zip(moved, dims):
        piece = out[:, off:off + m.numel()].reshape(g, *m.shape)
        full.append(piece.reshape(g * m.shape[0], *m.shape[1:])
                    .movedim(0, d))
        off += m.numel()
    return full


def gather_ceil_blocks(mesh, tensors: list, dims: list, units: list,
                       axes) -> list:
    """The whole of each tensor from every rank's ceil block of it along
    its dim (:func:`unit_block`); ``units`` gives each tensor's (unit,
    whole length).  Each block is padded to the ceil block and gathered
    in one all_gather; every block before the first short one is whole and
    every one after it empty, so the whole is the gather's first ``length``
    entries."""
    g = mesh.group_size(axes)
    padded = []
    for t, d, (u, n) in zip(tensors, dims, units):
        pad = list(t.shape)
        pad[d] = -(-(n // u) // g) * u - t.shape[d]
        padded.append(torch.cat([t, t.new_zeros(pad)], dim=d) if pad[d]
                      else t)
    full = gather_blocks(mesh, padded, list(dims), axes)
    return [f.narrow(d, 0, n) for f, d, (_, n) in zip(full, dims, units)]


class _CeilBlocks(torch.autograd.Function):
    """Forward: each tensor's ceil block along its dim over ``axes``
    (:func:`unit_block`: whole units of its dim); backward: the blocks'
    gradients all_gathered (each padded to the ceil block), so every rank
    holds the whole."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, units, *tensors):
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        ctx.units = [(u, t.shape[d]) for t, d, u in zip(tensors, dims, units)]
        g, i = mesh.group_size(axes), mesh.group_index(axes)
        out = []
        for t, d, u in zip(tensors, dims, units):
            lo, hi = unit_block(t.shape[d], u, g, i)
            out.append(t.narrow(d, lo, hi - lo))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        full = gather_ceil_blocks(ctx.mesh, list(grads), list(ctx.dims),
                                  ctx.units, ctx.axes)
        return (None,) * 4 + tuple(f.contiguous() for f in full)


def ceil_blocks(tensors: list, dims: list, mesh: Mesh, axes,
                units: list | None = None) -> list:
    """This rank's ceil block of each tensor along its dim over ``axes``,
    in whole ``units`` (default 1: elements; a head's channels for a
    projection's heads), differentiably: the gradient of the whole is every
    rank's block's, all_gathered (one all_gather for tensors of one
    dtype)."""
    units = [1] * len(tensors) if units is None else list(units)
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        got = _CeilBlocks.apply(mesh, axes, tuple(dims[i] for i in idx),
                                tuple(units[i] for i in idx),
                                *[tensors[i] for i in idx])
        for i, t in zip(idx, got):
            out[i] = t
    return out


def make_mesh(shape, axis_names) -> Mesh:
    """A mesh of ``shape`` over the ranks of the initialised default
    process group (``jax.make_mesh`` over processes)."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group first; the caller picks the "
                           "backend")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    return Mesh(dict(zip(axis_names, shape)), rank=dist.get_rank())


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, described: (16, 16) over
    ``("data", "model")``, or (2, 16, 16) over ``("pod", "data",
    "model")``.  ``"data"`` (and ``"pod"``) carry batch and FSDP sharding,
    ``"model"`` tensor, expert and sequence parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_local_mesh(model_parallel: int = 1) -> Mesh:
    """``("data", "model")`` over every rank of the process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into model_parallel="
                         f"{model_parallel}")
    return make_mesh((world // model_parallel, model_parallel),
                     ("data", "model"))


def mesh_chip_count(mesh: Mesh) -> int:
    return mesh.size
