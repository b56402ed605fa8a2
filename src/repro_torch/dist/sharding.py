"""FSDP/TP placement rules over a :class:`repro_torch.launch.mesh.Mesh`,
and the blocks they give each rank.

The port of ``repro.dist.sharding``.  Convention: the batch dimension and
the fully-sharded (ZeRO-3 style) weight dimension live on the ``("pod",
"data")`` axes; ``"model"`` shards a weight's last dimension.  All rules
are *logical*: :func:`named` drops axis names missing from the mesh and
axes whose size does not divide the array dimension, so the same rules
serve the (16, 16) and (2, 16, 16) production meshes (described, with no
process group) and a live mesh of a few ranks.

A spec is a :class:`P` (a tuple of entries, as ``jax.sharding.
PartitionSpec``: ``None``, an axis name, or a tuple of names), and
:class:`NamedSharding` places it on a mesh.  On a live mesh a sharding
knows this rank's block of a full array (:meth:`NamedSharding.shard`, the
block at :meth:`Mesh.group_index` of each dimension's axes, first name
major) and gathers the blocks back (:meth:`NamedSharding.gather`).
:func:`gather_on_use` is the differentiable gather of the sharded train
step.  Beside the storage layout, :func:`compute_use` gives each weight's
compute layout over ``"model"`` (the reference's activation constraints,
which split attention heads, MLP hidden units, experts, Mamba's inner
channels and the vocabulary over that axis): the block a rank of
``"model"`` computes with, and how it is made from the storage block.  A
column-parallel weight (``wq``, ``w_up``, ...) computes with the block it
stores, gathered over the FSDP axes only; a row-parallel one (``wo``,
``w_down``, Mamba's ``w_out``) and every expert matrix trade their stored
block for the compute block in one all_to_all over ``"model"``; a weight
stored whole over ``"model"`` (a vector, the vocabulary of an untied head
that ``"model"`` does not divide) is narrowed to its ceil block, and so is
one whose heads or experts ``"model"`` does not divide, in whole heads,
from the gathered whole (its even storage block does not line up with
the ceil block).  Backward
runs each step in reverse: a rank's gradient of its compute block is its
own product, reduce-scattered over the FSDP axes (whose ranks hold other
rows of the batch).  A weight that every rank of ``"model"`` computes
whole has either the same gradient on those ranks, which each slices to
its block, or (``Use("sum")``: kv projections that ``"model"`` cannot
split, Mamba's B/C projections) a part of it on each, which are summed.

Rules walk the port's trees (:mod:`repro_torch.tree`) by their path
strings; a model's period-stacked tree (:meth:`repro_torch.models.model.
Model.stack_for_training`) has the JAX package's paths, so
``['stack'][0]['attn']['wq']`` meets the reference's ``stack`` rule.
"""

from __future__ import annotations

import math
import re
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.launch.mesh import (
    ceil_blocks, gather_blocks, gather_ceil_blocks, unit_block)
from repro_torch.models.common import part_units
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

# Batch + fully-sharded-parameter axes, widest first; "pod" only ever
# carries batch/FSDP sharding, never TP.
FSDP_AXES = ("pod", "data")
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry per leading array dimension (``None``,
    an axis name, or a tuple of axis names); missing trailing entries
    replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _entry_axes(entry) -> tuple:
    """Spec entry (None | name | tuple of names) -> tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _collapse(axes: tuple):
    """Axis-name tuple -> canonical spec entry (None | name | tuple)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _fit_entry(dim: int, entry, sizes: dict):
    """Largest usable suffix of ``entry``'s axes for an array dim: axis
    names not in ``sizes`` (the mesh) are dropped, then leading axes until
    the combined size divides ``dim``."""
    axes = tuple(a for a in _entry_axes(entry) if a in sizes)
    while axes and dim % math.prod(sizes[a] for a in axes) != 0:
        axes = axes[1:]
    return _collapse(axes)


class NamedSharding:
    """``spec`` placed on ``mesh``; ``shape`` is the full array's shape
    when it is known (``named`` with a shape).  ``ceil``: {dim: unit} for
    the dims that split in ceil blocks of whole units
    (:func:`repro_torch.launch.mesh.unit_block`, as GSPMD pads) rather
    than in equal blocks; serving stores a part's uneven compute block so
    (:func:`compute_layout`)."""

    def __init__(self, mesh, spec: P, shape: Optional[tuple] = None,
                 ceil: Optional[dict] = None):
        self.mesh, self.spec = mesh, P(*spec)
        self.shape = None if shape is None else tuple(int(d) for d in shape)
        self.ceil = dict(ceil or {})

    def __repr__(self) -> str:
        ceil = f", ceil={self.ceil}" if self.ceil else ""
        return f"NamedSharding({self.spec!r}, shape={self.shape}{ceil})"

    # -- where the blocks lie ----------------------------------------------
    def dim_axes(self) -> list:
        """Per sharded dimension: (dim, its axes of size > 1)."""
        out = []
        for dim, entry in enumerate(self.spec):
            axes = tuple(a for a in _entry_axes(entry)
                         if self.mesh.shape[a] > 1)
            if axes:
                out.append((dim, axes))
        return out

    @property
    def axes(self) -> tuple:
        """Every axis (of size > 1) that shards the array, in mesh order."""
        used = {a for _, axes in self.dim_axes() for a in axes}
        return tuple(a for a in self.mesh.axis_names if a in used)

    @property
    def is_split(self) -> bool:
        return bool(self.dim_axes())

    def block_shape(self, shape: Optional[tuple] = None) -> tuple:
        shape = list(self.shape if shape is None else shape)
        for dim, axes in self.dim_axes():
            g = self.mesh.group_size(axes)
            if dim in self.ceil:
                lo, hi = unit_block(shape[dim], self.ceil[dim], g,
                                    self.mesh.group_index(axes))
                shape[dim] = hi - lo
            else:
                shape[dim] //= g
        return tuple(shape)

    def block_numel(self) -> int:
        return math.prod(self.block_shape())

    def block_slices(self, shape: Optional[tuple] = None) -> tuple:
        """This rank's block of a full array of ``shape`` as slices."""
        shape = self.shape if shape is None else shape
        out = [slice(None)] * len(shape)
        for dim, axes in self.dim_axes():
            g, i = self.mesh.group_size(axes), self.mesh.group_index(axes)
            if dim in self.ceil:
                out[dim] = slice(*unit_block(shape[dim], self.ceil[dim], g,
                                             i))
            else:
                n = shape[dim] // g
                out[dim] = slice(i * n, (i + 1) * n)
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``: a copy of its own, or ``full``
        itself when nothing splits it."""
        if not self.is_split:
            return full
        return full[self.block_slices(tuple(full.shape))].clone()

    @torch.no_grad()
    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full array from every rank's block (all_gather over each
        dimension's axes; every rank of a group gets the whole).  Not
        differentiable: :func:`gather_on_use` is."""
        for dim, axes in self.dim_axes():
            if dim in self.ceil:
                block, = gather_ceil_blocks(
                    self.mesh, [block], [dim],
                    [(self.ceil[dim], self.shape[dim])], axes)
            else:
                block = self.mesh.all_gather(block, axes, dim)
        return block

    def take(self, full: torch.Tensor, dim: int, like_dim: int):
        """The slice of ``full`` along ``dim`` that lines up with this
        sharding's block along its dimension ``like_dim`` (Adafactor's
        row and column moments for a block)."""
        like_dim %= len(self.shape)
        for d, axes in self.dim_axes():
            if d == like_dim:
                n = full.shape[dim] // self.mesh.group_size(axes)
                return full.narrow(dim, self.mesh.group_index(axes) * n, n)
        return full


def fsdp_extent(mesh) -> int:
    """The product of the mesh's FSDP axes (the reference's pod x data)."""
    return math.prod(mesh.shape.get(a, 1) for a in FSDP_AXES)


def named(mesh, spec: P, shape: Optional[tuple] = None) -> NamedSharding:
    """``spec`` sanitized against ``mesh`` (and ``shape``).

    Without ``shape``, only filters axis names absent from the mesh.  With
    ``shape``, also truncates the spec to the array rank and replicates any
    dimension the named axes cannot evenly divide.
    """
    sizes = dict(mesh.shape)
    entries = tuple(spec)
    if shape is None:
        clean = [_collapse(tuple(a for a in _entry_axes(e) if a in sizes))
                 for e in entries]
        return NamedSharding(mesh, P(*clean))
    entries = entries[: len(shape)]
    clean = [_fit_entry(int(d), e, sizes) for d, e in zip(shape, entries)]
    return NamedSharding(mesh, P(*clean), tuple(shape))


_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(-?\d+)\]|\.(\w+)")


def _path_names(path) -> tuple:
    """A tree path (the port's path string, or a sequence of keys) as its
    key names; a module's dotted parameter name counts as its parts."""
    if isinstance(path, str):
        keys = [next(g for g in m.groups() if g is not None)
                for m in _KEY.finditer(path)]
    else:
        keys = [str(k) for k in path]
    return tuple(part for k in keys for part in k.split("."))


def _rule_for(path, leaf) -> P:
    """Logical spec for one parameter (or optimizer-state) leaf.

    Matrix-shaped leaves get FSDP on the second-to-last dim and TP on the
    last dim; vectors/scalars (norm gains, biases, factored Adafactor rows)
    are replicated.  Leaves under the period-stacked ``stack`` subtree
    carry a leading ``n_periods`` dim which is never sharded; ``embed``
    (read by token gathers) is replicated.
    """
    shape = tuple(leaf.shape)
    ndim = len(shape)
    if ndim == 0:
        return P()
    names = _path_names(path)
    lead = 1 if ("stack" in names and ndim >= 2) else 0
    if ndim - lead < 2:
        return P()
    if names and names[-1] == "embed":
        return P()
    return P(*((None,) * (ndim - 2)), FSDP_AXES, MODEL_AXIS)


def _drop_fsdp(spec: P) -> P:
    """Remove FSDP axes from a spec (serving keeps only TP sharding)."""
    fsdp = set(FSDP_AXES)
    return P(*(_collapse(tuple(a for a in _entry_axes(e) if a not in fsdp))
               for e in tuple(spec)))


def _map_with_path(fn, tree):
    flat = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [fn(path, leaf) for path, leaf in flat])


def param_specs(params: Any, mesh, *, serve_replicated: bool = False) -> Any:
    """Tree of NamedShardings for a parameter tree (a model stands for the
    dict of its parameters by name).  ``serve_replicated=True`` drops the
    FSDP weight sharding (keeping TP): serving when bf16 weights fit the
    per-device budget."""
    def f(path, leaf):
        spec = _rule_for(path, leaf)
        if serve_replicated:
            spec = _drop_fsdp(spec)
        return named(mesh, spec, tuple(leaf.shape))

    return _map_with_path(f, params)


def tree_specs(tree: Any, mesh) -> Any:
    """The parameter rules over any tree of leaves (optimizer state,
    error-feedback residuals), each leaf by its own path and shape."""
    return _map_with_path(
        lambda path, leaf: named(mesh, _rule_for(path, leaf),
                                 tuple(leaf.shape)), tree)


def batch_specs(batch: Any, mesh) -> Any:
    """Shard every batch leaf's leading (batch) dim over the FSDP axes."""
    return _map_with_path(
        lambda path, leaf: named(mesh, P(FSDP_AXES), tuple(leaf.shape)),
        batch)


def cache_specs(caches: Any, mesh) -> Any:
    """KV/SSM cache shardings: batch dim over the FSDP axes; period-stacked
    caches (under ``stack``) carry a leading ``n_periods`` dim, so their
    batch is dim 1."""
    def f(path, leaf):
        shape = tuple(leaf.shape)
        if "stack" in _path_names(path) and len(shape) >= 2:
            return named(mesh, P(None, FSDP_AXES), shape)
        return named(mesh, P(FSDP_AXES), shape)

    return _map_with_path(f, caches)


# ---------------------------------------------------------------------------
# The compute layout over "model"
# ---------------------------------------------------------------------------

class Use(NamedTuple):
    """How a rank makes the tensor it computes with from its storage block.

    ``gather``: ``"full"`` (every splitting axis gathered; the gradient is
    the same on every rank of "model", each keeping its slice), ``"sum"``
    (every axis gathered; each rank of "model" holds a part of the
    gradient, which is summed over it) or ``"keep"`` (the FSDP axes
    gathered, the "model" block kept; the gradient is the rank's own).
    ``post``: None; ``("swap", storage dim, compute dim)``, an all_to_all
    over "model" that trades the block along the one dim for the block
    along the other; or ``("block", dim, unit)``, the rank's ceil block
    of whole ``unit``-element units (a head's channels; 1 for hidden
    units, experts and the vocabulary) along ``dim``
    (:func:`repro_torch.launch.mesh.unit_block`)."""
    gather: str = "full"
    post: Optional[tuple] = None


# (owner module, leaf) -> the dim a rank of "model" computes its block of:
# the reference's constraints on heads (attention.py), hidden units and
# experts (mlp.py), Mamba's inner channels (mamba.py) and the vocabulary
# (model.py's lm_logits)
_COMPUTE_DIM = {
    ("attn", "wq"): -1, ("attn", "bq"): 0, ("attn", "wo"): 0,
    ("mlp", "w_gate"): -1, ("mlp", "w_up"): -1, ("mlp", "w_down"): 0,
    ("shared", "w_gate"): -1, ("shared", "w_up"): -1, ("shared", "w_down"): 0,
    ("moe", "w_gate"): 0, ("moe", "w_up"): 0, ("moe", "w_down"): 0,
    ("mamba", "w_x"): -1, ("mamba", "w_z"): -1, ("mamba", "w_dt"): -1,
    ("mamba", "conv_x_w"): -1, ("mamba", "conv_x_b"): 0,
    ("mamba", "a_log"): 0, ("mamba", "dt_bias"): 0, ("mamba", "d_skip"): 0,
    ("mamba", "out_norm"): 0, ("mamba", "w_out"): 0,
    ("", "lm_head"): -1,
}
# the kv projections split with the kv heads when "model" divides them
_KV_DIM = {"wk": -1, "wv": -1, "bk": 0, "bv": 0}
# computed whole on every rank of "model", each rank's gradient a part
_SUMMED = {("mamba", "w_bc"), ("mamba", "conv_bc_w"), ("mamba", "conv_bc_b")}
# compute dims of a head's channels (``models.common.part_units``): their
# blocks are whole heads
_PER_HEAD = {("attn", n) for n in ("wq", "bq", "wo", *_KV_DIM)} | {
    ("mamba", n) for n in ("w_x", "w_z", "conv_x_w", "conv_x_b", "out_norm",
                           "w_out")}


def compute_use(path, shape: tuple, storage: NamedSharding, cfg) -> Use:
    """The compute layout of one parameter of ``cfg``'s model, stored under
    ``storage``: ``Use()`` (the whole weight) without a "model" axis of
    more than one rank, or for a part that never splits (MLA, NFFT
    attention, the router).  A part whose units (heads, experts) "model"
    does not divide computes its ceil block of whole units: the storage
    block, an even split of the elements, does not line up with it, so
    the rank cuts it from the gathered whole, and its gradient returns to
    the storage block; a weight stored in that block (``storage.ceil``,
    serving's :func:`compute_layout`) keeps it."""
    m = storage.mesh.shape.get(MODEL_AXIS, 1)
    names = _path_names(path)
    key = (names[-2] if len(names) > 1 else "", names[-1])
    if m == 1:
        return Use()
    if key[0] == "attn" and key[1] in _KV_DIM:
        if cfg.num_kv_heads % m:
            return Use("sum")
        dim = _KV_DIM[key[1]]
    elif key in _SUMMED:
        return Use("sum")
    elif key in _COMPUTE_DIM:
        dim = _COMPUTE_DIM[key]
    else:
        return Use()
    dim %= len(shape)
    unit = part_units(cfg, key[0])[1] if key in _PER_HEAD else 1
    even = shape[dim] // unit % m == 0
    stored = [d for d, axes in storage.dim_axes() if MODEL_AXIS in axes]
    if stored == [dim] and (even or storage.ceil.get(dim) == unit):
        return Use("keep")
    if stored and even:
        return Use("keep", ("swap", stored[0], dim))
    return Use("full", ("block", dim, unit))


def _ceil_storage(s: NamedSharding, shape: tuple, dim: int,
                  unit: int) -> NamedSharding:
    """``s`` with "model" moved to ``dim``, split in ceil blocks of
    ``unit`` elements; the FSDP axes that stood on ``dim`` move to the dim
    "model" left, where they still divide it."""
    spec = list(s.spec) + [None] * (len(shape) - len(s.spec))
    axes = [tuple(a for a in _entry_axes(e) if a != MODEL_AXIS)
            for e in spec]
    left = [d for d, e in enumerate(spec) if MODEL_AXIS in _entry_axes(e)]
    if left and left[0] != dim:
        axes[left[0]] += axes[dim]
    axes[dim] = ()
    sizes = dict(s.mesh.shape)
    entries = [_fit_entry(n, _collapse(a), sizes)
               for n, a in zip(shape, axes)]
    entries[dim] = MODEL_AXIS
    return NamedSharding(s.mesh, P(*entries), shape, ceil={dim: unit})


def compute_layout(model, shardings: dict, cfg) -> dict:
    """Storage shardings that hold every parameter's "model" block where
    its compute layout wants it, for weights that never change (serving):
    a weight whose :class:`Use` swaps (an all_to_all over "model" on every
    use) is stored with the entries of its two dims exchanged, and one
    whose use cuts a ceil block of units from the whole stores that block
    (``NamedSharding.ceil``), so that its use only gathers the FSDP axes.
    Each rank stores as many bytes as under ``shardings`` wherever the
    FSDP axes divide the other dim too (in every configuration of the
    repo), and a ceil block's more or fewer."""
    out = {}
    for name, p in model.named_parameters():
        s = shardings[name]
        post = compute_use((name,), tuple(p.shape), s, cfg).post
        if post is not None and post[0] == "swap":
            spec = list(s.spec) + [None] * (p.ndim - len(s.spec))
            a, b = post[1], post[2]
            spec[a], spec[b] = spec[b], spec[a]
            s = named(s.mesh, P(*spec), tuple(p.shape))
        elif post is not None:
            s = _ceil_storage(s, tuple(p.shape), post[1], post[2])
        out[name] = s
    return out


def compute_uses(model, shardings: dict, cfg) -> dict:
    """{parameter name: its :class:`Use`} over a model's parameters (full
    shapes, e.g. on the ``meta`` device) and their storage shardings."""
    return {name: compute_use((name,), tuple(p.shape), shardings[name], cfg)
            for name, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# The sharded train step's gather
# ---------------------------------------------------------------------------

def _fsdp_split(axes: tuple) -> bool:
    """Whether a dimension's axes are FSDP axes (the gradient is summed over
    them) rather than "model" ones; both at once is refused."""
    fsdp = [a in FSDP_AXES for a in axes]
    if any(fsdp) and not all(fsdp):
        raise ValueError(f"a dimension split over FSDP and model axes at "
                         f"once: {axes}")
    return all(fsdp)


def _group_key(t: torch.Tensor, s: NamedSharding, gather: str) -> tuple:
    """Tensors that gather and reduce together: one dtype, one sequence of
    splitting axes, one set of axes to all-reduce the gradient over (the
    FSDP axes that split nothing; with "sum", "model" when it splits
    nothing), one gather mode."""
    split = tuple(axes for _, axes in s.dim_axes())
    used = {a for axes in split for a in axes}
    summed = set(FSDP_AXES)
    if gather == "sum":
        summed.add(MODEL_AXIS)
    rest = tuple(a for a in s.mesh.axis_names if a in summed
                 and s.mesh.shape[a] > 1 and a not in used)
    return t.dtype, split, rest, gather


def _scatter_step(mesh, grads: list, dims: list, axes: tuple) -> list:
    """Each gradient summed over ``axes`` and cut to this rank's block
    along its own dim: one reduce_scatter of the concatenated blocks."""
    g = mesh.group_size(axes)
    moved = [x.movedim(d, 0) for x, d in zip(grads, dims)]
    buf = torch.cat([m.reshape(g, -1) for m in moved], dim=1)
    red = mesh.psum_scatter(buf, axes, 0).reshape(-1)
    out, off = [], 0
    for m, d in zip(moved, dims):
        n = m.numel() // g
        out.append(red[off:off + n].reshape(m.shape[0] // g, *m.shape[1:])
                   .movedim(0, d))
        off += n
    return out


def _swap_step(mesh, tensors: list, split_dims: list, concat_dims: list,
               axes) -> list:
    """Each tensor cut in equal blocks along its split dim, block ``k`` to
    group index ``k``; the blocks received concatenated along its concat
    dim in group-index order: one all_to_all of the concatenated blocks."""
    g = mesh.group_size(axes)
    moved = [t.movedim(sd, 0) for t, sd in zip(tensors, split_dims)]
    buf = torch.cat([m.reshape(g, -1) for m in moved], dim=1)
    got = mesh.all_to_all(buf, axes, 0, 0)
    out, off = [], 0
    for m, sd, cd in zip(moved, split_dims, concat_dims):
        n = m.numel() // g
        piece = (m.shape[0] // g,) + m.shape[1:]
        at = cd + 1 if cd < sd else cd  # the concat dim after movedim
        out.append(torch.cat([got[k, off:off + n].reshape(piece)
                              for k in range(g)], dim=at).movedim(0, sd))
        off += n
    return out


class _GatherOnUse(torch.autograd.Function):
    """Forward: the group's tensors gathered over each splitting axis group
    (one all_gather each; with ``"keep"``, over the FSDP axes only).
    Backward: each block's gradient: over "model", sliced (``"full"``),
    reduce-scattered (``"sum"``) or the rank's own (``"keep"``); one
    reduce_scatter a splitting FSDP axis group; one all_reduce over the
    group key's other axes."""

    @staticmethod
    def forward(ctx, shardings, gather, *blocks):
        ctx.shardings, ctx.gather = shardings, gather
        mesh = shardings[0].mesh
        full = list(blocks)
        for j, axes in enumerate(_group_key(blocks[0], shardings[0],
                                            gather)[1]):
            if gather == "keep" and not _fsdp_split(axes):
                continue
            dims = [s.dim_axes()[j][0] for s in shardings]
            full = gather_blocks(mesh, full, dims, axes)
        return tuple(f.view_as(f) if f is b else f
                     for f, b in zip(full, blocks))

    @staticmethod
    def backward(ctx, *grads):
        shardings, gather = ctx.shardings, ctx.gather  # grads: never None
        mesh = shardings[0].mesh
        grads = list(grads)
        _, split, rest, _ = _group_key(grads[0], shardings[0], gather)
        for j, axes in enumerate(split):
            if _fsdp_split(axes) or gather == "keep":
                continue
            dims = [s.dim_axes()[j][0] for s in shardings]
            if gather == "sum":
                grads = _scatter_step(mesh, grads, dims, axes)
                continue
            for k, d in enumerate(dims):
                n = grads[k].shape[d] // mesh.group_size(axes)
                grads[k] = grads[k].narrow(d, mesh.group_index(axes) * n, n)
        for j, axes in enumerate(split):
            if _fsdp_split(axes):
                grads = _scatter_step(mesh, grads, [
                    s.dim_axes()[j][0] for s in shardings], axes)
        if rest:
            red = mesh.psum(torch.cat([x.reshape(-1) for x in grads]), rest)
            out, off = [], 0
            for x in grads:
                out.append(red[off:off + x.numel()].reshape(x.shape))
                off += x.numel()
            grads = out
        return (None, None) + tuple(x.contiguous() for x in grads)


class _SwapBlocks(torch.autograd.Function):
    """Forward: one all_to_all over ``axes`` from each tensor's block along
    its storage dim to its block along its compute dim; backward: the
    reverse all_to_all."""

    @staticmethod
    def forward(ctx, mesh, axes, stored, compute, *tensors):
        ctx.mesh, ctx.axes, ctx.stored, ctx.compute = (mesh, axes, stored,
                                                       compute)
        return tuple(_swap_step(mesh, list(tensors), compute, stored, axes))

    @staticmethod
    def backward(ctx, *grads):
        out = _swap_step(ctx.mesh, list(grads), ctx.stored, ctx.compute,
                         ctx.axes)
        return (None,) * 4 + tuple(out)


def _by_dtype(tensors: list, idx: list) -> list:
    groups: dict = {}
    for i in idx:
        groups.setdefault(tensors[i].dtype, []).append(i)
    return list(groups.values())


def gather_on_use(blocks: list, shardings: list, uses: list) -> list:
    """The tensors this rank computes with, from its ``blocks`` under
    ``shardings`` and their compute ``uses`` (:class:`Use`;
    :func:`compute_uses`), differentiably, coalesced.

    The blocks that split alike (and share a dtype and a gather mode)
    gather in one all_gather an axis group, and their gradients come back
    in one reduce_scatter or all_reduce, each block receiving the summed
    gradient of its own rows over the FSDP axes (the ranks there hold
    other rows of the batch); over "model", the gradient of a whole
    tensor is sliced (its ranks computed the same gradient) or, with
    ``"sum"``, summed, and a kept block's is the rank's own.  Then the
    swaps of one dtype run in one all_to_all over "model", and the ceil
    blocks in one narrow (one all_gather backward).  A block that no axis
    splits, no FSDP rank shares and no sum over "model" reduces (a mesh of
    one rank) is returned as it is."""
    out = list(blocks)
    groups: dict = {}
    for i, (b, s, u) in enumerate(zip(blocks, shardings, uses)):
        key = _group_key(b, s, u.gather)
        if key[2] or any(u.gather != "keep" or _fsdp_split(axes)
                         for axes in key[1]):
            groups.setdefault(key, []).append(i)
    for key, idx in groups.items():
        full = _GatherOnUse.apply(tuple(shardings[i] for i in idx), key[3],
                                  *[blocks[i] for i in idx])
        for i, f in zip(idx, full):
            out[i] = f
    swaps = [i for i, u in enumerate(uses) if u.post and u.post[0] == "swap"]
    for idx in _by_dtype(out, swaps):
        got = _SwapBlocks.apply(
            shardings[idx[0]].mesh, MODEL_AXIS,
            tuple(uses[i].post[1] for i in idx),
            tuple(uses[i].post[2] for i in idx), *[out[i] for i in idx])
        for i, t in zip(idx, got):
            out[i] = t
    cut = [i for i, u in enumerate(uses) if u.post and u.post[0] == "block"]
    if cut:
        got = ceil_blocks([out[i] for i in cut],
                          [uses[i].post[1] for i in cut],
                          shardings[cut[0]].mesh, MODEL_AXIS,
                          [uses[i].post[2] for i in cut])
        for i, t in zip(cut, got):
            out[i] = t
    return out
