"""Shared model components: norms, RoPE, initializers, activations, and
the active mesh.

The port of ``repro.models.common``.  Weights keep the JAX layout (``x @
w`` with ``w`` of shape (in, out)), so a JAX parameter tree maps onto the
port's one to one.

:func:`set_mesh` makes a :class:`repro_torch.launch.mesh.Mesh` active, as
the reference's does.  Under a mesh, ``batch_axes`` names the axes over
which the rows in hand are this rank's block of the batch: :func:`batch_sum`
then sums a value over those ranks (differentiably), which is how the cross
entropy and the MoE's load-balancing loss stay the reference's means over
the whole batch.  ``model_axis`` names the axis whose ranks compute in
blocks, the twin of the reference's activation ``shard`` constraints over
``"model"``: every rank of it holds the same rows, and computes only its
ceil block of the attention heads, the MLP's hidden units, the experts,
Mamba's heads and the vocabulary (:func:`model_split`, :func:`part_split`).
:func:`model_copy` (identity forward, all-reduce backward) marks a
replicated input of such a block, :func:`model_sum` (all-reduce forward,
identity backward) the sum of the blocks' partial outputs.  Without a
``model_axis`` (serving, one device) every rank computes whole blocks.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import (
    block_range, ceil_blocks, gather_ceil_blocks)


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------

_STATE = threading.local()


def current_mesh():
    """The mesh :func:`set_mesh` made active on this thread, or None."""
    return getattr(_STATE, "mesh", None)


def current_batch_axes() -> tuple:
    return getattr(_STATE, "batch_axes", ())


def current_model_axis():
    return getattr(_STATE, "model_axis", None)


@contextlib.contextmanager
def set_mesh(mesh, batch_axes=(), model_axis=None):
    """Make ``mesh`` active on this thread (None: no mesh).  ``batch_axes``:
    the mesh axes over which the batch rows in hand are this rank's block
    (first name major); () when every rank holds the whole batch.
    ``model_axis``: the axis whose ranks compute in blocks (None: every
    rank computes whole blocks)."""
    prev = current_mesh(), current_batch_axes(), current_model_axis()
    _STATE.mesh = mesh
    _STATE.batch_axes = tuple(batch_axes) if mesh is not None else ()
    _STATE.model_axis = model_axis if mesh is not None else None
    try:
        yield
    finally:
        _STATE.mesh, _STATE.batch_axes, _STATE.model_axis = prev


def batch_block() -> tuple:
    """(this rank's block index, the number of blocks) of the batch rows."""
    mesh, axes = current_mesh(), current_batch_axes()
    if mesh is None or not axes:
        return 0, 1
    return mesh.group_index(axes), mesh.group_size(axes)


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.psum(t, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.psum(grad, ctx.axes), None, None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks that hold the other blocks of the batch
    (a psum whose backward is a psum); ``t`` itself without such ranks."""
    mesh, axes = current_mesh(), current_batch_axes()
    if mesh is None or not axes or mesh.group_size(axes) == 1:
        return t
    return _BatchSum.apply(t, mesh, axes)


def model_split() -> tuple:
    """(this rank's block index, the number of blocks) over the axis that
    computes in blocks; (0, 1) without one, or when it has one rank."""
    mesh, axis = current_mesh(), current_model_axis()
    if mesh is None or axis is None or mesh.shape.get(axis, 1) == 1:
        return 0, 1
    return mesh.group_index(axis), mesh.shape[axis]


def part_units(cfg, owner: str) -> tuple:
    """(units, channels a unit) of ``owner``'s part that a model axis
    splits: ``"attn"`` its q heads, ``"moe"`` its experts, ``"mamba"`` its
    heads."""
    if owner == "attn":
        return cfg.num_heads, cfg.head_dim_eff
    if owner == "moe":
        return cfg.moe.num_experts, 1
    if owner == "mamba":
        mc = cfg.mamba
        return mc.expand * cfg.d_model // mc.head_dim, mc.head_dim
    raise ValueError(owner)


def whole_parts(cfg, m: int) -> list:
    """The parts of ``cfg``'s model that compute whole on every rank of a
    model axis of ``m`` > 1 ranks, one line each: MLA and NFFT attention,
    which the reference never splits.  Every other part splits, in ceil
    blocks where ``m`` does not divide its units (:func:`part_split`).  A
    dry run's per-rank counts overstate these parts' work up to
    ``m``-fold."""
    if m == 1 or not any(cfg.is_attention_layer(i)
                         for i in range(cfg.num_layers)):
        return []
    if cfg.mla is not None:
        return ["attn: MLA"]
    if cfg.nfft_attention is not None:
        return ["attn: NFFT attention"]
    return []


def part_split(cfg, owner: str) -> tuple:
    """(lo, hi, m): this rank's ceil block [lo, hi) of ``owner``'s units
    (:func:`part_units`; :func:`repro_torch.launch.mesh.block_range`) over
    the model axis of ``m`` ranks; (0, units, 1) without a split.  A block
    may be empty: its rank still joins every collective of the part, with
    a partial output of zeros."""
    j, m = model_split()
    n = part_units(cfg, owner)[0]
    lo, hi = block_range(n, m, j)
    return lo, hi, m


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.psum(grad, ctx.axis), None, None


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.psum(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def model_copy(t: torch.Tensor) -> torch.Tensor:
    """``t``, an input that every rank of the model axis holds whole and
    computes its own block from: the identity, whose backward sums the
    blocks' gradients over that axis.  ``t`` itself without a split."""
    if model_split()[1] == 1:
        return t
    return _ModelCopy.apply(t, current_mesh(), current_model_axis())


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the model axis of each rank's partial ``t`` (a psum),
    whose gradient every rank already holds whole (identity backward).
    ``t`` itself without a split."""
    if model_split()[1] == 1:
        return t
    return _ModelSum.apply(t, current_mesh(), current_model_axis())


def model_max(t: torch.Tensor) -> torch.Tensor:
    """Under a model split, the elementwise max of ``t`` over the model
    axis, outside autograd (a softmax's shift, which its gradient does not
    see)."""
    return current_mesh().pmax(t.detach(), current_model_axis())


def model_gather(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Under a model split, the whole of ``n`` along ``dim`` from every
    rank's ceil block ``t`` of it (one all_gather), outside autograd:
    serving's logits."""
    return gather_ceil_blocks(current_mesh(), [t.detach()], [dim], [(1, n)],
                              current_model_axis())[0]


def model_block(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Under a model split, this rank's ceil block of ``t`` along ``dim``
    (:func:`repro_torch.launch.mesh.block_range`), whose backward
    all_gathers every rank's block gradient."""
    return ceil_blocks([t], [dim], current_mesh(), current_model_axis())[0]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + weight``, in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def init_rms_norm(d: int, dtype, device) -> torch.nn.Parameter:
    """Stored as (weight - 1): zeros."""
    return torch.nn.Parameter(torch.zeros((d,), dtype=dtype, device=device),
                              requires_grad=False)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, *,
                     device) -> torch.Tensor:
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32,
                             device=device) / half
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: (..., seq) integers.  Angles in
    float32, split-half rotation, result in x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(shape, dtype, *, generator: torch.Generator, device,
               in_axis: int = 0) -> torch.nn.Parameter:
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``."""
    scale = (1.0 / max(shape[in_axis], 1)) ** 0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device) * scale
    return torch.nn.Parameter(w.to(dtype), requires_grad=False)


def embed_init(shape, dtype, *, generator: torch.Generator,
               device) -> torch.nn.Parameter:
    """Normal(0, 1/d) in float32, cast to ``dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device) * (1.0 / shape[1] ** 0.5)
    return torch.nn.Parameter(w.to(dtype), requires_grad=False)


def activation_fn(name: str):
    """The gate's activation for 'silu'/'geglu', the MLP's for 'gelu'
    (jax.nn.gelu's default is the tanh approximation)."""
    if name == "silu":
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)
