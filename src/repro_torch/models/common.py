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
block of the attention heads, the MLP's hidden units, the experts, Mamba's
inner channels and the vocabulary (:func:`model_split`).
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

from repro_torch.launch.mesh import ceil_blocks


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


def splits_over_model(cfg, owner: str, m: int) -> bool:
    """Whether ``owner``'s units split evenly over ``m`` > 1 ranks of the
    model axis: ``"attn"`` its heads, in blocks that line up with the kv
    groups when the axis does not divide the kv heads; ``"moe"`` its
    experts; ``"mamba"`` its heads.  Every other part splits (hidden
    units and the vocabulary in ceil blocks)."""
    if m == 1:
        return False
    if owner == "attn":
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        if h % m:
            return False
        hl, group = h // m, h // hkv
        return hkv % m == 0 or group % hl == 0 or hl % group == 0
    if owner == "moe":
        return cfg.moe.num_experts % m == 0
    if owner == "mamba":
        mc = cfg.mamba
        return (mc.expand * cfg.d_model // mc.head_dim) % m == 0
    return True


def whole_parts(cfg, m: int) -> list:
    """The parts of ``cfg``'s model that compute whole on every rank of a
    model axis of ``m`` > 1 ranks, one line each: those whose heads or
    experts the axis does not divide (:func:`splits_over_model`; the
    reference's GSPMD splits them unevenly), and MLA and NFFT attention,
    which never split.  A dry run's per-rank counts overstate these parts'
    work up to ``m``-fold."""
    if m == 1:
        return []
    out = []
    if any(cfg.is_attention_layer(i) for i in range(cfg.num_layers)):
        if cfg.mla is not None:
            out.append("attn: MLA")
        elif cfg.nfft_attention is not None:
            out.append("attn: NFFT attention")
        elif not splits_over_model(cfg, "attn", m):
            out.append(f"attn: {cfg.num_heads} heads, {cfg.num_kv_heads} "
                       f"kv heads")
    if cfg.moe is not None and not splits_over_model(cfg, "moe", m):
        out.append(f"moe: {cfg.moe.num_experts} experts")
    if cfg.mamba is not None and not splits_over_model(cfg, "mamba", m):
        mc = cfg.mamba
        out.append(f"mamba: {mc.expand * cfg.d_model // mc.head_dim} heads")
    return out


def part_split(cfg, owner: str) -> tuple:
    """:func:`model_split` for ``owner``'s units: (0, 1), computing whole,
    when the model axis does not divide them (:func:`splits_over_model`)."""
    j, m = model_split()
    return (j, m) if splits_over_model(cfg, owner, m) else (0, 1)


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
    rank's ceil block ``t`` of it (each padded to the ceil block, one
    all_gather), outside autograd: serving's logits."""
    m = model_split()[1]
    c = -(-n // m)
    pad = list(t.shape)
    pad[dim] = c - t.shape[dim]
    if pad[dim]:
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    whole = current_mesh().all_gather(t.detach(), current_model_axis(), dim)
    return whole.narrow(dim, 0, n)


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
