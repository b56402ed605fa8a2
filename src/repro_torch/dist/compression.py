"""Block-wise int8 gradient compression with error feedback.

The port of ``repro.dist.compression``.  Quantization:
gradients are flattened, padded, and cut into blocks of ``BLOCK``
elements; each block is scaled by ``max|block| / 127`` and rounded (half
to even, as ``jnp.round``) to int8, giving a per-element error of at most
half a quantization step (``max|block| / 254``).  Error feedback adds the
previous step's quantization residual to the gradient before compressing,
so no signal is lost for good.  The same operations in the same order as
the reference's: the outputs are bit-identical to the JAX package's.

A block runs over the flattened *JAX leaf*, so a model's gradients go in
as the period-stacked tree (:meth:`repro_torch.models.model.Model.
stack_for_training`): a block of a stacked norm may span layers, as in
the reference.  ``compress_psum`` is the cross-replica mean over a mesh
axis: the values crossing the wire are int8-representable per block, but
the collective itself still moves float32, as in the reference.

``apply_error_feedback(..., shardings=)`` compresses this rank's blocks of
sharded leaves (the sharded train step): a 256-element block runs over
the flattened *full* leaf and may straddle ranks, so its scale is the max
over the ranks of their parts' maxima (``Mesh.pmax``); every element then
takes the scale it takes unsharded, and the result is the unsharded
compression's block, bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BLOCK = 256  # elements per quantization block (one scale per block)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten + pad ``x`` into (blocks, BLOCK) int8 with per-block scales."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(blocks / safe[:, None]).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`_quantize`; returns the first ``n`` elements flat."""
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    return flat[:n]


def compress_decompress(g: torch.Tensor, resid: torch.Tensor):
    """One error-feedback round: quantize ``g + resid``.

    Returns ``(out, new_resid)`` with ``out + new_resid == g + resid`` up
    to the rounding of the subtraction: the residual is the signal the
    int8 lattice lost this step, fed back into the next one.
    """
    total = g.to(torch.float32) + resid.to(torch.float32)
    q, scale = _quantize(total)
    out = _dequantize(q, scale, total.numel()).reshape(g.shape)
    return out, total - out


class CompressionState(NamedTuple):
    residuals: Any  # tree mirroring the grads, fp32


def init_compression_state(params: Any) -> CompressionState:
    return CompressionState(residuals=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _flat_index(sharding, device) -> torch.Tensor:
    """The flat (row-major) index in the full leaf of each element of this
    rank's block, flattened."""
    full, nd = sharding.shape, len(sharding.shape)
    strides = [math.prod(full[d + 1:]) for d in range(nd)]
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for d, (sl, n) in enumerate(zip(sharding.block_slices(),
                                    sharding.block_shape())):
        start = sl.start or 0
        ar = torch.arange(start, start + n, device=device) * strides[d]
        idx = idx + ar.reshape([n if i == d else 1 for i in range(nd)])
    return idx.reshape(-1)


def compress_decompress_block(g: torch.Tensor, resid: torch.Tensor,
                              sharding):
    """:func:`compress_decompress` of the full leaf, on this rank's block
    ``g`` (and ``resid``) of it under ``sharding``: the same output and
    residual blocks, bit for bit."""
    total = g.to(torch.float32) + resid.to(torch.float32)
    flat = total.reshape(-1)
    bid = _flat_index(sharding, g.device) // BLOCK
    n_blocks = -(-math.prod(sharding.shape) // BLOCK)
    part = flat.new_zeros(n_blocks).scatter_reduce_(
        0, bid, flat.abs(), reduce="amax")
    scale = sharding.mesh.pmax(part, sharding.axes) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(flat / safe[bid]).to(torch.int8)
    out = (q.to(torch.float32) * scale[bid]).reshape(g.shape)
    return out, total - out


def apply_error_feedback(grads: Any, state: CompressionState,
                         shardings: Any = None):
    """Compress a gradient tree leaf-wise, carrying residuals in ``state``;
    with ``shardings``, the leaves are this rank's blocks."""
    sh = [None] * len(tree_leaves(grads)) if shardings is None \
        else tree_leaves(shardings)
    pairs = [compress_decompress(g, r) if s is None or not s.is_split
             else compress_decompress_block(g, r, s) for g, r, s in
             zip(tree_leaves(grads), tree_leaves(state.residuals), sh)]
    out = tree_unflatten(grads, [p[0] for p in pairs])
    resid = tree_unflatten(grads, [p[1] for p in pairs])
    return out, CompressionState(residuals=resid)


def compress_psum(g: torch.Tensor, axis_name, resid: torch.Tensor, mesh):
    """Error-feedback-compressed mean over the replicas of a mesh axis.

    Each replica quantizes its local ``g + resid``; the dequantized values
    are averaged over the group of ``axis_name`` (a name, or a tuple of
    names, of ``mesh``: a :class:`repro_torch.launch.mesh.Mesh`), so every
    replica holds the same approximate mean (``pmean`` in the JAX
    package: the sum, then a division by the group size).  The mean's
    per-element error is at most the mean of the replicas' quantization
    errors, i.e. <= max|g| / 254 globally.  Returns ``(mean,
    new_resid)``.
    """
    out, new_resid = compress_decompress(g, resid)
    mean = mesh.psum(out, axis_name) / mesh.group_size(axis_name)
    return mean, new_resid
