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
"""

from __future__ import annotations

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


def apply_error_feedback(grads: Any, state: CompressionState):
    """Compress a gradient tree leaf-wise, carrying residuals in ``state``."""
    pairs = [compress_decompress(g, r) for g, r in
             zip(tree_leaves(grads), tree_leaves(state.residuals))]
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
