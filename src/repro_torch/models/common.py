"""Shared model components: norms, RoPE, initializers, activations.

The port of ``repro.models.common`` for one device: the JAX package's
sharding helpers (``shard``/``set_mesh``) are no-ops without a mesh and
are dropped here.  Weights keep the JAX layout (``x @ w`` with ``w`` of
shape (in, out)), so a JAX parameter tree maps onto the port's one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
