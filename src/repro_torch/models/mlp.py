"""Feed-forward layers: the gated MLPs (SwiGLU/GeGLU) and the plain GELU MLP.

The port of the dense part of ``repro.models.mlp``.  Mixture of experts
(``init_moe``/``moe_forward``) is not ported yet (ROADMAP queue 1 item 13c).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import activation_fn, dense_init


class MLP(nn.Module):
    """``init_mlp``: w_up (d, ff), w_down (ff, d), and w_gate (d, ff) when
    the activation is gated."""

    def __init__(self, d_model: int, d_ff: int, activation: str, dtype, *,
                 generator: torch.Generator, device):
        super().__init__()
        self.activation = activation
        kw = dict(generator=generator, device=device)
        self.w_up = dense_init((d_model, d_ff), dtype, **kw)
        self.w_down = dense_init((d_ff, d_model), dtype, **kw)
        if activation in ("silu", "geglu"):
            self.w_gate = dense_init((d_model, d_ff), dtype, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``mlp_forward``."""
        act = activation_fn(self.activation)
        up = x @ self.w_up
        if self.activation in ("silu", "geglu"):
            h = act(x @ self.w_gate) * up
        else:
            h = act(up)
        return h @ self.w_down
