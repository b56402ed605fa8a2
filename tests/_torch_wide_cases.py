"""The ratios that ``reduced_config`` drops from llama3-405b, qwen1.5-32b
and jamba-1.5-large, put back at a CPU size.

Each variant is a ``dataclasses.replace`` of a package's reduced config
with the same fields, so the JAX package's and the port's variants are one
config (``tests/test_torch_wide_archs.py`` checks that):

- llama3-405b: 16 query heads on 1 kv head (GQA 16:1; the reduced config
  has 4 on 1) at head dim 16;
- qwen1.5-32b: 10 MHA heads (not a power of two) at head dim 16, whose QKV
  biases ``qkv_biases`` draws nonzero;
- jamba-1.5-large: depth 2, the card's cut (layer 0 Mamba + MoE, layer 1
  Mamba + dense), 16 experts top-2, Mamba head dim 64 and d_state 16 (the
  reduced config has 8 experts and head dim 16).

No JAX here: the card's tests import it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BIAS_SCALE = 0.1


def variant(name: str, reduced):
    """``name``'s wide variant of ``reduced`` (either package's reduced
    config of ``name``)."""
    if name == "llama3-405b":
        return dataclasses.replace(reduced, num_heads=16, num_kv_heads=1,
                                   head_dim=16)
    if name == "qwen1.5-32b":
        return dataclasses.replace(reduced, num_heads=10, num_kv_heads=10,
                                   head_dim=16)
    if name == "jamba-1.5-large-398b":
        return dataclasses.replace(
            reduced, num_layers=2,
            moe=dataclasses.replace(reduced.moe, num_experts=16, top_k=2),
            mamba=dataclasses.replace(reduced.mamba, head_dim=64,
                                      d_state=16))
    raise KeyError(name)


VARIANTS = ("llama3-405b", "qwen1.5-32b", "jamba-1.5-large-398b")


def qkv_biases(shapes, seed: int) -> list:
    """BIAS_SCALE N(0, 1) float32 draws of the given shapes, in order,
    from one numpy generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    return [(BIAS_SCALE * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]
