"""Config registry: ``get_config(name)`` and reduced smoke variants."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MLAConfig, MambaConfig, MoEConfig, NFFTAttentionConfig,
    ShapeSpec, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)
from repro_torch.configs.archs import (  # noqa: F401
    ALL_ARCHS, EXTRA_ARCHS, DEEPSEEK_V3_671B, GEMMA_7B, GRANITE_3_2B,
    GRANITE_3_2B_NFFT, HUBERT_XLARGE, JAMBA_1_5_LARGE, LLAMA3_405B,
    MAMBA2_1_3B, OLMOE_1B_7B, PALIGEMMA_3B, QWEN15_32B,
)

_REGISTRY = {c.name: c for c in ALL_ARCHS + EXTRA_ARCHS}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return _REGISTRY[name]


def reduced_config(cfg: ArchConfig, *, seq_len: int = 64,
                   global_batch: int = 2) -> ArchConfig:
    """Small same-family config for CPU smoke tests.

    Preserves the structural pattern (GQA ratio, MoE/hybrid periodicity, MLA,
    frontends) while shrinking widths/depths/vocab.
    """
    num_layers = 4
    if cfg.attn_every > 1:
        # keep the hybrid interleave pattern visible: one full period
        num_layers = 2 * cfg.attn_every
    if cfg.moe is not None and cfg.moe.first_dense_layers > 0:
        num_layers = max(num_layers, cfg.moe.first_dense_layers + 2)

    kv_ratio = max(1, (cfg.num_heads or 1) // max(cfg.num_kv_heads or 1, 1))
    heads = 4
    kv_heads = max(1, heads // kv_ratio)

    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(8, cfg.moe.num_experts), top_k=2,
            d_ff_expert=64,
            num_shared_experts=min(1, cfg.moe.num_shared_experts),
            first_dense_layers=min(1, cfg.moe.first_dense_layers))
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16)
    mamba = None
    if cfg.mamba is not None:
        mamba = dataclasses.replace(cfg.mamba, d_state=16, head_dim=16,
                                    chunk_size=16)

    shapes = tuple(
        dataclasses.replace(s, seq_len=seq_len, global_batch=global_batch)
        for s in cfg.shapes)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers, d_model=64, num_heads=heads if cfg.num_heads else 0,
        num_kv_heads=kv_heads if cfg.num_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0, vocab_size=128,
        head_dim=16 if cfg.head_dim else None,
        moe=moe, mla=mla, mamba=mamba,
        frontend_dim=32 if cfg.frontend_dim else 0,
        num_prefix_embeds=min(4, cfg.num_prefix_embeds),
        shapes=shapes,
        param_dtype="float32", activation_dtype="float32",
    )
