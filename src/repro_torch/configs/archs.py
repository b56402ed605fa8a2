"""The 10 architectures of the LM framework, plus the `granite-3-2b-nfft`
variant that swaps softmax attention for the paper's O(n) NFFT kernel
attention (the port's copy of the JAX package's configs, as data).

Shape-cell skips follow the assignment rules:
  * encoder-only archs skip decode shapes,
  * pure full-attention archs skip long_500k (needs sub-quadratic attention),
  * SSM / hybrid archs run long_500k natively.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    ArchConfig, DECODE_32K, LONG_500K, MLAConfig, MambaConfig, MoEConfig,
    NFFTAttentionConfig, PREFILL_32K, TRAIN_4K, _skip,
)

_FULL_ATTN_SKIP = "pure full-attention arch: long_500k needs sub-quadratic attention (DESIGN.md §5)"
_ENCODER_SKIP = "encoder-only arch: no decode step"


HUBERT_XLARGE = ArchConfig(
    name="hubert-xlarge", family="audio",
    source="arXiv:2106.07447; unverified",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    encoder_only=True, causal=False, activation="gelu",
    frontend="audio_stub", frontend_dim=512,
    shapes=(TRAIN_4K, PREFILL_32K,
            _skip(DECODE_32K, _ENCODER_SKIP),
            _skip(LONG_500K, _ENCODER_SKIP + "; full attention")),
)

DEEPSEEK_V3_671B = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    source="arXiv:2412.19437; hf",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432,  # dense layers (first 3); routed experts use d_ff_expert
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_dense_layers=3),
    mtp_depth=1,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K,
            _skip(LONG_500K, _FULL_ATTN_SKIP)),
)

OLMOE_1B_7B = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    source="arXiv:2409.02060; hf",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K,
            _skip(LONG_500K, _FULL_ATTN_SKIP)),
)

LLAMA3_405B = ArchConfig(
    name="llama3-405b", family="dense",
    source="arXiv:2407.21783; unverified",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, rope_theta=500_000.0,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K,
            _skip(LONG_500K, _FULL_ATTN_SKIP)),
)

GRANITE_3_2B = ArchConfig(
    name="granite-3-2b", family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155, head_dim=64, tie_embeddings=True,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K,
            _skip(LONG_500K, _FULL_ATTN_SKIP)),
)

GRANITE_3_2B_NFFT = dataclasses.replace(
    GRANITE_3_2B,
    name="granite-3-2b-nfft",
    nfft_attention=NFFTAttentionConfig(feature_dim=2, bandwidth=32,
                                       window_cutoff=4, sigma=0.15),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K),
)

GEMMA_7B = ArchConfig(
    name="gemma-7b", family="dense",
    source="arXiv:2403.08295; hf",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    d_ff=24576, vocab_size=256_000, head_dim=256, activation="geglu",
    tie_embeddings=True, embedding_scale=True,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K,
            _skip(LONG_500K, _FULL_ATTN_SKIP)),
)

QWEN15_32B = ArchConfig(
    name="qwen1.5-32b", family="dense",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064, qkv_bias=True,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K,
            _skip(LONG_500K, _FULL_ATTN_SKIP)),
)

MAMBA2_1_3B = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    attn_every=0,  # attention-free
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=128),
    tie_embeddings=True,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K),
)

PALIGEMMA_3B = ArchConfig(
    name="paligemma-3b", family="vlm",
    source="arXiv:2407.07726; hf",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=257_216, head_dim=256, activation="geglu",
    tie_embeddings=True, embedding_scale=True,
    frontend="vision_stub", frontend_dim=1152, num_prefix_embeds=256,
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K,
            _skip(LONG_500K, _FULL_ATTN_SKIP)),
)

JAMBA_1_5_LARGE = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    source="arXiv:2403.19887; hf",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    attn_every=8,  # 1 attention : 7 mamba
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=128),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, moe_every=2),
    shapes=(TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K),
)

ALL_ARCHS = (
    HUBERT_XLARGE, DEEPSEEK_V3_671B, OLMOE_1B_7B, LLAMA3_405B, GRANITE_3_2B,
    GEMMA_7B, QWEN15_32B, MAMBA2_1_3B, PALIGEMMA_3B, JAMBA_1_5_LARGE,
)

EXTRA_ARCHS = (GRANITE_3_2B_NFFT,)
