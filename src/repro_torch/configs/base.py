"""Architecture + shape configuration schema (the port's own copy).

Every architecture is an :class:`ArchConfig`; the four LM shape cells are
:class:`ShapeSpec`s.  ``skip_reason`` marks (arch x shape) cells that are
skipped by design (encoder-only decode, full-attention long-context).
The same data as ``repro.configs.base``; ``dtype``/``pdtype`` return
``torch`` dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # layers whose FFN is dense instead of MoE (e.g. deepseek first 3)
    first_dense_layers: int = 0
    # jamba: MoE only every k-th layer (1 = every layer)
    moe_every: int = 1
    # routing token groups, aligned with the data shards (grouped routing:
    # local scatter/gather + one all-to-all reshard; see models/mlp.py)
    token_groups: int = 16


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class NFFTAttentionConfig:
    """Paper-integration: O(n) Gaussian-kernel attention on low-d features."""
    feature_dim: int = 2
    bandwidth: int = 32  # N per dim
    window_cutoff: int = 4  # m
    # kernel width in feature space (features live in ~[-0.17, 0.17]^d);
    # sigma = 0.15 keeps both the bandwidth-truncation and periodization
    # errors of K_RF below ~1e-5 at N = 32 (see models/nfft_attention.py)
    sigma: float = 0.15
    # learn the kernel width: adds a log_sigma parameter leaf and routes
    # b_hat through the differentiable kernel_fourier_coefficients path
    learn_sigma: bool = False


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int
    skip_reason: Optional[str] = None


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)


def _skip(shape: ShapeSpec, reason: str) -> ShapeSpec:
    return dataclasses.replace(shape, skip_reason=reason)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'vlm' | 'audio'
    source: str  # provenance string from the assignment table

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // num_heads
    encoder_only: bool = False
    causal: bool = True
    activation: str = "silu"  # 'silu' (SwiGLU), 'geglu', 'gelu'
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embedding_scale: bool = False  # gemma: multiply embeds by sqrt(d)
    logit_softcap: Optional[float] = None

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    # hybrid: attention every k-th layer (jamba 1:7 -> attn_every=8), 0 = all
    attn_every: int = 1
    mtp_depth: int = 0  # deepseek multi-token prediction heads

    # modality frontend stub: inputs are precomputed embeddings, not tokens
    frontend: str = "none"  # 'none' | 'audio_stub' | 'vision_stub'
    frontend_dim: int = 0  # raw embedding dim fed by the stub
    num_prefix_embeds: int = 0  # vlm: image patch positions prepended

    # paper integration: replace softmax attention by NFFT kernel attention
    nfft_attention: Optional[NFFTAttentionConfig] = None

    shapes: Tuple[ShapeSpec, ...] = ()

    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def head_dim_eff(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def dtype(self):
        return getattr(torch, self.activation_dtype)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def is_attention_layer(self, layer_idx: int) -> bool:
        if self.mamba is not None and self.attn_every == 0:
            return False  # pure SSM
        if self.attn_every <= 1:
            return True
        return (layer_idx % self.attn_every) == self.attn_every - 1

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if layer_idx < self.moe.first_dense_layers:
            return False
        return ((layer_idx - self.moe.first_dense_layers)
                % self.moe.moe_every) == 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_eff
        total = v * d  # embedding
        if not self.tie_embeddings and not self.encoder_only:
            total += v * d
        for i in range(self.num_layers):
            if self.is_attention_layer(i):
                if self.mla is not None:
                    m = self.mla
                    total += d * m.q_lora_rank
                    total += m.q_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.qk_rope_head_dim)
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += self.num_heads * m.v_head_dim * d
                else:
                    total += d * self.num_heads * hd  # Q
                    total += 2 * d * self.num_kv_heads * hd  # K, V
                    total += self.num_heads * hd * d  # O
            elif self.mamba is not None:
                mc = self.mamba
                d_in = mc.expand * d
                n_h = d_in // mc.head_dim
                conv_dim = d_in + 2 * mc.n_groups * mc.d_state
                total += d * (2 * d_in + 2 * mc.n_groups * mc.d_state + n_h)
                total += conv_dim * mc.d_conv
                total += d_in * d
            # FFN
            n_mats = 3 if self.activation in ("silu", "geglu") else 2
            if self.is_moe_layer(i):
                total += self.moe.num_experts * n_mats * d * self.moe.d_ff_expert
                total += (self.moe.num_shared_experts * n_mats * d
                          * self.moe.d_ff_expert)
                total += d * self.moe.num_experts  # router
            else:
                total += n_mats * d * ff
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        n_mats = 3 if self.activation in ("silu", "geglu") else 2
        total = self.param_count()
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                inactive = (self.moe.num_experts - self.moe.top_k)
                total -= inactive * n_mats * d * self.moe.d_ff_expert
        return total
