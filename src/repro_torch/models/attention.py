"""GQA/MQA/MHA softmax attention with a static-shape KV cache.

The port of the GQA part of ``repro.models.attention``.  Full-sequence
attention is an einsum, or with ``use_flash`` (and no prefix-LM prefix) the
flash kernel (:mod:`repro_torch.kernels.flash_attention`, hand-written CUDA
on the card); decode attends over the whole cache with position masking.
The cache holds RoPE'd keys in the JAX layout (b, s_max, hkv, hd) and is
updated in place.  MLA (DeepSeek latent attention) is not ported yet
(ROADMAP queue 1 item 13c).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, dense_init


class KVCache(NamedTuple):
    k: torch.Tensor  # (b, s_max, hkv, hd), RoPE'd keys
    v: torch.Tensor  # (b, s_max, hkv, hd)


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
                  device) -> KVCache:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim_eff)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def _softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None) -> torch.Tensor:
    """q (b, h, sq, hd), k/v (b, hkv, sk, hd); mask broadcasts against
    (b, hkv, group, sq, sk).  Logits in q's dtype, softmax in float32, as
    the JAX einsum path."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, sq, hd)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) / (hd ** 0.5)
    logits = logits.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bhkd->bhgqd", probs, v).reshape(b, h, sq, hd)


class Attention(nn.Module):
    """``init_attention``: wq (d, h·hd), wk and wv (d, hkv·hd), wo (h·hd, d),
    and zero biases bq/bk/bv with ``qkv_bias``."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim_eff)
        kw = dict(generator=generator, device=device)
        self.wq = dense_init((d, h * hd), cfg.pdtype, **kw)
        self.wk = dense_init((d, hkv * hd), cfg.pdtype, **kw)
        self.wv = dense_init((d, hkv * hd), cfg.pdtype, **kw)
        self.wo = dense_init((h * hd, d), cfg.pdtype, **kw)
        if cfg.qkv_bias:
            for name, width in (("bq", h * hd), ("bk", hkv * hd),
                                ("bv", hkv * hd)):
                setattr(self, name, nn.Parameter(
                    torch.zeros((width,), dtype=cfg.pdtype, device=device),
                    requires_grad=False))

    def project_qkv(self, x: torch.Tensor):
        """``_project_qkv``: x (b, s, d) -> q (b, s, h, hd), k and v
        (b, s, hkv, hd)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        hd = cfg.head_dim_eff
        return (q.reshape(b, s, cfg.num_heads, hd),
                k.reshape(b, s, cfg.num_kv_heads, hd),
                v.reshape(b, s, cfg.num_kv_heads, hd))

    def _attend_sequence(self, q, k, v, positions, *, use_flash: bool,
                         prefix_len: int) -> torch.Tensor:
        """q, k, v from :meth:`project_qkv` -> (b, s, d)."""
        cfg = self.cfg
        b, s = q.shape[:2]
        q = apply_rope(q.transpose(1, 2), positions[:, None, :],
                       cfg.rope_theta)
        k = apply_rope(k.transpose(1, 2), positions[:, None, :],
                       cfg.rope_theta)
        v = v.transpose(1, 2)
        if use_flash and prefix_len == 0:
            if torch.is_grad_enabled() and q.requires_grad:
                raise RuntimeError(
                    "the flash attention kernel has no backward (nor has "
                    "the JAX package's); train through the einsum "
                    "(use_flash=False)")
            ctx = flash_attention(q, k, v, causal=cfg.causal)
        else:
            mask = None
            if cfg.causal:
                mask = (positions[:, None, None, None, :]
                        <= positions[:, None, None, :, None])
                if prefix_len > 0:
                    mask = mask | (positions[:, None, None, None, :]
                                   < prefix_len)
            ctx = _softmax_attend(q, k, v, mask)
        return ctx.transpose(1, 2).reshape(b, s, -1) @ self.wo

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                use_flash: bool = False,
                prefix_len: int = 0) -> torch.Tensor:
        """``attention_forward``: x (b, s, d), positions (b, s).
        ``prefix_len > 0`` lets every query see the keys before it
        (prefix-LM); the flash kernel is used only without such a prefix,
        and never where a gradient is wanted: it has no backward."""
        q, k, v = self.project_qkv(x)
        return self._attend_sequence(q, k, v, positions, use_flash=use_flash,
                                     prefix_len=prefix_len)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                cache: KVCache, *, use_flash: bool = False,
                prefix_len: int = 0) -> torch.Tensor:
        """``attention_prefill``: :meth:`forward`, and writes the RoPE'd keys
        and the values of [0, s) into ``cache`` in place."""
        s = x.shape[1]
        q, k, v = self.project_qkv(x)
        k_rot = apply_rope(k.transpose(1, 2), positions[:, None, :],
                           self.cfg.rope_theta).transpose(1, 2)
        cache.k[:, :s] = k_rot.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
        return self._attend_sequence(q, k, v, positions, use_flash=use_flash,
                                     prefix_len=prefix_len)

    def decode(self, x: torch.Tensor, pos: torch.Tensor,
               cache: KVCache) -> torch.Tensor:
        """``attention_decode``: one token per row.  x (b, 1, d), pos (b,)
        current positions.  Writes k/v at ``pos`` into ``cache`` in place
        (the JAX package's one-hot ``_scatter_seq``, as an indexed write),
        then attends over every cache row at or before ``pos``."""
        cfg = self.cfg
        b = x.shape[0]
        q, k, v = self.project_qkv(x)
        q = apply_rope(q.transpose(1, 2), pos[:, None, None], cfg.rope_theta)
        k = apply_rope(k.transpose(1, 2), pos[:, None, None], cfg.rope_theta)
        rows = torch.arange(b, device=x.device)
        cache.k[rows, pos] = k[:, :, 0].to(cache.k.dtype)
        cache.v[rows, pos] = v[:, 0].to(cache.v.dtype)
        s_max = cache.k.shape[1]
        valid = (torch.arange(s_max, device=x.device)[None, :]
                 <= pos[:, None])
        ctx = _softmax_attend(q, cache.k.transpose(1, 2),
                              cache.v.transpose(1, 2),
                              valid[:, None, None, None, :])
        return ctx.transpose(1, 2).reshape(b, 1, -1) @ self.wo
