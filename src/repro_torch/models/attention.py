"""Attention layers: GQA/MQA/MHA softmax attention and DeepSeek-style MLA,
each with a static-shape cache.

The port of ``repro.models.attention``.  Full-sequence GQA attention is
an einsum, or with ``use_flash`` (and no prefix-LM prefix) the flash kernel
(:mod:`repro_torch.kernels.flash_attention`, hand-written CUDA on the
card); decode attends over the whole cache with position masking.  The KV
cache holds RoPE'd keys in the JAX layout (b, s_max, hkv, hd) and is
updated in place.

MLA (multi-head latent attention): training and prefill use the expanded
form; decode uses the *absorbed* form on the compressed (c_kv, k_rope)
cache, which holds kv_lora_rank + rope_dim values a position.  MLA is an
einsum everywhere, as in the JAX package: it never uses the flash kernel.

Under a model split (:func:`repro_torch.models.common.part_split`, the
sharded train and serving steps), GQA's training forward and prefill
compute this rank's ceil block of the q heads (none on a rank past the
last block, which still joins every collective with zeros) and the kv
heads they read, and its product with ``wo``'s rows of those heads,
summed over the split; a block that crosses a kv group reads each of its
heads' kv head by index.  The prefill writes every kv head into the
cache, which holds the whole batch rows of the rank (its own kv heads
all-gathered over the split).  Decode
splits the cache positions instead, as the reference's constraint does:
each rank attends with every head over its ceil block of the positions
(:func:`repro_torch.launch.mesh.block_range`), and the blocks combine
through the max, the sum of exponentials and the sum of weighted values
over the split.  MLA, which the reference does not split, computes whole.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.mesh import (
    block_range, gather_blocks, gather_ceil_blocks)
from repro_torch.models.common import (
    apply_rope, current_mesh, current_model_axis, dense_init, init_rms_norm,
    model_copy, model_max, model_split, model_sum, part_split, rms_norm,
)


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
    the JAX einsum path.  h may be 0 (a rank's empty block of heads)."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv if hkv else 1, sq, hd)
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
        if use_flash and prefix_len == 0 and q.shape[1]:
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
        return ctx.transpose(1, 2).reshape(b, s, q.shape[1] * q.shape[3]) \
            @ self.wo

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                use_flash: bool = False,
                prefix_len: int = 0) -> torch.Tensor:
        """``attention_forward``: x (b, s, d), positions (b, s).
        ``prefix_len > 0`` lets every query see the keys before it
        (prefix-LM); the flash kernel is used only without such a prefix,
        and never where a gradient is wanted: it has no backward."""
        if part_split(self.cfg, "attn")[2] > 1:
            return model_sum(self._attend_sequence(
                *self._project_block(model_copy(x)), positions,
                use_flash=use_flash, prefix_len=prefix_len))
        q, k, v = self.project_qkv(x)
        return self._attend_sequence(q, k, v, positions, use_flash=use_flash,
                                     prefix_len=prefix_len)

    def _kv_read(self, lo: int, hi: int) -> tuple:
        """(klo, khi, index): the kv heads [klo, khi) that q heads [lo, hi)
        read, and each q head's kv head in that range when the block does
        not read them in equal groups of consecutive heads (None when it
        does, or is empty)."""
        group = self.cfg.num_heads // self.cfg.num_kv_heads
        if hi == lo:
            return lo // group, lo // group, None
        klo, khi = lo // group, (hi - 1) // group + 1
        index = [g // group - klo for g in range(lo, hi)]
        per = (hi - lo) // (khi - klo)
        if (hi - lo) % (khi - klo) == 0 and index == [
                i // per for i in range(hi - lo)]:
            return klo, khi, None
        return klo, khi, index

    def _project_block(self, x: torch.Tensor):
        """:meth:`project_qkv` of this rank's ceil block [lo, hi) of the q
        heads (``wq`` and ``bq`` hold its columns) and of the kv heads
        they read: the block of ``wk``, ``wv`` when the split divides the
        kv heads, else the columns of the kv heads the block reads, out of
        the whole projections (whose gradient the ranks sum).  A block
        that crosses a kv group gets one kv head a q head (by index)."""
        cfg = self.cfg
        lo, hi, m = part_split(cfg, "attn")
        hkv, hd = cfg.num_kv_heads, cfg.head_dim_eff
        wk, wv = self.wk, self.wv
        bk, bv = (self.bk, self.bv) if cfg.qkv_bias else (None, None)
        index = None
        if hkv % m:
            klo, khi, index = self._kv_read(lo, hi)
            cols = slice(klo * hd, khi * hd)
            wk, wv = wk[:, cols], wv[:, cols]
            if cfg.qkv_bias:
                bk, bv = bk[cols], bv[cols]
        b, s, _ = x.shape
        q, k, v = x @ self.wq, x @ wk, x @ wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + bk, v + bv
        q = q.reshape(b, s, hi - lo, hd)
        k = k.reshape(b, s, wk.shape[1] // hd, hd)
        v = v.reshape(b, s, wv.shape[1] // hd, hd)
        if index is not None:
            index = torch.tensor(index, device=x.device)
            k, v = k.index_select(2, index), v.index_select(2, index)
        return q, k, v

    def _whole_kv(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """Under a model split, every kv head of x's k and v: this rank's
        block ``k``, ``v`` all-gathered over the split when it divides the
        kv heads, else the whole projections (which the rank holds)."""
        cfg = self.cfg
        m = part_split(cfg, "attn")[2]
        if cfg.num_kv_heads % m == 0:
            return gather_blocks(current_mesh(), [k, v], [2, 2],
                                 current_model_axis())
        b, s, _ = x.shape
        k, v = x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            k, v = k + self.bk, v + self.bv
        return (k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim_eff),
                v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim_eff))

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                cache: KVCache, *, use_flash: bool = False,
                prefix_len: int = 0) -> torch.Tensor:
        """``attention_prefill``: :meth:`forward`, and writes the RoPE'd keys
        and the values of [0, s) into ``cache`` in place (under a model
        split, every kv head: :meth:`_whole_kv`)."""
        s = x.shape[1]
        split = part_split(self.cfg, "attn")[2] > 1
        if split:
            q, k, v = self._project_block(model_copy(x))
            k_all, v_all = self._whole_kv(x, k, v)
        else:
            q, k, v = self.project_qkv(x)
            k_all, v_all = k, v
        k_rot = apply_rope(k_all.transpose(1, 2), positions[:, None, :],
                           self.cfg.rope_theta).transpose(1, 2)
        cache.k[:, :s] = k_rot.to(cache.k.dtype)
        cache.v[:, :s] = v_all.to(cache.v.dtype)
        out = self._attend_sequence(q, k, v, positions, use_flash=use_flash,
                                    prefix_len=prefix_len)
        return model_sum(out) if split else out

    def decode(self, x: torch.Tensor, pos: torch.Tensor,
               cache: KVCache) -> torch.Tensor:
        """``attention_decode``: one token per row.  x (b, 1, d), pos (b,)
        current positions.  Writes k/v at ``pos`` into ``cache`` in place
        (the JAX package's one-hot ``_scatter_seq``, as an indexed write),
        then attends over every cache row at or before ``pos``; under a
        model split, over this rank's block of the rows
        (:meth:`_decode_split`)."""
        cfg = self.cfg
        b = x.shape[0]
        lo, hi, m = part_split(cfg, "attn")
        if m > 1:
            q, k, v = self._project_block(x)
            q, = gather_ceil_blocks(current_mesh(), [q], [2],
                                    [(1, cfg.num_heads)],
                                    current_model_axis())
            k, v = self._whole_kv(x, k, v)
        else:
            q, k, v = self.project_qkv(x)
        q = apply_rope(q.transpose(1, 2), pos[:, None, None], cfg.rope_theta)
        k = apply_rope(k.transpose(1, 2), pos[:, None, None], cfg.rope_theta)
        rows = torch.arange(b, device=x.device)
        cache.k[rows, pos] = k[:, :, 0].to(cache.k.dtype)
        cache.v[rows, pos] = v[:, 0].to(cache.v.dtype)
        if m > 1:
            return self._decode_split(q, pos, cache, lo, hi)
        s_max = cache.k.shape[1]
        valid = (torch.arange(s_max, device=x.device)[None, :]
                 <= pos[:, None])
        ctx = _softmax_attend(q, cache.k.transpose(1, 2),
                              cache.v.transpose(1, 2),
                              valid[:, None, None, None, :])
        return ctx.transpose(1, 2).reshape(b, 1, -1) @ self.wo

    def _decode_split(self, q: torch.Tensor, pos: torch.Tensor,
                      cache: KVCache, lo: int, hi: int) -> torch.Tensor:
        """Every head's RoPE'd query q (b, h, 1, hd) over this rank's ceil
        block of the cache rows, combined over the split: the logits' max
        (``model_max``), then the sums of the exponentials and of the
        values they weigh (``model_sum``); then the product of this rank's
        heads [lo, hi) with ``wo``'s rows of them, summed over the
        split."""
        b, h, _, hd = q.shape
        hkv = cache.k.shape[2]
        j, m = model_split()
        r0, r1 = block_range(cache.k.shape[1], m, j)
        kk = cache.k[:, r0:r1].transpose(1, 2)
        vv = cache.v[:, r0:r1].transpose(1, 2)
        qg = q.reshape(b, hkv, h // hkv, 1, hd)
        logits = (torch.einsum("bhgqd,bhkd->bhgqk", qg, kk)
                  / (hd ** 0.5)).float()
        valid = (torch.arange(r0, r1, device=q.device)[None, :]
                 <= pos[:, None])
        logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
        shift = model_max(logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - shift)
        den = model_sum(p.sum(dim=-1, keepdim=True))
        num = model_sum(torch.einsum("bhgqk,bhkd->bhgqd", p.to(vv.dtype), vv))
        ctx = (num / den.to(num.dtype)).reshape(b, h, 1, hd)
        mine = ctx[:, lo:hi].transpose(1, 2)
        return model_sum(mine.reshape(b, 1, (hi - lo) * hd) @ self.wo)


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (b, s_max, kv_lora_rank), normed latents
    k_rope: torch.Tensor  # (b, s_max, rope_dim), RoPE'd shared keys


def init_mla_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
                   device) -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=cfg.dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                           dtype=cfg.dtype, device=device))


class MLA(nn.Module):
    """``init_mla``: wq_a (d, q_lora), q_norm, wq_b (q_lora, h·(nope +
    rope)), wkv_a (d, kv_lora + rope), kv_norm, wkv_b (kv_lora, h·(nope +
    v)), wo (h·v, d)."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(generator=generator, device=device)
        self.wq_a = dense_init((d, m.q_lora_rank), cfg.pdtype, **kw)
        self.q_norm = init_rms_norm(m.q_lora_rank, cfg.pdtype, device)
        self.wq_b = dense_init((m.q_lora_rank, h * qk), cfg.pdtype, **kw)
        self.wkv_a = dense_init((d, m.kv_lora_rank + m.qk_rope_head_dim),
                                cfg.pdtype, **kw)
        self.kv_norm = init_rms_norm(m.kv_lora_rank, cfg.pdtype, device)
        self.wkv_b = dense_init(
            (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
            cfg.pdtype, **kw)
        self.wo = dense_init((h * m.v_head_dim, d), cfg.pdtype, **kw)

    @property
    def scale(self) -> float:
        m = self.cfg.mla
        return 1.0 / (m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5

    def project_q(self, x: torch.Tensor, positions: torch.Tensor):
        """``_mla_q``: x (b, s, d) -> q_nope (b, s, h, nope), q_rope
        (b, s, h, rope) RoPE'd."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        q_c = rms_norm(x @ self.wq_a, self.q_norm, cfg.norm_eps)
        q = (q_c @ self.wq_b).reshape(
            b, s, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
        q_rope = apply_rope(q[..., m.qk_nope_head_dim:].transpose(1, 2),
                            positions[:, None, :], cfg.rope_theta)
        return q[..., :m.qk_nope_head_dim], q_rope.transpose(1, 2)

    def kv_latent(self, x: torch.Tensor, positions: torch.Tensor):
        """``_mla_kv_latent``: x (b, s, d) -> c_kv (b, s, kv_lora) normed,
        k_rope (b, s, rope) RoPE'd, one for all heads."""
        cfg, m = self.cfg, self.cfg.mla
        kv_all = x @ self.wkv_a
        c_kv = rms_norm(kv_all[..., :m.kv_lora_rank], self.kv_norm,
                        cfg.norm_eps)
        k_rope = apply_rope(kv_all[..., m.kv_lora_rank:][:, None],
                            positions[:, None, :], cfg.rope_theta)[:, 0]
        return c_kv, k_rope

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        """``mla_forward``, the expanded form (train and prefill): every
        head's keys and values from the latents, logits of the nope and
        rope parts summed and scaled by 1/sqrt(nope + rope), softmax in
        float32."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        h = cfg.num_heads
        q_nope, q_rope = self.project_q(x, positions)
        c_kv, k_rope = self.kv_latent(x, positions)
        kv = (c_kv @ self.wkv_b).reshape(
            b, s, h, m.qk_nope_head_dim + m.v_head_dim)
        k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
        logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
                  + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) \
            * self.scale
        logits = logits.float()
        if cfg.causal:
            mask = positions[:, None, None, :] <= positions[:, None, :, None]
            logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return ctx.reshape(b, s, h * m.v_head_dim) @ self.wo

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                cache: MLACache) -> torch.Tensor:
        """``mla_prefill``: :meth:`forward`, and the latents of [0, s)
        written into ``cache`` in place."""
        s = x.shape[1]
        c_kv, k_rope = self.kv_latent(x, positions)
        cache.c_kv[:, :s] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[:, :s] = k_rope.to(cache.k_rope.dtype)
        return self.forward(x, positions)

    def decode(self, x: torch.Tensor, pos: torch.Tensor,
               cache: MLACache) -> torch.Tensor:
        """``mla_decode``, the absorbed form: one token per row, x (b, 1, d),
        pos (b,).  Writes the token's latents at ``pos`` in place, folds
        W_UK into q, attends over the cached latents (every row at or
        before ``pos``) and applies W_UV after."""
        cfg, m = self.cfg, self.cfg.mla
        b = x.shape[0]
        h = cfg.num_heads
        q_nope, q_rope = self.project_q(x, pos[:, None])
        c_new, kr_new = self.kv_latent(x, pos[:, None])
        rows = torch.arange(b, device=x.device)
        cache.c_kv[rows, pos] = c_new[:, 0].to(cache.c_kv.dtype)
        cache.k_rope[rows, pos] = kr_new[:, 0].to(cache.k_rope.dtype)
        wkv_b = self.wkv_b.reshape(m.kv_lora_rank, h,
                                   m.qk_nope_head_dim + m.v_head_dim)
        w_uk = wkv_b[..., :m.qk_nope_head_dim]
        w_uv = wkv_b[..., m.qk_nope_head_dim:]
        q_lat = torch.einsum("bqhn,chn->bqhc", q_nope, w_uk)
        logits = (torch.einsum("bqhc,bsc->bhqs", q_lat, cache.c_kv)
                  + torch.einsum("bqhd,bsd->bhqs", q_rope, cache.k_rope)) \
            * self.scale
        logits = logits.float()
        s_max = cache.c_kv.shape[1]
        valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]
        logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
        probs = torch.softmax(logits, dim=-1).to(cache.c_kv.dtype)
        ctx_lat = torch.einsum("bhqs,bsc->bqhc", probs, cache.c_kv)
        ctx = torch.einsum("bqhc,chv->bqhv", ctx_lat, w_uv)
        return ctx.reshape(b, 1, h * m.v_head_dim) @ self.wo
