"""Mamba2 (state-space duality) block: chunked SSD for train and prefill,
the O(1)-state recurrence for decode.

The port of ``repro.models.mamba``.  Input projections give
[z | x | B | C | dt] (x, z and dt through their own matrices, B and C
through one small ``w_bc``); a short depthwise causal conv over x and over
(B, C); SSD with a scalar decay A and a skip D per head; a gated RMS norm;
the output projection.  The JAX package computes all of it with ``jnp``
einsums and a ``lax.scan`` outside any Pallas kernel; here the einsums are
``torch.einsum`` and the scan over chunks is a loop.

The chunked SSD computes, per chunk of length Q:
  * intra-chunk: causal (C_q . B_k) pairs weighted by decay segments,
  * chunk states: S = sum_k decay_to_end(k) B_k (dt x)_k^T,
  * inter-chunk: a loop over chunks carrying the state with the chunk's
    decay,
  * output: Y = intra + C . carried state (+ D x).

The state, the decays and ``a_log``, ``dt_bias`` and ``d_skip`` are
float32 whatever the model's dtype.  A sequence must be at most
``chunk_size`` long or a whole multiple of it: nothing is padded.

Decode per token: h = exp(dt A) h + dt B x;  y = C . h + D x, with a
rolling conv buffer of the last d_conv - 1 raw projections.

Under a model split (the sharded train and serving steps), the forward
computes this rank's ceil block of the heads (none on a rank past the last
block), which are its block of the inner channels, from the whole B/C
projections; the gated RMS norm sums its squares over the split, since it
normalises the whole inner dim (an empty block adds 0).  Prefill
and decode keep the cache's whole shape but a rank reads and writes only
its heads' state and its channels' conv buffer (and the whole B/C conv
buffer): no collective moves state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    dense_init, init_rms_norm, model_copy, model_sum, part_split, rms_norm,
)


def _dims(cfg: ArchConfig):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return mc, d_in, d_in // mc.head_dim, 2 * mc.n_groups * mc.d_state


class MambaCache(NamedTuple):
    conv_x: torch.Tensor  # (b, d_conv-1, d_in) rolling raw x projections
    conv_bc: torch.Tensor  # (b, d_conv-1, 2·g·n) rolling raw B/C projections
    ssm: torch.Tensor  # (b, h, n, p) state


def init_mamba_cache(cfg: ArchConfig, batch: int, *, device) -> MambaCache:
    """Zeros, float32: a constant size per slot, whatever the length."""
    mc, d_in, n_heads, bc_dim = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MambaCache(
        conv_x=torch.zeros((batch, mc.d_conv - 1, d_in), **f32),
        conv_bc=torch.zeros((batch, mc.d_conv - 1, bc_dim), **f32),
        ssm=torch.zeros((batch, n_heads, mc.d_state, mc.head_dim), **f32))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                d_conv: int) -> torch.Tensor:
    """``_causal_conv``: depthwise causal conv over the sequence, then SiLU.
    x (b, s, c); w (d_conv, c)."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(d_conv))
    return F.silu(out + b)


def ssd_chunked(x, dt, a, b_mat, c_mat, d_skip, chunk: int):
    """``_ssd_chunked``.  x (b, s, h, p); dt (b, s, h); a (h,) negative;
    b_mat, c_mat (b, s, g, n) with the h heads in g groups; all float32.
    Returns (y (b, s, h, p), the final state (b, h, n, p))."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk != 0:
        raise ValueError(f"the chunked SSD pads nothing: {s} tokens are "
                         f"not a whole multiple of the chunk, {chunk}")
    nc = s // chunk
    if g != h:  # g == h: a head a group already (and h may be 0)
        b_mat = b_mat.repeat_interleave(h // g, dim=2)
        c_mat = c_mat.repeat_interleave(h // g, dim=2)
    bh = b_mat.reshape(bsz, nc, chunk, h, n)
    ch = c_mat.reshape(bsz, nc, chunk, h, n)
    x = x.reshape(bsz, nc, chunk, h, p)
    dt = dt.reshape(bsz, nc, chunk, h)

    cum = torch.cumsum(dt * a, dim=2)  # (b, nc, q, h), inclusive
    # intra-chunk: L[q, k] = exp(cum[q] - cum[k]) for q >= k; the exponent
    # is masked before exp (for q < k it is positive and would overflow)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, q, k, h)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril_()
    seg = seg.masked_fill(~causal[None, None, :, :, None], -math.inf)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", ch, bh) * torch.exp(seg)
    xdt = x * dt[..., None]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)

    # chunk end-states: S_c = sum_k exp(cum[-1] - cum[k]) B_k (dt x)_k
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcqhn,bcqhp->bchnp", bh * decay_to_end[..., None],
                          xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)

    # inter-chunk: H_c = exp(sum da_c) H_{c-1} + S_c; chunk c reads H_{c-1}
    carry = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, n, p)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           ch * torch.exp(cum)[..., None], prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + x.reshape(bsz, s, h, p) * d_skip[None, None, :, None]
    return y, carry


class Mamba(nn.Module):
    """``init_mamba``: w_x and w_z (d, d_in), w_bc (d, 2·g·n), w_dt
    (d, h), the conv weights (d_conv, ·) and biases, float32 ``a_log``
    (log of 1..16 over the heads), ``dt_bias`` (zeros) and ``d_skip``
    (ones), ``out_norm`` and w_out (d_in, d)."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        self.cfg = cfg
        mc, d_in, n_heads, bc_dim = _dims(cfg)
        d = cfg.d_model
        kw = dict(generator=generator, device=device)

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.w_x = dense_init((d, d_in), cfg.pdtype, **kw)
        self.w_z = dense_init((d, d_in), cfg.pdtype, **kw)
        self.w_bc = dense_init((d, bc_dim), cfg.pdtype, **kw)
        self.w_dt = dense_init((d, n_heads), cfg.pdtype, **kw)
        self.conv_x_w = dense_init((mc.d_conv, d_in), cfg.pdtype, **kw)
        self.conv_x_b = param(torch.zeros((d_in,), dtype=cfg.pdtype,
                                          device=device))
        self.conv_bc_w = dense_init((mc.d_conv, bc_dim), cfg.pdtype, **kw)
        self.conv_bc_b = param(torch.zeros((bc_dim,), dtype=cfg.pdtype,
                                           device=device))
        self.a_log = param(torch.log(torch.linspace(
            1.0, 16.0, n_heads, dtype=torch.float32, device=device)))
        self.dt_bias = param(torch.zeros((n_heads,), dtype=torch.float32,
                                         device=device))
        self.d_skip = param(torch.ones((n_heads,), dtype=torch.float32,
                                       device=device))
        self.out_norm = init_rms_norm(d_in, cfg.pdtype, device)
        self.w_out = dense_init((d_in, d), cfg.pdtype, **kw)

    def _project(self, u: torch.Tensor):
        """u (b, s, d) -> x, z (b, s, d_in), bc (b, s, 2·g·n), dt (b, s, h)."""
        return u @ self.w_x, u @ self.w_z, u @ self.w_bc, u @ self.w_dt

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """The gated RMS norm and the output projection."""
        y = rms_norm(y * F.silu(z), self.out_norm, self.cfg.norm_eps)
        return y @ self.w_out

    def forward(self, u: torch.Tensor, *, return_state: bool = False):
        """``mamba_forward``: u (b, s, d) -> (b, s, d) [, (conv_x, conv_bc,
        ssm): the last d_conv - 1 raw projections in float32 (fewer when
        s is shorter) and the final state; under a model split, of this
        rank's channels and heads (:meth:`_forward_split`)]."""
        if part_split(self.cfg, "mamba")[2] > 1:
            return self._forward_split(u, return_state)
        cfg = self.cfg
        mc, d_in, n_heads, _ = _dims(cfg)
        bsz, s, _ = u.shape
        chunk = min(mc.chunk_size, s)
        x_raw, z, bc_raw, dt = self._project(u)
        x = causal_conv(x_raw, self.conv_x_w, self.conv_x_b, mc.d_conv)
        bc = causal_conv(bc_raw, self.conv_bc_w, self.conv_bc_b, mc.d_conv)
        gn = mc.n_groups * mc.d_state
        y, state = ssd_chunked(
            x.reshape(bsz, s, n_heads, mc.head_dim).float(),
            F.softplus(dt.float() + self.dt_bias), -torch.exp(self.a_log),
            bc[..., :gn].reshape(bsz, s, mc.n_groups, mc.d_state).float(),
            bc[..., gn:].reshape(bsz, s, mc.n_groups, mc.d_state).float(),
            self.d_skip, chunk)
        out = self._out(y.reshape(bsz, s, d_in).to(u.dtype), z)
        if not return_state:
            return out
        return out, self._tail(x_raw, bc_raw, state)

    def _tail(self, x_raw, bc_raw, state):
        """(conv_x, conv_bc, ssm) of :meth:`forward`'s ``return_state``."""
        s, keep = x_raw.shape[1], self.cfg.mamba.d_conv - 1
        return (x_raw[:, s - min(s, keep):].float(),
                bc_raw[:, s - min(s, keep):].float(), state)

    def _heads(self, t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """(..., g·n) B or C -> heads [lo, hi)'s (..., hi - lo, n)."""
        mc = self.cfg.mamba
        per = _dims(self.cfg)[2] // mc.n_groups
        return (t.reshape(t.shape[:-1] + (mc.n_groups, mc.d_state))
                .repeat_interleave(per, dim=-2)[..., lo:hi, :])

    def _out_split(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """:meth:`_out` of this rank's channels: the gated RMS norm's sum of
        squares summed over the split (a psum both ways: every rank scales
        its own channels by it), and the partial outputs of ``w_out``'s
        rows too."""
        d_in = _dims(self.cfg)[1]
        dtype = y.dtype
        yf = (y * F.silu(z)).float()
        squares = model_sum(model_copy((yf * yf).sum(dim=-1, keepdim=True)))
        y = yf * torch.rsqrt(squares / d_in + self.cfg.norm_eps)
        y = (y * (1.0 + self.out_norm.float())).to(dtype)
        return model_sum(y @ self.w_out)

    def _forward_split(self, u: torch.Tensor, return_state: bool = False):
        """:meth:`forward` of this rank's ceil block of the heads under a
        model split: ``w_x``, ``w_z``, ``w_dt``, the x conv, ``a_log``,
        ``dt_bias``, ``d_skip``, ``out_norm`` and ``w_out``'s rows hold its
        block; the B/C projection and conv are whole (each rank's gradient
        a part).  ``return_state``: its channels' conv buffer, the whole
        B/C one and its heads' state."""
        cfg = self.cfg
        mc = cfg.mamba
        lo, hi, _ = part_split(cfg, "mamba")
        hl = hi - lo
        bsz, s, _ = u.shape
        chunk = min(mc.chunk_size, s)
        x_raw, z, bc_raw, dt = self._project(model_copy(u))
        x = causal_conv(x_raw, self.conv_x_w, self.conv_x_b, mc.d_conv)
        bc = causal_conv(bc_raw, self.conv_bc_w, self.conv_bc_b, mc.d_conv)
        gn = mc.n_groups * mc.d_state
        y, state = ssd_chunked(
            x.reshape(bsz, s, hl, mc.head_dim).float(),
            F.softplus(dt.float() + self.dt_bias), -torch.exp(self.a_log),
            self._heads(bc[..., :gn], lo, hi).float(),
            self._heads(bc[..., gn:], lo, hi).float(), self.d_skip, chunk)
        out = self._out_split(y.reshape(bsz, s, hl * mc.head_dim)
                              .to(u.dtype), z)
        if not return_state:
            return out
        return out, self._tail(x_raw, bc_raw, state)

    def _cache_block(self, cache: MambaCache) -> MambaCache:
        """The views of ``cache`` this rank reads and writes: its channels'
        conv buffer and its heads' state under a model split, the whole
        B/C buffer; ``cache`` itself without one."""
        lo, hi, m = part_split(self.cfg, "mamba")
        if m == 1:
            return cache
        p = self.cfg.mamba.head_dim
        return MambaCache(conv_x=cache.conv_x[..., lo * p:hi * p],
                          conv_bc=cache.conv_bc, ssm=cache.ssm[:, lo:hi])

    def prefill(self, u: torch.Tensor, cache: MambaCache) -> torch.Tensor:
        """:meth:`forward`, and the conv buffers and final state written
        into ``cache`` in place; a prompt shorter than d_conv - 1 leaves
        zeros in front of its projections (the JAX package's left pad)."""
        out, (conv_x, conv_bc, ssm) = self.forward(u, return_state=True)
        cache = self._cache_block(cache)
        pad = cache.conv_x.shape[1] - conv_x.shape[1]
        cache.conv_x[:, :pad] = 0.0
        cache.conv_x[:, pad:] = conv_x
        cache.conv_bc[:, :pad] = 0.0
        cache.conv_bc[:, pad:] = conv_bc
        cache.ssm.copy_(ssm)
        return out

    def decode(self, u: torch.Tensor, cache: MambaCache) -> torch.Tensor:
        """``mamba_decode``: one token per row, u (b, 1, d); the conv
        buffers and the state advance in place (under a model split, this
        rank's heads: :meth:`_cache_block`)."""
        cfg = self.cfg
        mc = cfg.mamba
        lo, hi, m = part_split(cfg, "mamba")
        hl = hi - lo
        bsz = u.shape[0]
        cache = self._cache_block(cache)
        x_raw, z, bc_raw, dt = (t[:, 0] for t in self._project(
            model_copy(u) if m > 1 else u))

        def conv_step(buf, new_col, w, b):
            window = torch.cat([buf, new_col[:, None, :].float()], dim=1)
            out = torch.einsum("btc,tc->bc", window, w.float())
            buf.copy_(window[:, 1:])
            return F.silu(out + b.float())

        x = conv_step(cache.conv_x, x_raw, self.conv_x_w, self.conv_x_b)
        bc = conv_step(cache.conv_bc, bc_raw, self.conv_bc_w, self.conv_bc_b)
        x = x.reshape(bsz, hl, mc.head_dim)
        gn = mc.n_groups * mc.d_state
        bh = self._heads(bc[..., :gn], lo, hi)  # (b, hl, n)
        ch = self._heads(bc[..., gn:], lo, hi)
        dt_f = F.softplus(dt.float() + self.dt_bias)  # (b, hl)
        decay = torch.exp(dt_f * -torch.exp(self.a_log)[None, :])
        xdt = x * dt_f[..., None]  # (b, hl, p)
        cache.ssm.mul_(decay[..., None, None]).add_(
            bh[..., None] * xdt[:, :, None, :])
        y = torch.einsum("bhn,bhnp->bhp", ch, cache.ssm)
        y = y + x * self.d_skip[None, :, None]
        y = y.reshape(bsz, hl * mc.head_dim).to(u.dtype)
        out = self._out_split(y, z) if m > 1 else self._out(y, z)
        return out[:, None, :]
