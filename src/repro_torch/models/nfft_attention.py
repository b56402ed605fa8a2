"""NFFT kernel attention: the paper's fast summation as an O(n) attention.

The port of ``repro.models.nfft_attention``.  The paper's identity
(Section 3)

    K(q - k) ≈ K_RF(q - k) = sum_{l in I_N^d} b_hat[l] e^{2 pi i l.(q - k)}
             = phi(q)^H diag(b_hat) phi(k),     phi(x)[l] = e^{-2 pi i l.x}

separates queries from keys, so attention with Gaussian-kernel scores and
row-stochastic normalization (the paper's D^{-1} W̃) is a linear attention
over the lattice of trigonometric features:

    out(q) = sum_i K(q-k_i) v_i / sum_i K(q-k_i)
           = Re[phi(q)^H (b ⊙ S)] / Re[phi(q)^H (b ⊙ z)],
      S = sum_i phi(k_i) v_i^T   (N^d x d_v),    z = sum_i phi(k_i).

S and z are prefix sums, so causality is free.  The forward runs the
chunked scheme (inter-chunk through the running (S, z), intra-chunk by the
exact O(Q^2) kernel); decode keeps (S, z) as the whole cache, of a size
independent of the context length.

As in the JAX package, the transforms are exact truncated NDFTs written as
phase matmuls (N^d ≈ 1024 coefficients is too few for the window + FFT
pipeline to pay): on the card they are cuBLAS float32 products, with TF32
off whatever the caller's setting, and no kernel of this package runs.
Features are bounded into the admissible box by 0.17 tanh(.), so the node
rescaling of Algorithm 3.2 is the identity.

Three choices differ from the reference's order of operations and not in
what is computed (the parity tests hold them):

* prefill adds its sums into the cache in place (``add_``): the engine
  hands prefill batch-1 *views* of its batch cache and never writes them
  back, so a prefill that returned a new cache would be lost;
* decode's cache update is an in-place ``addcmul_``, and b_hat scales the
  (b, h, N^d) query features instead of a cache-sized copy of (S, z);
* prefill takes the cache's sums from the forward's per-chunk sums instead
  of computing the key features a second time.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.kernels import make_kernel
from repro_torch.core.regularization import kernel_fourier_coefficients
from repro_torch.models.common import dense_init

FEATURE_BOX = 0.17  # ||f||_inf <= 0.17 -> ||f||_2 <= 0.24 < 1/4 for d=2
CHUNK = 128  # longest chunk of the forward's causal scheme
_DEN_FLOOR = 1e-6


def lattice_frequencies(bandwidth: int, d: int) -> np.ndarray:
    """I_N^d integer frequency lattice, FFT order, shape (N^d, d)."""
    freqs = np.fft.fftfreq(bandwidth, d=1.0 / bandwidth).astype(np.float32)
    grids = np.meshgrid(*([freqs] * d), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


@functools.lru_cache(maxsize=32)
def kernel_coefficients(bandwidth: int, d: int, sigma: float) -> np.ndarray:
    """Regularized Gaussian Fourier coefficients b_hat (Eq. 3.4), flat
    (N^d,), float32: computed once per (N, d, sigma) in float64 on the
    CPU; eps_B = 0 (the Gaussian at the feature-box scale decays well
    inside the torus)."""
    b = kernel_fourier_coefficients(make_kernel("gaussian", sigma=sigma), d,
                                    bandwidth, p=4, eps_b=0.0, device="cpu")
    return b.real.numpy().astype(np.float32).reshape(-1)


def kernel_coefficients_traced(bandwidth: int, d: int,
                               sigma: torch.Tensor) -> torch.Tensor:
    """Differentiable b_hat for a tensor Gaussian width (``learn_sigma``):
    the same quantity as :func:`kernel_coefficients`, computed with the
    graph kept, so gradients flow sigma -> profile samples -> FFT -> b_hat
    -> attention."""
    b = kernel_fourier_coefficients(make_kernel("gaussian", sigma=sigma), d,
                                    bandwidth, p=4, eps_b=0.0,
                                    device=sigma.device)
    return b.real.reshape(-1).float()


@functools.lru_cache(maxsize=32)
def _on_device(bandwidth: int, d: int, sigma: float, device: torch.device):
    """(frequencies (N^d, d), b_hat (N^d,)) as float32 tensors on
    ``device``, made once per device: no host copy per call."""
    freqs = torch.as_tensor(lattice_frequencies(bandwidth, d), device=device)
    bhat = torch.as_tensor(kernel_coefficients(bandwidth, d, sigma),
                           device=device)
    return freqs, bhat


def phase_features(x: torch.Tensor, freqs: torch.Tensor):
    """cos/sin features (the real pair of phi(x)): x (..., d) ->
    two (..., N^d) float32 tensors."""
    angles = 2.0 * math.pi * torch.einsum("...d,ld->...l", x.float(), freqs)
    return torch.cos(angles), torch.sin(angles)


@contextlib.contextmanager
def _full_fp32(device: torch.device):
    """Float32 products in full float32 on the card: TF32 off inside, the
    caller's setting restored on exit."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class NFFTCache(NamedTuple):
    """Constant-size decode state: the accumulated spectral sums (S, z).

    s_cos / s_sin: (b, h, N^d, hd + 1) float32, the value channels and the
    degree channel.  Their size does not depend on the context length.
    """
    s_cos: torch.Tensor
    s_sin: torch.Tensor


def init_nfft_cache(cfg: ArchConfig, batch: int, *, device) -> NFFTCache:
    nc = cfg.nfft_attention
    shape = (batch, cfg.num_heads, nc.bandwidth ** nc.feature_dim,
             cfg.head_dim_eff + 1)
    return NFFTCache(
        s_cos=torch.zeros(shape, dtype=torch.float32, device=device),
        s_sin=torch.zeros(shape, dtype=torch.float32, device=device))


def causal_kernel_attention(qf: torch.Tensor, kf: torch.Tensor,
                            v: torch.Tensor, freqs: torch.Tensor,
                            bhat: torch.Tensor, sigma, *,
                            return_sums: bool = False):
    """The chunked causal kernel attention on features.

    qf, kf: (b, h, s, d) float32 features; v: (b, h, s, hd); ``sigma`` a
    float or a 0-d tensor.  Returns the row-normalized output (b, h, s, hd)
    in float32 and, with ``return_sums``, the sequence's whole (S_cos,
    S_sin), each (b, h, N^d, hd + 1).
    """
    b, h, s, _ = qf.shape
    hd = v.shape[-1]
    chunk = min(CHUNK, s)
    if s % chunk:
        raise AssertionError((s, chunk))
    nch = s // chunk
    qf = qf.reshape(b, h, nch, chunk, -1)
    kf = kf.reshape(b, h, nch, chunk, -1)
    vc1 = torch.cat([v.float(), v.new_ones(v.shape[:-1] + (1,),
                                           dtype=torch.float32)], dim=-1)
    vc1 = vc1.reshape(b, h, nch, chunk, hd + 1)

    # per-chunk adjoint NDFT: S_c = sum_i phi(k_i) [v_i; 1]
    kcos, ksin = phase_features(kf, freqs)  # (b, h, c, Q, L)
    s_cos = torch.einsum("bhcql,bhcqe->bhcle", kcos, vc1)
    s_sin = torch.einsum("bhcql,bhcqe->bhcle", ksin, vc1)
    del kcos, ksin
    sums = (s_cos.sum(dim=2), s_sin.sum(dim=2)) if return_sums else None

    # exclusive prefix over chunks (the inter-chunk state), then b_hat:
    # Re[phi(q)^H (b ⊙ S_prefix)] = qcos . (b ⊙ S_cos) + qsin . (b ⊙ S_sin)
    pre_cos = torch.cumsum(s_cos, dim=2).sub_(s_cos)
    del s_cos
    pre_sin = torch.cumsum(s_sin, dim=2).sub_(s_sin)
    del s_sin
    if bhat.requires_grad:  # learn_sigma: keep S_prefix for b_hat's grad
        pre_cos, pre_sin = pre_cos * bhat[:, None], pre_sin * bhat[:, None]
    else:
        pre_cos.mul_(bhat[:, None])
        pre_sin.mul_(bhat[:, None])
    qcos, qsin = phase_features(qf, freqs)
    total = torch.einsum("bhcql,bhcle->bhcqe", qcos, pre_cos)
    del qcos, pre_cos
    total.add_(torch.einsum("bhcql,bhcle->bhcqe", qsin, pre_sin))
    del qsin, pre_sin

    # intra-chunk: the exact kernel, causal (diagonal included: K(0))
    diff = qf[..., :, None, :] - kf[..., None, :, :]
    w = torch.exp(-(diff * diff).sum(dim=-1) / (sigma ** 2))
    del diff
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=w.device).tril_()
    w = w * causal
    total.add_(torch.einsum("bhcqk,bhcke->bhcqe", w, vc1))
    del w

    num, den = total[..., :hd], total[..., hd:]
    out = (num / torch.clamp(den, min=_DEN_FLOOR)).reshape(b, h, s, hd)
    return (out, sums) if return_sums else out


class NFFTAttention(nn.Module):
    """``init_nfft_attention``: wqf and wkf (d, h·F), wv (d, h·hd), wo
    (h·hd, d), and with ``learn_sigma`` a scalar float32 ``log_sigma``;
    the JAX package's key names, so ``params_from_arrays`` carries them."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device):
        super().__init__()
        self.cfg = cfg
        nc = cfg.nfft_attention
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_eff
        kw = dict(generator=generator, device=device)
        self.wqf = dense_init((d, h * nc.feature_dim), cfg.pdtype, **kw)
        self.wkf = dense_init((d, h * nc.feature_dim), cfg.pdtype, **kw)
        self.wv = dense_init((d, h * hd), cfg.pdtype, **kw)
        self.wo = dense_init((h * hd, d), cfg.pdtype, **kw)
        if getattr(nc, "learn_sigma", False):
            self.log_sigma = nn.Parameter(
                torch.tensor(np.log(nc.sigma), dtype=torch.float32,
                             device=device), requires_grad=False)

    def sigma_and_bhat(self, device: torch.device):
        """(frequencies, kernel width, flat b_hat); the width and b_hat
        carry log_sigma's graph iff ``learn_sigma``."""
        nc = self.cfg.nfft_attention
        freqs, bhat = _on_device(nc.bandwidth, nc.feature_dim, nc.sigma,
                                 device)
        if hasattr(self, "log_sigma"):
            sigma = torch.exp(self.log_sigma.float())
            bhat = kernel_coefficients_traced(nc.bandwidth, nc.feature_dim,
                                              sigma)
            return freqs, sigma, bhat
        return freqs, nc.sigma, bhat

    def features(self, x: torch.Tensor):
        """x (b, s, d) -> qf, kf (b, s, h, F) float32 in the feature box,
        and v (b, s, h, hd) in the parameters' dtype."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, nf = cfg.num_heads, cfg.nfft_attention.feature_dim
        qf = FEATURE_BOX * torch.tanh((x @ self.wqf).float())
        kf = FEATURE_BOX * torch.tanh((x @ self.wkf).float())
        v = (x @ self.wv).reshape(b, s, h, cfg.head_dim_eff)
        return qf.reshape(b, s, h, nf), kf.reshape(b, s, h, nf), v

    def attend(self, x: torch.Tensor, *, return_sums: bool = False):
        """The mixer's output before ``wo``: (b, s, h, hd) float32 (and
        the sequence's (S_cos, S_sin) with ``return_sums``)."""
        qf, kf, v = self.features(x)
        freqs, sigma, bhat = self.sigma_and_bhat(x.device)
        with _full_fp32(x.device):
            res = causal_kernel_attention(
                qf.transpose(1, 2), kf.transpose(1, 2), v.transpose(1, 2),
                freqs, bhat, sigma, return_sums=return_sums)
        out, sums = res if return_sums else (res, None)
        out = out.transpose(1, 2)
        return (out, sums) if return_sums else out

    def _project(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        b, s = out.shape[:2]
        return out.reshape(b, s, -1).to(x.dtype) @ self.wo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Chunked causal kernel attention (train / whole sequence).  A
        sequence longer than 128 must be a multiple of 128 (the JAX
        package's assertion; nothing is padded, since a pad token would
        enter (S, z))."""
        return self._project(self.attend(x), x)

    def prefill(self, x: torch.Tensor, cache: NFFTCache) -> torch.Tensor:
        """Forward, and the whole prefix's (S, z) added into ``cache`` in
        place."""
        out, (s_cos, s_sin) = self.attend(x, return_sums=True)
        cache.s_cos.add_(s_cos)
        cache.s_sin.add_(s_sin)
        return self._project(out, x)

    def decode(self, x: torch.Tensor, cache: NFFTCache) -> torch.Tensor:
        """One step on the constant-size cache, updated in place; x
        (b, 1, d)."""
        b = x.shape[0]
        hd = self.cfg.head_dim_eff
        freqs, _, bhat = self.sigma_and_bhat(x.device)
        qf, kf, v = self.features(x)  # (b, 1, h, *)
        with _full_fp32(x.device):
            kcos, ksin = phase_features(kf[:, 0], freqs)  # (b, h, L)
            v1 = torch.cat([v[:, 0].float(),
                            v.new_ones((b, v.shape[2], 1),
                                       dtype=torch.float32)], dim=-1)
            cache.s_cos.addcmul_(kcos[..., None], v1[:, :, None, :])
            cache.s_sin.addcmul_(ksin[..., None], v1[:, :, None, :])
            qcos, qsin = phase_features(qf[:, 0], freqs)
            total = (torch.einsum("bhl,bhle->bhe", qcos * bhat, cache.s_cos)
                     + torch.einsum("bhl,bhle->bhe", qsin * bhat,
                                    cache.s_sin))
        num, den = total[..., :hd], total[..., hd:]
        out = num / torch.clamp(den, min=_DEN_FLOOR)
        return self._project(out[:, None], x)
