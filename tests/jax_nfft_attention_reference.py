"""The JAX package's NFFT kernel attention error against the exact
Gaussian attention, at chip_smoke.py's [nfft_serve] sequence length and
reduced width, on the CPU.

    PYTHONPATH=src python tests/jax_nfft_attention_reference.py

One granite-3-2b-nfft mixer layer at the reduced width (d_model 64, four
heads of 16; the full config's feature_dim 2, N = 32, sigma 0.15) with
``wo`` = I, on seeded standard normal inputs of 2048 tokens: prints, per
seed, max|out - exact| / max|exact|, where ``exact`` is the causal
row-normalized Gaussian attention sum_i K(q - k_i) v_i / sum_i K(q - k_i)
computed in float64 on the JAX package's own features.  chip_smoke.py
keeps the largest as ``JAX_NFFT_EXACT_REL`` and holds one full-width layer
on the card to NFFT_EXACT_FACTOR times it.  Takes about a minute.
"""

import dataclasses
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import nfft_attention as jnf  # noqa: E402

S = 2048
SEEDS = (0, 1, 2)


def exact_attention(qf, kf, v, sigma):
    """Causal, row-normalized Gaussian attention in float64; qf, kf
    (s, h, F), v (s, h, hd) -> (s, h, hd), one head at a time."""
    qf, kf, v = (np.asarray(a, np.float64) for a in (qf, kf, v))
    s = qf.shape[0]
    mask = np.tril(np.ones((s, s)))
    out = np.empty(v.shape)
    for h in range(qf.shape[1]):
        diff = qf[:, None, h] - kf[None, :, h]
        w = np.exp(-(diff ** 2).sum(-1) / sigma ** 2) * mask
        out[:, h] = (w @ v[:, h]) / w.sum(axis=1)[:, None]
    return out


def main() -> None:
    cfg = reduced_config(get_config("granite-3-2b-nfft"))
    cfg = dataclasses.replace(cfg, shapes=())
    d = cfg.d_model
    forward = jax.jit(jnf.nfft_attention_forward, static_argnums=2)
    worst = 0.0
    for seed in SEEDS:
        params = jnf.init_nfft_attention(jax.random.PRNGKey(seed), cfg)
        params = dict(params, wo=jnp.eye(d, dtype=jnp.float32))
        x = jnp.asarray(np.random.default_rng(seed).normal(
            size=(1, S, d)).astype(np.float32))
        out = np.asarray(forward(params, x, cfg), np.float64)[0]
        qf, kf, v = jnf._features(params, x, cfg)
        exact = exact_attention(qf[0], kf[0], v[0],
                                cfg.nfft_attention.sigma).reshape(S, d)
        rel = float(np.abs(out - exact).max() / np.abs(exact).max())
        worst = max(worst, rel)
        print(f"seed {seed}: s={S} d_model={d} heads={cfg.num_heads} "
              f"N={cfg.nfft_attention.bandwidth} "
              f"sigma={cfg.nfft_attention.sigma}: max|out - exact| / "
              f"max|exact| = {rel:.6e}")
    print(f"largest: {worst:.6e}")


if __name__ == "__main__":
    main()
