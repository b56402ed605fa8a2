"""The port's MLA (DeepSeek multi-head latent attention) against the JAX
package's ``mla_forward``, ``mla_prefill`` and ``mla_decode``.

The reduced deepseek-v3-671b config (float32: d 64, 4 heads, q_lora 32,
kv_lora 16, nope 16, rope 8, v 16), the JAX package's ``init_mla`` weights
(with nonzero q_norm and kv_norm, zeros at init, so that they count)
carried onto the port's ``MLA``, numpy-seeded inputs.  The expanded form
(train and prefill), the latents prefill writes into its cache, and four
absorbed-form decode steps on that cache (two rows at different
positions) must agree within 1e-5 of the largest output or cache entry
(sums run in another order).  Within the port, the absorbed decode of
token s - 1 after a prefill of s - 1 tokens equals the expanded forward
at s - 1 within 1e-5: folding W_UK into q and W_UV after the softmax
reorders sums only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as cases
from repro.models import attention as jattn
from repro_torch.models.attention import MLA, init_mla_cache

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mla():
    jcfg, tcfg = cases.configs("deepseek-v3-671b")
    params = dict(jattn.init_mla(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    for key in ("q_norm", "kv_norm"):
        params[key] = jnp.asarray(0.3 * rng.standard_normal(
            params[key].shape), jnp.float32)
    with torch.device("meta"):
        port = MLA(tcfg, generator=None, device="meta")
    port = port.to_empty(device="cpu")
    port.load_state_dict({k: torch.from_numpy(np.asarray(v).copy())
                          for k, v in params.items()}, strict=True)
    fns = dict(
        forward=jax.jit(lambda p, x, pos: jattn.mla_forward(p, x, pos,
                                                            jcfg)),
        prefill=jax.jit(lambda p, x, pos, c: jattn.mla_prefill(p, x, pos,
                                                               jcfg, c)),
        decode=jax.jit(lambda p, x, pos, c: jattn.mla_decode(p, x, pos,
                                                             jcfg, c)))
    return jcfg, tcfg, params, port, fns


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s)[None], (b, s)).copy()


def test_expanded_forward_matches_jax(mla):
    jcfg, _, params, port, fns = mla
    x, pos = _x(jcfg, 2, 20, 0), _positions(2, 20)
    want = fns["forward"](params, jnp.asarray(x), jnp.asarray(pos))
    got = port(torch.from_numpy(x), torch.from_numpy(pos))
    assert got.shape == (2, 20, jcfg.d_model)
    assert cases.rel(got.numpy(), want) <= TOL


def test_prefill_and_absorbed_decode_match_jax(mla):
    """Prefill 10 tokens into a 24-row cache, then four decode steps with
    the rows at positions 10 and 6 (the second rewriting rows its prefill
    wrote); outputs and both cache tensors."""
    jcfg, tcfg, params, port, fns = mla
    x, pos = _x(jcfg, 2, 10, 1), _positions(2, 10)
    jc = jattn.init_mla_cache(jcfg, 2, 24)
    want, jc = fns["prefill"](params, jnp.asarray(x), jnp.asarray(pos), jc)
    tc = init_mla_cache(tcfg, 2, 24, device="cpu")
    got = port.prefill(torch.from_numpy(x), torch.from_numpy(pos), tc)
    assert cases.rel(got.numpy(), want) <= TOL
    steps = np.array([10, 6])
    for step in range(4):
        xs = _x(jcfg, 2, 1, 10 + step)
        want, jc = fns["decode"](params, jnp.asarray(xs),
                                 jnp.asarray(steps + step), jc)
        got = port.decode(torch.from_numpy(xs),
                          torch.from_numpy(steps + step), tc)
        assert got.shape == (2, 1, jcfg.d_model)
        assert cases.rel(got.numpy(), want) <= TOL, step
    for name in ("c_kv", "k_rope"):
        assert cases.rel(getattr(tc, name).numpy(),
                         getattr(jc, name)) <= TOL, name


@pytest.mark.parametrize("s", [1, 9, 17])
def test_absorbed_decode_equals_expanded_forward(mla, s):
    _, tcfg, _, port, _ = mla
    x, pos = _x(tcfg, 2, s, 20 + s), _positions(2, s)
    full = port(torch.from_numpy(x), torch.from_numpy(pos))
    cache = init_mla_cache(tcfg, 2, s, device="cpu")
    if s > 1:
        port.prefill(torch.from_numpy(x[:, :-1]),
                     torch.from_numpy(pos[:, :-1]), cache)
    dec = port.decode(torch.from_numpy(x[:, -1:]),
                      torch.full((2,), s - 1), cache)
    assert cases.rel(dec.numpy(), full[:, -1:].numpy()) <= TOL


def test_mla_cache_is_the_latents(mla):
    """kv_lora_rank + rope_dim values a position, in the model's dtype."""
    _, tcfg, _, _, _ = mla
    cache = init_mla_cache(tcfg, 3, 7, device="cpu")
    m = tcfg.mla
    assert cache.c_kv.shape == (3, 7, m.kv_lora_rank)
    assert cache.k_rope.shape == (3, 7, m.qk_rope_head_dim)
    assert cache.c_kv.dtype == cache.k_rope.dtype == tcfg.dtype

