"""The port's Mamba2 SSD block against the JAX package's ``_ssd_chunked``,
``mamba_forward`` and ``mamba_decode``.

The reduced mamba2-1.3b config (float32: d 64, d_in 128, 8 heads of 16,
d_state 16, d_conv 4, chunk 16), the JAX package's ``init_mamba`` weights
(with nonzero conv biases, ``dt_bias`` and ``out_norm`` so that they
count) carried onto the port's ``Mamba``, numpy-seeded inputs.  Outputs,
the three state tensors and four recurrent decode steps must agree within
1e-5 of their largest entry (sums run in another order; the inter-chunk
scan is a loop here and a ``lax.scan`` there).  The twin of
tests/test_arch_smoke.py::test_mamba_prefill_decode_consistency holds the
port's recurrent decode after a prefill of s - 1 tokens against its own
chunked forward at s - 1, within 1e-5 (the JAX test's limit is 2e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as cases
from repro.models import mamba as jmamba
from repro_torch.models import model as TM
from repro_torch.models.mamba import Mamba, init_mamba_cache, ssd_chunked

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = cases.configs("mamba2-1.3b")
    params = dict(jmamba.init_mamba(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(4)
    for key in ("conv_x_b", "conv_bc_b", "dt_bias", "out_norm"):
        params[key] = jnp.asarray(0.2 * rng.standard_normal(
            params[key].shape), params[key].dtype)
    with torch.device("meta"):
        port = Mamba(tcfg, generator=None, device="meta")
    port = port.to_empty(device="cpu")
    port.load_state_dict({k: torch.from_numpy(np.asarray(v).copy())
                          for k, v in params.items()}, strict=True)
    fns = dict(
        forward=jax.jit(lambda p, u: jmamba.mamba_forward(
            p, u, jcfg, return_state=True)),
        decode=jax.jit(lambda p, u, c: jmamba.mamba_decode(p, u, jcfg, c)))
    return jcfg, tcfg, params, port, fns


def _u(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_ssd_chunked_matches_jax():
    """Four chunks of 8, 6 heads in 2 groups."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n = 2, 32, 6, 4, 2, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, g, n)).astype(np.float32)
              for _ in range(2))
    d = rng.standard_normal(h).astype(np.float32)
    want_y, want_state = jax.jit(jmamba._ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, (x, dt, a, bm, cm, d)), 8)
    y, state = ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm, d)), 8)
    assert cases.rel(y.numpy(), want_y) <= TOL
    assert cases.rel(state.numpy(), want_state) <= TOL
    with pytest.raises(ValueError, match="whole multiple"):
        ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm, d)), 7)


@pytest.mark.parametrize("s", [2, 16, 48])
def test_forward_with_state_and_decode_match_jax(mamba, s):
    """A prompt shorter than d_conv - 1, one chunk, three chunks; then
    four decode steps from the returned state."""
    jcfg, tcfg, params, port, fns = mamba
    u = _u(jcfg, 2, s, s)
    want, (jx, jbc, jssm) = fns["forward"](params, jnp.asarray(u))
    got, (tx, tbc, tssm) = port(torch.from_numpy(u), return_state=True)
    assert cases.rel(got.numpy(), want) <= TOL
    for g, w in ((tx, jx), (tbc, jbc), (tssm, jssm)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert cases.rel(g.numpy(), w) <= TOL
    # decode from a full-width cache: the JAX package pads a short prompt's
    # conv state in front (repro/models/model.py), as Mamba.prefill does
    cache = init_mamba_cache(tcfg, 2, device="cpu")
    port.prefill(torch.from_numpy(u), cache)
    pad = jcfg.mamba.d_conv - 1 - jx.shape[1]
    jc = jmamba.MambaCache(
        conv_x=jnp.pad(jx, ((0, 0), (pad, 0), (0, 0))),
        conv_bc=jnp.pad(jbc, ((0, 0), (pad, 0), (0, 0))), ssm=jssm)
    for name in jc._fields:
        assert cases.rel(getattr(cache, name).numpy(),
                         getattr(jc, name)) <= TOL, name
    for step in range(4):
        us = _u(jcfg, 2, 1, 100 + step)
        want, jc = fns["decode"](params, jnp.asarray(us), jc)
        got = port.decode(torch.from_numpy(us), cache)
        assert got.shape == (2, 1, jcfg.d_model)
        assert cases.rel(got.numpy(), want) <= TOL, step
    for name in jc._fields:
        assert cases.rel(getattr(cache, name).numpy(),
                         getattr(jc, name)) <= TOL, name


def test_sequence_must_be_whole_chunks(mamba):
    """At most chunk_size tokens or a multiple: nothing is padded."""
    _, tcfg, _, port, _ = mamba
    with pytest.raises(ValueError, match="pads nothing"):
        port(torch.zeros((1, tcfg.mamba.chunk_size + 3, tcfg.d_model)))


def test_prefill_decode_consistency():
    """The twin of tests/test_arch_smoke.py's: the reduced mamba2 model,
    prefill of s - 1 tokens then decode of token s - 1, against the whole
    sequence's forward at s - 1."""
    cfg = cases.configs("mamba2-1.3b")[1]
    model = TM.init_params(cfg, 2, device="cpu")
    b, s = 2, 16
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (b, s)))
    x, positions, _ = model.embed_inputs({"tokens": toks})
    full = model.lm_logits(model.run_backbone(x, positions, mode="train"))
    caches = TM.init_caches(cfg, b, s, device="cpu")
    _, caches = model.forward_prefill({"tokens": toks[:, :s - 1]}, caches)
    dec, _ = model.forward_decode(toks[:, s - 1:], torch.full((b,), s - 1),
                                  caches)
    assert cases.rel(dec[:, 0].numpy(), full[:, -1].numpy()) <= TOL


def test_state_is_float32_and_constant_size():
    """The cache of a slot is its conv buffers and state, float32 in a
    bfloat16 model, whatever the sequence length."""
    cfg = dataclasses.replace(cases.configs("mamba2-1.3b")[1],
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    caches = TM.init_caches(cfg, 3, 10_000, device="cpu")
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    for c in caches:
        assert all(t.dtype == torch.float32 for t in c)
        assert c.conv_x.shape == (3, mc.d_conv - 1, d_in)
        assert c.conv_bc.shape == (3, mc.d_conv - 1, 2 * mc.d_state)
        assert c.ssm.shape == (3, d_in // mc.head_dim, mc.d_state,
                               mc.head_dim)
    model = TM.init_params(cfg, 0, device="cpu")
    blk = model.blocks[0].mamba
    assert blk.w_x.dtype == torch.bfloat16
    assert {blk.a_log.dtype, blk.dt_bias.dtype, blk.d_skip.dtype} == \
        {torch.float32}
