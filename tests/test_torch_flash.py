"""The port's flash attention against the JAX package, on the CPU.

``repro_torch.kernels.flash_attention`` (CPU tensors take its plain
version) against the Pallas kernel run in interpret mode and against its
oracle ``repro.kernels.ref.flash_attention_ref``, on the sweep of
``tests/test_kernels_pallas.py`` (shapes, causal or not, bf16, decode
alignment).  Absolute limits are the JAX tests' own: 2e-5 in float32 and
5e-2 in bfloat16.  Rows that see no key are 0 in the port (the oracle
gives NaN there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as tfa

RNG = np.random.default_rng(13)


def _inputs(b, hq, hkv, sq, sk, dh):
    return (RNG.normal(size=(b, hq, sq, dh)).astype(np.float32),
            RNG.normal(size=(b, hkv, sk, dh)).astype(np.float32),
            RNG.normal(size=(b, hkv, sk, dh)).astype(np.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    return tfa.flash_attention(*(torch.as_tensor(a).to(dtype)
                                 for a in (q, k, v)), **kw)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 100, 100, 64),   # MQA, ragged seq
    (1, 2, 2, 64, 192, 32),    # cross-length
    (1, 16, 8, 96, 96, 128),   # GQA group 2
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_sweep_matches_jax(b, hq, hkv, sq, sk, dh, causal):
    q, k, v = _inputs(b, hq, hkv, sq, sk, dh)
    got = _port(q, k, v, causal=causal).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    assert np.abs(got - np.asarray(pallas)).max() < 2e-5
    assert np.abs(got - np.asarray(oracle)).max() < 2e-5


def test_flash_attention_bf16_matches_jax():
    q, k, v = _inputs(1, 4, 2, 128, 128, 64)
    got = _port(q, k, v, torch.bfloat16, causal=True)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                 block_k=64, interpret=True)
    oracle = ref.flash_attention_ref(jq.astype(jnp.float32),
                                     jk.astype(jnp.float32),
                                     jv.astype(jnp.float32), causal=True)
    got = got.float().numpy()
    assert np.abs(got - np.asarray(oracle)).max() < 5e-2
    assert np.abs(got - np.asarray(pallas, np.float32)).max() < 5e-2


def test_flash_attention_decode_alignment_matches_jax():
    """One query against a long KV cache, causal offset."""
    q, k, v = _inputs(2, 4, 4, 1, 256, 64)
    got = _port(q, k, v, causal=True).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal=True, block_q=8,
                                 block_k=64, interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True)
    assert np.abs(got - np.asarray(pallas)).max() < 2e-5
    assert np.abs(got - np.asarray(oracle)).max() < 2e-5


def test_rows_without_visible_keys_are_zero():
    """Causal, sq > sk: rows t < sq - sk see no key.  The port returns 0
    there; the oracle gives NaN, and agrees with the port on every other
    row."""
    q, k, v = _inputs(1, 4, 2, 40, 25, 16)
    got = _port(q, k, v, causal=True).numpy()
    oracle = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True))
    assert np.all(got[:, :, :15] == 0.0)
    assert np.all(np.isnan(oracle[:, :, :15]))
    assert np.abs(got[:, :, 15:] - oracle[:, :, 15:]).max() < 2e-5


def test_explicit_scale_matches_jax():
    q, k, v = _inputs(1, 4, 2, 33, 33, 32)
    got = _port(q, k, v, causal=True, scale=0.3).numpy()
    want = ref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=True, scale=0.3)
    assert np.abs(got - np.asarray(want)).max() < 2e-5


@pytest.mark.parametrize("shapes,dtypes,err", [
    (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), None, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 32), (1, 2, 8, 32)), None, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)), None, ValueError),
    (((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
     (torch.float32, torch.float64, torch.float64), TypeError),
])
def test_flash_attention_rejects_bad_inputs(shapes, dtypes, err):
    dtypes = dtypes or (torch.float32,) * 3
    q, k, v = (torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))
    with pytest.raises(err):
        tfa.flash_attention(q, k, v)
