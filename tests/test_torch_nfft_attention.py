"""The port's NFFT kernel attention against the JAX package's.

``repro_torch.models.nfft_attention`` against ``repro.models.
nfft_attention`` on the reduced granite-3-2b-nfft config (d_model 64, four
heads of 16, feature_dim 2, N = 32, sigma 0.15), float32, on the CPU.  One
module-scoped fixture holds the JAX layer parameters and inputs; each
port layer carries the same weights.  Outputs and cache tensors agree
within 1e-5 of their largest entry (sums run in another order); the
learn_sigma gradients within 1e-4 (a float32 loss through b_hat's float64
FFT and the float32 attention).  Against the exact row-normalized
Gaussian attention in float64, the port is no worse than the JAX function
plus 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import nfft_attention as jnf
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import nfft_attention as tnf

ARCH = "granite-3-2b-nfft"
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's tensors are small, and under pytest-xdist's parallel
    workers torch's OpenMP threads oversubscribe the cores, so its many
    small parallel operations stall.  One thread here; the caller's count
    back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _cfgs(learn_sigma=False):
    jcfg = jconfigs.reduced_config(jconfigs.get_config(ARCH))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(ARCH))
    if learn_sigma:
        jcfg = dataclasses.replace(jcfg, nfft_attention=dataclasses.replace(
            jcfg.nfft_attention, learn_sigma=True))
        tcfg = dataclasses.replace(tcfg, nfft_attention=dataclasses.replace(
            tcfg.nfft_attention, learn_sigma=True))
    return jcfg, tcfg


def _port_layer(jparams, tcfg):
    with torch.device("meta"):
        layer = tnf.NFFTAttention(tcfg, generator=None, device="meta")
    layer = layer.to_empty(device="cpu")
    layer.load_state_dict({k: torch.as_tensor(np.array(v))
                           for k, v in jparams.items()}, strict=True)
    return layer


@pytest.fixture(scope="module")
def jax_side():
    """The JAX layers (plain and learn_sigma, with wo = I so that the
    output is the mixer's before its projection), inputs and the JAX
    outputs every test compares with."""
    jcfg, tcfg = _cfgs()
    jcfg_ls, tcfg_ls = _cfgs(learn_sigma=True)
    d = jcfg.d_model
    assert jcfg.num_heads * jcfg.head_dim_eff == d
    params = jnf.init_nfft_attention(jax.random.PRNGKey(3), jcfg)
    params = dict(params, wo=jnp.eye(d, dtype=jnp.float32))
    params_ls = jnf.init_nfft_attention(jax.random.PRNGKey(4), jcfg_ls)
    rng = np.random.default_rng(0)
    xs = {s: rng.normal(size=(2, s, d)).astype(np.float32)
          for s in (32, 256)}
    steps = rng.normal(size=(4, 2, 1, d)).astype(np.float32)
    # jitted: one compile per function, not one per eager operation
    forward = jax.jit(jnf.nfft_attention_forward, static_argnums=2)
    out = {s: np.asarray(forward(params, jnp.asarray(x), jcfg))
           for s, x in xs.items()}
    # prefill 32 tokens, then four decode steps
    jout, cache = jax.jit(jnf.nfft_attention_prefill, static_argnums=2)(
        params, jnp.asarray(xs[32]), jcfg, jnf.init_nfft_cache(jcfg, 2))
    prefill_cache = jax.tree.map(np.asarray, cache)
    decode_fn = jax.jit(jnf.nfft_attention_decode, static_argnums=2)
    decode = []
    for st in steps:
        o, cache = decode_fn(params, jnp.asarray(st), jcfg, cache)
        decode.append(np.asarray(o))
    # learn_sigma: forward and the gradient of <R, forward>
    r = jnp.asarray(rng.normal(size=(2, 256, d)).astype(np.float32))

    def loss(p):
        return jnp.sum(jnf.nfft_attention_forward(p, jnp.asarray(xs[256]),
                                                  jcfg_ls) * r)
    val, grads = jax.jit(jax.value_and_grad(loss))(params_ls)
    return {
        "jcfg": jcfg, "tcfg": tcfg, "tcfg_ls": tcfg_ls,
        "params": jax.tree.map(np.asarray, params),
        "params_ls": jax.tree.map(np.asarray, params_ls),
        "jparams": params, "xs": xs, "steps": steps, "out": out,
        # the prefill's output, and the cache after the four decode steps
        "prefill": (np.asarray(jout), jax.tree.map(np.asarray, cache)),
        "prefill_cache": prefill_cache,
        "decode": decode, "r": np.asarray(r),
        "ls_loss": float(val), "ls_grads": jax.tree.map(np.asarray, grads),
        "ls_out": np.asarray(forward(params_ls, jnp.asarray(xs[256]),
                                     jcfg_ls))}


def test_lattice_and_coefficients_match_jax():
    for n, d in ((32, 2), (8, 3), (16, 1)):
        assert np.array_equal(tnf.lattice_frequencies(n, d),
                              jnf.lattice_frequencies(n, d))
    for n, d, sigma in ((32, 2, 0.15),):
        got = tnf.kernel_coefficients(n, d, sigma)
        want = jnf.kernel_coefficients(n, d, sigma)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == (n ** d,)
        assert _rel(got, want) <= TOL
    sigma = torch.tensor(0.15, dtype=torch.float32)
    traced = tnf.kernel_coefficients_traced(32, 2, sigma)
    assert traced.dtype == torch.float32
    assert _rel(traced.numpy(), jnf.kernel_coefficients(32, 2, 0.15)) <= TOL


@pytest.mark.parametrize("s", [32, 256])
def test_forward_matches_jax(jax_side, s):
    """s = 32 is one chunk; s = 256 two, so the inter-chunk prefix runs."""
    layer = _port_layer(jax_side["params"], jax_side["tcfg"])
    got = layer(torch.as_tensor(jax_side["xs"][s]))
    assert got.shape == (2, s, jax_side["tcfg"].d_model)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), jax_side["out"][s]) <= TOL


def test_prefill_and_decode_match_jax(jax_side):
    """Outputs and both cache tensors, after the prefill and after four
    decode steps; the cache is filled in place."""
    layer = _port_layer(jax_side["params"], jax_side["tcfg"])
    cache = tnf.init_nfft_cache(jax_side["tcfg"], 2, device="cpu")
    ptrs = [t.data_ptr() for t in cache]
    jout, jcache = jax_side["prefill"]
    out = layer.prefill(torch.as_tensor(jax_side["xs"][32]), cache)
    assert _rel(out.numpy(), jout) <= TOL
    for step, want in zip(jax_side["steps"], jax_side["decode"]):
        got = layer.decode(torch.as_tensor(step), cache)
        assert got.shape == (2, 1, jax_side["tcfg"].d_model)
        assert _rel(got.numpy(), want) <= TOL
    assert [t.data_ptr() for t in cache] == ptrs
    assert cache.s_cos.dtype == torch.float32
    assert cache.s_cos.shape == (2, 4, 32 ** 2, 17)
    assert _rel(cache.s_cos.numpy(), jcache.s_cos) <= TOL
    assert _rel(cache.s_sin.numpy(), jcache.s_sin) <= TOL


def test_attention_on_the_jax_features_matches_tightly(jax_side):
    """Fed the JAX package's own features (qf, kf, v), the port's chunked
    attention and its whole-sequence sums agree with the JAX forward and
    prefill within 1e-6: the looser NFFT tolerances of test_torch_lm.py
    come from the features, whose few-ulp differences the 34 rad phases
    amplify, not from the attention."""
    jcfg = jax_side["jcfg"]
    nc = jcfg.nfft_attention
    for s in (32, 256):
        feats = jnf._features(jax_side["jparams"],
                              jnp.asarray(jax_side["xs"][s]), jcfg)
        qf, kf, v = (torch.from_numpy(np.array(a)).transpose(1, 2)
                     for a in feats)
        freqs, bhat = tnf._on_device(nc.bandwidth, nc.feature_dim, nc.sigma,
                                     torch.device("cpu"))
        out, (s_cos, s_sin) = tnf.causal_kernel_attention(
            qf, kf, v, freqs, bhat, nc.sigma, return_sums=True)
        got = out.transpose(1, 2).reshape(2, s, -1).numpy()
        assert _rel(got, jax_side["out"][s]) <= 1e-6, s
    jcache = jax_side["prefill_cache"]  # right after the prefill of xs[32]
    feats = jnf._features(jax_side["jparams"], jnp.asarray(jax_side["xs"][32]),
                          jcfg)
    qf, kf, v = (torch.from_numpy(np.array(a)).transpose(1, 2) for a in feats)
    _, (s_cos, s_sin) = tnf.causal_kernel_attention(
        qf, kf, v, freqs, bhat, nc.sigma, return_sums=True)
    assert _rel(s_cos.numpy(), jcache.s_cos) <= 1e-6
    assert _rel(s_sin.numpy(), jcache.s_sin) <= 1e-6


def test_learn_sigma_forward_and_gradients_match_jax(jax_side):
    """With learn_sigma, b_hat is computed with the graph kept: the
    gradient of <R, forward> in log_sigma (through the profile samples and
    the FFT) and in wqf against jax.grad, within GRAD_TOL."""
    layer = _port_layer(jax_side["params_ls"], jax_side["tcfg_ls"])
    assert layer.log_sigma.shape == () and layer.log_sigma.dtype == \
        torch.float32
    layer.log_sigma.requires_grad_(True)
    layer.wqf.requires_grad_(True)
    out = layer(torch.as_tensor(jax_side["xs"][256]))
    assert _rel(out.detach().numpy(), jax_side["ls_out"]) <= TOL
    loss = (out * torch.from_numpy(jax_side["r"].copy())).sum()
    assert abs(loss.item() - jax_side["ls_loss"]) <= TOL * abs(
        jax_side["ls_loss"])
    g_sigma, g_wqf = torch.autograd.grad(loss, (layer.log_sigma, layer.wqf))
    want = jax_side["ls_grads"]
    assert float(want["log_sigma"]) != 0.0
    assert abs(float(g_sigma) - float(want["log_sigma"])) <= GRAD_TOL * abs(
        float(want["log_sigma"]))
    assert _rel(g_wqf.numpy(), want["wqf"]) <= GRAD_TOL


def _exact_attention(qf, kf, v, sigma):
    """Causal sum_i K(q - k_i) v_i / sum_i K(q - k_i) in float64; qf, kf
    (b, s, h, F), v (b, s, h, hd) -> (b, s, h, hd)."""
    qf, kf, v = (np.asarray(a, np.float64) for a in (qf, kf, v))
    diff = qf[:, :, None] - kf[:, None, :]  # (b, sq, sk, h, F)
    w = np.exp(-(diff ** 2).sum(-1) / sigma ** 2)
    s = qf.shape[1]
    w = w * np.tril(np.ones((s, s)))[None, :, :, None]
    return (np.einsum("bqkh,bkhe->bqhe", w, v)
            / w.sum(axis=2)[..., None])


def test_error_against_exact_kernel_attention(jax_side):
    """K_RF ≈ K: the port's output against the exact row-normalized
    Gaussian attention on the same features, in float64, is no worse than
    the JAX function's plus 1e-6 (s = 256: 128 exact intra-chunk pairs a
    row, the rest through the Fourier sums)."""
    jcfg, s = jax_side["jcfg"], 256
    x = jax_side["xs"][s]
    qf, kf, v = jnf._features(jax_side["jparams"], jnp.asarray(x), jcfg)
    exact = _exact_attention(qf, kf, v, jcfg.nfft_attention.sigma)
    exact = exact.reshape(2, s, -1)
    layer = _port_layer(jax_side["params"], jax_side["tcfg"])
    got = layer.attend(torch.as_tensor(x)).reshape(2, s, -1).numpy()
    err_jax = _rel(jax_side["out"][s], exact)
    err_port = _rel(got, exact)
    assert err_jax < 1e-3
    assert err_port <= err_jax + 1e-6, (err_port, err_jax)


def test_long_prompts_must_be_whole_chunks(jax_side):
    """As in the JAX package: a sequence longer than 128 must be a
    multiple of 128; nothing is padded."""
    layer = _port_layer(jax_side["params"], jax_side["tcfg"])
    x = torch.zeros((1, 200, jax_side["tcfg"].d_model))
    with pytest.raises(AssertionError):
        layer(x)
    with pytest.raises(AssertionError):
        jnf.nfft_attention_forward(jax_side["jparams"], jnp.asarray(x.numpy()),
                                   jax_side["jcfg"])


def test_future_tokens_dont_affect_past():
    """The port twin of tests/test_causality.py's granite-3-2b-nfft case:
    logits at p are invariant to the tokens after p, and do change after
    it."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(ARCH))
    model = TM.init_params(cfg, 0, device="cpu")
    b, s, cut = 2, 32, 17
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    toks2 = toks.copy()
    toks2[:, cut:] = rng.integers(0, cfg.vocab_size, (b, s - cut))

    def logits(t):
        x, positions, _ = model.embed_inputs({"tokens": torch.as_tensor(t)})
        return model.lm_logits(model.run_backbone(x, positions,
                                                  mode="train"))
    la, lb = logits(toks), logits(toks2)
    assert float((la[:, :cut] - lb[:, :cut]).abs().max()) < 1e-4
    assert float((la[:, cut:] - lb[:, cut:]).abs().max()) > 1e-4


def test_model_runs_the_nfft_blocks_with_constant_caches():
    """Every layer of the reduced model is an NFFT block; its caches are
    NFFTCaches whose size does not depend on max_seq."""
    jcfg, tcfg = _cfgs()
    model = TM.init_params(tcfg, 0, device="cpu")
    assert all(hasattr(b, "nfft") and not hasattr(b, "attn")
               for b in model.blocks)
    small = TM.init_caches(tcfg, 2, 16, device="cpu")
    big = TM.init_caches(tcfg, 2, 4096, device="cpu")
    assert all(isinstance(c, tnf.NFFTCache) for c in small)
    assert [tuple(c.s_cos.shape) for c in small] == \
        [tuple(c.s_cos.shape) for c in big]
    jc = JM.init_caches(jcfg, 2, 16)
    assert tuple(jc["stack"][0].s_cos.shape[1:]) == tuple(
        small[0].s_cos.shape)
