"""The port's LM configs and serving forwards against the JAX package.

Configs and layer plans must equal the JAX package's for every registered
architecture, and the port's ``init_params`` builds every one of them with
the JAX package's parameter count.  For the reduced dense token
architectures (granite-3-2b: GQA and a tied head; gemma-7b: GeGLU,
embedding scale; qwen1.5-32b: MHA with QKV biases; llama3-405b: GQA, an
untied head), the JAX model's weights are carried onto the port by
``params_from_arrays``; for the other token architectures (deepseek-v3:
MLA, MoE with a shared expert, 1 dense layer first; olmoe: MoE; mamba2:
pure SSM blocks; jamba: the 1:7 attention/Mamba hybrid with MoE every
other layer) the port's weights are carried the other way
(tests/_torch_lm_cases.py).  Both run the same numpy-seeded tokens in
float32.  Logits must agree within 1e-5 of the largest |logit|, and
caches (KV, MLA latents, Mamba conv buffers and state) within 1e-5 of
their largest entry (sums run in another order).  MoE routing is the same
discrete choice in both packages; a near tie between two experts' router
probabilities could flip between the two packages' float32 matmuls, and
then the outputs would differ by far more than the tolerance: none occurs
at these seeds, and tests/test_torch_moe.py checks the routing itself.

The NFFT kernel attention blocks (granite-3-2b-nfft) run the same prefill
and decode checks: prefill logits within 1e-5, decode logits and the
(S, z) caches within NFFT_TOL = 5e-5.  Their phase features cos(2 pi l.f)
reach angles of 34 rad, where one float32 ulp is 3.8e-6: the few-ulp
differences of ``x @ wqf`` and ``tanh`` between the two packages' CPU
libraries are multiplied by up to 2 pi |l| in the angles, and grow
through four layers and four decode steps.  Fed the JAX package's own
features, the port's attention and cache sums agree within 1e-6
(tests/test_torch_nfft_attention.py::
test_attention_on_the_jax_features_matches_tightly).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as cases
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import HEAD_DIMS, WGMMA_HEAD_DIMS
from repro_torch.models import model as TM

DENSE = ["granite-3-2b", "gemma-7b", "qwen1.5-32b", "llama3-405b"]
# MLA, MoE, Mamba and the hybrid: weights drawn by the port
MIXERS = ["deepseek-v3-671b", "olmoe-1b-7b", "mamba2-1.3b",
          "jamba-1.5-large-398b"]
# the NFFT kernel attention blocks: prefill and decode against the JAX
# package as the dense ones are (it has no flash path)
PARITY = DENSE + MIXERS + ["granite-3-2b-nfft"]
# the architectures whose layers include GQA softmax attention, which
# takes the flash kernel on the card
FLASH_ARCHS = [n for n in tconfigs.list_archs() if any(
    TM.layer_signature(tconfigs.get_config(n), i).mixer == "attn"
    for i in range(tconfigs.get_config(n).num_layers))]
TOL = 1e-5
NFFT_TOL = 5e-5


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


@pytest.mark.parametrize("name", jconfigs.list_archs())
def test_registry_matches_jax(name):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.head_dim_eff == jcfg.head_dim_eff
    assert tcfg.dtype == getattr(torch, jcfg.dtype.name)
    assert tcfg.pdtype == getattr(torch, jcfg.pdtype.name)
    jred = jconfigs.reduced_config(jcfg, seq_len=32, global_batch=4)
    tred = tconfigs.reduced_config(tcfg, seq_len=32, global_batch=4)
    assert dataclasses.asdict(tred) == dataclasses.asdict(jred)
    assert tred.param_count() == jred.param_count()
    assert [tcfg.is_moe_layer(i) for i in range(tcfg.num_layers)] == \
        [jcfg.is_moe_layer(i) for i in range(jcfg.num_layers)]


@pytest.mark.parametrize("name", jconfigs.list_archs())
def test_layer_plan_matches_jax(name):
    for reduce in (False, True):
        jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
        if reduce:
            jcfg, tcfg = (jconfigs.reduced_config(jcfg),
                          tconfigs.reduced_config(tcfg))
        jplan, tplan = JM.make_layer_plan(jcfg), TM.make_layer_plan(tcfg)
        assert tuple(tplan) == tuple(jplan)
        assert tplan.num_layers == jplan.num_layers == tcfg.num_layers


@pytest.mark.parametrize("name", jconfigs.list_archs())
def test_init_params_builds_every_arch(name):
    """Every registered architecture builds at its reduced config, with
    the JAX package's tree (paths, shapes, dtypes) and parameter count."""
    jcfg, tcfg = cases.configs(name)
    model = TM.init_params(tcfg, 0, device="cpu")
    cases.assert_tree_is_jax_init(cases.port_tree(model), jcfg)
    want = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(want))


@pytest.mark.parametrize("name", FLASH_ARCHS)
def test_attention_head_dims_have_a_flash_kernel(name):
    """Each config whose layers include GQA attention has a head dim the
    CUDA flash kernel is built for (gemma-7b and paligemma-3b 256,
    hubert-xlarge 80): a prefill on the card launches it."""
    assert tconfigs.get_config(name).head_dim_eff in HEAD_DIMS


@pytest.mark.parametrize("name", FLASH_ARCHS)
def test_attention_head_dims_have_a_tensor_core_flash_kernel(name):
    """... and that bf16 / fp16 there take the tensor-core kernel (wgmma),
    hubert-xlarge's dh 80 and gemma-7b's and paligemma-3b's 256 too."""
    assert tconfigs.get_config(name).head_dim_eff in WGMMA_HEAD_DIMS


def _carry(name, seed=1):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights;
    QKV biases (zeros at init) are made nonzero so that they count.  The
    MIXERS' weights come from the port (``cases.carried``)."""
    if name in MIXERS:
        return cases.carried(name, seed)
    jcfg = jconfigs.reduced_config(jconfigs.get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for slot in params["stack"]:
            for key in ("bq", "bk", "bv"):
                a = slot["attn"][key]
                slot["attn"][key] = jnp.asarray(
                    0.1 * rng.normal(size=a.shape), a.dtype)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, TM.params_from_arrays(tree, tcfg,
                                                     device="cpu")


def _jax_cache_layers(caches, cfg):
    """Per-layer JAX caches (a KVCache's (k, v), an MLACache's (c_kv,
    k_rope), a MambaCache's (conv_x, conv_bc, ssm), an NFFTCache's
    (s_cos, s_sin)) with numpy leaves."""
    plan = JM.make_layer_plan(cfg)
    out = [None] * cfg.num_layers
    for i, c in caches.get("prefix", {}).items():
        out[i] = type(c)(*map(np.asarray, c))
    for slot, c in enumerate(caches.get("stack", [])):
        for p in range(plan.n_periods):
            layer = len(plan.prefix) + p * len(plan.period) + slot
            out[layer] = type(c)(*(np.asarray(f[p]) for f in c))
    return out


def _tol(cfg):
    """Decode logits' and caches' tolerance (see the module docstring)."""
    return TOL if cfg.nfft_attention is None else NFFT_TOL


def _assert_caches_match(tcaches, jcaches, cfg):
    """Field by field (the port's cache types have the JAX package's
    fields)."""
    for i, jc in enumerate(_jax_cache_layers(jcaches, cfg)):
        assert tcaches[i]._fields == jc._fields, i
        for name in jc._fields:
            got = getattr(tcaches[i], name).numpy()
            assert _rel(got, getattr(jc, name)) <= _tol(cfg), (name, i)


def _jax(name, jcfg):
    """The JAX package's prefill and decode: jitted for the MIXERS, whose
    eager forwards take seconds each."""
    if name in MIXERS:
        return cases.jax_fns(name)
    return SimpleNamespace(
        prefill=lambda p, b, c: JM.forward_prefill(p, jcfg, b, c),
        decode=lambda p, t, pos, c: JM.forward_decode(p, jcfg, t, pos, c))


@pytest.mark.parametrize("name", PARITY)
def test_prefill_matches_jax(name):
    jcfg, params, tcfg, model = _carry(name)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 12))
    jl, jc = _jax(name, jcfg).prefill(
        params, {"tokens": jnp.asarray(toks, jnp.int32)},
        JM.init_caches(jcfg, 2, 24))
    tl, tc = model.forward_prefill({"tokens": torch.as_tensor(toks)},
                                   TM.init_caches(tcfg, 2, 24, device="cpu"))
    assert tl.shape == jl.shape == (2, 1, tcfg.vocab_size)
    assert _rel(tl.numpy(), jl) <= TOL
    _assert_caches_match(tc, jc, jcfg)


@pytest.mark.parametrize("name", PARITY)
def test_decode_steps_match_jax(name):
    """Prefill, then four decode steps with the two rows at different
    positions (one rewriting rows its prefill wrote), teacher-forced with
    the same tokens on both sides."""
    jcfg, params, tcfg, model = _carry(name, seed=2)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, 10))
    fns = _jax(name, jcfg)
    _, jc = fns.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                        JM.init_caches(jcfg, 2, 24))
    _, tc = model.forward_prefill({"tokens": torch.as_tensor(toks)},
                                  TM.init_caches(tcfg, 2, 24, device="cpu"))
    pos = np.array([10, 6])
    for step in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1))
        jl, jc = fns.decode(params, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos + step, jnp.int32), jc)
        tl, tc = model.forward_decode(torch.as_tensor(tok),
                                      torch.as_tensor(pos + step), tc)
        assert tl.shape == (2, 1, tcfg.vocab_size)
        assert _rel(tl.numpy(), jl) <= _tol(tcfg), step
    _assert_caches_match(tc, jc, jcfg)


@pytest.mark.parametrize("name", DENSE)
def test_flash_and_einsum_prefill_agree(name):
    """use_flash=True (the flash kernel's plain version on the CPU) and the
    einsum path give the same logits and caches; both match JAX."""
    jcfg, params, tcfg, model = _carry(name, seed=3)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 9))
    batch = {"tokens": torch.as_tensor(toks)}
    out = {flag: model.forward_prefill(
        batch, TM.init_caches(tcfg, 2, 16, device="cpu"), use_flash=flag)
        for flag in (True, False)}
    assert _rel(out[True][0].numpy(), out[False][0].numpy()) <= TOL
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    jl, _ = JM.forward_prefill(params, jcfg,
                               {"tokens": jnp.asarray(toks, jnp.int32)},
                               JM.init_caches(jcfg, 2, 16))
    assert _rel(out[True][0].numpy(), jl) <= TOL


@pytest.mark.parametrize("name", DENSE + MIXERS)
def test_prefill_decode_consistency(name):
    """Prefill s-1 tokens then decode token s-1 equals the whole-sequence
    forward at position s-1 (as tests/test_arch_smoke.py does for JAX).
    MoE routing drops the choices past an expert's capacity in each token
    group, and the groups of a 2 x 16-token forward, a 2 x 15-token
    prefill and a 2-token decode differ, so the three agree only where no
    choice is dropped (in the JAX package too): for the MoE architectures
    the capacity factor is e / k, which makes every capacity the group's
    size."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = TM.init_params(cfg, 1, device="cpu")
    b, s = 2, 16
    toks = torch.as_tensor(
        np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s)))
    x, positions, _ = model.embed_inputs({"tokens": toks})
    full = model.lm_logits(model.run_backbone(x, positions, mode="train"))
    caches = TM.init_caches(cfg, b, s, device="cpu")
    _, caches = model.forward_prefill({"tokens": toks[:, :s - 1]}, caches)
    dec, _ = model.forward_decode(toks[:, s - 1:], torch.full((b,), s - 1),
                                  caches)
    assert _rel(dec[:, 0].numpy(), full[:, -1].numpy()) <= TOL


@pytest.mark.parametrize("name", MIXERS)
def test_future_tokens_dont_affect_past(name):
    """The twin of tests/test_causality.py's for the port's MLA, MoE,
    Mamba and hybrid stacks (MoE with every choice kept: a dropped choice
    depends on the other tokens of its group, later ones too, in both
    packages)."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
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


def test_params_from_arrays_carries_bf16_leaves():
    """The full configs are bfloat16: JAX's bf16 numpy leaves (ml_dtypes)
    arrive bit for bit."""
    jcfg = dataclasses.replace(
        jconfigs.reduced_config(jconfigs.get_config("granite-3-2b")),
        param_dtype="bfloat16", activation_dtype="bfloat16")
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("granite-3-2b")),
        param_dtype="bfloat16", activation_dtype="bfloat16")
    params = JM.init_params(jax.random.PRNGKey(4), jcfg)
    model = TM.params_from_arrays(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    assert model.embed.dtype == torch.bfloat16
    want = np.asarray(params["stack"][0]["attn"]["wq"][3], np.float32)
    got = model.blocks[3].attn.wq.float().numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(model.embed.float().numpy(),
                          np.asarray(params["embed"], np.float32))
