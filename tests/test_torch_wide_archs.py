"""llama3-405b, qwen1.5-32b and jamba-1.5-large at the ratios that
``reduced_config`` drops, against the JAX package; and the card memory
plan of ``chip_smoke.py``'s [llama_serve], [qwen_serve] and [jamba_serve].

The variants (``tests/_torch_wide_cases.py``) put back GQA 16:1 (llama),
10 MHA heads with nonzero QKV biases (qwen) and jamba's depth-2 cut with
16 experts top-2 at Mamba head dim 64, d_state 16.  llama's and qwen's
weights come from the JAX package's ``init_params`` (``params_from_arrays``
carries them over), jamba's from the port's (laid out as the JAX tree, as
``tests/_torch_lm_cases.py`` does).  Both packages run the same
numpy-seeded tokens in float32; logits and caches must agree within
tests/test_torch_lm.py's TOL, 1e-5 of the largest entry.

The memory plan builds each phase's cut on the meta device at the depths
``chip_smoke.WIDE_SERVE`` names, and holds its parameter bytes to
``param_count()`` and its peak to the card's 70 GB, so that a cut that
would run out of memory fails here, without the card.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as cases
import _torch_wide_cases as wide
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

TOL = 1e-5  # tests/test_torch_lm.py's: sums in another order
PHASES = tuple(cs.WIDE_SERVE)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread (pytest-xdist's workers would
    oversubscribe the cores); the caller's count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    """(JAX variant, port variant) of ``name``."""
    return (wide.variant(name, jconfigs.reduced_config(
                jconfigs.get_config(name))),
            wide.variant(name, tconfigs.reduced_config(
                tconfigs.get_config(name))))


def _carried(name):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights:
    llama's and qwen's drawn by the JAX package (qwen's QKV biases drawn
    nonzero), jamba's by the port."""
    jcfg, tcfg = _configs(name)
    if jcfg.moe is not None:
        tree = cases.port_tree(TM.init_params(tcfg, 1, device="cpu"))
        cases.assert_tree_is_jax_init(tree, jcfg)
        return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                TM.params_from_arrays(tree, tcfg, device="cpu"))
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    if jcfg.qkv_bias:
        attn = [slot["attn"] for slot in params["stack"]]
        shapes = [a[k].shape for a in attn for k in ("bq", "bk", "bv")]
        drawn = iter(wide.qkv_biases(shapes, seed=3))
        for a in attn:
            for k in ("bq", "bk", "bv"):
                a[k] = jnp.asarray(next(drawn))
    return jcfg, params, tcfg, TM.params_from_arrays(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


@pytest.fixture(scope="module")
def carried():
    """Each variant's weights on both sides, and the JAX package's
    prefill and decode jitted once."""
    out = {}
    for name in wide.VARIANTS:
        jcfg, params, tcfg, model = _carried(name)
        out[name] = SimpleNamespace(
            jcfg=jcfg, params=params, tcfg=tcfg, model=model,
            prefill=jax.jit(lambda p, b, c, cfg=jcfg:
                            JM.forward_prefill(p, cfg, b, c)),
            decode=jax.jit(lambda p, t, pos, c, cfg=jcfg:
                           JM.forward_decode(p, cfg, t, pos, c)))
    return out


def _jax_cache_layers(caches, cfg):
    """Per-layer JAX caches with numpy leaves."""
    plan = JM.make_layer_plan(cfg)
    out = [None] * cfg.num_layers
    for i, c in caches.get("prefix", {}).items():
        out[i] = type(c)(*map(np.asarray, c))
    for slot, c in enumerate(caches.get("stack", [])):
        for p in range(plan.n_periods):
            layer = len(plan.prefix) + p * len(plan.period) + slot
            out[layer] = type(c)(*(np.asarray(f[p]) for f in c))
    return out


def _assert_caches_match(tcaches, jcaches, cfg):
    for i, jc in enumerate(_jax_cache_layers(jcaches, cfg)):
        assert tcaches[i]._fields == jc._fields, i
        for field in jc._fields:
            got = getattr(tcaches[i], field).numpy()
            assert cases.rel(got, getattr(jc, field)) <= TOL, (field, i)


@pytest.mark.parametrize("name", wide.VARIANTS)
def test_variant_configs_match_jax(name):
    """The same fields give the same config, layer plan and parameter
    count in both packages, and the ratios the reduced config drops."""
    jcfg, tcfg = _configs(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tuple(TM.make_layer_plan(tcfg)) == tuple(JM.make_layer_plan(jcfg))
    assert tcfg.param_count() == jcfg.param_count()
    if name == "llama3-405b":
        assert tcfg.num_heads // tcfg.num_kv_heads == 16
    elif name == "qwen1.5-32b":
        assert tcfg.num_heads == tcfg.num_kv_heads == 10 and tcfg.qkv_bias
    else:
        assert [tuple(TM.layer_signature(tcfg, i)) for i in range(2)] == \
            [("mamba", "moe"), ("mamba", "dense")]
        assert (tcfg.moe.num_experts, tcfg.moe.top_k) == (16, 2)
        assert (tcfg.mamba.head_dim, tcfg.mamba.d_state) == (64, 16)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("name", ["llama3-405b", "qwen1.5-32b"])
def test_dense_prefill_matches_jax(carried, name, use_flash):
    """GQA 16:1 and 10 MHA heads with biases: the prefill through the
    flash kernel's plain version and through the einsum, logits and KV
    caches."""
    c = carried[name]
    if name == "qwen1.5-32b":
        assert min(float(b.abs().max()) for blk in c.model.blocks
                   for b in (blk.attn.bq, blk.attn.bk, blk.attn.bv)) > 0
    toks = np.random.default_rng(0).integers(0, c.tcfg.vocab_size, (2, 12))
    jl, jc = c.prefill(c.params, {"tokens": jnp.asarray(toks, jnp.int32)},
                       JM.init_caches(c.jcfg, 2, 24))
    tl, tc = c.model.forward_prefill(
        {"tokens": torch.as_tensor(toks)},
        TM.init_caches(c.tcfg, 2, 24, device="cpu"), use_flash=use_flash)
    assert tl.shape == jl.shape == (2, 1, c.tcfg.vocab_size)
    assert cases.rel(tl.numpy(), jl) <= TOL
    _assert_caches_match(tc, jc, c.jcfg)


@pytest.mark.parametrize("name", wide.VARIANTS)
def test_decode_steps_match_jax(carried, name):
    """Prefill, then four teacher-forced decode steps with the two rows
    at different positions (one rewriting rows its prefill wrote): every
    step's logits and, after the last, every layer's cache (KV; Mamba's
    conv buffers and state)."""
    c = carried[name]
    rng = np.random.default_rng(5)
    n = 32 if name == "jamba-1.5-large-398b" else 10  # whole Mamba chunks
    toks = rng.integers(0, c.tcfg.vocab_size, (2, n))
    jl, jc = c.prefill(c.params, {"tokens": jnp.asarray(toks, jnp.int32)},
                       JM.init_caches(c.jcfg, 2, 48))
    tl, tc = c.model.forward_prefill({"tokens": torch.as_tensor(toks)},
                                     TM.init_caches(c.tcfg, 2, 48,
                                                    device="cpu"))
    assert cases.rel(tl.numpy(), jl) <= TOL
    pos = np.array([n, n - 4])
    for step in range(4):
        tok = rng.integers(0, c.tcfg.vocab_size, (2, 1))
        jl, jc = c.decode(c.params, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos + step, jnp.int32), jc)
        tl, tc = c.model.forward_decode(torch.as_tensor(tok),
                                        torch.as_tensor(pos + step), tc)
        assert tl.shape == (2, 1, c.tcfg.vocab_size)
        assert cases.rel(tl.numpy(), jl) <= TOL, step
    _assert_caches_match(tc, jc, c.jcfg)


def _meta_model(cfg):
    with torch.device("meta"):
        return TM.Model(cfg, generator=None, device="meta")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("phase", PHASES)
def test_memory_plan_of_each_phase(phase, dtype):
    """The phase's cut on meta: its matrices hold ``param_count()``
    elements, in the config's dtype but for the float32 MoE router; the
    plan visits every parameter; weights, the engine's caches and the
    init transient stay under the card's 70 GB.  The transient is taken in
    init order (a matrix drawn in float32 and scaled, 8 bytes an element,
    beside the weights drawn before it), which the looser sum of the
    weights, the caches and twice the largest float32 matrix bounds."""
    cfg = cs.wide_config(phase, dtype)
    arch, bf16_layers, f32_layers = cs.WIDE_SERVE[phase]
    assert cfg.name == arch
    assert cfg.num_layers == (bf16_layers if dtype == "bfloat16"
                              else f32_layers)
    model = _meta_model(cfg)
    mats = {n: p for n, p in model.named_parameters() if p.ndim >= 2}
    itemsize = torch.finfo(cfg.pdtype).bits // 8
    assert sum(p.numel() for p in mats.values()) == cfg.param_count()
    routers = [p for n, p in mats.items() if n.endswith("moe.router")]
    assert all(p.dtype == torch.float32 for p in routers)
    assert all(p.dtype == cfg.pdtype for n, p in mats.items()
               if not n.endswith("moe.router"))
    assert sum(p.numel() * p.element_size() for p in mats.values()) == \
        cfg.param_count() * itemsize + (4 - itemsize) * sum(
            p.numel() for p in routers)
    plan = cs.serve_memory_plan(cfg)
    params = list(model.parameters())
    assert plan["params"] == sum(p.numel() for p in params)
    assert plan["weight_bytes"] == sum(p.numel() * p.element_size()
                                       for p in params)
    largest = max(p.numel() for p in mats.values())
    assert plan["init_peak_bytes"] <= plan["weight_bytes"] + 8 * largest
    assert plan["peak_bytes"] <= cs.WIDE_PLAN_LIMIT_GB * 1e9


def test_memory_plan_refuses_a_cut_past_the_card():
    """qwen1.5-32b at its full 64 layers in bf16 (73.5 GB of weights) and
    jamba's first period with its attention layer: the plan says they do
    not fit, as the phases' cuts say."""
    qwen = dataclasses.replace(cs.wide_config("qwen_serve", "bfloat16"),
                               num_layers=64)
    jamba = dataclasses.replace(cs.wide_config("jamba_serve", "bfloat16"),
                                num_layers=8)
    for cfg in (qwen, jamba):
        assert cs.serve_memory_plan(cfg)["peak_bytes"] > \
            cs.WIDE_PLAN_LIMIT_GB * 1e9
