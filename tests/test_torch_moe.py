"""The port's mixture of experts against the JAX package's ``moe_forward``.

Reduced configs in float32 (olmoe-1b-7b: SwiGLU experts, no shared
expert; deepseek-v3-671b: a shared expert; jamba: top-2 of 8), the JAX
package's ``init_moe`` weights carried onto the port's ``MoE``, and
numpy-seeded inputs.  The routing is compared first, exactly: the top-k
experts in descending order, each choice's place in its expert's queue,
its slot and whether it is kept, on the same router logits (the JAX side
repeats ``moe_forward``'s own routing lines, which it does not return).
Then the output and the aux loss within 1e-5 relative, and gradients of
the output's weighted sum with respect to the input and every weight
within 1e-5 of each leaf's largest entry (the scatter into the expert
buffer and the gather back carry them; a dropped choice gets none).

Routing is discrete: two experts whose router probabilities tie to within
the float32 rounding of the two packages' matmuls could swap places in the
top-k, and the outputs would then differ by far more than the tolerance.
The routing check shows that no such near tie occurs at these seeds; the
seeds were not chosen for it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_cases as cases
from repro.models import mlp as jmlp
from repro_torch.models.mlp import MoE, moe_groups

TOL = 1e-5
# (arch, (b, s), capacity factor or None for the config's 1.25)
CASES = [("olmoe-1b-7b", (2, 24), None),      # 16 groups of 3: many drops
         ("olmoe-1b-7b", (2, 1), None),       # a decode step
         ("deepseek-v3-671b", (2, 40), None),  # shared expert, 16 x 5
         ("deepseek-v3-671b", (1, 64), 4.0),  # every choice kept
         ("jamba-1.5-large-398b", (3, 10), None)]  # t = 30: 2 groups


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, shape, factor, seed=0):
    jcfg, tcfg = cases.configs(name)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=factor))
    params = _init_moe(jax.random.PRNGKey(seed), jcfg)
    with torch.device("meta"):
        moe = MoE(tcfg, generator=None, device="meta")
    moe = moe.to_empty(device="cpu")
    flat = {}
    for key, val in params.items():
        if isinstance(val, dict):
            flat.update({f"{key}.{k}": v for k, v in val.items()})
        else:
            flat[key] = val
    moe.load_state_dict({k: torch.from_numpy(np.asarray(v).copy())
                         for k, v in flat.items()}, strict=True)
    x = np.random.default_rng(seed + 1).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return jcfg, params, moe, x


# the JAX side jitted, the config static (its eager MoE takes seconds)
_init_moe = jax.jit(jmlp.init_moe, static_argnums=1)
_moe_forward = jax.jit(jmlp.moe_forward, static_argnums=2)


@functools.partial(jax.jit, static_argnums=2)
def _jax_routing(params, x, cfg):
    """``moe_forward``'s routing lines (repro/models/mlp.py), no mesh:
    (top_idx (t, k), pos, slot, within, each (groups, tg, k))."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    t = b * s
    probs = jax.nn.softmax(x.reshape(t, d).astype(jnp.float32)
                           @ params["router"], axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    groups = moe.token_groups
    while t % groups != 0:
        groups //= 2
    tg = t // groups
    top_idx_g = top_idx.reshape(groups, tg, k)
    capacity = max(1, int(moe.capacity_factor * tg * k / e))
    flat = jax.nn.one_hot(top_idx_g, e, dtype=jnp.int32).reshape(
        groups, tg * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1).reshape(
        groups, tg, k)
    within = pos < capacity
    slot = top_idx_g * capacity + jnp.minimum(pos, capacity - 1)
    slot = jnp.where(within, slot, e * capacity)
    return top_idx, pos, slot, within


@pytest.mark.parametrize("name,shape,factor", CASES)
def test_routing_matches_jax(name, shape, factor):
    jcfg, params, moe, x = _setup(name, shape, factor)
    want = [np.asarray(a) for a in _jax_routing(params, jnp.asarray(x),
                                                jcfg)]
    r = moe.route(torch.from_numpy(x).reshape(-1, jcfg.d_model))
    groups = moe_groups(x.shape[0] * x.shape[1], jcfg.moe.token_groups)
    got = [r.top_idx.numpy()] + [a.reshape(groups, -1, jcfg.moe.top_k)
                                 .numpy() for a in (r.pos, r.slot, r.within)]
    for label, g, w in zip(("top_idx", "pos", "slot", "within"), got, want):
        assert np.array_equal(g, w), label
    if factor is None and shape == (2, 24):
        assert not r.within.all(), "the case meant to drop choices did not"


@pytest.mark.parametrize("name,shape,factor", CASES)
def test_output_and_aux_match_jax(name, shape, factor):
    jcfg, params, moe, x = _setup(name, shape, factor)
    want, want_aux = _moe_forward(params, jnp.asarray(x), jcfg)
    got, aux = moe(torch.from_numpy(x))
    assert got.shape == x.shape and aux.dtype == torch.float32
    assert cases.rel(got.numpy(), want) <= TOL
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))


@functools.partial(jax.jit, static_argnums=3)
def _jax_grads(params, x, w, cfg):
    """Gradients of <moe_forward(x), w> + aux wrt the params and x."""
    def loss(p, xx):
        out, aux = jmlp.moe_forward(p, xx, cfg)
        return (out * w).sum() + aux
    return jax.grad(loss, argnums=(0, 1))(params, x)


@pytest.mark.parametrize("name,shape,factor", CASES[::2])
def test_gradients_match_jax(name, shape, factor):
    jcfg, params, moe, x = _setup(name, shape, factor)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    gp, gx = _jax_grads(params, jnp.asarray(x), jnp.asarray(w), jcfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    moe.requires_grad_(True)
    out, aux = moe(xt)
    names = [n for n, _ in moe.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [xt] + list(moe.parameters()))
    assert cases.rel(grads[0].numpy(), gx) <= TOL
    for n, g in zip(names, grads[1:]):
        want = gp
        for key in n.split("."):
            want = want[key]
        assert cases.rel(g.numpy(), want) <= TOL, n
