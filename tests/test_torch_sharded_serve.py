"""The port's sharded prefill and decode (``launch.steps.ShardedServeStep``)
on four gloo ranks on the CPU, against the JAX package's single-device
``forward_prefill`` and ``forward_decode``.

The JAX package serves under a mesh only in its dry run's lowerings; the
port's steps run.  Reduced granite-3-2b (GQA, one kv head) at (2, 2) and
(1, 4), reduced olmoe-1b-7b (8 experts, 2 a rank; one token group on both
sides) and reduced mamba2-1.3b (2 of 8 heads a rank) at (1, 4), float32:
a prefill of 4 rows x 32 tokens and 4 decode steps on fixed tokens, from
one set of weights (drawn with the port's ``init_params``, laid out as the
JAX tree).  Every rank's logits of every step are within ``SERVE_TOL`` of
the largest JAX logit from the JAX package's, and bitwise equal on every
rank.  One ``RankPool`` of four ranks, one torch thread each; the rank
side is ``tests/_torch_serve_cases.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_cases as C
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch.launch.ranks import RankPool
from repro_torch.models import model as TM
from repro_torch.tree import tree_map

SERVE_TOL = 1e-5
ROWS, PROMPT, DECODES, MAX_SEQ = 4, 32, 4, 64
# (arch, mesh, token_groups)
CASES = [("granite-3-2b", (2, 2), None), ("granite-3-2b", (1, 4), None),
         ("olmoe-1b-7b", (1, 4), 1), ("mamba2-1.3b", (1, 4), None)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "gloo", "cpu", threads=1) as ranks:
        yield ranks


def _jax_steps(arch, token_groups, tree, prompt, tokens):
    """The JAX package's single-device prefill and decode steps' logits."""
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch),
                                   global_batch=ROWS)
    if token_groups is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, token_groups=token_groups))
    params = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(lambda p, b, c: JM.forward_prefill(p, jcfg, b, c))
    decode = jax.jit(lambda p, t, pos, c: JM.forward_decode(p, jcfg, t, pos,
                                                            c))
    caches = JM.init_caches(jcfg, ROWS, MAX_SEQ)
    logits, caches = prefill(params, {"tokens": jnp.asarray(prompt)}, caches)
    out = [np.asarray(logits)]
    for i in range(tokens.shape[1]):
        pos = jnp.full((ROWS,), PROMPT + i, jnp.int32)
        logits, caches = decode(params, jnp.asarray(tokens[:, i:i + 1]), pos,
                                caches)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("arch,shape,groups", CASES)
def test_sharded_serving_matches_jax_single_device(pool, arch, shape,
                                                   groups):
    cfg = C.config(arch, ROWS, groups)
    tree = tree_map(lambda t: t.detach().numpy().copy(),
                    TM.init_params(cfg, 3, device="cpu")
                    .stack_for_training())
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (ROWS, PROMPT), dtype=np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (ROWS, DECODES),
                          dtype=np.int32)
    outs = pool.run(C.serve, arch, shape, tree, prompt, tokens, MAX_SEQ,
                    groups)
    want = _jax_steps(arch, groups, tree, prompt, tokens)
    scale = np.abs(want).max()
    for out in outs:
        got = out["logits"]
        assert got.shape == want.shape == (DECODES + 1, ROWS, 1,
                                           cfg.vocab_size)
        err = np.abs(got - want).max() / scale
        assert err <= SERVE_TOL, (out["rank"], err)
        assert np.array_equal(got, outs[0]["logits"]), out["rank"]
