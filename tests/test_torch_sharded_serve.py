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
rank.  Where "model" does not divide a part's units, each rank serves its
ceil block of them: at (1, 4), granite with 6 heads over 2 kv heads
(blocks 2, 2, 2, 0; rank 1's crosses a kv group), olmoe-1b-7b with 6
experts and mamba2-1.3b with 6 heads (d_model 48), each by
``dataclasses.replace`` in both packages.  One ``RankPool`` of four ranks,
one torch thread each; the rank side is ``tests/_torch_serve_cases.py``.
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
# uneven splits at (1, 4): (arch, token_groups, fields replaced in both
# packages' reduced configs)
UNEVEN = [("granite-3-2b", None, (("num_heads", 6), ("num_kv_heads", 2))),
          ("olmoe-1b-7b", 1, (("moe.num_experts", 6),)),
          ("mamba2-1.3b", None, (("d_model", 48),))]


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


def _jax_steps(arch, token_groups, tree, prompt, tokens, over=()):
    """The JAX package's single-device prefill and decode steps' logits."""
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch),
                                   global_batch=ROWS)
    if token_groups is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, token_groups=token_groups))
    jcfg = C.replace_fields(jcfg, over)
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


def _check_serving(pool, arch, shape, groups, over=()):
    cfg = C.config(arch, ROWS, groups, over)
    tree = tree_map(lambda t: t.detach().numpy().copy(),
                    TM.init_params(cfg, 3, device="cpu")
                    .stack_for_training())
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (ROWS, PROMPT), dtype=np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (ROWS, DECODES),
                          dtype=np.int32)
    outs = pool.run(C.serve, arch, shape, tree, prompt, tokens, MAX_SEQ,
                    groups, over)
    want = _jax_steps(arch, groups, tree, prompt, tokens, over)
    scale = np.abs(want).max()
    for out in outs:
        got = out["logits"]
        assert got.shape == want.shape == (DECODES + 1, ROWS, 1,
                                           cfg.vocab_size)
        err = np.abs(got - want).max() / scale
        assert err <= SERVE_TOL, (out["rank"], err)
        assert np.array_equal(got, outs[0]["logits"]), out["rank"]


@pytest.mark.parametrize("arch,shape,groups", CASES)
def test_sharded_serving_matches_jax_single_device(pool, arch, shape,
                                                   groups):
    _check_serving(pool, arch, shape, groups)


@pytest.mark.parametrize("arch,groups,over", UNEVEN,
                         ids=lambda v: str(v).replace(" ", ""))
def test_uneven_sharded_serving_matches_jax_single_device(pool, arch, groups,
                                                          over):
    """Prefill and decode with each rank's ceil block of the heads or
    experts (weights stored in that block: ``compute_layout``); a rank
    with an empty block still joins every collective."""
    _check_serving(pool, arch, (1, 4), groups, over)
