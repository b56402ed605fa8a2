"""Reduced LM architectures on both packages' sides, for the port's tests.

``carried(name, seed)`` draws the weights with the port's ``init_params``
(a torch generator: the JAX package's own ``init_params`` takes 8 s per
reduced DeepSeek or Jamba model on the CPU), lays them out as the JAX
package's parameter tree (``Model.stack_for_training``), checks that tree's
paths, shapes and dtypes against ``jax.eval_shape`` of the JAX package's
``init_params``, and builds the port's model from the numpy tree with
``params_from_arrays``.  ``jax_fns(name)`` jits the JAX package's three
entry points once per worker.  Both are cached: tests must not change the
weights they get (train a fresh ``params_from_arrays`` model instead).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.tree import tree_flatten_with_path, tree_map


def configs(name: str):
    return (jconfigs.reduced_config(jconfigs.get_config(name)),
            tconfigs.reduced_config(tconfigs.get_config(name)))


def port_tree(model: TM.Model) -> dict:
    """The port's weights as the JAX package's tree of numpy arrays."""
    return tree_map(lambda t: t.detach().numpy().copy(),
                    model.stack_for_training())


def assert_tree_is_jax_init(tree: dict, jcfg) -> None:
    """Same paths, shapes and dtypes as ``repro.models.model.init_params``'
    output (traced only, nothing computed)."""
    want = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = tree_flatten_with_path(tree)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype), path


@functools.lru_cache(maxsize=None)
def carried(name: str, seed: int = 1):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights."""
    jcfg, tcfg = configs(name)
    tree = port_tree(TM.init_params(tcfg, seed, device="cpu"))
    assert_tree_is_jax_init(tree, jcfg)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            TM.params_from_arrays(tree, tcfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def jax_fns(name: str):
    """The JAX package's forward_prefill (params, batch, caches),
    forward_decode (params, token, pos, caches) and forward_train
    (params, batch), jitted for the reduced config."""
    jcfg, _ = configs(name)
    return SimpleNamespace(
        prefill=jax.jit(lambda p, b, c: JM.forward_prefill(p, jcfg, b, c)),
        decode=jax.jit(lambda p, t, pos, c: JM.forward_decode(p, jcfg, t,
                                                              pos, c)),
        train=jax.jit(lambda p, b: JM.forward_train(p, jcfg, b)))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))
