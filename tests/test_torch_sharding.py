"""The port's sharding rules (``repro_torch.dist.sharding``,
``repro_torch.launch.steps``) against the JAX package's.

The six cases of tests/test_dist_sharding.py, each also against the JAX
package's answer; then every leaf's spec, per dimension, for full-width
granite-3-2b and olmoe-1b-7b on the production meshes (16, 16) and
(2, 16, 16): the port's trees are built on the ``meta`` device (no
storage), the reference's by ``jax.eval_shape``, its rules run on a
``jax.sharding.AbstractMesh`` of the same sizes (no devices).  The three
kinds of ``shardings_for`` (train, prefill, decode) are compared on the
reference's own abstract inputs (``repro.launch.specs.input_specs``), laid
out as trees of ``meta`` tensors for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.dist import sharding as jshr
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.dist.sharding import (
    FSDP_AXES, MODEL_AXIS, P, _fit_entry, _rule_for, batch_specs, cache_specs,
    named, param_specs)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.training import train_loop as ttl
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ARCHS = ["granite-3-2b", "olmoe-1b-7b"]
MULTI_POD = [False, True]


@pytest.fixture(scope="module")
def mesh():
    """A live mesh of one rank (no process group: nothing to gather)."""
    return tmesh.Mesh({"data": 1, "model": 1}, rank=0)


def _jmesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _spec(s):
    """A sharding's spec as a plain tuple (either package's)."""
    return tuple(s.spec)


def test_fit_entry_drops_non_dividing_axes():
    sizes = {"pod": 2, "data": 16, "model": 16}
    cases = [(64, ("pod", "data"), sizes, ("pod", "data")),
             (48, ("pod", "data"), sizes, "data"),
             (7, ("pod", "data"), sizes, None),
             (48, ("pod", "data"), {"data": 16}, "data"),
             (100, None, sizes, None)]
    for dim, entry, sz, want in cases:
        assert _fit_entry(dim, entry, sz) == want
        assert jshr._fit_entry(dim, entry, sz) == want


def test_named_filters_and_truncates(mesh):
    jm = AbstractMesh((1, 1), ("data", "model"))
    for spec, shape, want in [((FSDP_AXES, MODEL_AXIS), (8, 4),
                               ("data", "model")),
                              ((FSDP_AXES, MODEL_AXIS), (8,), ("data",)),
                              ((), None, ()), ((("pod",),), None, (None,))]:
        assert _spec(named(mesh, P(*spec), shape)) == want
        assert _spec(jshr.named(jm, JP(*spec), shape)) == want


def test_rule_for_shapes():
    w, vec, scalar = (torch.zeros(s) for s in ((8, 4), (4,), ()))
    assert _rule_for(("mlp", "w_up"), w) == P(FSDP_AXES, MODEL_AXIS)
    assert _rule_for("['mlp']['w_up']", vec) == P()
    assert _rule_for("['mlp']['w_up']", scalar) == P()
    assert _rule_for("['embed']", w) == P()
    stacked = torch.zeros((3, 8, 4))
    assert _rule_for("['stack'][0]['w_up']", stacked) == P(
        None, FSDP_AXES, MODEL_AXIS)
    # a module's dotted parameter names count as their parts
    assert _rule_for("['blocks.0.mlp.w_up']", w) == P(FSDP_AXES, MODEL_AXIS)
    key = jax.tree_util
    jpath = (key.DictKey("stack"), key.SequenceKey(0), key.DictKey("w_up"))
    assert tuple(jshr._rule_for(jpath, jnp.zeros((3, 8, 4)))) == tuple(
        _rule_for("['stack'][0]['w_up']", stacked))


def test_param_specs_tree(mesh):
    params = {"embed": torch.zeros((16, 8)),
              "prefix": [{"norm": torch.zeros((8,)),
                          "w": torch.zeros((8, 8))}],
              "stack": [{"w_up": torch.zeros((2, 8, 8))}]}
    specs = param_specs(params, mesh)
    assert _spec(specs["embed"]) == ()
    assert _spec(specs["prefix"][0]["norm"]) == ()
    assert _spec(specs["prefix"][0]["w"]) == ("data", "model")
    assert _spec(specs["stack"][0]["w_up"]) == (None, "data", "model")
    # every sharding is usable: a block and back on the one-rank mesh
    for s, leaf in zip(tree_leaves(specs), tree_leaves(params)):
        assert s.shape == tuple(leaf.shape)
        assert s.gather(s.shard(leaf)) is leaf


def test_param_specs_serve_replicated(mesh):
    specs = param_specs({"w": torch.zeros((8, 8))}, mesh,
                        serve_replicated=True)
    assert _spec(specs["w"]) == (None, "model")


def test_batch_and_cache_specs(mesh):
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "labels": torch.zeros((4, 8), dtype=torch.int32)}
    assert _spec(batch_specs(batch, mesh)["tokens"]) == ("data",)
    caches = {"prefix": {0: torch.zeros((4, 8, 2, 2))},
              "stack": [torch.zeros((3, 4, 8, 2, 2))]}
    cs = cache_specs(caches, mesh)
    assert _spec(cs["prefix"][0]) == ("data",)
    assert _spec(cs["stack"][0]) == (None, "data")


def test_blocks_of_a_described_mesh():
    """On the (2, 16, 16) mesh a (4096, 2048) weight's block is
    (128, 128); the spec keeps ("pod", "data") on the rows."""
    m = tmesh.make_production_mesh(multi_pod=True)
    s = named(m, P(FSDP_AXES, MODEL_AXIS), (4096, 2048))
    assert s.spec == P(("pod", "data"), "model")
    assert s.block_shape() == (128, 128) and s.block_numel() == 128 * 128
    assert s.axes == ("pod", "data", "model")


def _meta(tree):
    """A JAX abstract tree as the same tree of ``meta`` tensors."""
    return jax.tree.map(lambda a: torch.empty(tuple(a.shape),
                                              device="meta"), tree)


def _compare(port_tree, jax_tree):
    got = tree_flatten_with_path(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert _spec(g) == _spec(w), (path, g, w)
    return len(got)


@pytest.mark.parametrize("multi_pod", MULTI_POD, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_specs_match_jax(arch, multi_pod):
    """Every leaf of the port's meta model's period-stacked tree against
    the reference's ``param_specs`` of ``jax.eval_shape(init_params)``;
    the per-layer parameters of the port's model (what the sharded step
    stores) take the stacked leaf's spec without its leading entry."""
    cfg = get_config(arch)
    tm, jm = tmesh.make_production_mesh(multi_pod=multi_pod), \
        _jmesh(multi_pod)
    with torch.device("meta"):
        model = TM.Model(cfg, generator=None, device="meta")
    tree = model.stack_for_training()
    jtree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                  jget_config(arch)))
    specs = param_specs(tree, tm)
    n = _compare(specs, jshr.param_specs(jtree, jm))
    assert n > 10
    assert sum(s.is_split for s in tree_leaves(specs)) > 5
    per_layer = param_specs(model, tm)
    plan = TM.make_layer_plan(cfg)
    for name, p in model.named_parameters():
        if not name.startswith("blocks."):
            continue
        layer, rest = name.split(".", 2)[1:]
        slot = (int(layer) - len(plan.prefix)) % len(plan.period)
        leaf = specs["stack"][slot]
        for key in rest.split("."):
            leaf = leaf[key]
        assert _spec(per_layer[name]) == _spec(leaf)[1:], name


@pytest.mark.parametrize("multi_pod", MULTI_POD, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_for_each_kind_match_jax(arch, multi_pod):
    """``shardings_for`` / ``out_shardings_for`` of train (state: params,
    AdamW/Adafactor state; batch), prefill (serve-replicated weights when
    they fit the budget; batch; caches) and decode on the reference's
    inputs for every shape of the config."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    tm, jm = tmesh.make_production_mesh(multi_pod=multi_pod), \
        _jmesh(multi_pod)
    assert tsteps._serve_replicated(cfg, tm) == jsteps._serve_replicated(
        jcfg, jm)
    kinds = set()
    for shape in jcfg.shapes:
        spec = jspecs.input_specs(jcfg, shape)
        kind, args = spec["kind"], spec["args"]
        kinds.add(kind)
        want = jsteps.shardings_for(kind, args, jm, jcfg)
        got = tsteps.shardings_for(kind, _meta(args), tm, cfg)
        _compare(got, want)
        out_got = tsteps.out_shardings_for(kind, _meta(args), tm, cfg)
        out_want = jsteps.out_shardings_for(kind, args, jm, jcfg)
        assert [x is None for x in out_got] == [x is None for x in out_want]
        _compare([x for x in out_got if x is not None],
                 [x for x in out_want if x is not None])
    assert kinds == {"train", "prefill", "decode"}


def test_state_shardings_of_the_ports_own_state():
    """``_state_shardings`` of the port's abstract train state (a model
    by parameter name, the optimizer state and residuals in the JAX
    layout): the optimizer and residual leaves take the reference's specs
    for the same paths and shapes; the step is replicated."""
    from repro.training import train_loop as jtl
    from repro_torch.configs import reduced_config
    cfg = reduced_config(get_config("granite-3-2b"))
    jcfg = jget_config("granite-3-2b")
    from repro.configs import reduced_config as jreduced
    jcfg = jreduced(jcfg)
    tc = ttl.TrainConfig(compress_grads=True)
    tm = tmesh.Mesh({"data": 4, "model": 2})
    jm = AbstractMesh((4, 2), ("data", "model"))
    sh = tsteps._state_shardings(ttl.abstract_train_state(cfg, tc), tm)
    jstate = jax.eval_shape(lambda: jtl.init_train_state(
        jax.random.PRNGKey(0), jcfg, jtl.TrainConfig(compress_grads=True)))
    want = jsteps._state_shardings(jstate, jm)
    _compare(sh.opt_state, want.opt_state)
    _compare(sh.ef_state, want.ef_state)
    assert _spec(sh.step) == ()
    assert sorted(sh.params) == sorted(
        n for n, _ in TM.Model(cfg, generator=None,
                               device="meta").named_parameters())
    assert np.prod(sh.params["blocks.0.mlp.w_up"].block_shape()) * 8 == \
        np.prod(sh.params["blocks.0.mlp.w_up"].shape)
