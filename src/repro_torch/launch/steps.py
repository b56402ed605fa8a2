"""The step functions of a cell, and their sharding assignments.

The port of ``repro.launch.steps``.  ``make_step_fn`` gives the train,
prefill and decode steps; ``shardings_for`` / ``out_shardings_for`` the
trees of :class:`repro_torch.dist.sharding.NamedSharding` over their
arguments and results.  Only the train step runs sharded
(:class:`repro_torch.training.train_loop.ShardedTrainStep`, which reads
:func:`_state_shardings`); the prefill and decode shardings are the
reference's assignments as trees (its dry-run lowers them), and the port's
serving runs on one device.  ``lower_cell`` has no twin here.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as shr
from repro_torch.dist.sharding import P
from repro_torch.training.train_loop import (
    TrainConfig, TrainState, make_train_step)


def make_step_fn(cfg: ArchConfig, kind: str, tc: TrainConfig, mesh=None):
    """The function a cell runs: ``train_step(state, batch)`` (sharded over
    ``mesh``'s ranks when one is given), ``prefill_step(model, batch,
    caches)`` or ``serve_step(model, token, pos, caches)``."""
    if kind == "train":
        return make_train_step(cfg, tc, mesh=mesh)

    if kind == "prefill":
        def prefill_step(model, batch, caches):
            return model.forward_prefill(batch, caches)
        return prefill_step

    if kind == "decode":
        def serve_step(model, token, pos, caches):
            return model.forward_decode(token, pos, caches)
        return serve_step

    raise ValueError(kind)


def _state_shardings(state, mesh) -> TrainState:
    """TrainState shardings: the parameter rules over the parameters (a
    model: by parameter name), the optimizer state and the residuals, each
    leaf by its own path and full shape (``state`` holds full leaves, e.g.
    :func:`repro_torch.training.train_loop.abstract_train_state`)."""
    ef = None
    if state.ef_state is not None:
        ef = shr.tree_specs(state.ef_state, mesh)
    return TrainState(step=shr.named(mesh, P(), ()),
                      params=shr.param_specs(state.params, mesh),
                      opt_state=shr.tree_specs(state.opt_state, mesh),
                      ef_state=ef)


HBM_SERVE_BUDGET = 8e9  # bytes/device available for TP-resident weights


def _serve_replicated(cfg: ArchConfig, mesh) -> bool:
    """True when bf16 weights / model-axis fit the serving HBM budget;
    then serving drops FSDP weight sharding (no per-step weight gathers)."""
    model_ways = mesh.shape.get("model", 1)
    return cfg.param_count() * 2 / model_ways <= HBM_SERVE_BUDGET


def shardings_for(kind: str, args: tuple, mesh, cfg: ArchConfig | None = None):
    """The shardings of a step's arguments: ``(state, batch)`` for train,
    ``(params, batch, caches)`` for prefill, ``(params, token, pos,
    caches)`` for decode."""
    if kind == "train":
        state, batch = args
        return (_state_shardings(state, mesh), shr.batch_specs(batch, mesh))
    rep = cfg is not None and _serve_replicated(cfg, mesh)
    if kind == "prefill":
        params, batch, caches = args
        return (shr.param_specs(params, mesh, serve_replicated=rep),
                shr.batch_specs(batch, mesh),
                shr.cache_specs(caches, mesh))
    if kind == "decode":
        params, token, pos, caches = args
        return (shr.param_specs(params, mesh, serve_replicated=rep),
                shr.named(mesh, P(shr.FSDP_AXES), tuple(token.shape)),
                shr.named(mesh, P(shr.FSDP_AXES), tuple(pos.shape)),
                shr.cache_specs(caches, mesh))
    raise ValueError(kind)


def out_shardings_for(kind: str, args: tuple, mesh,
                      cfg: ArchConfig | None = None):
    """The shardings of a step's results: (new state, metrics) for train,
    (logits, caches) for prefill and decode; None is unconstrained."""
    ins = shardings_for(kind, args, mesh, cfg)
    if kind == "train":
        return (ins[0], None)
    if kind == "prefill":
        return (None, ins[2])
    if kind == "decode":
        return (None, ins[3])
    raise ValueError(kind)
