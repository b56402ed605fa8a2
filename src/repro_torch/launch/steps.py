"""The step functions of a cell, their sharding assignments, and the
dry run's trace of one rank's step.

The port of ``repro.launch.steps``.  ``make_step_fn`` gives the train,
prefill and decode steps, sharded over a mesh's ranks when one is given
(:class:`repro_torch.training.train_loop.ShardedTrainStep`, which reads
:func:`_state_shardings`, and :class:`ShardedServeStep`);
``shardings_for`` / ``out_shardings_for`` the trees of
:class:`repro_torch.dist.sharding.NamedSharding` over their arguments and
results.  :func:`trace_cell`, the twin of the reference's ``lower_cell``,
runs one of those steps once as one rank of a described mesh, on the
``meta`` device, and counts what that rank would do.
"""

from __future__ import annotations

import time

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist import sharding as shr
from repro_torch.dist.sharding import P
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import whole_parts
from repro_torch.training.train_loop import (
    TrainConfig, TrainState, local_rows, make_train_step, shard_parameters,
    shard_train_state, sharded_call)
from repro_torch.tree import tree_leaves


class ShardedServeStep:
    """Prefill and decode over the ranks of ``mesh``.

    * **Weights.** Each rank holds its block of every parameter under
      ``param_specs(..., serve_replicated=_serve_replicated(cfg, mesh))``
      (``"model"`` on a matrix's last dim, and the FSDP axes on the one
      before unless bf16 weights over ``"model"`` fit the serving budget),
      stored once in its compute layout (``sharding.compute_layout``: a
      weight the training step swaps over ``"model"`` on every use has its
      two dims' axes exchanged; :meth:`shard`).  A block's weights are
      gathered on use as the train step's are (``sharded_call``), over the
      FSDP axes, and over ``"model"`` only for a part that computes
      whole.  A part whose heads or experts ``"model"`` does not divide
      stores each rank's ceil block of them (``NamedSharding.ceil``).
      These are not ``shardings_for``'s assignments, the reference's,
      under which GSPMD would reshard the weights every step.
    * **Rows.** The batch's rows split over the FSDP axes (``batch_specs``,
      ``local_rows``); the caches are this rank's blocks under
      ``cache_specs``: its rows, every head and position.
    * **Compute over ``"model"``.** Prefill splits heads, hidden units,
      experts and Mamba heads in ceil blocks as the training forward
      does; each rank writes every kv head into its cache.  Decode splits
      the attention's cache positions (the reference's constraint) and
      otherwise the training forward's blocks.  MLA and NFFT attention
      compute whole.
    * **Results.** Every rank ends with the whole last-position logits of
      the whole batch (the vocabulary blocks and the row blocks
      all-gathered) and its own caches, updated in place.
    """

    def __init__(self, cfg: ArchConfig, mesh):
        from repro_torch.launch.specs import abstract_params
        self.cfg, self.mesh = cfg, mesh
        self.replicated = _serve_replicated(cfg, mesh)
        abstract = abstract_params(cfg)
        self.shardings = shr.compute_layout(abstract, shr.param_specs(
            abstract, mesh, serve_replicated=self.replicated), cfg)
        self.uses = shr.compute_uses(abstract, self.shardings, cfg)

    def shard(self, model):
        """``model`` holding this rank's blocks of its parameters (in
        place)."""
        shard_parameters(model, self.shardings)
        return model

    def shard_caches(self, caches: list) -> list:
        """This rank's blocks of whole-batch caches (``cache_specs``)."""
        specs = shr.cache_specs(caches, self.mesh)
        return [type(c)(*[s.shard(t) for t, s in zip(c, cs)])
                for c, cs in zip(caches, specs)]

    def _whole_rows(self, logits, axes):
        return self.mesh.all_gather(logits, axes, 0) if axes else logits

    def _use_flash(self, device, use_flash):
        """``use_flash`` None: the flash kernel on the card, and on the
        meta device, which stands for it."""
        if use_flash is None:
            return device.type in ("cuda", "meta")
        return use_flash

    @torch.no_grad()
    def prefill(self, model, batch: dict, caches: list, *,
                use_flash: bool | None = None):
        """(last-position logits (b, 1, V), caches) of the whole ``batch``;
        ``caches``: this rank's blocks, filled in place.  ``use_flash``
        None: the flash kernel on the card (and in a ``meta`` trace)."""
        local, axes = local_rows(self.mesh, batch)
        flash = self._use_flash(next(iter(batch.values())).device, use_flash)
        logits, caches = sharded_call(
            model, self.mesh, axes, self.shardings, self.uses,
            "forward_prefill", local, caches, use_flash=flash)
        return self._whole_rows(logits, axes), caches

    @torch.no_grad()
    def decode(self, model, token, pos, caches: list):
        """(logits (b, 1, V), caches) of one decode step of the whole batch
        (token (b, 1), pos (b,)); ``caches``: this rank's blocks."""
        local, axes = local_rows(self.mesh, {"token": token, "pos": pos})
        logits, caches = sharded_call(
            model, self.mesh, axes, self.shardings, self.uses,
            "forward_decode", local["token"], local["pos"], caches)
        return self._whole_rows(logits, axes), caches


def make_step_fn(cfg: ArchConfig, kind: str, tc: TrainConfig, mesh=None):
    """The function a cell runs: ``train_step(state, batch)``,
    ``prefill_step(model, batch, caches)`` or ``serve_step(model, token,
    pos, caches)``; over ``mesh``'s ranks when one is given (the state,
    the model and the caches this rank's blocks: ``ShardedTrainStep``,
    :class:`ShardedServeStep`)."""
    if kind == "train":
        return make_train_step(cfg, tc, mesh=mesh)
    serve = None if mesh is None else ShardedServeStep(cfg, mesh)

    if kind == "prefill":
        def prefill_step(model, batch, caches, use_flash=None):
            if serve is not None:
                return serve.prefill(model, batch, caches,
                                     use_flash=use_flash)
            return model.forward_prefill(batch, caches, use_flash=use_flash)
        prefill_step.serve = serve
        return prefill_step

    if kind == "decode":
        def serve_step(model, token, pos, caches):
            if serve is not None:
                return serve.decode(model, token, pos, caches)
            return model.forward_decode(token, pos, caches)
        serve_step.serve = serve
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


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[StorageWeakRef(s).cdata] = s.nbytes()
    return sum(seen.values())


def rank_args(kind: str, args: tuple, mesh, step):
    """This rank's blocks of a cell's whole ``meta`` arguments
    (``launch.specs.input_specs``) for ``step`` (``make_step_fn`` over
    ``mesh``): the train state's blocks and the whole batch, which the
    step splits; the model's blocks, the whole batch (or token and
    positions) and the caches' blocks."""
    if kind == "train":
        state, batch = args
        return shard_train_state(state, mesh), batch
    model, *rest = args
    step.serve.shard(model)
    return (model, *rest[:-1], step.serve.shard_caches(rest[-1]))


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *, rank: int = 0,
               tc: TrainConfig | None = None,
               use_flash: bool | None = None) -> dict:
    """The step of one (arch x shape) cell run once as rank ``rank`` of
    ``mesh``'s shape (a described mesh: no process group), on ``meta``
    tensors: nothing is allocated or computed.  Counted meanwhile
    (:func:`trace_call`): the aten ops' FLOPs, their HBM bytes and the
    peak of live bytes, the kernels' launches and ``work``, and the mesh's
    collectives.

    Returns :func:`trace_call`'s record ("stats", "memory", "mesh": the
    described rank, with its ``traffic`` and ``traffic_axes``) and
    "kind", "trace_s", "replicated" (prefill and decode:
    ``_serve_replicated``), "whole_parts" (``models.common.whole_parts``:
    the parts every rank computes whole, MLA and NFFT attention, whose
    counts overstate a split's work; every other part counts the rank's
    ceil block).
    ``use_flash`` (prefill): None takes the flash kernel, as the card
    does."""
    from repro_torch.launch.specs import input_specs
    tc = tc or TrainConfig.for_arch(cfg)
    t0 = time.perf_counter()
    rank_mesh = Mesh(mesh.shape, rank=rank, described=True)
    spec = input_specs(cfg, shape, tc=tc)
    kind = spec["kind"]
    step = make_step_fn(cfg, kind, tc, mesh=rank_mesh)
    args = rank_args(kind, spec["args"], rank_mesh, step)
    kw = {"use_flash": use_flash} if kind == "prefill" else {}
    out = trace_call(rank_mesh, step, *args, **kw)
    out.update(kind=kind, trace_s=time.perf_counter() - t0,
               replicated=None if kind == "train" else step.serve.replicated,
               whole_parts=whole_parts(cfg, rank_mesh.shape.get("model", 1)))
    return out


def trace_call(mesh, fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` once on ``meta`` arguments, counted
    (:class:`repro_torch.launch.roofline.TraceCounter`): the aten ops'
    FLOPs (``FlopCounterMode``'s registry), their HBM bytes and the peak
    of live bytes (the arguments' storages held throughout), the kernels'
    launches and ``work``, and the collectives of ``mesh`` (a described
    rank).
    Returns {"stats": TraceStats, "memory": {argument, output and peak
    live bytes}, "mesh": mesh, "collectives": the mesh's record of each
    collective}."""
    arg_bytes = _storage_bytes((args, kwargs))
    records = mesh.log = []
    try:
        with rl.TraceCounter(base=arg_bytes) as counter:
            out = fn(*args, **kwargs)
    finally:
        mesh.log = None
    stats = rl.TraceStats(
        flops=counter.flops + counter.kernel_flops,
        matmul_flops=counter.flops,
        hbm_bytes=counter.hbm_bytes + counter.kernel_bytes,
        kernels=counter.kernels, **rl.collective_stats(records))
    return {"stats": stats, "mesh": mesh, "collectives": records,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": _storage_bytes(out),
                       "peak_bytes": counter.peak}}
