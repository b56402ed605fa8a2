"""Train-step factory: microbatched gradient accumulation, optional int8
error-feedback gradient compression, clipping, the optimizer, metrics.

The port of ``repro.training.train_loop``, in the reference's order:
split the batch into microbatches, accumulate each microbatch's gradients
in float32 and scale by 1/n, compress (with ``compress_grads``), clip,
``lr = schedule(step)``, update, ``step + 1``.

The state's model is :class:`TrainState.params`: an ``nn.Module``, which
the checkpoint stores as its parameters by name and restores into place
(:mod:`repro_torch.tree`).  The optimizer and the compression see the
JAX package's period-stacked leaves (:meth:`repro_torch.models.model.
Model.stack_for_training`), so their per-leaf decisions are the
reference's; the optimizer state and the residuals are trees in the JAX
package's layout, the checkpoint paths included.

``make_train_step(cfg, tc, mesh=mesh)`` is the same step over the ranks of
a :class:`repro_torch.launch.mesh.Mesh` (:class:`ShardedTrainStep`): each
rank holds only its block of every leaf of the model, the optimizer state
and the residuals under ``launch.steps._state_shardings`` (ZeRO-3), gathers
a block's weights on use and reduce-scatters their gradients, and the
ranks of ``"model"`` each compute their block of the heads, hidden units,
experts, Mamba channels and vocabulary; see its docstring for what runs
where.

A step updates its state in place (the reference donates nothing, but a
2.5e9-parameter model holds one copy of its state on the card), so the
state it was given is spent: stepping a spent state again by hand raises
:class:`SpentStateError` instead of training on from the advanced model.
:func:`repro_torch.training.fault_tolerance.run_resilient` keeps a replay
target the step cannot spend (a step-0 checkpoint, or a host copy).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.compression import (
    CompressionState, apply_error_feedback, init_compression_state)
from repro_torch.dist.sharding import (
    FSDP_AXES, MODEL_AXIS, P, compute_uses, fsdp_extent, gather_on_use,
    named, param_specs)
from repro_torch.models import model as model_mod
from repro_torch.models.common import set_mesh
from repro_torch.training.optimizer import (
    AdafactorState, AdamWState, OptimizerConfig, clip_by_global_norm,
    init_optimizer, make_schedule)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    num_microbatches: int = 1
    compress_grads: bool = False
    remat: bool = True

    @staticmethod
    def for_arch(arch: ArchConfig, **overrides) -> "TrainConfig":
        """Production defaults: Adafactor for >=100B-param archs."""
        big = arch.param_count() >= 100e9
        opt = OptimizerConfig(name="adafactor" if big else "adamw")
        base = TrainConfig(optimizer=opt)
        return dataclasses.replace(base, **overrides)


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the model's device
    params: Any  # the Model
    opt_state: Any
    ef_state: Optional[CompressionState]  # error-feedback residuals


def _state_of(model, tc: TrainConfig, device) -> TrainState:
    leaves = model.stack_for_training()
    ef = init_compression_state(leaves) if tc.compress_grads else None
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=model,
                      opt_state=init_optimizer(tc.optimizer).init(leaves),
                      ef_state=ef)


def init_train_state(cfg: ArchConfig, tc: TrainConfig, seed: int = 0, *,
                     device: str | torch.device | None = None,
                     mesh=None) -> TrainState:
    """A seeded model (``init_params``) with every parameter trainable,
    the optimizer's state and, with ``compress_grads``, zero residuals, on
    ``device`` (default: the CUDA card).  With ``mesh``, this rank's blocks
    of that state (:func:`shard_train_state`)."""
    dev = resolve_device(device)
    state = _state_of(model_mod.init_params(cfg, seed, device=dev), tc, dev)
    return state if mesh is None else shard_train_state(state, mesh)


def abstract_train_state(cfg: ArchConfig, tc: TrainConfig) -> TrainState:
    """The full train state's shapes and dtypes, on the ``meta`` device
    (no storage): what the sharding rules read."""
    with torch.device("meta"):
        model = model_mod.Model(cfg, generator=None, device="meta")
    return _state_of(model, tc, "meta")


def _tree_zip(fn, tree, other):
    return tree_unflatten(tree, [fn(a, b) for a, b in
                                 zip(tree_leaves(tree), tree_leaves(other))])


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """This rank's blocks of a full train state under
    ``launch.steps._state_shardings``: the model's parameters are replaced
    by their blocks (and re-stacked), every optimizer and residual leaf by
    its block; a leaf that nothing splits stays as it is."""
    from repro_torch.launch.steps import _state_shardings
    sh = _state_shardings(state, mesh)
    model = state.params
    if shard_parameters(model, sh.params):
        model.leaf_tree = model.leaf_members = None
        model.stack_for_training()

    def blocks(tree, shardings):
        return None if tree is None else _tree_zip(
            lambda t, s: s.shard(t), tree, shardings)

    ef = state.ef_state
    if ef is not None:
        ef = CompressionState(residuals=blocks(ef.residuals,
                                               sh.ef_state.residuals))
    return TrainState(step=state.step, params=model,
                      opt_state=type(state.opt_state)(*[
                          blocks(t, s) for t, s in zip(state.opt_state,
                                                       sh.opt_state)]),
                      ef_state=ef)


def shard_parameters(model, shardings: dict) -> bool:
    """Replace each of ``model``'s parameters by this rank's block of it
    under ``shardings`` (by parameter name); whether any was split."""
    named_params = list(model.named_parameters())
    if not any(shardings[n].is_split for n, _ in named_params):
        return False
    with torch.no_grad():
        for name, p in named_params:
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr, nn.Parameter(
                shardings[name].shard(p.detach()),
                requires_grad=p.requires_grad))
    return True


def local_rows(mesh, batch: dict):
    """(this rank's rows of ``batch`` over the FSDP axes, the axes that
    split them); a row count they do not divide is replicated, as
    ``named`` decides."""
    rows = next(iter(batch.values())).shape[0]
    sh = named(mesh, P(FSDP_AXES), (rows,))
    if not sh.is_split:
        return batch, ()
    rows_slice = sh.block_slices()[0]
    return {k: v[rows_slice] for k, v in batch.items()}, sh.axes


def train_state_from_arrays(state, cfg: ArchConfig, tc: TrainConfig, *,
                            device: str | torch.device | None = None
                            ) -> TrainState:
    """The port's train state from a JAX ``TrainState`` whose leaves are
    numpy arrays: the parameters (``params_from_arrays``), the optimizer
    state and the residuals (same trees: the port keeps the JAX layout)
    and the step."""
    dev = resolve_device(device)
    model = model_mod.params_from_arrays(state.params, cfg, device=dev)
    model.stack_for_training()

    def tensors(tree):
        return tree_map(lambda a: model_mod._tensor(a).to(dev), tree)

    state_type = {"adamw": AdamWState,
                  "adafactor": AdafactorState}[tc.optimizer.name]
    opt_state = state_type(*[tensors(getattr(state.opt_state, f))
                             for f in state_type._fields])
    ef = None
    if tc.compress_grads:
        ef = CompressionState(residuals=tensors(state.ef_state.residuals))
    return TrainState(step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=dev),
                      params=model, opt_state=opt_state, ef_state=ef)


class SpentStateError(RuntimeError):
    """A train state that a step has already advanced in place."""


def _split_microbatches(batch: dict, n: int) -> list:
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


class TrainStep:
    """``make_train_step``'s step: ``step(state, batch) -> (state,
    metrics)``, with the gradient pass on its own as :meth:`gradients`."""

    # the sharded step's: the stacked leaves' and the state's shardings
    leaf_shardings = state_shardings = None

    def __init__(self, cfg: ArchConfig, tc: TrainConfig):
        self.cfg, self.tc = cfg, tc
        self.opt = init_optimizer(tc.optimizer)
        self.schedule = make_schedule(tc.optimizer)

    def gradients(self, model, batch: dict):
        """(loss, metrics, grads): the batch's loss and its gradients as
        float32 trees of the JAX package's leaves, accumulated over the
        microbatches in float32 and scaled by 1/n (one accumulator: each
        microbatch's gradients are added into it as autograd returns
        them, never summed by autograd in the parameters' dtype)."""
        leaves = model.stack_for_training()
        members = model.leaf_members
        flat = [p for group in members for p in group]
        acc, stacked = [], []
        for leaf, group in zip(tree_leaves(leaves), members):
            acc.append(torch.zeros(leaf.shape, dtype=torch.float32,
                                   device=leaf.device))
            stacked.append(group[0] is not leaf)
        n = self.tc.num_microbatches
        micro = [batch] if n == 1 else _split_microbatches(batch, n)
        loss_sum = None
        for mb in micro:
            with torch.enable_grad():
                loss, metrics, grads = self._microbatch(model, mb, flat)
                grads = iter(grads)
            with torch.no_grad():
                for a, layers in zip(acc, stacked):
                    for row in (a if layers else (a,)):
                        row.add_(next(grads))
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del grads
        if n > 1:
            torch._foreach_mul_(acc, 1.0 / n)
            loss = loss_sum * (1.0 / n)
            metrics = {"loss": loss}
        else:
            metrics = {k: v.detach() for k, v in metrics.items()}
        return loss, metrics, tree_unflatten(leaves, acc)

    def _microbatch(self, model, mb: dict, flat: list):
        """(loss, metrics, gradients of ``flat``) of one microbatch."""
        loss, metrics = model.forward_train(mb, remat=self.tc.remat)
        return loss, metrics, torch.autograd.grad(loss, flat)

    def __call__(self, state: TrainState, batch: dict):
        model = state.params
        loss, metrics, grads = self.gradients(model, batch)
        ef_state = state.ef_state
        sh = self.leaf_shardings
        if self.tc.compress_grads:
            grads, ef_state = apply_error_feedback(grads, ef_state,
                                                   shardings=sh)
        grads, gnorm = clip_by_global_norm(grads, self.tc.optimizer.clip_norm,
                                           shardings=sh)
        lr = self.schedule(state.step)
        _spend(state)
        _, opt_state = self.opt.update(
            grads, state.opt_state, model.stack_for_training(), lr,
            state.step, shardings=None if sh is None else (
                sh, self.state_shardings.opt_state))
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, loss=loss)
        return TrainState(step=state.step + 1, params=model,
                          opt_state=opt_state, ef_state=ef_state), metrics


def _spend(state: TrainState) -> None:
    """Mark ``state`` spent before its model is updated in place, raising
    if it already is.  A state is known by its step tensor, which every
    step, init and restore makes anew; the marks are kept on the model."""
    model = state.params
    spent = getattr(model, "_spent_steps", None)
    if spent is None:
        spent = model._spent_steps = weakref.WeakSet()
    if state.step in spent:
        raise SpentStateError(
            "this train state was already advanced by a step, which "
            "updates the model and the optimizer state in place; start "
            "again from a checkpoint or a fresh init_train_state")
    spent.add(state.step)


class _Call(nn.Module):
    """A model's method as a module's forward, so that ``functional_call``
    can run it on gathered top-level weights."""

    def __init__(self, model, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def _in_block(name: str) -> bool:
    """A parameter of a residual block (a layer's or an MTP depth's)."""
    return name.startswith("blocks.") or ".block." in name


def sharded_call(model, mesh, batch_axes: tuple, shardings: dict,
                 uses: dict, method: str, *args, **kwargs):
    """``model.<method>(*args, **kwargs)`` on the weights this rank
    computes with, under ``set_mesh(mesh, batch_axes, "model")``: the
    model holds its storage blocks (``shardings``, by parameter name), and
    each block's weights are gathered on use (:func:`repro_torch.dist.
    sharding.gather_on_use`, their compute ``uses``) inside the block's
    call (its remat boundary, when the method asks for one), the
    top-level weights once around the call.  The one body of the sharded
    train step's forward and of the sharded serving steps."""
    params = dict(model.named_parameters())
    shard_of = {id(p): shardings[n] for n, p in params.items()}
    use_of = {id(p): uses[n] for n, p in params.items()}

    def layouts(tensors):
        return ([shard_of[id(t)] for t in tensors],
                [use_of[id(t)] for t in tensors])

    def block_call(block, x, positions, remat=False, **kw):
        names, blocks = zip(*block.named_parameters())
        block_shardings, block_uses = layouts(blocks)

        def run(x, positions, *blocks):
            with set_mesh(mesh, batch_axes, MODEL_AXIS):
                full = dict(zip(names, gather_on_use(blocks, block_shardings,
                                                     block_uses)))
                return functional_call(block, full, (x, positions), kw)

        if remat and torch.is_grad_enabled():
            return checkpoint(run, x, positions, *blocks,
                              use_reentrant=False)
        return run(x, positions, *blocks)

    names, tops = zip(*[(name, p) for name, p in params.items()
                        if not _in_block(name)])
    top = {"model." + name: full for name, full in zip(
        names, gather_on_use(tops, *layouts(tops)))}
    model.block_call = block_call
    try:
        with set_mesh(mesh, batch_axes, MODEL_AXIS):
            return functional_call(_Call(model, method), top, args, kwargs)
    finally:
        model.block_call = None


class ShardedTrainStep(TrainStep):
    """The train step over the ranks of ``mesh`` (``torch.distributed``),
    with the single-device step's results up to the order of sums.

    * **State.** Each rank holds its block of every leaf of the model, the
      optimizer state and the residuals under ``_state_shardings``
      (:func:`shard_train_state`): the last two dims of a matrix leaf over
      (FSDP axes, ``"model"``), vectors, scalars and ``embed`` replicated.
    * **Batch.** Split into microbatches first, then each microbatch's rows
      over the FSDP axes (``batch_specs``; a row count they do not divide
      replicates, as ``_fit_entry`` decides).
    * **Forward and backward (ZeRO-3).** A block's weights are gathered on
      use over the FSDP axes (:func:`repro_torch.dist.sharding.
      gather_on_use`: one collective for the weights that split alike),
      inside the block's remat boundary, so the recompute gathers them
      again and the gathered weights live for one block.  Every rank
      computes the batch's loss (its sums and counts summed over the ranks
      of the batch, as the MoE's load-balancing means are) and
      back-propagates it divided by the FSDP extent; a weight's gradient
      is reduce-scattered (summed) over the FSDP axes.  Replicated leaves'
      gradients are all-reduced, so their updates are bitwise equal on
      every rank.
    * **Compute over ``"model"``.** The ranks of ``"model"`` hold the same
      rows, and each computes its block (``compute_uses``, the twin of the
      reference's activation constraints): the attention's q heads and the
      kv heads they read, the MLP's hidden units, the MoE's experts (the
      routing replicated), Mamba's heads and inner channels, and the
      vocabulary's logits and cross entropy.  A column-parallel weight
      keeps its stored ``"model"`` block; a row-parallel weight and the
      experts trade theirs for the compute block in one all_to_all; a
      block's replicated input enters through ``model_copy`` (its
      gradient all-reduced) and its partial output leaves through
      ``model_sum`` (all-reduced).  The rest (norms, the router, MLA, the
      embedding lookup) is computed whole on every rank, with the same
      gradient, which each rank slices to its block.  On a ``"model"``
      axis of one rank this is the storage-only step, operation for
      operation.
    * **Update.** The global norm sums each leaf's squares over the axes
      that split its storage; Adafactor factors by the full leaf's shape
      and reduces its moments over the axes that split their dims; error
      feedback takes each 256-element block's scale as the max over the
      ranks that hold its parts (``Mesh.pmax``), so compression equals
      the unsharded one.
    """

    def __init__(self, cfg: ArchConfig, tc: TrainConfig, mesh):
        super().__init__(cfg, tc)
        from repro_torch.launch.steps import _state_shardings
        self.mesh = mesh
        abstract = abstract_train_state(cfg, tc)
        self.state_shardings = _state_shardings(abstract, mesh)
        self.leaf_shardings = param_specs(
            abstract.params.stack_for_training(), mesh)
        self.uses = compute_uses(abstract.params, self.state_shardings.params,
                                 cfg)
        self.fsdp = fsdp_extent(mesh)

    def shard_batch(self, mb: dict):
        """(this rank's rows of ``mb``, the axes that split them)."""
        return local_rows(self.mesh, mb)

    def forward(self, model, mb: dict):
        """(loss, metrics) of this rank's rows of microbatch ``mb``: the
        batch's loss, every block run on the weights it computes with."""
        local, axes = self.shard_batch(mb)
        return sharded_call(model, self.mesh, axes,
                            self.state_shardings.params, self.uses,
                            "forward_train", local, remat=self.tc.remat)

    def _microbatch(self, model, mb: dict, flat: list):
        loss, metrics = self.forward(model, mb)
        scaled = loss / self.fsdp if self.fsdp > 1 else loss
        return loss, metrics, torch.autograd.grad(scaled, flat)


def make_train_step(cfg: ArchConfig, tc: TrainConfig, mesh=None
                    ) -> TrainStep:
    """The train step; with ``mesh``, the sharded step over its ranks
    (:class:`ShardedTrainStep`), whose state comes from
    ``init_train_state(..., mesh=mesh)`` or :func:`shard_train_state`."""
    return TrainStep(cfg, tc) if mesh is None else ShardedTrainStep(
        cfg, tc, mesh)
