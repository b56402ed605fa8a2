"""Train-step factory: microbatched gradient accumulation, optional int8
error-feedback gradient compression, clipping, the optimizer, metrics.

The port of ``repro.training.train_loop`` for one device, in the
reference's order: split the batch into microbatches, accumulate each
microbatch's gradients in float32 and scale by 1/n, compress (with
``compress_grads``), clip, ``lr = schedule(step)``, update, ``step + 1``.

The state's model is :class:`TrainState.params`: an ``nn.Module``, which
the checkpoint stores as its parameters by name and restores into place
(:mod:`repro_torch.tree`).  The optimizer and the compression see the
JAX package's period-stacked leaves (:meth:`repro_torch.models.model.
Model.stack_for_training`), so their per-leaf decisions are the
reference's; the optimizer state and the residuals are trees in the JAX
package's layout, the checkpoint paths included.

A step updates its state in place (the reference donates nothing, but a
2.5e9-parameter model holds one copy of its state on the card), so the
state it was given is spent: stepping a spent state again (a replay from
an initial state that is no longer initial) raises :class:`SpentStateError`
instead of training on from the advanced model.  A caller that needs the
state from before a step keeps its own copy, or restores a checkpoint.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.compression import (
    CompressionState, apply_error_feedback, init_compression_state)
from repro_torch.models import model as model_mod
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


def init_train_state(cfg: ArchConfig, tc: TrainConfig, seed: int = 0, *,
                     device: str | torch.device | None = None) -> TrainState:
    """A seeded model (``init_params``) with every parameter trainable,
    the optimizer's state and, with ``compress_grads``, zero residuals, on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    model = model_mod.init_params(cfg, seed, device=dev)
    leaves = model.stack_for_training()
    ef = init_compression_state(leaves) if tc.compress_grads else None
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=model,
                      opt_state=init_optimizer(tc.optimizer).init(leaves),
                      ef_state=ef)


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
                loss, metrics = model.forward_train(mb, remat=self.tc.remat)
                grads = iter(torch.autograd.grad(loss, flat))
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

    def __call__(self, state: TrainState, batch: dict):
        model = state.params
        loss, metrics, grads = self.gradients(model, batch)
        ef_state = state.ef_state
        if self.tc.compress_grads:
            grads, ef_state = apply_error_feedback(grads, ef_state)
        grads, gnorm = clip_by_global_norm(grads, self.tc.optimizer.clip_norm)
        lr = self.schedule(state.step)
        _spend(state)
        _, opt_state = self.opt.update(grads, state.opt_state,
                                       model.stack_for_training(), lr,
                                       state.step)
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


def make_train_step(cfg: ArchConfig, tc: TrainConfig) -> TrainStep:
    return TrainStep(cfg, tc)
