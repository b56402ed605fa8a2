"""Optimizers: AdamW (fp32 master + moments) and Adafactor (factored second
moment, no master), and the learning-rate schedule.

The port of ``repro.training.optimizer``, on trees of tensors
(:mod:`repro_torch.tree`): ``init(params) -> state``, ``update(grads,
state, params, lr, step) -> (params, state)``.  The decisions the
reference makes per leaf (weight decay on ``ndim >= 2``, Adafactor's
factoring and its update-RMS clip) are made per leaf here too, so the
tree handed in must have the JAX package's leaves: for a model, the
period-stacked tree of :meth:`repro_torch.models.model.Model.
stack_for_training`, where a stacked norm is one (n_periods, d) leaf
that is decayed and whose update RMS is taken over every layer at once.

Unlike the reference's, ``update`` works in place: the state's tensors
and the parameters are overwritten (and returned), so that a model at
full width holds one copy of each.  ``grads`` are float32 and are only
read.  ``lr`` and ``step`` are 0-d tensors (or numbers) on the leaves'
device; nothing here reads them on the host.

Sharded (``update(..., shardings=(param shardings, state shardings))``
and ``clip_by_global_norm(..., shardings=)``, trees of
:class:`repro_torch.dist.sharding.NamedSharding`): each leaf is this
rank's block.  AdamW is elementwise and runs on the blocks as they are;
Adafactor decides whether to factor by the full leaf's shape, sums the
squared gradient's rows and columns over the axes that split them, keeps
its moments as blocks under their own shardings, and takes the update's
RMS over the whole leaf; the global norm sums each leaf's squares over
the axes that split it (a replicated leaf counts once).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # 'adamw' | 'adafactor'
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # adafactor
    decay_offset: float = 1e-30
    factored_min_dim: int = 128


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def make_schedule(cfg: OptimizerConfig) -> Callable:
    """Linear warmup from peak/warmup at step 0, then cosine decay to
    ``min_lr_ratio`` of the peak; float32, as the reference's."""
    def schedule(step) -> torch.Tensor:
        step = _f32(step)
        # (step+1)/warmup: step 0 must have a nonzero LR or it is a no-op
        warm = cfg.peak_lr * (step + 1.0) / max(cfg.warmup_steps, 1)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)
    return schedule


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in float32 (per-leaf norms:
    no squared copy of a leaf).  With ``shardings``, the leaves are blocks
    and each leaf's squares are summed over the axes that split it."""
    leaves = [x.float() for x in tree_leaves(tree)]
    norms = torch._foreach_norm(leaves)
    sh = None if shardings is None else tree_leaves(shardings)
    if sh is None or not any(s.is_split for s in sh):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms) ** 2
    by_axes = {}
    for i, s in enumerate(sh):
        by_axes.setdefault(s.axes, []).append(i)
    total = sq.new_zeros(())
    for axes in sorted(by_axes):
        part = sq[by_axes[axes]]
        if axes:
            part = sh[by_axes[axes][0]].mesh.psum(part, axes)
        total = total + part.sum()
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, shardings=None):
    """Scale float32 ``grads`` in place so that their global norm is at
    most ``max_norm``; returns (grads, norm before clipping)."""
    norm = global_norm(grads, shardings)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(tree_leaves(grads), scale)
    return grads, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    master: Any  # fp32 master params
    m: Any
    v: Any


def _adamw_init(params) -> AdamWState:
    return AdamWState(
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params))


@torch.no_grad()
def _adamw_update(cfg: OptimizerConfig, grads, state: AdamWState, params,
                  lr, step):
    t = _f32(step) + 1.0
    corr1 = 1.0 - cfg.b1 ** t
    corr2 = 1.0 - cfg.b2 ** t
    for g, m, v, master, p in zip(*map(tree_leaves, (
            grads, state.m, state.v, state.master, params))):
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        u = (m / corr1).div_((v / corr2).sqrt_().add_(cfg.eps))
        if master.ndim >= 2:  # decoupled weight decay on matrices only
            u.add_(master, alpha=cfg.weight_decay)
        master.sub_(u.mul_(lr))
        p.copy_(master)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    v_row: Any  # factored second moment (rows) or full v for small leaves
    v_col: Any
    v_full: Any


def _factored(p, min_dim: int) -> bool:
    return _factored_shape(tuple(p.shape), min_dim)


def _factored_shape(shape: tuple, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def _adafactor_init(params, cfg: OptimizerConfig) -> AdafactorState:
    def zeros(p, shape):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def row(p):
        return zeros(p, p.shape[:-1] if _factored(p, cfg.factored_min_dim)
                     else ())

    def col(p):
        return zeros(p, p.shape[:-2] + p.shape[-1:]
                     if _factored(p, cfg.factored_min_dim) else ())

    def full(p):
        return zeros(p, () if _factored(p, cfg.factored_min_dim)
                     else p.shape)

    return AdafactorState(v_row=tree_map(row, params),
                          v_col=tree_map(col, params),
                          v_full=tree_map(full, params))


@torch.no_grad()
def _adafactor_update(cfg: OptimizerConfig, grads, state: AdafactorState,
                      params, lr, step):
    t = _f32(step) + 1.0
    beta2 = 1.0 - t ** (-0.8)  # Shazeer-Stern decay schedule
    for g, vr, vc, vf, p in zip(*map(tree_leaves, (
            grads, state.v_row, state.v_col, state.v_full, params))):
        g2 = (g * g).add_(cfg.decay_offset)
        if _factored(p, cfg.factored_min_dim):
            vr.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
            vc.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
            del g2
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                     + 1e-30)
        else:
            vf.mul_(beta2).add_((1 - beta2) * g2)
            del g2
            u = g / (torch.sqrt(vf) + 1e-30)
        # update clipping (RMS <= 1) stabilizes bf16-weight training
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u.div_(torch.clamp(rms, min=1.0))
        if p.ndim >= 2:
            u.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float() - lr * u)
    return params, state


def _full_sum(x: torch.Tensor, sharding, dim: int) -> torch.Tensor:
    """The sum over ``dim`` of the full array whose block is ``x``, whole
    (replicated): summed over the axes that split ``dim``, gathered over
    the axes that split the other dims."""
    dim %= x.ndim
    out = x.sum(dim=dim)
    for d, axes in sharding.dim_axes():
        if d == dim:
            out = sharding.mesh.psum(out, axes)
    for d, axes in sharding.dim_axes():
        if d != dim:
            out = sharding.mesh.all_gather(out, axes, d if d < dim else d - 1)
    return out


@torch.no_grad()
def _adafactor_update_sharded(cfg: OptimizerConfig, grads,
                              state: AdafactorState, params, lr, step,
                              param_sh, state_sh: AdafactorState):
    t = _f32(step) + 1.0
    beta2 = 1.0 - t ** (-0.8)
    for g, vr, vc, vf, p, psh, rsh, csh in zip(*map(tree_leaves, (
            grads, state.v_row, state.v_col, state.v_full, params, param_sh,
            state_sh.v_row, state_sh.v_col))):
        full = psh.shape
        g2 = (g * g).add_(cfg.decay_offset)
        if _factored_shape(full, cfg.factored_min_dim):
            row = _full_sum(g2, psh, -1) / full[-1]
            col = _full_sum(g2, psh, -2) / full[-2]
            del g2
            vr_full = rsh.gather(vr).mul_(beta2).add_((1 - beta2) * row)
            vc_full = csh.gather(vc).mul_(beta2).add_((1 - beta2) * col)
            vr.copy_(rsh.shard(vr_full))
            vc.copy_(csh.shard(vc_full))
            r = vr_full / torch.clamp(vr_full.mean(dim=-1, keepdim=True),
                                      min=1e-30)
            r = psh.take(r, -1, -2)  # this block's rows
            c = psh.take(vc_full, -1, -1)  # and its columns
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(c)[..., None, :]
                     + 1e-30)
        else:
            vf.mul_(beta2).add_((1 - beta2) * g2)
            del g2
            u = g / (torch.sqrt(vf) + 1e-30)
        sq = (u * u).sum()
        if psh.axes:
            sq = psh.mesh.psum(sq, psh.axes)
        rms = torch.sqrt(sq / math.prod(full) + 1e-30)
        u.div_(torch.clamp(rms, min=1.0))
        if p.ndim >= 2:
            u.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float() - lr * u)
    return params, state


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Any
    # (grads, state, params, lr, step, shardings=None) -> (params, state)
    update: Any
    config: OptimizerConfig


def _adafactor(cfg, g, s, p, lr, step, shardings=None):
    if shardings is None:
        return _adafactor_update(cfg, g, s, p, lr, step)
    return _adafactor_update_sharded(cfg, g, s, p, lr, step, *shardings)


def init_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        # elementwise: a block updates as it is
        return Optimizer(
            init=_adamw_init,
            update=lambda g, s, p, lr, step, shardings=None: _adamw_update(
                cfg, g, s, p, lr, step),
            config=cfg)
    if cfg.name == "adafactor":
        return Optimizer(
            init=lambda p: _adafactor_init(p, cfg),
            update=lambda g, s, p, lr, step, shardings=None: _adafactor(
                cfg, g, s, p, lr, step, shardings),
            config=cfg)
    raise ValueError(cfg.name)
