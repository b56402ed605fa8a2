"""Rank-side cases of the sharded train step's tests.

Module-level functions that ``repro_torch.launch.ranks.RankPool`` runs on
every rank, SPMD, as ``fn(ctx, *args)`` (tests/test_torch_sharded_train.py
and the ``gpu`` test of tests/test_torch_gpu.py).  A case builds its
state from a plain initial state (numpy trees and the step, no JAX
classes), or from the port's seeded init, trains on the pipeline's
batches and sends back numpy: the metrics of every step, the gathered
full leaves, digests of what every rank must hold alike, the bytes of
state the rank holds and each step's collective traffic; or the matmul
FLOPs of one forward (``forward_flops``).  No JAX here: the card's tests
import this module too.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.dist.compression import CompressionState
from repro_torch.launch.mesh import make_mesh
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import train_loop as ttl
from repro_torch.training.optimizer import (
    AdafactorState, AdamWState, OptimizerConfig)
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map


def replace_fields(cfg, over=()):
    """``cfg`` (either package's config) with each (field, value) of
    ``over`` replaced; ``"moe.num_experts"`` names a sub-config's field."""
    for name, value in over:
        sub, _, field = name.rpartition(".")
        if sub:
            value = dataclasses.replace(getattr(cfg, sub), **{field: value})
        cfg = dataclasses.replace(cfg, **{sub or field: value})
    return cfg


def config(arch: str, batch: int, token_groups: int | None = None,
           vocab: int | None = None, over=()):
    """The reduced config of ``arch`` for a global batch of ``batch`` rows;
    ``token_groups`` replaces the MoE's, ``vocab`` the vocabulary size,
    ``over`` other fields (:func:`replace_fields`)."""
    cfg = reduced_config(get_config(arch), global_batch=batch)
    if token_groups is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, token_groups=token_groups))
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return replace_fields(cfg, over)


def train_config(opt: str, micro: int, compress: bool) -> ttl.TrainConfig:
    """The reference's default optimizer settings, Adafactor factoring
    leaves of 16 and more (at 128 no reduced leaf is factored)."""
    kw = {"factored_min_dim": 16} if opt == "adafactor" else {}
    return ttl.TrainConfig(optimizer=OptimizerConfig(name=opt, **kw),
                           num_microbatches=micro, compress_grads=compress)


def mesh(ctx, shape):
    key = ("mesh", tuple(shape))
    if key not in ctx.cache:
        ctx.cache[key] = make_mesh(shape, ("data", "model"))
    return ctx.cache[key]


class _Plain:
    """A plain initial state as ``train_state_from_arrays`` reads it."""

    def __init__(self, plain: dict, opt: str):
        state_type = {"adamw": AdamWState, "adafactor": AdafactorState}[opt]
        self.step = plain["step"]
        self.params = plain["params"]
        self.opt_state = state_type(*plain["opt_state"])
        self.ef_state = None if plain["ef"] is None else CompressionState(
            residuals=plain["ef"])


def state_for(ctx, cfg, tc, m, plain=None, seed=0):
    if plain is None:
        return ttl.init_train_state(cfg, tc, seed, device=ctx.device, mesh=m)
    return ttl.shard_train_state(ttl.train_state_from_arrays(
        _Plain(plain, tc.optimizer.name), cfg, tc, device=ctx.device), m)


def batch(ctx, cfg, step):
    return {k: torch.as_tensor(v, device=ctx.device)
            for k, v in batch_for_step(cfg, cfg.shapes[0], step).items()}


def _np(t) -> np.ndarray:
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _digest(t) -> str:
    return hashlib.sha256(_np(t).tobytes()).hexdigest()


def gathered(state, step) -> dict:
    """The full state in the JAX package's layout (the params stacked),
    gathered from the ranks' blocks, as numpy trees."""
    sh = step.state_shardings
    leaves = state.params.stack_for_training()

    def full(tree, shardings):
        return ttl._tree_zip(lambda t, s: _np(s.gather(t)), tree, shardings)

    out = {"params": full(leaves, step.leaf_shardings),
           "opt_state": [full(t, s) for t, s in zip(state.opt_state,
                                                     sh.opt_state)]}
    if state.ef_state is not None:
        out["ef"] = full(state.ef_state.residuals, sh.ef_state.residuals)
    return out


def state_bytes(state, step) -> tuple:
    """(bytes of state this rank holds, the bytes the rules give it: the
    blocks of ``_state_shardings``, the unsharded total)."""
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(state) if isinstance(t, torch.Tensor))
    abstract = ttl.abstract_train_state(step.cfg, step.tc)
    pairs = list(zip(tree_leaves(abstract), tree_leaves(step.state_shardings)))
    want = sum(s.block_numel() * t.element_size() for t, s in pairs)
    full = sum(t.numel() * t.element_size() for t, _ in pairs)
    return held, want, full


def digests(state, step) -> dict:
    """sha256 of every leaf that no axis splits (its block is the whole
    leaf on every rank), by path."""
    out = {}
    sh = step.state_shardings
    for (path, t), s in zip(tree_flatten_with_path(state), tree_leaves(sh)):
        if isinstance(t, torch.Tensor) and not s.is_split:
            out[path] = _digest(t)
    return out


def train(ctx, arch, shape, opt, micro, compress, batch_rows, plain, steps,
          token_groups=None, save_dir=None, save_at=None, vocab=None,
          over=()):
    """``steps`` sharded steps on mesh ``shape`` from ``plain`` (or the
    seeded init); with ``save_dir``, a sharded checkpoint after
    ``save_at`` steps.  Returns metrics, the gathered state, digests of
    the unsplit leaves, bytes of state, each step's collective traffic
    (by kind, and by kind and axes)."""
    m = mesh(ctx, shape)
    cfg = config(arch, batch_rows, token_groups, vocab, over)
    tc = train_config(opt, micro, compress)
    state = state_for(ctx, cfg, tc, m, plain)
    step = ttl.make_train_step(cfg, tc, mesh=m)
    metrics, traffic, by_axes = [], [], []
    for s in range(steps):
        m.traffic.clear()
        m.traffic_axes.clear()
        state, mt = step(state, batch(ctx, cfg, s))
        traffic.append(dict(m.traffic))
        by_axes.append(dict(m.traffic_axes))
        metrics.append({k: float(v) for k, v in mt.items()})
        if save_dir is not None and s + 1 == save_at:
            ckpt.save_checkpoint(save_dir, s + 1, state,
                                 shardings=step.state_shardings)
    return {"metrics": metrics, "full": gathered(state, step),
            "digests": digests(state, step),
            "bytes": state_bytes(state, step), "traffic": traffic,
            "traffic_axes": by_axes}


def resume(ctx, arch, shape, opt, batch_rows, directory, at, steps):
    """A state restored from ``directory``'s step ``at`` onto mesh
    ``shape`` (each rank reads its blocks), then ``steps`` more steps:
    their metrics."""
    m = mesh(ctx, shape)
    cfg = config(arch, batch_rows)
    tc = train_config(opt, 1, False)
    step = ttl.make_train_step(cfg, tc, mesh=m)
    like = state_for(ctx, cfg, tc, m, seed=1)
    state = ckpt.restore_checkpoint(directory, at, like,
                                    shardings=step.state_shardings)
    assert int(state.step) == at
    out = []
    for s in range(at, at + steps):
        state, mt = step(state, batch(ctx, cfg, s))
        out.append({k: float(v) for k, v in mt.items()})
    return out


def route_positions(ctx, shape, t, seed):
    """MoE routing under ``shape``'s mesh, each rank holding its block of
    t tokens over the data axis: this rank's positions, slots and aux loss
    from layer 0's router of reduced olmoe-1b-7b (seed 0)."""
    from repro_torch.models.common import set_mesh
    from repro_torch.models.model import init_params
    m = mesh(ctx, shape)
    cfg = config("olmoe-1b-7b", 2)
    moe = init_params(cfg, 0, device=ctx.device).blocks[0].moe
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (t, cfg.d_model)).astype(np.float32), device=ctx.device)
    n = m.shape["data"]
    i = m.coords()["data"]
    local = x[i * t // n:(i + 1) * t // n]
    with torch.no_grad(), set_mesh(m, ("data",)):
        r = moe.route(local)
    return {"pos": _np(r.pos), "slot": _np(r.slot), "aux": float(r.aux)}


def param_tree(model) -> dict:
    return tree_map(_np, model.stack_for_training())


def forward_flops(ctx, arch, shape, batch_rows, token_groups=None, over=()):
    """Matmul FLOPs (``FlopCounterMode``) of the sharded step's forward of
    one batch on mesh ``shape`` (seeded init, no gradient), and of the
    single-device model's forward on this rank's rows of it."""
    from torch.utils.flop_counter import FlopCounterMode
    m = mesh(ctx, shape)
    cfg = config(arch, batch_rows, token_groups, over=over)
    tc = train_config("adamw", 1, False)
    state = state_for(ctx, cfg, tc, m)
    step = ttl.make_train_step(cfg, tc, mesh=m)
    b = batch(ctx, cfg, 0)
    with torch.no_grad():
        with FlopCounterMode(display=False) as sharded:
            step.forward(state.params, b)
        local, _ = step.shard_batch(b)
        whole = ttl.init_train_state(cfg, tc, 0, device=ctx.device).params
        with FlopCounterMode(display=False) as single:
            whole.forward_train(local, remat=False)
    return {"rank": ctx.rank, "flops": sharded.get_total_flops(),
            "single": single.get_total_flops()}
