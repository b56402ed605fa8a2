"""Rank-side cases of the dry run's and the sharded serving steps' tests.

Module-level functions that ``repro_torch.launch.ranks.RankPool`` runs on
every rank, SPMD, as ``fn(ctx, *args)`` (tests/test_torch_dryrun.py and
tests/test_torch_sharded_serve.py).  No JAX here.

* ``live_and_dry``: one train, prefill or decode step of a reduced config
  on the live mesh, its collective traffic and ``FlopCounterMode`` FLOPs,
  beside the dry run of the same cell as this rank of the described mesh.
* ``serve``: the sharded prefill and decode steps on weights and tokens
  the test hands over, the logits of every step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_shard_cases import replace_fields
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import model as lm
from repro_torch.training import train_loop as ttl

DECODE_POS = 40  # the live decode step's position (a mid-cache row)


def config(arch: str, batch: int, token_groups: int | None = None,
           over=()):
    """The reduced config of ``arch``; ``over``: fields replaced
    (``_torch_shard_cases.replace_fields``)."""
    cfg = reduced_config(get_config(arch), global_batch=batch)
    if token_groups is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, token_groups=token_groups))
    return replace_fields(cfg, over)


def mesh(ctx, shape):
    key = ("mesh", tuple(shape))
    if key not in ctx.cache:
        ctx.cache[key] = make_mesh(shape, ("data", "model"))
    return ctx.cache[key]


def _counts(m, flops) -> dict:
    return {"traffic": dict(m.traffic),
            "traffic_axes": {f"{k}@{'+'.join(a)}": v
                             for (k, a), v in m.traffic_axes.items()},
            "flops": flops}


def live_and_dry(ctx, arch, shape, kind, rows):
    """(live counts, dry counts) of one ``kind`` step of reduced ``arch``
    (``rows`` rows) on mesh ``shape``: the live step on this rank (seeded
    weights, the pipeline's batch; decode at ``DECODE_POS`` on zero
    caches) and ``trace_cell`` as this rank of the described mesh, both
    without the flash kernel in prefill (the CPU's einsum, which
    ``FlopCounterMode`` counts)."""
    cfg = config(arch, rows)
    cell = next(s for s in cfg.shapes if s.kind == kind and not
                s.skip_reason)
    tc = ttl.TrainConfig.for_arch(cfg)
    m = mesh(ctx, shape)
    step = steps.make_step_fn(cfg, kind, tc, mesh=m)
    batch = {k: torch.as_tensor(v) for k, v in
             batch_for_step(cfg, cell, 0).items()}
    if kind == "train":
        args = (ttl.init_train_state(cfg, tc, 0, device="cpu", mesh=m),
                batch)
        kw = {}
    else:
        model = step.serve.shard(lm.init_params(cfg, 0, device="cpu"))
        caches = step.serve.shard_caches(
            lm.init_caches(cfg, rows, cell.seq_len, device="cpu"))
        if kind == "prefill":
            batch.pop("labels", None)
            args, kw = (model, batch, caches), {"use_flash": False}
        else:
            token = batch["tokens"][:, :1]
            pos = torch.full((rows,), DECODE_POS, dtype=torch.int32)
            args, kw = (model, token, pos, caches), {}
    m.traffic.clear()
    m.traffic_axes.clear()
    with FlopCounterMode(display=False) as flops:
        step(*args, **kw)
    live = _counts(m, flops.get_total_flops())
    dry = steps.trace_cell(cfg, cell, Mesh(m.shape), rank=ctx.rank, tc=tc,
                           use_flash=False)
    out = _counts(dry["mesh"], dry["stats"].matmul_flops)
    out["kernels"] = dry["stats"].kernels
    return live, out


def serve(ctx, arch, shape, tree, prompt, tokens, max_seq,
          token_groups=None, over=()):
    """The sharded prefill of ``prompt`` (b, s) and one decode step per
    column of ``tokens`` (b, n) at the positions after it, on mesh
    ``shape``, from the weights ``tree`` (the JAX package's parameter
    tree as numpy): the logits of every step, as numpy."""
    rows = prompt.shape[0]
    cfg = config(arch, rows, token_groups, over)
    m = mesh(ctx, shape)
    prefill = steps.make_step_fn(cfg, "prefill", None, mesh=m)
    decode = steps.make_step_fn(cfg, "decode", None, mesh=m)
    serve_step = prefill.serve
    model = serve_step.shard(lm.params_from_arrays(tree, cfg, device="cpu"))
    local = serve_step.shard_caches(
        lm.init_caches(cfg, rows, max_seq, device="cpu"))
    logits, local = prefill(model, {"tokens": torch.as_tensor(prompt)},
                            local)
    out = [logits.numpy().copy()]
    s = prompt.shape[1]
    for i in range(tokens.shape[1]):
        pos = torch.full((rows,), s + i, dtype=torch.int32)
        logits, local = decode(model, torch.as_tensor(tokens[:, i:i + 1]),
                               pos, local)
        out.append(logits.numpy().copy())
    return {"rank": ctx.rank, "logits": np.stack(out)}
