"""``meta`` stand-ins for every (arch x shape) cell's inputs.

The port of ``repro.launch.specs``.  ``input_specs(cfg, shape)`` mirrors
the pipeline's batch structures as tensors on the ``meta`` device (shape
and dtype, no storage): the dry run (:mod:`repro_torch.launch.dryrun`)
traces the step functions on them.  ``abstract_*`` build the matching
model, train state and caches on ``meta``.  Nothing here allocates.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as model_mod
from repro_torch.training.train_loop import TrainConfig
from repro_torch.training.train_loop import (
    abstract_train_state as _abstract_train_state)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_stub":
        return {"embeds": _spec((b, s, cfg.frontend_dim), torch.float32),
                "labels": _spec((b, s), torch.int32)}
    if cfg.frontend == "vision_stub":
        text = s - cfg.num_prefix_embeds
        return {"image_embeds": _spec((b, cfg.num_prefix_embeds,
                                       cfg.frontend_dim), torch.float32),
                "tokens": _spec((b, text), torch.int32),
                "labels": _spec((b, text), torch.int32)}
    return {"tokens": _spec((b, s), torch.int32),
            "labels": _spec((b, s), torch.int32)}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    spec = train_input_specs(cfg, shape)
    spec.pop("labels", None)
    return spec


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b = shape.global_batch
    return {"token": _spec((b, 1), torch.int32),
            "pos": _spec((b,), torch.int32)}


def abstract_params(cfg: ArchConfig) -> model_mod.Model:
    """The model's parameters on ``meta``."""
    with torch.device("meta"):
        return model_mod.Model(cfg, generator=None, device="meta")


def abstract_train_state(cfg: ArchConfig, tc: TrainConfig):
    return _abstract_train_state(cfg, tc)


def abstract_caches(cfg: ArchConfig, batch: int, max_seq: int) -> list:
    return model_mod.init_caches(cfg, batch, max_seq, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                tc: TrainConfig | None = None) -> dict[str, Any]:
    """All ``meta`` inputs of the step this cell traces.

    Returns {'kind', 'args': tuple} matching the signature of the step
    function (see launch/steps.py): (state, batch) for train, (params,
    batch, caches) for prefill, (params, token, pos, caches) for decode.
    """
    tc = tc or TrainConfig.for_arch(cfg)
    if shape.kind == "train":
        return {"kind": "train",
                "args": (abstract_train_state(cfg, tc),
                         train_input_specs(cfg, shape))}
    params = abstract_params(cfg)
    caches = abstract_caches(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return {"kind": "prefill",
                "args": (params, prefill_input_specs(cfg, shape), caches)}
    if shape.kind == "decode":
        d = decode_input_specs(cfg, shape)
        return {"kind": "decode",
                "args": (params, d["token"], d["pos"], caches)}
    raise ValueError(shape.kind)
