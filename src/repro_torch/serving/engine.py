"""Batched serving engine with continuous batching.

A fixed-size decode batch of ``slots``; requests queue up, prefill runs
per request (the cache written into the request's slot), and decode steps
run for the whole batch every tick with per-slot positions.  Finished slots
(EOS or max tokens) are recycled at once, so the decode batch never drains.
Per-slot positions drive the position-masked cache attention, so a batch can
mix requests at very different progress.

The port of ``repro.serving.engine``: the same admission, backpressure,
recycling and greedy sampling.  PyTorch runs eagerly, so there is no
per-length compile cache; a slot's caches are views into the batch's, and
prefill fills them in place: a KV cache's or an MLA cache's rows, a Mamba
layer's conv buffers and state, or an NFFT layer's constant-size (S, z),
which prefill adds into.  Every token architecture is served: dense, MoE,
MLA, Mamba, hybrid and NFFT stacks.  A Mamba layer takes prompts of at
most ``chunk_size`` tokens or whole multiples of it, an NFFT layer
prompts of at most 128 tokens or whole multiples of 128.
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    uid: int
    tokens: list  # prompt token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


class ServeEngine:
    """Continuous-batching greedy decoder over ``model`` (a
    :class:`~repro_torch.models.model.Model`) on ``device`` (default: the
    CUDA card), which must be the model's device."""

    def __init__(self, cfg: ArchConfig, model: M.Model, *, slots: int = 4,
                 max_seq: int = 256, max_queue: Optional[int] = None,
                 device: str | torch.device | None = None):
        if cfg.frontend != "none" or cfg.encoder_only:
            raise ValueError("the engine serves token-only decoder archs")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.cfg, self.model = cfg, model
        self.slots, self.max_seq = slots, max_seq
        self.caches = M.init_caches(cfg, slots, max_seq, device=self.device)
        self.pos = np.zeros((slots,), np.int64)
        self.active: list[Optional[Request]] = [None] * slots
        self.last_token = np.zeros((slots, 1), np.int64)
        # max_queue bounds admission: submit rejects with backpressure
        # instead of growing the queue without limit
        self.queue: "queue.Queue[Request]" = \
            queue.Queue(maxsize=max_queue or 0)
        self.backpressure_rejections = 0

    # -- internals ----------------------------------------------------------
    def _slot_caches(self, slot: int) -> list:
        """One slot's caches as batch-1 views of every tensor field, of any
        cache type (writes land in the batch)."""
        return [type(c)(*(t[slot:slot + 1] for t in c)) for c in self.caches]

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                return
            prompt = torch.as_tensor(np.asarray(req.tokens, np.int64)[None, :],
                                     device=self.device)
            # zero the slot's cache, then prefill into it
            sub = self._slot_caches(slot)
            for c in sub:
                for t in c:
                    t.zero_()
            logits, _ = self.model.forward_prefill({"tokens": prompt}, sub)
            nxt = self._sample(logits[:, -1, :])
            self.active[slot] = req
            self.pos[slot] = prompt.shape[1]
            self.last_token[slot, 0] = nxt
            req.output.append(nxt)

    def _sample(self, logits: torch.Tensor) -> int:
        return int(torch.argmax(logits, dim=-1)[0])

    # -- public -------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request; False (request failed immediately) when the
        bounded queue is full — backpressure instead of unbounded growth."""
        try:
            self.queue.put_nowait(req)
        except queue.Full:
            req.error = "queue full (backpressure)"
            req.done = True
            self.backpressure_rejections += 1
            return False
        return True

    def step(self) -> int:
        """One engine tick: admit waiting requests, one decode step for the
        whole batch, retire finished slots.  Returns #active slots."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        logits, _ = self.model.forward_decode(
            torch.as_tensor(self.last_token, device=self.device),
            torch.as_tensor(self.pos, device=self.device), self.caches)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        n_active = 0
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.output.append(tok)
            self.pos[slot] += 1
            self.last_token[slot, 0] = tok
            finished = (len(req.output) >= req.max_new_tokens
                        or (req.eos_id is not None and tok == req.eos_id)
                        or self.pos[slot] >= self.max_seq - 1)
            if finished:
                req.done = True
                self.active[slot] = None
            else:
                n_active += 1
        return n_active

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            n = self.step()
            if n == 0 and self.queue.empty():
                return
