"""Deterministic synthetic data pipeline for LM training (numpy only).

The port's own copy of ``repro.data.pipeline``: the same seed and step
give the same arrays.  ``batch_for_step(step)`` is a pure function of
(seed, step, shape), so restarted and replayed steps see identical data.
A background prefetcher keeps ``depth`` batches ahead of the consumer so
that host-side generation overlaps the card's work; the training loop
moves each batch to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec


NOISE = 0.1  # structured-stream corruption rate (loss floor ~ -0.9 ln 0.9
#              - 0.1 ln(0.1/V) << ln V — a learnable signal, unlike uniform
#              random tokens whose optimal loss IS ln V)


def _structured_tokens(rng, b: int, length: int, vocab: int) -> np.ndarray:
    """Affine-recurrence token stream with epsilon-noise: learnable synthetic
    language.  t_{i+1} = (5 t_i + 1) mod V with prob 1-NOISE, else uniform."""
    toks = np.empty((b, length), np.int32)
    toks[:, 0] = rng.integers(0, vocab, b)
    noise = rng.random((b, length - 1)) < NOISE
    rand = rng.integers(0, vocab, (b, length - 1)).astype(np.int32)
    for i in range(length - 1):
        nxt = (5 * toks[:, i] + 1) % vocab
        toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
    return toks


def batch_for_step(cfg: ArchConfig, shape: ShapeSpec, step: int, *,
                   seed: int = 0, batch_override: Optional[int] = None) -> dict:
    """One training batch as host numpy arrays (tokens/embeds + labels)."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.frontend == "audio_stub":
        embeds = rng.standard_normal((b, s, cfg.frontend_dim),
                                     dtype=np.float32)
        labels = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
        return {"embeds": embeds, "labels": labels}
    if cfg.frontend == "vision_stub":
        text = s - cfg.num_prefix_embeds
        image = rng.standard_normal((b, cfg.num_prefix_embeds,
                                     cfg.frontend_dim), dtype=np.float32)
        toks = _structured_tokens(rng, b, text + 1, cfg.vocab_size)
        return {"image_embeds": image, "tokens": toks[:, :-1],
                "labels": toks[:, 1:]}
    toks = _structured_tokens(rng, b, s + 1, cfg.vocab_size)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Host-side prefetch: generates batches for steps [start, ...) in a
    daemon thread, ``depth`` ahead.  ``get(step)`` enforces the deterministic
    step->batch mapping (out-of-order gets fall back to direct generation,
    e.g. after a restart rewind)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, *, start: int = 0,
                 depth: int = 2, seed: int = 0,
                 batch_override: Optional[int] = None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.batch_override = batch_override
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(start,),
                                        daemon=True)
        self._thread.start()

    def _direct(self, step: int) -> dict:
        return batch_for_step(self.cfg, self.shape, step, seed=self.seed,
                              batch_override=self.batch_override)

    def _fill(self, start: int) -> None:
        step = start
        while not self._stop.is_set():
            batch = self._direct(step)
            try:
                self._q.put((step, batch), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def get(self, step: int) -> dict:
        try:
            while True:
                got_step, batch = self._q.get(timeout=5.0)
                if got_step == step:
                    return batch
                if got_step > step:  # rewound (restart): regenerate directly
                    return self._direct(step)
        except queue.Empty:  # pragma: no cover
            return self._direct(step)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
