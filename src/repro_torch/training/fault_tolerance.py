"""Fault-tolerant step loop: checkpoint/restart, failure injection,
straggler monitoring.

PyTorch counterpart of ``repro.training.fault_tolerance``.
:func:`run_resilient` drives any ``step(state, batch) -> (state,
metrics)`` for ``total_steps``, checkpointing every ``ckpt_every`` steps
(async, :mod:`repro_torch.training.checkpoint`).  An
:class:`InjectedFault` inside a step triggers a restore from the latest
intact checkpoint and a replay.  Steps are deterministic functions of
(state, batch) and ``batch_fn`` is a function of the step index, so
replayed steps reproduce the originals.  :class:`StepTimer` keeps an EWMA
of step latency and flags outliers (stragglers).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.training import checkpoint as ckpt

log = logging.getLogger("repro_torch.fault_tolerance")


@dataclasses.dataclass
class StepTimer:
    """EWMA step-latency monitor; flags steps slower than mean + k*std."""

    alpha: float = 0.1
    threshold_sigmas: float = 4.0
    warmup: int = 3
    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        """Record one step time; True when it is a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            # initialize on the early steps (the first may include builds)
            self.mean = dt if self.count == 1 else (
                self.mean + (dt - self.mean) / self.count)
            return False
        is_straggler = False
        std = self.var ** 0.5
        if std > 0 and dt > self.mean + self.threshold_sigmas * std:
            is_straggler = True
            self.stragglers += 1
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return is_straggler


class InjectedFault(RuntimeError):
    """Raised by test fault hooks to simulate a node failure."""


def _wait(tree) -> None:
    """Wait for the card's work on every CUDA tensor of ``tree``."""
    devices = {t.device for t in ckpt.tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def run_resilient(
    train_step: Callable,
    state,
    batch_fn: Callable[[int], Any],
    *,
    total_steps: int,
    ckpt_dir: Optional[str],
    ckpt_every: int = 50,
    max_restarts: int = 10,
    fault_hook: Optional[Callable[[int], None]] = None,
    on_straggler: Optional[Callable[[int, float], None]] = None,
    device: str | torch.device | None = None,
    log_every: int = 10,
):
    """Run ``total_steps`` steps with checkpoint/restart fault tolerance.

    ``batch_fn(step)`` must be a deterministic function of the step index
    so that restarts replay identical batches.  ``device``: where restored
    state goes (default: each leaf's own device).  ``ckpt_dir=None``
    writes no checkpoint (a state too large to snapshot in the run's
    time): a fault then replays from the initial state.  A step that
    updates its state in place (the LM train step) leaves no initial
    state to replay from: a fault before the first checkpoint has landed
    then ends the run with the step's
    :class:`~repro_torch.training.train_loop.SpentStateError`.  Returns
    ``(final_state, info dict)``.
    """
    initial_state = state  # the restart target before the first checkpoint
    start, restored = (None, None) if ckpt_dir is None else \
        ckpt.restore_latest_valid(ckpt_dir, state, device=device)
    if start is not None:
        state = restored
        log.info("resumed from checkpoint step %d", start)
    step = int(start) if start is not None else 0

    timer = StepTimer()
    restarts = 0
    pending = None
    metrics = None
    while step < total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch_fn(step))
            _wait(metrics)
            dt = time.perf_counter() - t0
            if timer.observe(dt) and on_straggler is not None:
                on_straggler(step, dt)
            step += 1
            if step % log_every == 0:
                loss = float(metrics.get("loss", 0.0))
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            if ckpt_dir is not None and (step % ckpt_every == 0
                                         or step == total_steps):
                pending = ckpt.save_checkpoint(ckpt_dir, step, state,
                                               blocking=False)
        except InjectedFault as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("fault at step %d (%s); restarting from checkpoint",
                        step, e)
            if pending is not None:
                pending.join()  # let any in-flight write land
            last, restored = (None, None) if ckpt_dir is None else \
                ckpt.restore_latest_valid(ckpt_dir, state, device=device)
            if last is None:
                # a fault before the first checkpoint landed: restart from
                # the caller's initial state (replay from step 0 is
                # deterministic), still bounded by max_restarts
                state = initial_state
                step = 0
            else:
                state = restored
                step = int(last)
    if pending is not None:
        pending.join()
    return state, {
        "steps": step,
        "restarts": restarts,
        "stragglers": timer.stragglers,
        "mean_step_time": timer.mean,
        "final_metrics": metrics,
    }
