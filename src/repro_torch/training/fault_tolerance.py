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

The replay target before the first checkpoint is one that no step can
spend, since the LM train step updates its state in place: a step-0
checkpoint written before the first step, or, without a checkpoint
directory, a host copy of the initial state that a replay copies back in
place.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.training import checkpoint as ckpt
from repro_torch.tree import tree_leaves, tree_unflatten

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


def _mem_available() -> Optional[int]:
    """The host's MemAvailable in bytes (None where /proc/meminfo is not
    there to read)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def host_copy(state) -> tuple:
    """A host copy of every leaf of ``state`` (the replay target without
    checkpoints) and its record: bytes, the host's MemAvailable before,
    seconds.  Raises MemoryError, before anything is copied, when the
    copy would not fit in nine tenths of MemAvailable."""
    leaves = tree_leaves(state)
    nbytes = sum(t.numel() * t.element_size() for t in leaves
                 if isinstance(t, torch.Tensor))
    avail = _mem_available()
    if avail is not None and nbytes > 0.9 * avail:
        raise MemoryError(
            f"run_resilient without a checkpoint directory keeps a host copy "
            f"of the initial state to replay from: {nbytes} bytes, but the "
            f"host has {avail} bytes available; give ckpt_dir")
    t0 = time.perf_counter()
    # pageable: page-locked memory stays in torch's host cache after the
    # run, tens of GB at full width
    host = [t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor)
            else copy.deepcopy(t) for t in leaves]
    info = {"bytes": nbytes, "mem_available": avail,
            "seconds": time.perf_counter() - t0}
    log.info("host copy of the initial state: %d bytes in %.2fs "
             "(MemAvailable %s bytes)", nbytes, info["seconds"], avail)
    return host, info


@torch.no_grad()
def copy_back(state, host: list):
    """``state`` with the values of ``host`` (a :func:`host_copy`), copied
    into its tensors in place (a module's parameters too); 0-d tensors,
    such as a train state's step, are made anew, so a step that marks the
    states it spent takes the result."""
    out = []
    for live, saved in zip(tree_leaves(state), host):
        if isinstance(live, torch.Tensor):
            live.copy_(saved)
            out.append(live.clone() if live.ndim == 0 else live)
        else:
            out.append(copy.deepcopy(saved))
    return ckpt._into_modules(state, tree_unflatten(state, out))


def _barrier(state_shardings) -> None:
    """Every rank waits for the others (a sharded state: rank 0 writes the
    checkpoints the others read)."""
    if state_shardings is not None and dist.is_initialized():
        dist.barrier()


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
    state_shardings: Any = None,
    device: str | torch.device | None = None,
    log_every: int = 10,
):
    """Run ``total_steps`` steps with checkpoint/restart fault tolerance.

    ``batch_fn(step)`` must be a deterministic function of the step index
    so that restarts replay identical batches.  ``device``: where restored
    state goes (default: each leaf's own device).  ``state_shardings``:
    ``state`` is this rank's blocks under these shardings (the sharded
    train step's); every save and restore is sharded, and every rank of
    the mesh runs this.

    A fault before the first periodic checkpoint replays from the initial
    state, which no step can spend (the LM train step updates its state in
    place): with ``ckpt_dir``, a step-0 checkpoint written before the
    first step (unless the run resumed from a checkpoint), restored in
    place; with ``ckpt_dir=None`` (nothing is written: a state too large
    to snapshot in the run's time), a host copy taken before the first
    step (:func:`host_copy`; it raises before the first step when the host
    cannot hold it) and copied back in place.  Returns ``(final_state,
    info dict)``; ``info["initial_copy"]`` is the host copy's record.
    """
    start, restored = (None, None) if ckpt_dir is None else \
        ckpt.restore_latest_valid(ckpt_dir, state, device=device,
                                  shardings=state_shardings)
    if start is not None:
        state = restored
        log.info("resumed from checkpoint step %d", start)
    step = int(start) if start is not None else 0

    timer = StepTimer()
    restarts = 0
    pending = None
    metrics = None
    initial_state, initial_host, copy_info = state, None, None
    if ckpt_dir is None:
        initial_host, copy_info = host_copy(state)
    elif start is None:
        # written before the clock starts, so no step shares the host with
        # the writer
        ckpt.save_checkpoint(ckpt_dir, 0, state, shardings=state_shardings)
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
                                               blocking=False,
                                               shardings=state_shardings)
        except InjectedFault as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("fault at step %d (%s); restarting from checkpoint",
                        step, e)
            if pending is not None:
                pending.join()  # let any in-flight write land
            _barrier(state_shardings)
            if ckpt_dir is None:
                # replay from step 0 is deterministic, still bounded by
                # max_restarts
                state, step = copy_back(state, initial_host), 0
                continue
            last, restored = ckpt.restore_latest_valid(
                ckpt_dir, state, device=device, shardings=state_shardings)
            if last is None:
                # even step 0's checkpoint is damaged: the caller's state
                # (an in-place step refuses it as spent)
                state, step = initial_state, 0
            else:
                state = restored
                step = int(last)
    if pending is not None:
        pending.join()
    _barrier(state_shardings)
    return state, {
        "steps": step,
        "restarts": restarts,
        "stragglers": timer.stragglers,
        "mean_step_time": timer.mean,
        "final_metrics": metrics,
        "initial_copy": copy_info,
    }
