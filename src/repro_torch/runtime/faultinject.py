"""Deterministic fault injection for the solve and serve paths.

PyTorch counterpart of ``repro.runtime.faultinject``.  Every injector is
deterministic given its arguments, so a chaos test is never flaky:

* kill points (:class:`KillPoint`, :class:`KillSchedule`) raise
  :class:`Preemption` at the durable drivers' segment boundaries;
* solver-side injectors wrap a matvec so that chosen columns or bank
  members always emit NaN (a poisoned operator), and :class:`SlowMatvec`
  delays and counts calls;
* serving-side injectors alter a
  :class:`~repro_torch.serving.graph.GraphModelRegistry` from the inside
  (NaN-poisoned cached grids, a corrupted prediction plan), and
  :class:`TickChaos` schedules drops, delays and poisonings per engine tick
  through ``GraphServeEngine(chaos=...)``.

:func:`chaos_schedule` and :func:`nan_poison_grid` draw from numpy's
generator, so a seed gives the JAX package's schedule and masks exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.training.fault_tolerance import InjectedFault


class Preemption(InjectedFault):
    """A simulated process kill (SIGKILL/preemption) at a host sync point."""


@dataclasses.dataclass
class KillPoint:
    """Deterministic preemption for the durable drivers (their
    ``fault_hook``): raises :class:`Preemption` the first ``kills`` times
    the driver's iteration counter has reached ``at_iteration``.  The hook
    fires at segment boundaries, so the driver loses exactly the work
    since its last snapshot."""

    at_iteration: int
    kills: int = 1
    fired: int = 0

    def __call__(self, i: int) -> None:
        if self.fired < self.kills and i >= self.at_iteration:
            self.fired += 1
            raise Preemption(
                f"injected preemption at iteration {i} "
                f"(kill {self.fired}/{self.kills})")


@dataclasses.dataclass
class KillSchedule:
    """Several kill points in one run (a preemption storm); each entry of
    ``at_iterations`` fires once, in order, when the counter reaches it."""

    at_iterations: tuple
    next_idx: int = 0

    def __call__(self, i: int) -> None:
        if (self.next_idx < len(self.at_iterations)
                and i >= self.at_iterations[self.next_idx]):
            self.next_idx += 1
            raise Preemption(
                f"injected preemption at iteration {i} "
                f"(kill {self.next_idx}/{len(self.at_iterations)})")


# ---------------------------------------------------------------------------
# Solver-side injectors
# ---------------------------------------------------------------------------

def poison_columns(matvec: Callable, columns) -> Callable:
    """Wrap an (n, C) -> (n, C) matvec so ``columns`` always emit NaN; the
    guarded solvers must quarantine exactly these columns."""
    cols = list(columns)

    def wrapped(x):
        y = matvec(x).clone()
        y[:, cols] = float("nan")
        return y

    return wrapped


def poison_bank_member(bank_matvec: Callable, members) -> Callable:
    """Wrap an (S, n, C) -> (S, n, C) bank matvec so ``members`` emit NaN:
    one bad member of a ``cg_bank`` / ``minres_bank`` sweep."""
    mem = list(members)

    def wrapped(xb):
        yb = bank_matvec(xb).clone()
        yb[mem] = float("nan")
        return yb

    return wrapped


@dataclasses.dataclass
class SlowMatvec:
    """Host-side matvec delay and call counter (straggler injection)."""

    inner: Callable
    delay_s: float = 0.0
    calls: int = 0

    def __call__(self, x):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return self.inner(x)


# ---------------------------------------------------------------------------
# Grid / plan injectors (serving registry, from the inside)
# ---------------------------------------------------------------------------

def nan_poison_grid(grid: torch.Tensor, *, frac: float = 0.02,
                    seed: int = 0) -> torch.Tensor:
    """NaN a seeded random subset of grid entries (memory corruption); the
    mask is numpy's, as in the JAX package."""
    mask = np.random.default_rng(seed).random(tuple(grid.shape)) < frac
    return torch.where(torch.as_tensor(mask, device=grid.device),
                       float("nan"), grid)


def poison_registry_grids(registry, model_id: str, *, frac: float = 0.02,
                          seed: int = 0) -> int:
    """NaN-poison every cached transformed grid of ``model_id`` in place;
    returns how many.  The engine's non-finite output guard must fail the
    affected requests, trip the model's breaker and drop the poisoned
    grids, so later requests rebuild clean ones."""
    group = registry.group_of(model_id)
    if group is None:
        return 0
    poisoned = 0
    with registry._lock:
        for key in list(group.grids):
            if key[0] == model_id:
                group.grids[key] = nan_poison_grid(
                    group.grids[key], frac=frac, seed=seed + poisoned)
                poisoned += 1
    return poisoned


def corrupt_group_plan(registry, model_id: str, *,
                       shift_by: float = 10.0) -> bool:
    """Corrupt ``model_id``'s frozen PredictionPlan in place: its shift and
    its scaled sources move out of the admissible ball.  Detectable (the
    plan's own sources break its admissibility invariant, which the engine
    checks when admissions fail) and recoverable
    (``registry.rebuild_group``)."""
    group = registry.group_of(model_id)
    if group is None:
        return False
    with registry._lock:
        pred = group.pred
        group.pred = dataclasses.replace(
            pred, shift=pred.shift + shift_by,
            scaled_src=pred.scaled_src + 2.0 * pred.radius)
    return True


# ---------------------------------------------------------------------------
# Engine tick chaos
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TickChaos:
    """Seeded per-tick fault schedule for ``GraphServeEngine(chaos=...)``.

    The engine calls :meth:`apply` at the top of every tick; True drops
    the tick (requests wait).  ``slow_ticks`` sleeps on the host;
    ``poison_grids`` / ``corrupt_plans`` fire the registry injectors above
    at their tick.
    """

    drop_ticks: frozenset = frozenset()
    slow_ticks: Mapping[int, float] = dataclasses.field(default_factory=dict)
    poison_grids: Mapping[int, str] = dataclasses.field(default_factory=dict)
    corrupt_plans: Mapping[int, str] = dataclasses.field(default_factory=dict)
    seed: int = 0

    def apply(self, engine, tick: int) -> bool:
        delay = self.slow_ticks.get(tick)
        if delay:
            time.sleep(delay)
        model_id = self.poison_grids.get(tick)
        if model_id is not None:
            poison_registry_grids(engine.registry, model_id, seed=self.seed)
        model_id = self.corrupt_plans.get(tick)
        if model_id is not None:
            corrupt_group_plan(engine.registry, model_id)
        return tick in self.drop_ticks


def chaos_schedule(seed: int, *, ticks: int, models=(),
                   p_drop: float = 0.05, p_slow: float = 0.05,
                   slow_s: float = 0.002, p_poison: float = 0.0) -> TickChaos:
    """A seeded random :class:`TickChaos` over ``ticks`` engine ticks."""
    rng = np.random.default_rng(seed)
    drops, slows, poisons = set(), {}, {}
    for t in range(ticks):
        r = rng.random()
        if r < p_drop:
            drops.add(t)
        elif r < p_drop + p_slow:
            slows[t] = slow_s
        elif models and r < p_drop + p_slow + p_poison:
            poisons[t] = models[int(rng.integers(len(models)))]
    return TickChaos(drop_ticks=frozenset(drops), slow_ticks=slows,
                     poison_grids=poisons, seed=seed)
